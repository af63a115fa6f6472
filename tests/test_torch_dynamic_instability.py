"""The port's dynamic instability against the JAX package's.

The same seeded state and the same `SimRNG` state go into both packages'
`apply_dynamic_instability` on every branch (catastrophe only, a group built
from scratch, nucleation into inactive slots, capacity growth with
``node_multiple = 4``, two resolution buckets, and the two raises); the
active mask, lengths, bindings, config ranks, the stats and the RNG
counters after the update must be equal, and the positions agree to 1e-14.
Then the nucleation-site table's order, the padded slots' finiteness in a
flow, and `System.run` on the resume test's scene (a 100-node sphere with 12
sites, DI at 16 nodes, adaptive dt off), four steps in f64 on the CPU: the
per-step events, live counts and GMRES iterations are equal, and the
per-frame fiber counts and bindings too, with positions within 1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.bodies import bodies as jbd
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import DynamicInstability as JDI
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.periphery.precompute import precompute_body
from skellysim_tpu.system import System as JSystem
from skellysim_tpu.system import dynamic_instability as jdi
from skellysim_tpu.utils.rng import SimRNG as JRNG
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.system import System
from skellysim_tpu_torch.system import dynamic_instability as tdi
from skellysim_tpu_torch.utils.rng import SimRNG as TRNG

_PRE = precompute_body("sphere", 100, radius=0.5)


def _sites(n, seed=11, radius=0.5):
    s = np.random.default_rng(seed).standard_normal((n, 3))
    return radius * s / np.linalg.norm(s, axis=1, keepdims=True)


def _body(n_sites, position=(0.0, 0.0, 0.0), n_bodies=1, rank0=0):
    sites = np.stack([_sites(n_sites, seed=11 + b) for b in range(n_bodies)])
    return jbd.make_group(
        np.repeat(_PRE["node_positions_ref"][None], n_bodies, 0),
        np.repeat(_PRE["node_normals_ref"][None], n_bodies, 0),
        np.repeat(_PRE["node_weights"][None], n_bodies, 0),
        position=np.asarray(position, float).reshape(-1, 3)
        + np.arange(n_bodies)[:, None] * np.array([2.0, 0.0, 0.0]),
        nucleation_sites_ref=sites, radius=0.5,
        config_rank=rank0 + np.arange(n_bodies))


def _fibers(nf, n=16, seed=5, bound_sites=(), rank0=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    d = rng.standard_normal((nf, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = rng.uniform(-3, 3, (nf, 1, 3)) + t[None, :, None] * d[:, None]
    bb = np.full(nf, -1)
    bs = np.full(nf, -1)
    for i, s in enumerate(bound_sites):
        bb[i], bs[i] = 0, s
    return jfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                          radius=0.0125, binding_body=bb, binding_site=bs,
                          config_rank=rank0 + np.arange(nf))


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()
            if v is not None}


def _params(**kw):
    di = dict(n_nodes=16, v_growth=0.5, f_catastrophe=1.0,
              nucleation_rate=10.0, min_length=0.4, radius=0.0125,
              bending_rigidity=0.01)
    di.update(kw)
    return JParams(eta=1.0, dt_initial=0.05, t_final=1.0, gmres_tol=1e-8,
                   adaptive_timestep_flag=False,
                   dynamic_instability=JDI(**di))


def _both(jp, fibers=None, bodies=None):
    jstate = JSystem(jp).make_state(fibers=fibers, bodies=bodies)

    def leaves(x, group_type):
        if x is None:
            return None
        if isinstance(x, group_type):
            return _leaves(x)
        return [_leaves(g) for g in x]

    tf = leaves(fibers, jfc.FiberGroup)
    tb = leaves(bodies, jbd.BodyGroup)
    tstate = convert.state_from_numpy(tf, time=0.0, dt=float(jstate.dt),
                                      bodies=tb, device="cpu")
    return jstate, tstate, convert.params_from_dict(dataclasses.asdict(jp))


def _check_group(jg, tg):
    for name in ("active", "length", "length_prev", "binding_body",
                 "binding_site", "config_rank", "minus_clamped", "v_growth",
                 "penalty", "beta_tstep", "bending_rigidity", "radius"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.binding_body.dtype == torch.int32
    assert tg.config_rank.dtype == torch.int32
    np.testing.assert_allclose(tg.x.numpy(), np.asarray(jg.x), rtol=0,
                               atol=1e-14)


def _apply_both(jp, jstate, tstate, tp, seed=3, node_multiple=1, steps=1):
    jr, tr = JRNG(seed), TRNG(seed)
    total = {"catastrophes": 0, "nucleations": 0}
    for _ in range(steps):
        js, ts = {}, {}
        jstate = jdi.apply_dynamic_instability(
            jstate, jp, jr, node_multiple=node_multiple, stats=js)
        tstate = tdi.apply_dynamic_instability(
            tstate, tp, tr, node_multiple=node_multiple, stats=ts)
        assert js == ts
        assert jr.dump_state() == tr.dump_state()
        total = {k: total[k] + v for k, v in ts.items()}
        jb, tb = jfc.as_buckets(jstate.fibers), tfc.as_buckets(tstate.fibers)
        assert len(jb) == len(tb)
        for jg, tg in zip(jb, tb):
            _check_group(jg, tg)
    return jstate, tstate, total


def test_catastrophe_only():
    jp = _params(f_catastrophe=4.0, nucleation_rate=0.0)
    jstate, tstate, tp = _both(jp, fibers=_fibers(40))
    _, tout, stats = _apply_both(jp, jstate, tstate, tp, steps=2)
    assert 0 < stats["catastrophes"] and stats["nucleations"] == 0
    assert 0 < int(tout.fibers.active.sum()) < 40


def test_from_scratch():
    jp = _params(f_catastrophe=0.0, nucleation_rate=100.0)
    jstate, tstate, tp = _both(jp, bodies=_body(12))
    _, tout, stats = _apply_both(jp, jstate, tstate, tp)
    n = stats["nucleations"]
    assert n > 0 and tout.fibers.n_fibers == tdi.buckets.next_fiber_capacity(n)


def test_fill_inactive_slots():
    jp = _params(f_catastrophe=0.0, nucleation_rate=400.0)
    g = _fibers(8, bound_sites=(0, 1))
    g = g._replace(active=jnp.asarray(np.arange(8) < 4))
    jstate, tstate, tp = _both(jp, fibers=g, bodies=_body(5))
    _, tout, stats = _apply_both(jp, jstate, tstate, tp)
    assert stats["nucleations"] == 3 and tout.fibers.n_fibers == 8


def test_capacity_growth_node_multiple_4():
    jp = _params(f_catastrophe=1.0, nucleation_rate=400.0)
    jstate, tstate, tp = _both(jp, fibers=_fibers(3, bound_sites=(2,)),
                               bodies=_body(12))
    _, tout, stats = _apply_both(jp, jstate, tstate, tp, node_multiple=4,
                                 steps=3)
    assert tout.fibers.n_fibers == 16
    assert tout.fibers.n_fibers * tout.fibers.n_nodes % 4 == 0


def test_two_buckets():
    jp = _params(f_catastrophe=2.0, nucleation_rate=200.0)
    g16 = _fibers(4, bound_sites=(0, 1))
    g8 = _fibers(3, n=8, seed=9, rank0=4)._replace(
        binding_body=jnp.asarray([0, -1, -1], jnp.int32),
        binding_site=jnp.asarray([2, -1, -1], jnp.int32))
    jstate, tstate, tp = _both(jp, fibers=(g8, g16), bodies=_body(10))
    _, tout, stats = _apply_both(jp, jstate, tstate, tp, steps=2)
    assert stats["nucleations"] > 0
    bb = torch.cat([g.binding_body[g.active] for g in tout.fibers])
    bs = torch.cat([g.binding_site[g.active] for g in tout.fibers])
    pairs = [(int(b), int(s)) for b, s in zip(bb, bs) if b >= 0]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("fibers,match", [
    ((_fibers(2, n=8),), "matches no fiber bucket"),
    (_fibers(2, n=8), "must match the fiber group"),
])
def test_unmatched_resolution_raises(fibers, match):
    jp = _params()
    jstate, tstate, tp = _both(jp, fibers=fibers, bodies=_body(4))
    for apply, state, p, rng in (
            (jdi.apply_dynamic_instability, jstate, jp, JRNG(1)),
            (tdi.apply_dynamic_instability, tstate, tp, TRNG(1))):
        with pytest.raises(NotImplementedError, match=match):
            apply(state, p, rng)


def test_host_site_table_order():
    """Two body buckets (a pair of spheres, then one more at global id 2),
    rotated: the same (id, site, origin, com) rows in the same order."""
    b2 = _body(6, n_bodies=2)
    b1 = _body(4, position=(0.0, 3.0, 0.0), rank0=2)
    q = np.array([0.9, 0.1, -0.3, 0.2])
    b2 = b2._replace(orientation=jnp.asarray(
        np.tile(q / np.linalg.norm(q), (2, 1))))
    _, tstate, _ = _both(_params(), bodies=(b2, b1))
    jt = jdi.host_site_table((b2, b1))
    tt = tdi.host_site_table(tstate.bodies)
    assert [r[:2] for r in jt] == [r[:2] for r in tt]
    assert len(jt) == 16
    for (_, _, jo, jc), (_, _, to, tc) in zip(jt, tt):
        np.testing.assert_allclose(to, np.asarray(jo), rtol=0, atol=1e-14)
        np.testing.assert_array_equal(tc, np.asarray(jc))


def test_capacity_growth_padding_is_finite_in_flow():
    """Padded slots replicate slot 0, so neither the fiber caches nor the
    flow of a grown group see a NaN (the JAX package's regression)."""
    x = np.tile(np.linspace(0, 1, 16)[None, :, None], (2, 1, 3)) \
        + np.array([[[1.0, 0, 0]], [[-1.0, 0, 0]]])
    fibers = tfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125)
    grown = tfc.grow_capacity(fibers, 5)
    assert grown.n_fibers == 5 and int(grown.active.sum()) == 2
    caches = tfc.update_cache(grown, dt=0.01, eta=1.0)
    for leaf in caches:
        if leaf is not None:
            assert torch.isfinite(leaf).all(), "NaN in fiber cache"
    r_trg = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, (7, 3)))
    forces = torch.zeros_like(grown.x)
    u = tfc.flow_multi((grown,), (caches,), r_trg, (forces,), eta=1.0,
                       subtract_self=False)
    assert torch.isfinite(u).all()


def _run_scene(steps=4):
    jp = JParams(eta=1.0, dt_initial=0.05, dt_write=0.05, t_final=1.0,
                 gmres_tol=1e-10, adaptive_timestep_flag=False,
                 dynamic_instability=JDI(
                     n_nodes=16, v_growth=0.2, f_catastrophe=0.5,
                     nucleation_rate=50.0, min_length=0.4, radius=0.0125,
                     bending_rigidity=0.01))
    return jp, _body(12)


def test_system_run_matches_jax(tmp_path):
    jp, body = _run_scene()
    jsys = JSystem(jp)
    jstate, tstate, tp = _both(jp, bodies=body)
    tsys = System(tp, device="cpu")
    frames = {"jax": [], "port": []}

    def writer(key):
        def w(state, solution=None, *, rng_state=None):
            frames[key].append((state, rng_state))
        return w

    jsys.run(jstate, writer=writer("jax"), rng=JRNG(3), max_steps=4,
             metrics_path=str(tmp_path / "jax.jsonl"))
    tsys.run(tstate, writer=writer("port"), rng=TRNG(3), max_steps=4,
             metrics_path=str(tmp_path / "port.jsonl"))
    import json

    jm = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    tm = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    assert len(jm) == len(tm) == 4
    assert sum(m["nucleations"] for m in tm) > 0
    for a, b in zip(jm, tm):
        for key in ("nucleations", "catastrophes", "active_fibers", "iters",
                    "accepted"):
            assert a[key] == b[key], (key, a, b)
    assert len(frames["jax"]) == len(frames["port"]) == 4
    for (js, jr), (ts, tr) in zip(frames["jax"], frames["port"]):
        assert jr == tr
        ja = np.asarray(js.fibers.active)
        ta = ts.fibers.active.numpy()
        np.testing.assert_array_equal(ta, ja)
        for name in ("binding_body", "binding_site", "config_rank"):
            np.testing.assert_array_equal(
                getattr(ts.fibers, name).numpy()[ta],
                np.asarray(getattr(js.fibers, name))[ja])
        np.testing.assert_allclose(ts.fibers.x.numpy()[ta],
                                   np.asarray(js.fibers.x)[ja], rtol=0,
                                   atol=1e-10)
