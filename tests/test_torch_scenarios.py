"""The port's device dynamic instability and scenario sweep against the
JAX package's.

`sample_draws` gives `jax.random`'s draws bit for bit from a member's
stream carry; `di_update` on the same state and carry gives the JAX
update's flips and counts exactly (masks, bindings, ranks, lengths) and its
nucleated positions to 1e-14 (torch's and XLA's linspace and normalisation
round apart), on nucleation into free slots, on a catastrophe-only scene
and on a capacity overflow (the update aborts, state untouched). On
`scenarios/smoke.py`'s confined scene (solved to 1e-12) `ScenarioEnsemble`
finishes the same members with the same nucleations, catastrophes, reseats
and rungs, final states within 1e-8 (the scene amplifies roundoff: the JAX
package's own "vmap" and "unroll" plans end 4.5e-9 apart on it); and `python -m skellysim_tpu_torch.scenarios.smoke` exits 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.bodies import bodies as jbd
from skellysim_tpu.ensemble.scheduler import MemberSpec as JMember
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import DynamicInstability as JDI
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.periphery.precompute import (precompute_body,
                                                precompute_periphery)
from skellysim_tpu.scenarios import ScenarioEnsemble as JScenario
from skellysim_tpu.scenarios import di_device as jdd
from skellysim_tpu.system import System as JSystem
from skellysim_tpu.utils.rng import SimRNG as JRNG
from skellysim_tpu_torch.ensemble.scheduler import MemberSpec as TMember
from skellysim_tpu_torch.scenarios import ScenarioEnsemble as TScenario
from skellysim_tpu_torch.scenarios import di_device as tdd
from skellysim_tpu_torch.utils.rng import SimRNG as TRNG
from torch_jax_state import port_state, port_system


def _params(**di):
    kw = dict(n_nodes=8, v_growth=0.2, f_catastrophe=0.5,
              nucleation_rate=60.0, min_length=0.4, radius=0.0125,
              bending_rigidity=0.01)
    kw.update(di)
    return JParams(eta=1.0, dt_initial=0.02, dt_write=0.02, t_final=0.08,
                   gmres_tol=1e-10, adaptive_timestep_flag=False,
                   dynamic_instability=JDI(**kw))


@pytest.fixture(scope="module")
def body():
    pre = precompute_body("sphere", 40, radius=0.5)
    s = np.random.default_rng(11).standard_normal((6, 3))
    s = 0.5 * s / np.linalg.norm(s, axis=1, keepdims=True)
    return jbd.make_group(pre["node_positions_ref"], pre["node_normals_ref"],
                          pre["node_weights"], nucleation_sites_ref=s[None],
                          radius=0.5)


def _fibers(capacity, n_active, bound_site=None):
    x = np.tile(np.linspace(0.0, 1.0, 8)[None, :, None], (n_active, 1, 3))
    x += (1.5 + np.arange(n_active))[:, None, None]
    g = jfc.make_group(x, lengths=1.0, bending_rigidity=0.01, radius=0.0125)
    g = jfc.grow_capacity(g, capacity)
    if bound_site is not None:
        bb = np.asarray(g.binding_body).copy()
        bs = np.asarray(g.binding_site).copy()
        bb[0], bs[0] = 0, bound_site
        g = g._replace(binding_body=bb, binding_site=bs)
    return type(g)(*[jnp.asarray(v) if v is not None and n != "rt_mats"
                     else v for n, v in zip(g._fields, g)])


@pytest.mark.parametrize("counter", [0, 3, 27])
def test_sample_draws_bit_for_bit(counter):
    """u_cat, the Poisson count and the site priorities of one round equal
    `jax.random`'s (exact), from the member's (seed, stream id, counter)."""
    carry = [5, 7, counter]
    for lam in (0.0, 2.5, 37.0):
        j = jdd.sample_draws(jnp.asarray(carry, jnp.int32), jnp.float64(lam),
                             12, 6, jnp.float64)
        t = tdd.sample_draws(carry, lam, 12, 6)
        np.testing.assert_array_equal(t.u_cat, np.asarray(j.u_cat))
        np.testing.assert_array_equal(t.u_site, np.asarray(j.u_site))
        assert t.n_raw == int(j.n_raw)


_CASES = {
    # nucleation into free slots, one site occupied
    "nucleate": dict(capacity=8, n_active=3, bound=0, bodies=True, di={}),
    # a burst larger than the free slots: the update aborts
    "overflow": dict(capacity=3, n_active=2, bound=None, bodies=True,
                     di=dict(nucleation_rate=600.0, f_catastrophe=0.0)),
    # no nucleation sites: catastrophe and growth only
    "catastrophe": dict(capacity=6, n_active=5, bound=None, bodies=False,
                        di=dict(f_catastrophe=20.0)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_di_update_matches_jax(body, case):
    """One device DI update from the same state and stream carry: the same
    flips, bindings, config ranks, lengths and counts (exact), positions to
    1e-14, and on overflow ``needs_growth`` with the state unchanged."""
    c = _CASES[case]
    params = _params(**c["di"])
    jsys = JSystem(params)
    jstate = jsys.make_state(
        fibers=_fibers(c["capacity"], c["n_active"], c["bound"]),
        bodies=body if c["bodies"] else None)
    carry = [17, 5, 6]
    jnew, jinfo = jax.jit(lambda st, r: jdd.di_update(st, params, r))(
        jstate, jnp.asarray(carry, jnp.int32))
    tstate = port_state(jstate)
    tparams = port_system(jsys).params
    tnew, tinfo = tdd.di_update(tstate, tparams, carry)
    assert (tinfo.nucleations, tinfo.catastrophes, tinfo.active_fibers,
            tinfo.needs_growth) == (int(jinfo.nucleations),
                                    int(jinfo.catastrophes),
                                    int(jinfo.active_fibers),
                                    bool(jinfo.needs_growth))
    jf, tf = jnew.fibers, tnew.fibers
    for k in ("active", "binding_body", "binding_site", "config_rank",
              "minus_clamped", "plus_pinned", "length", "length_prev",
              "v_growth", "bending_rigidity", "radius", "tension"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf, k)), err_msg=k)
    np.testing.assert_allclose(tf.x.numpy(), np.asarray(jf.x), rtol=0,
                               atol=1e-14)
    if case == "overflow":
        assert tinfo.needs_growth and tnew is tstate
    if case == "nucleate":
        assert tinfo.nucleations > 0
    if case == "catastrophe":
        assert tinfo.catastrophes > 0 and tinfo.nucleations == 0


def _smoke_scene():
    """`scenarios/smoke.py`'s scene in the JAX package, solved to
    gmres_tol 1e-12 (the smoke's 1e-8 would bound the two packages'
    agreement at ~1e-8)."""
    params = JParams(
        eta=1.0, dt_initial=0.02, dt_write=0.02, t_final=0.08,
        gmres_tol=1e-12, adaptive_timestep_flag=False,
        dynamic_instability=JDI(
            n_nodes=8, v_growth=0.2, f_catastrophe=0.1,
            nucleation_rate=100.0, min_length=0.3, radius=0.0125,
            bending_rigidity=0.01))
    pdata = precompute_periphery("sphere", n_nodes=60, radius=2.5, eta=1.0)
    shell = jperi.make_state(pdata["nodes"], pdata["normals"],
                             pdata["quadrature_weights"],
                             pdata["stresslet_plus_complementary"],
                             pdata["M_inv"], dtype=jnp.float64)
    shape = jperi.PeripheryShape(kind="sphere", radius=2.5)
    bdata = precompute_body("sphere", 40, radius=0.4)
    rng = np.random.default_rng(3)
    sites = rng.standard_normal((2, 3))
    sites = 0.4 * sites / np.linalg.norm(sites, axis=1, keepdims=True)
    bodies = jbd.make_group(bdata["node_positions_ref"],
                            bdata["node_normals_ref"], bdata["node_weights"],
                            nucleation_sites_ref=sites[None], radius=0.4)
    jsys = JSystem(params, shell_shape=shape)
    states = []
    for i in range(2):
        x = np.tile(np.linspace(0.0, 0.8, 8)[None, :, None], (2, 1, 3))
        x += 0.6 + 0.1 * i
        fibers = jfc.make_group(x, lengths=0.8 * np.sqrt(3.0),
                                bending_rigidity=0.01, radius=0.0125)
        states.append(jsys.make_state(fibers=fibers, bodies=bodies,
                                      shell=shell))
    return jsys, states


def _drain(make_scenario, member_cls, rng_cls, states, system, t_final):
    finals, records = {}, []

    def on_retire(mid, state, reason, **kw):
        finals[mid] = state

    se = make_scenario(system, [member_cls(member_id=f"m{i}", state=s,
                                           t_final=t_final,
                                           rng=rng_cls(17).member(i))
                                for i, s in enumerate(states)],
                       batch=2, metrics=records.append, on_retire=on_retire)
    finished = se.run(max_rounds=60)
    return se, finished, finals, records


def test_scenario_ensemble_matches_jax():
    """`scenarios/smoke.py`'s scene through both packages'
    `ScenarioEnsemble` ("vmap"): the same finished members, nucleations,
    catastrophes, live counts, acceptances, reseats and rungs, record for
    record, and final fiber positions and body placement within 1e-8, the
    shell density within 1e-8 of its largest entry. (GMRES iterations are not compared: member m0's second
    round takes 19 to 22 iterations across the two packages' plans, the
    JAX package's own vmap and unroll included, and their final positions
    spread by 4.5e-9.)"""
    jsys, jstates = _smoke_scene()
    tsys = port_system(jsys)
    tstates = [port_state(s) for s in jstates]
    t_final = jsys.params.t_final
    jse, jfin, jfinals, jrec = _drain(JScenario, JMember, JRNG, jstates,
                                      jsys, t_final)
    tse, tfin, tfinals, trec = _drain(TScenario, TMember, TRNG, tstates,
                                      tsys, t_final)
    assert tfin == jfin == ["m0", "m1"]
    assert (tse.reseats, sorted(tse._scheds)) == (jse.reseats,
                                                  sorted(jse._scheds))
    keys = ("event", "member", "lane", "nucleations", "catastrophes",
            "active_fibers", "accepted", "capacity")

    def pick(recs):
        return [{k: r[k] for k in keys if k in r} for r in recs]

    assert pick(trec) == pick(jrec)
    for mid in ("m0", "m1"):
        j, t = jfinals[mid], tfinals[mid]
        np.testing.assert_array_equal(t.fibers.active.numpy(),
                                      np.asarray(j.fibers.active))
        np.testing.assert_allclose(t.fibers.x.numpy(), np.asarray(j.fibers.x),
                                   rtol=0, atol=1e-8)
        jd = np.asarray(j.shell.density)
        np.testing.assert_allclose(t.shell.density.numpy(), jd, rtol=0,
                                   atol=1e-8 * np.abs(jd).max())
        np.testing.assert_allclose(t.bodies.position.numpy(),
                                   np.asarray(j.bodies.position), rtol=0,
                                   atol=1e-8)
        assert float(t.time) == pytest.approx(float(j.time), abs=1e-15)


def test_port_scenario_smoke_exits_zero(capsys):
    """`python -m skellysim_tpu_torch.scenarios.smoke` (its `main`) exits
    0 and reports the reseats."""
    from skellysim_tpu_torch.scenarios import smoke

    assert smoke.main() == 0
    assert "growth reseat(s)" in capsys.readouterr().out
