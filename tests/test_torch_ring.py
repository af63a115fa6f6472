"""The port's ring pair evaluator against the JAX package's.

Port meshes are ``make_mesh(n, device="cpu")``: n shards in one process on
the CPU, the single-controller model of the JAX tests, whose meshes are
conftest's 8 virtual CPU devices (`skellysim_tpu.parallel.make_mesh`). The
same seeded numpy inputs go through both packages. On the CPU the fused
ring kernels E / F run their plain version (the ring accumulation over
kernel A's / C's plain block); their kernels are held against it on the
card in `tests/test_torch_gpu.py`.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.parallel import make_mesh as jmake_mesh
from skellysim_tpu.parallel import ring as jring
from skellysim_tpu.parallel import shard_state, use_mesh
from skellysim_tpu.system import BackgroundFlow as JBackground
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.ops import cuda_kernels as ck
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.parallel import make_mesh, ring
from skellysim_tpu_torch.parallel.compat import fused_ring_mode
from skellysim_tpu_torch.parallel.ring import _ring_accumulate
from skellysim_tpu_torch.system import System

GATE = 1e-12  # f64 ring sums: the same pairs in another order


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cloud(n_src, n_trg, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n_src, 3)).astype(dtype),
            rng.uniform(-1, 1, (n_trg, 3)).astype(dtype),
            rng.standard_normal((n_src, 3)).astype(dtype),
            rng.standard_normal((n_src, 3, 3)).astype(dtype))


def _payload(family, f, S):
    return f if family == "stokeslet" else S


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_ring_sums_match_jax(family, n_dev):
    """`ring_stokeslet` / `ring_stresslet` with impl "exact" in f64 on 4-
    and 8-shard meshes against the JAX ring: the same pair sums in the same
    ring order, to 1e-12."""
    src, trg, f, S = _cloud(8 * 12, 8 * 5, seed=3)
    pay = _payload(family, f, S)
    jfn = getattr(jring, f"ring_{family}")
    ref = jfn(jnp.asarray(src), jnp.asarray(trg), jnp.asarray(pay), 1.7,
              mesh=jmake_mesh(n_dev))
    got = getattr(ring, f"ring_{family}")(_t(src), _t(trg), _t(pay), 1.7,
                                           mesh=make_mesh(n_dev, device="cpu"))
    assert got.dtype == torch.float64
    assert _rel(got, ref) < GATE


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_df_rings_match_jax(family):
    """The f64-grade rings (one kernel B / D block a hop; the plain f64
    version here) against the JAX double-float rings (impl "df"), float64
    out, to 1e-12, and the port's own "df" tile (double-float a hop)."""
    src, _, f, S = _cloud(8 * 4, 0, seed=47)
    pay = _payload(family, f, S)
    ref = getattr(jring, f"ring_{family}_df")(
        jnp.asarray(src), jnp.asarray(src), jnp.asarray(pay), 1.3,
        mesh=jmake_mesh(8))
    port = getattr(ring, f"ring_{family}_df")
    mesh = make_mesh(8, device="cpu")
    got = port(_t(src).float(), _t(src), _t(pay), 1.3, mesh=mesh)
    assert got.dtype == torch.float64
    ref_f32_src = getattr(ring, f"ring_{family}")(
        _t(src).float().double(), _t(src), _t(pay), 1.3, mesh=mesh)
    assert _rel(got, ref_f32_src) < GATE  # f32 inputs widen exactly
    got = port(_t(src), _t(src), _t(pay), 1.3, mesh=mesh)
    assert _rel(got, ref) < GATE
    # the double-float tile a hop, the JAX package's own default
    got = port(_t(src), _t(src), _t(pay), 1.3, mesh=mesh, impl="df")
    assert got.dtype == torch.float64 and _rel(got, ref) < GATE


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_fused_ring_plain_matches_jax_pallas_ring(family):
    """The f32 ring under impl "pallas" — on the CPU the fused kernel's
    plain version (`ring_*_f32`), shard by shard — against the JAX ring
    with impl "pallas" (the ppermute ring over the Pallas tile in interpret
    mode: jax cannot trace the fused Pallas ring on the CPU). JAX's own
    gate, 1e-5 of the norm (tests/test_ring_kernels.py)."""
    rng = np.random.default_rng(43)
    n = 8 * 8
    r = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    pay = (rng.standard_normal((n, 3)) if family == "stokeslet"
           else rng.standard_normal((n, 3, 3))).astype(np.float32)
    jmesh, mesh = jmake_mesh(8), make_mesh(8, device="cpu")
    ref = np.asarray(getattr(jring, f"ring_{family}")(
        jnp.asarray(r), jnp.asarray(r), jnp.asarray(pay), 1.2, mesh=jmesh,
        impl="pallas"))

    def rel_norm(u):
        return float(np.linalg.norm(np.asarray(u, dtype=np.float64) - ref)
                     / np.linalg.norm(ref))

    got = getattr(ring, f"ring_{family}")(_t(r), _t(r), _t(pay), 1.2,
                                           mesh=mesh, impl="pallas")
    assert got.dtype == torch.float32 and rel_norm(got) < 1e-5
    # the kernel's own entry on per-shard lists: unscaled, launches counted
    # only on the card
    wrapper = getattr(ck, f"ring_{family}_f32")
    n0 = wrapper.launches
    blocks = [b.contiguous() for b in _t(r).split(8)]
    pays = list(_t(pay).reshape(n, -1).split(8))
    out = wrapper(blocks, blocks, pays)
    assert wrapper.launches == n0 and len(out) == 8
    assert rel_norm(torch.cat(out) / (8 * math.pi * 1.2)) < 1e-5


def test_coincident_points_across_shards_stay_finite():
    """Points that coincide with points of other shards (and with
    themselves) drop their r = 0 pairs in every ring: exact f64 (against
    the JAX ring to 1e-12), the f32 fused-ring plain version and the
    f64-grade ring all stay finite."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (16, 3))
    pts = np.concatenate([pts, pts[::-1]])      # i and 31 - i coincide
    f = rng.standard_normal((32, 3))
    S = rng.standard_normal((32, 3, 3))
    mesh = make_mesh(4, device="cpu")
    ref = jring.ring_stokeslet(jnp.asarray(pts), jnp.asarray(pts),
                               jnp.asarray(f), 1.0, mesh=jmake_mesh(4))
    got = ring.ring_stokeslet(_t(pts), _t(pts), _t(f), 1.0, mesh=mesh)
    assert torch.isfinite(got).all() and _rel(got, ref) < GATE
    for u in (ring.ring_stokeslet(_t(pts).float(), _t(pts).float(),
                                  _t(f).float(), 1.0, mesh=mesh,
                                  impl="pallas"),
              ring.ring_stresslet(_t(pts).float(), _t(pts).float(),
                                  _t(S).float(), 1.0, mesh=mesh,
                                  impl="pallas"),
              ring.ring_stresslet_df(_t(pts), _t(pts), _t(S), 1.0,
                                     mesh=mesh)):
        assert torch.isfinite(u).all()
    assert _rel(ring.ring_stokeslet(_t(pts).float(), _t(pts).float(),
                                    _t(f).float(), 1.0, mesh=mesh,
                                    impl="pallas"), ref) < 1e-5


def test_ring_accumulation_order():
    """Shard k adds its own block first, then its left neighbour's, and so
    on (the JAX ring's perm [(j, j + 1 mod n)]), in n - 1 hops."""
    n = 5
    seen = [[] for _ in range(n)]

    def block(k, blk):
        seen[k].append(int(blk[0]))
        return blk

    u = _ring_accumulate(block, [torch.device("cpu")] * n,
                         [torch.zeros(1) for _ in range(n)],
                         [torch.tensor([float(k)]) for k in range(n)])
    assert seen == [[(k - j) % n for j in range(n)] for k in range(n)]
    assert [float(x) for x in u] == [float(sum(range(n)))] * n


def test_fused_ring_mode_and_mesh(monkeypatch):
    """The fused kernel serves impl "pallas" on CUDA tensors only;
    SKELLY_FUSED_RING=0 opts out; a CPU mesh holds n shards on one device;
    a mesh of cards needs a card; the system refuses a mesh on another
    device type."""
    cuda = torch.device("cuda", 0)
    assert fused_ring_mode("pallas", cuda) == "fused"
    assert fused_ring_mode("exact", cuda) == "ppermute"
    assert fused_ring_mode("pallas", torch.device("cpu")) == "ppermute"
    monkeypatch.setenv("SKELLY_FUSED_RING", "0")
    assert fused_ring_mode("pallas", cuda) == "ppermute"
    mesh = make_mesh(3, device="cpu")
    assert mesh.size == 3
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)
    else:
        with pytest.raises(ValueError, match="visible"):
            make_mesh(torch.cuda.device_count() + 1)
        with pytest.raises(ValueError, match="shards lie on"):
            System(Params(pair_evaluator="ring"), device="cuda", mesh=mesh)


def _fiber_x(n_fibers, n_nodes, seed, spread):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n_nodes)
    origins = rng.uniform(-spread, spread, size=(n_fibers, 3))
    dirs = rng.normal(size=(n_fibers, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins[:, None, :] + t[None, :, None] * dirs[:, None, :]


def _leaves(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


def _port_ring_step(jsys, jstate, n_dev, shape=None):
    from skellysim_tpu_torch.periphery import periphery as tperi

    tsys = System(convert.params_from_dict(dataclasses.asdict(jsys.params)),
                  shell_shape=(None if shape is None else tperi.PeripheryShape(
                      **dataclasses.asdict(shape))),
                  device="cpu", mesh=make_mesh(n_dev, device="cpu"))
    bg = jstate.background
    tstate = convert.state_from_numpy(
        _leaves(jstate.fibers), time=float(jstate.time), dt=float(jstate.dt),
        background=None if bg is None else _leaves(bg),
        shell=None if jstate.shell is None else _leaves(jstate.shell),
        device="cpu")
    return tsys.step(tstate)


RING_PARAMS = dict(eta=1.0, dt_initial=1e-3, t_final=1e-2, gmres_tol=1e-10,
                   adaptive_timestep_flag=False, pair_evaluator="ring")


@pytest.fixture(scope="module")
def free_fiber_steps():
    """tests/test_ring_solve.py's scene (16 fibers x 16 nodes in a uniform
    background flow) stepped by the JAX ring on 8 devices and by the port's
    ring on 8 CPU shards."""
    jmesh = jmake_mesh(8)
    jsys = JSystem(JParams(**RING_PARAMS), mesh=jmesh)
    fibers = jfc.make_group(_fiber_x(16, 16, 5, 4.0), lengths=1.0,
                            bending_rigidity=0.01, radius=0.0125,
                            dtype=jnp.float64)
    jstate = jsys.make_state(fibers=fibers, background=JBackground.make(
        uniform=(1.0, 0.0, 0.0), dtype=jnp.float64))
    with use_mesh(jmesh):
        jout = jsys.step(shard_state(jstate, jmesh))
        jax.block_until_ready(jout[0])
    return jout, _port_ring_step(jsys, jstate, 8)


def test_ring_free_fiber_step_matches_jax(free_fiber_steps):
    """The ring free-fiber step against JAX's, at test_ring_solve.py's
    tolerances: fiber nodes 5e-11, solution 5e-9."""
    (jnew, jsol, jinfo), (tnew, tsol, tinfo) = free_fiber_steps
    assert tinfo.converged and bool(jinfo.converged)
    np.testing.assert_allclose(tnew.fibers.x.numpy(), np.asarray(jnew.fibers.x),
                               rtol=0, atol=5e-11)
    np.testing.assert_allclose(tsol.numpy(), np.asarray(jsol), rtol=0,
                               atol=5e-9)


def test_ring_confined_step_matches_jax():
    """A confined ring step — a 150-node sphere shell (not divisible by the
    4-shard mesh: the shell's sources pad with far zero-density nodes) and
    8 fibers x 16 nodes — against JAX's ring step: solution to 1e-9 of its
    largest entry, fiber nodes to 1e-10."""
    from skellysim_tpu.testing import make_coupled_parts

    jmesh = jmake_mesh(4)
    shell, shape, _ = make_coupled_parts(150, 77, jnp.float64, radius=3.0)
    fibers = jfc.make_group(_fiber_x(8, 16, 7, 1.5), lengths=1.0,
                            bending_rigidity=0.01, radius=0.0125,
                            dtype=jnp.float64)
    jsys = JSystem(JParams(**RING_PARAMS), shell_shape=shape, mesh=jmesh)
    jstate = jsys.make_state(fibers=fibers, shell=shell)
    with use_mesh(jmesh):
        jnew, jsol, jinfo = jsys.step(
            shard_state(jstate, jmesh, allow_replicated_shell=True))
        jax.block_until_ready(jnew)
    tnew, tsol, tinfo = _port_ring_step(jsys, jstate, 4, shape)
    assert tinfo.converged and bool(jinfo.converged)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-9 * np.abs(jsol).max())
    np.testing.assert_allclose(tnew.fibers.x.numpy(), np.asarray(jnew.fibers.x),
                               rtol=0, atol=1e-10)


def _three_fiber_config():
    from skellysim_tpu_torch.config import Config, Fiber

    cfg = Config()
    cfg.params.dt_initial = 0.01
    cfg.params.t_final = 0.02
    cfg.params.adaptive_timestep_flag = False
    cfg.params.pair_evaluator = "ring"
    for i in range(3):
        f = Fiber(n_nodes=16, length=1.0, bending_rigidity=0.01)
        f.fill_node_positions(np.array([2.0 * i, 0.0, 0.0]),
                              np.array([0.0, 0.0, 1.0]))
        cfg.fibers.append(f)
    return cfg


def test_build_simulation_pads_for_the_ring_mesh():
    """build_simulation pads a 48-node batch (3 fibers x 16) on a 5-shard
    mesh with inert fibers to the JAX package's padded count, and the
    padded state solves; without a mesh it warns, as JAX does, and builds
    the unpadded direct run."""
    from skellysim_tpu_torch import builder

    system, state, _ = builder.build_simulation(
        _three_fiber_config(), device="cpu", mesh=make_mesh(5, device="cpu"))
    g = state.fibers
    assert (g.n_fibers * g.n_nodes) % 5 == 0 and g.n_fibers == 5
    assert g.active.tolist() == [True] * 3 + [False] * 2
    assert g.binding_body.tolist()[3:] == [-1, -1]
    torch.testing.assert_close(g.x[3], g.x[0])  # pads replicate slot 0
    _, _, info = system.step(state)
    assert info.converged
    with pytest.warns(UserWarning, match="no mesh was given"):
        _, state, _ = builder.build_simulation(_three_fiber_config(),
                                               device="cpu")
    assert state.fibers.n_fibers == 3


def test_ring_indivisible_fiber_nodes_raises():
    """A fiber-node count the mesh does not divide fails with an
    actionable message (24 nodes on a 5-shard mesh), as in JAX."""
    system = System(Params(**RING_PARAMS), device="cpu",
                    mesh=make_mesh(5, device="cpu"))
    g = tfc.make_group(_fiber_x(3, 8, 1, 1.0), lengths=1.0,
                       bending_rigidity=0.01, radius=0.0125)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        system.step(system.make_state(fibers=g))


def test_padded_groups_convert_from_jax():
    """A JAX group padded for a 5-shard mesh (`grow_capacity` with
    node_multiple) converts with its active mask and unbound pads, and
    equals the port's own padding of the same group."""
    x = _fiber_x(3, 16, 2, 1.0)
    jg = jfc.grow_capacity(jfc.make_group(x, lengths=1.0,
                                          bending_rigidity=0.01,
                                          radius=0.0125, dtype=jnp.float64),
                           3, node_multiple=5)
    tg = convert.group_from_numpy(_leaves(jg), device="cpu")
    own = tfc.grow_capacity(tfc.make_group(x, lengths=1.0,
                                           bending_rigidity=0.01,
                                           radius=0.0125), 3, node_multiple=5)
    assert tg.n_fibers == own.n_fibers == 5
    for name, a in tg._asdict().items():
        b = getattr(own, name)
        if a is None:  # runtime node matrices: neither group carries them
            assert b is None, name
            continue
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def test_ring_without_mesh_warns_and_runs_direct():
    """pair_evaluator='ring' with no mesh warns and takes the direct path:
    the step equals the direct evaluator's bit for bit."""
    g = tfc.make_group(_fiber_x(4, 16, 9, 1.0), lengths=1.0,
                       bending_rigidity=0.01, radius=0.0125)
    ring_sys = System(Params(**RING_PARAMS), device="cpu")
    with pytest.warns(UserWarning, match="falls back to 'direct'"):
        _, sol_ring, _ = ring_sys.step(ring_sys.make_state(fibers=g))
    direct = System(Params(**{**RING_PARAMS, "pair_evaluator": "direct"}),
                    device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, sol, _ = direct.step(direct.make_state(fibers=g))
    assert torch.equal(sol, sol_ring)
