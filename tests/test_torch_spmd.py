"""The port's sharded step (`System.step_spmd`, `parallel.spmd`) on CPU
meshes of shards.

Port meshes are ``make_mesh(n, device="cpu")``: n shards in one process.
The step is held against the port's own `System.step` at the reference's
backend-agreement gate (5e-9, `kernel_test.cpp:93`), and the coupled step
against the JAX package's `step_spmd` on conftest's 8 virtual CPU devices
at 1e-10. The in-mesh seams (`ring_flow_local`, `flow_multi_local`,
`flow_local`) are held against the JAX functions inside a `shard_map`,
`ring_oseen_contract` against the JAX ring, and the solver's ``rdot`` seam
against its default. Replicated rows (bodies, a replicated shell) must be
the same bits on every shard: this stands in for the JAX package's
replication audit, which has no counterpart in eager torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.parallel import make_mesh as jmake_mesh
from skellysim_tpu.parallel import ring as jring
from skellysim_tpu.parallel import shard_state as jshard_state
from skellysim_tpu.parallel.compat import shard_map
from skellysim_tpu.periphery import periphery as jperi
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch.bodies import bodies as tbd
from skellysim_tpu_torch.fibers import container as tfc
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.parallel import (Collectives, ShardVec,
                                          build_spmd_step, gather_state,
                                          make_mesh, ring, shard_state,
                                          spmd_shell_mode, spmd_step)
from skellysim_tpu_torch.parallel.mesh import _rows
from skellysim_tpu_torch.parallel.spmd import _make_rdot
from skellysim_tpu_torch.periphery import periphery as tperi
from skellysim_tpu_torch.solver.gmres import gmres, gmres_ir
from skellysim_tpu_torch.system import BackgroundFlow, System
from skellysim_tpu_torch.testing import make_coupled_parts

#: the reference's backend-agreement gate (`kernel_test.cpp:93`)
GATE = 5e-9

PARAMS = dict(eta=1.0, dt_initial=1e-3, t_final=1e-2, gmres_tol=1e-10,
              adaptive_timestep_flag=False)
SHAPE = tperi.PeripheryShape(kind="sphere", radius=6.0)


def _arcs(n_fibers=16, n_nodes=16, seed=5, box=4.0, curvature=0.5):
    """Circular arcs of unit length: curved, so that their pair flows
    couple the solve (straight fibers in a uniform flow leave it
    uncoupled)."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-box, box, (n_fibers, 3))
    dirs = rng.normal(size=(n_fibers, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    perp = np.cross(dirs, rng.normal(size=(n_fibers, 3)))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    t = np.linspace(0.0, 1.0, n_nodes)[None, :, None]
    R = 1.0 / curvature
    return (origins[:, None, :] + R * np.sin(t / R) * dirs[:, None, :]
            + R * (1.0 - np.cos(t / R)) * perp[:, None, :])


def _fibers(**kw):
    return tfc.make_group(_arcs(**kw), lengths=1.0, bending_rigidity=0.01,
                          radius=0.0125, force_scale=-0.05)


def _free_state(system):
    return system.make_state(
        fibers=_fibers(),
        background=BackgroundFlow.make(uniform=(1.0, 0.0, 0.0),
                                       dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def coupled_parts():
    # 56 shell nodes split node-aligned over 2 and 4 shards: the
    # row-sharded shell is under test, not the replicated fallback
    return make_coupled_parts(56, 50)


def _coupled_state(system, parts):
    shell, _, bodies = parts
    return system.make_state(fibers=_fibers(seed=7, box=2.0), shell=shell,
                             bodies=bodies)


def _max(a, b) -> float:
    return float((a - b).abs().max())


def _same_rows_on_every_shard(sharded):
    """The replicated fields of every shard equal shard 0's bit for bit."""
    first = sharded.shards[0]
    for st in sharded.shards[1:]:
        if first.bodies is not None:
            for f in first.bodies._fields:
                a, b = getattr(first.bodies, f), getattr(st.bodies, f)
                assert a is None or torch.equal(a, b), f
        if sharded.shell_mode == "replicated":
            assert torch.equal(first.shell.density, st.shell.density)
        assert (st.time, st.dt) == (first.time, first.dt)


def _step_pair(system, state, n, **kw):
    """(System.step, System.step_spmd on n shards) from ``state``."""
    ref = system.step(state)
    mesh = make_mesh(n, device="cpu")
    sp = system.step_spmd(shard_state(state, mesh, **kw), mesh, **kw)
    return ref, sp


def _assert_parity(ref, sp):
    (s_ref, sol_ref, info_ref), (s_sp, sol_sp, info_sp) = ref, sp
    assert info_ref.converged and info_sp.converged
    assert abs(info_sp.residual_true - info_ref.residual_true) <= GATE
    assert _max(sol_sp, sol_ref) <= GATE
    g = gather_state(s_sp)
    assert _max(g.fibers.x, s_ref.fibers.x) <= GATE
    return g


@pytest.mark.parametrize("n", [2, 4])
def test_spmd_free_fiber_step_matches_step(n):
    system = System(Params(**PARAMS), device="cpu")
    ref, sp = _step_pair(system, _free_state(system), n)
    assert ref[2].iters > 1  # the arcs couple the solve
    _assert_parity(ref, sp)
    # the fibers stay sharded across the step (no implicit gather)
    assert [st.fibers.n_fibers for st in sp[0].shards] == [16 // n] * n


def test_spmd_step_solution_layouts(coupled_parts):
    """`spmd_step` (build, then run) gives `System.step_spmd`'s bits; its
    ``flat_solution=False`` parts (per bucket and shard, the shell's rows a
    shard, the replicated body solution a shard) concatenate to the flat
    reference-layout solution."""
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    mesh = make_mesh(4, device="cpu")
    sharded = shard_state(_coupled_state(system, coupled_parts), mesh)
    _, flat, _ = system.step_spmd(sharded, mesh)
    _, flat2, _ = spmd_step(system, sharded, mesh)
    assert torch.equal(flat2, flat)
    _, parts, _ = spmd_step(system, sharded, mesh, flat_solution=False)
    assert len(parts.fibers) == 1 and len(parts.fibers[0]) == 4
    assert all(torch.equal(b, parts.bodies[0]) for b in parts.bodies)
    joined = torch.cat([torch.cat(parts.fibers[0]).reshape(-1),
                        torch.cat(parts.shell), parts.bodies[0]])
    assert torch.equal(joined, flat)


@pytest.mark.parametrize("n", [2, 4])
def test_spmd_coupled_step_matches_step(coupled_parts, n):
    """A row-sharded shell and a replicated body: the solution, the shell
    density and the body's motion at the gate; the dense operators stay
    row blocks; the replicated rows are the same bits on every shard."""
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    ref, sp = _step_pair(system, _coupled_state(system, coupled_parts), n)
    g = _assert_parity(ref, sp)
    assert _max(g.shell.density, ref[0].shell.density) <= GATE
    assert _max(g.bodies.position, ref[0].bodies.position) <= 1e-10
    assert sp[0].shell_mode == "sharded"
    for st in sp[0].shards:
        assert st.shell.M_inv.shape == (3 * 56 // n, 3 * 56)
        assert st.shell.stresslet_plus_complementary.shape == (3 * 56 // n,
                                                               3 * 56)
    _same_rows_on_every_shard(sp[0])


def _jax_coupled(parts, params):
    """The JAX package's System and state of `_coupled_state`."""
    from skellysim_tpu.bodies.bodies import BodyGroup as JBodies

    shell, _, bodies = parts

    def jleaves(nt, cls):
        return cls(**{k: None if v is None else jnp.asarray(v.numpy())
                      for k, v in nt._asdict().items()})

    jsys = JSystem(JParams(**params), shell_shape=jperi.PeripheryShape(
        **dataclasses.asdict(SHAPE)))
    fib = jfc.make_group(_arcs(seed=7, box=2.0), lengths=1.0,
                         bending_rigidity=0.01, radius=0.0125,
                         force_scale=-0.05)
    return jsys, jsys.make_state(fibers=fib,
                                 shell=jleaves(shell, jperi.PeripheryState),
                                 bodies=jleaves(bodies, JBodies))


def test_spmd_coupled_step_matches_jax_step_spmd(coupled_parts):
    """The coupled step on 4 shards against the JAX package's `step_spmd`
    on a 4-device mesh: the same decomposition, to 1e-10."""
    jsys, jstate = _jax_coupled(coupled_parts, PARAMS)
    jmesh = jmake_mesh(4)
    js, jsol, jinfo = jsys.step_spmd(jshard_state(jstate, jmesh), jmesh,
                                     donate=False)
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    mesh = make_mesh(4, device="cpu")
    ts, tsol, tinfo = system.step_spmd(
        shard_state(_coupled_state(system, coupled_parts), mesh), mesh)
    assert tinfo.converged and bool(jinfo.converged)
    assert tinfo.iters == int(jinfo.iters)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-10 * np.abs(jsol).max())
    g = gather_state(ts)
    np.testing.assert_allclose(g.fibers.x.numpy(), np.asarray(js.fibers.x),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(g.bodies.position.numpy(),
                               np.asarray(js.bodies.position), rtol=0,
                               atol=1e-10)


def test_spmd_mixed_refinement_inside_mesh(coupled_parts):
    """"mixed": the f32 Krylov interior rings in f32, the prep flows and
    the refinement residual ring the f64-grade tile ("pallas_df", B / D a
    hop); the sweeps never leave the mesh. The residual agrees with
    `System.step`'s at the gate and the sweeps are as many; the solutions
    agree to the tolerance ball only (other f32 Krylov paths)."""
    params = Params(**PARAMS, solver_precision="mixed",
                    refine_pair_impl="pallas_df", kernel_impl="pallas")
    system = System(params, shell_shape=SHAPE, device="cpu")
    ref, sp = _step_pair(system, _coupled_state(system, coupled_parts), 4)
    info_ref, info_sp = ref[2], sp[2]
    assert info_sp.converged and info_sp.residual_true <= params.gmres_tol
    assert info_sp.refines >= 1 and info_sp.refines == info_ref.refines
    assert abs(info_sp.residual_true - info_ref.residual_true) <= GATE
    assert _max(sp[1], ref[1]) <= 1e-5 * float(ref[1].abs().max())
    _same_rows_on_every_shard(sp[0])


def test_spmd_replicated_shell_fallback():
    """A shell that cannot split node-aligned raises; the opt-in puts the
    whole shell on every shard and matches `System.step`, its density the
    same bits on every shard."""
    parts = make_coupled_parts(102, 50)  # 102 % 4 != 0
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    state = _coupled_state(system, parts)
    mesh = make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        shard_state(state, mesh)
    sharded = shard_state(state, mesh, allow_replicated_shell=True)
    with pytest.raises(ValueError, match="allow_replicated_shell"):
        system.step_spmd(sharded, mesh)
    ref, sp = _step_pair(system, state, 4, allow_replicated_shell=True)
    assert sp[0].shell_mode == "replicated"
    g = _assert_parity(ref, sp)
    assert _max(g.shell.density, ref[0].shell.density) <= GATE
    _same_rows_on_every_shard(sp[0])


def test_spmd_indivisible_fibers_raise():
    system = System(Params(**PARAMS), device="cpu")
    state = system.make_state(fibers=_fibers(n_fibers=12))  # 12 % 8 != 0
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="grow_capacity"):
        spmd_shell_mode(state, mesh)
    with pytest.raises(ValueError, match="grow_capacity"):
        shard_state(state, mesh)


def test_spmd_indivisible_shell_raises():
    """Node-misaligned shells fail loudly (the O(n^2) operators never
    replicate silently); the explicit opt-in reports "replicated"."""
    parts = make_coupled_parts(100, 50)  # 100 % 8 != 0
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    state = _coupled_state(system, parts)
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        spmd_shell_mode(state, mesh)
    assert spmd_shell_mode(state, mesh,
                           allow_replicated_shell=True) == "replicated"


def _tree_params():
    return Params(**PARAMS, pair_evaluator="tree", tree_tol=1e-3)


def test_spmd_tree_branch_matches_tree_step():
    """``pair_evaluator = "tree"`` with every slot active: the Krylov
    fiber flows take the tree on every shard, each shard's sums under its
    own kept geometry (keyed by call site: no shard is served shard 0's), no
    NaN anywhere, and the step lands on the one-device "tree" step to
    1e-10."""
    system = System(_tree_params(), device="cpu")
    # 20 arcs in a cube of side 4: a depth-2 tree at tree_tol 1e-3
    state = system.make_state(
        fibers=_fibers(n_fibers=20, seed=11, box=2.0),
        background=BackgroundFlow.make(uniform=(1.0, 0.0, 0.0),
                                       dtype=torch.float64, device="cpu"))
    _, sol_ref, info_ref = system.step(state)
    mesh = make_mesh(4, device="cpu")
    sharded = shard_state(state, mesh)
    pair = system._pair_args(gather_state(sharded, shell_operators=False))
    assert pair.plan.depth >= 2
    new, sol, info = build_spmd_step(system, mesh, sharded, pair=pair)(
        sharded)
    assert info.converged and info.health == 0
    assert not torch.isnan(sol).any()
    for st in new.shards:
        assert torch.isfinite(st.fibers.x).all()
    sites = {key[0] for key in pair.geometry}
    assert {("fibers", "shard", k, "resident") for k in range(4)} <= sites
    assert info.iters == info_ref.iters
    assert _max(sol, sol_ref) <= 1e-10 * float(sol_ref.abs().max())
    # System.step_spmd builds the same plan and takes the same path
    _, sol2, _ = system.step_spmd(sharded, mesh)
    assert torch.equal(sol2, sol)


def test_spmd_tree_falls_back_to_the_ring_with_inactive_slots():
    """With inactive padding slots the layout cannot spread their nodes:
    `build_spmd_step(pair=...)` refuses, and `System.step_spmd` runs the
    ring flows instead, landing on the dense step."""
    fibers = tfc.grow_capacity(_fibers(), 24)
    system = System(_tree_params(), device="cpu")
    dense = System(Params(**PARAMS), device="cpu")
    bg = BackgroundFlow.make(uniform=(1.0, 0.0, 0.0), dtype=torch.float64,
                             device="cpu")
    state = system.make_state(fibers=fibers, background=bg)
    mesh = make_mesh(4, device="cpu")
    sharded = shard_state(state, mesh)
    pair = system._pair_args(state)
    with pytest.raises(ValueError, match="every fiber slot"):
        build_spmd_step(system, mesh, sharded, pair=pair)
    _, sol, info = system.step_spmd(sharded, mesh)
    _, sol_ref, _ = dense.step(dense.make_state(fibers=fibers,
                                                background=bg))
    assert info.converged
    assert _max(sol, sol_ref) <= GATE


# ------------------------------------------------------- the in-mesh seams

def _blocks(a, n):
    t = torch.as_tensor(np.asarray(a))
    m = t.shape[0] // n
    return [t[k * m:(k + 1) * m] for k in range(n)]


def _jax_local(fn, n, in_specs, out_specs, *args):
    return shard_map(fn, mesh=jmake_mesh(n), in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)(*args)


@pytest.mark.parametrize("ring_", [True, False])
@pytest.mark.parametrize("kind,impl,dtype", [
    ("stokeslet", "exact", np.float64), ("stresslet", "exact", np.float64),
    ("stokeslet", "pallas_df", np.float32)])
def test_ring_flow_local_matches_jax(kind, impl, dtype, ring_):
    """`ring_flow_local` on 4 shards against the JAX function inside a
    `shard_map`: the ring (every shard's sources at each shard's targets)
    and the local partial, f64 to 1e-12. The f64-grade tile on f32
    operands (the port's "pallas_df": native f64 kernel B) is held
    against the JAX f64 sum of the same operands, to 1e-6 of the f32
    result it is cast back to. (The JAX package's own f64-grade tiles,
    "df" and "pallas_df", take minutes to build on the CPU.)"""
    n, eta = 4, 1.3
    rng = np.random.default_rng(17)
    trg = rng.uniform(-1, 1, (4 * 6, 3)).astype(dtype)
    src = rng.uniform(-1, 1, (4 * 9, 3)).astype(dtype)
    pay = rng.standard_normal((4 * 9, 3) if kind == "stokeslet"
                              else (4 * 9, 3, 3)).astype(dtype)
    ref = _jax_local(
        lambda t, s, p: jring.ring_flow_local(kind, "exact", t, s, p, eta,
                                              axis_name="fib", n_dev=n,
                                              ring=ring_),
        n, (P("fib"),) * 3, P("fib"), *(jnp.asarray(a, dtype=jnp.float64)
                                       for a in (trg, src, pay)))
    got = ring.ring_flow_local(kind, impl, _blocks(trg, n), _blocks(src, n),
                               _blocks(pay, n), eta,
                               comm=Collectives(make_mesh(n, device="cpu")),
                               ring=ring_)
    got = torch.cat(got)
    assert got.dtype == torch.as_tensor(trg).dtype
    ref = np.asarray(ref, dtype=np.float64)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_flow_multi_local_matches_jax():
    """`fibers.container.flow_multi_local` (the ring branch: resident rows
    [fiber nodes | extra rows] around the ring with the self-interaction
    subtracted, replicated rows as a per-shard partial) against the JAX
    function inside a `shard_map` on 4 shards, to 1e-12."""
    n, eta = 4, 1.0
    x = _arcs(n_fibers=8, n_nodes=16, seed=3, box=1.5)
    jg = jfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                        radius=0.0125)
    jc = jfc.update_cache(jg, 1e-3, eta)
    rng = np.random.default_rng(4)
    forces = rng.standard_normal((8, 16, 3))
    extra = rng.uniform(-2, 2, (4 * 5, 3))
    r_rep = rng.uniform(-2, 2, (7, 3))

    def local(g, c, f, ex, rr):
        r_loc = jnp.concatenate([jfc.node_positions(g), ex])
        return jfc.flow_multi_local([g], [c], [f], r_loc, rr, eta,
                                    axis_name="fib", n_dev=n)

    spec = P("fib")
    v_loc, v_rep = _jax_local(
        local, n, (jax.tree_util.tree_map(lambda _: spec, jg),
                   jax.tree_util.tree_map(lambda _: spec, jc), spec, spec,
                   P()), (spec, spec),
        jg, jc, jnp.asarray(forces), jnp.asarray(extra), jnp.asarray(r_rep))

    tg = tfc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                        radius=0.0125)
    groups = [_rows(tg, k, n, torch.device("cpu")) for k in range(n)]
    caches = [[tfc.update_cache(g, 1e-3, eta)] for g in groups]
    f_blocks = _blocks(forces, n)
    r_loc = [torch.cat([tfc.node_positions(g), e])
             for g, e in zip(groups, _blocks(extra, n))]
    rr = torch.as_tensor(r_rep)
    got_loc, got_rep = tfc.flow_multi_local(
        [[g] for g in groups], caches, [[f] for f in f_blocks], r_loc,
        [rr] * n, eta, comm=Collectives(make_mesh(n, device="cpu")))
    for got, ref in ((got_loc, v_loc), (got_rep, v_rep)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(torch.cat(got).numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


def test_flow_local_matches_jax(coupled_parts):
    """`periphery.flow_local` (each shard's shell row block as a ring
    source at the resident rows, and as a partial at the replicated rows)
    against the JAX function inside a `shard_map` on 4 shards."""
    n, eta = 4, 1.0
    shell = coupled_parts[0]
    rng = np.random.default_rng(9)
    density = rng.standard_normal(3 * 56)
    r_loc = rng.uniform(-3, 3, (4 * 10, 3))
    r_rep = rng.uniform(-3, 3, (6, 3))
    jshell = jperi.PeripheryState(**{k: jnp.asarray(v.numpy())
                                     for k, v in shell._asdict().items()
                                     if v is not None})

    def local(sh, d, rl, rr):
        return jperi.flow_local(sh, rl, rr, d, eta, axis_name="fib",
                                n_dev=n)

    spec = P("fib")
    v_loc, v_rep = _jax_local(
        local, n, (jax.tree_util.tree_map(lambda _: spec, jshell), spec,
                   spec, P()), (spec, spec), jshell, jnp.asarray(density),
        jnp.asarray(r_loc), jnp.asarray(r_rep))
    cpu = torch.device("cpu")
    got_loc, got_rep = tperi.flow_local(
        [_rows(shell, k, n, cpu) for k in range(n)], _blocks(r_loc, n),
        [torch.as_tensor(r_rep)] * n, _blocks(density, n), eta,
        comm=Collectives(make_mesh(n, device="cpu")))
    for got, ref in ((got_loc, v_loc), (got_rep, v_rep)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(torch.cat(got).numpy(), ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


def test_ring_oseen_contract_matches_jax():
    rng = np.random.default_rng(23)
    src = rng.uniform(-1, 1, (4 * 8, 3))
    trg = rng.uniform(-1, 1, (4 * 5, 3))
    rho = rng.standard_normal((4 * 8, 3))
    ref = np.asarray(jring.ring_oseen_contract(
        jnp.asarray(src), jnp.asarray(trg), jnp.asarray(rho), 1.7,
        mesh=jmake_mesh(4)))
    got = ring.ring_oseen_contract(torch.as_tensor(src), torch.as_tensor(trg),
                                   torch.as_tensor(rho), 1.7,
                                   mesh=make_mesh(4, device="cpu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


# ----------------------------------------------------------- the solver

def _system_matrix(n_rows, seed):
    rng = np.random.default_rng(seed)
    A = np.eye(n_rows) * 4.0 + rng.standard_normal((n_rows, n_rows)) * 0.3
    return torch.as_tensor(A), torch.as_tensor(rng.standard_normal(n_rows))


def test_gmres_rdot_seam_is_threaded():
    """An ``rdot`` that is the plain contraction, in `gmres` and through
    `gmres_ir` to its inner solves: the iterations of ``rdot=None`` and
    the solution to 1e-13 (its norms are sqrt(rdot(v, v)), the default's
    `torch.linalg.vector_norm`)."""
    A, b = _system_matrix(40, 2)
    kw = dict(tol=1e-12, restart=10, maxiter=200)
    for solve in (lambda **o: gmres(lambda v: A @ v, b, **kw, **o),
                  lambda **o: gmres_ir(
                      lambda v: A @ v, lambda v: (A.float() @ v.float()
                                                  ).double(), b, **kw, **o)):
        ref = solve()
        got = solve(rdot=lambda M, w: M @ w)
        assert (got.iters, got.refines) == (ref.iters, ref.refines)
        assert _max(got.x, ref.x) <= 1e-13 * float(ref.x.abs().max())


@pytest.mark.parametrize("n", [2, 4])
def test_gmres_on_shard_vectors(n):
    """`gmres` on `ShardVec` Krylov vectors split as the sharded step
    splits them ([resident rows | replicated tail], the tail on every
    shard) with `_make_rdot` gives the bits of `gmres` on one tensor with
    an ``rdot`` that splits the vector the same way (the partials added in
    shard order, then the tail), and the tail is the same bits on every
    shard; the iterations are those of ``rdot=None``."""
    rows, tail = 12, 5
    A, b = _system_matrix(n * rows + tail, 6)
    head = [slice(k * rows, (k + 1) * rows) for k in range(n)]
    t_sl = slice(n * rows, n * rows + tail)

    def split(v):
        return ShardVec(torch.cat([v[h], v[t_sl]]) for h in head)

    def join(sv):
        return torch.cat([p[:rows] for p in sv.parts] + [sv.parts[0][rows:]])

    def rdot_split(M, w):
        acc = M[..., head[0]] @ w[head[0]]
        for h in head[1:]:
            acc = acc + M[..., h] @ w[h]
        return acc + M[..., t_sl] @ w[t_sl]

    kw = dict(tol=1e-12, restart=8, maxiter=200)
    plain = gmres(lambda v: A @ v, b, **kw)
    ref = gmres(lambda v: A @ v, b, rdot=rdot_split, **kw)
    comm = Collectives(make_mesh(n, device="cpu"))
    got = gmres(lambda sv: split(A @ join(sv)), split(b),
                rdot=_make_rdot(comm, rows), **kw)
    assert got.converged and got.iters == ref.iters == plain.iters
    assert torch.equal(join(got.x), ref.x)
    assert got.residual_true == ref.residual_true
    assert all(torch.equal(p[rows:], got.x.parts[0][rows:])
               for p in got.x.parts)


def test_shard_and_gather_round_trip(coupled_parts):
    """`gather_state` is `shard_state`'s inverse on every field, a
    sharded shell's operators included; a shard's blocks are views of the
    state's tensors on its own device."""
    system = System(Params(**PARAMS), shell_shape=SHAPE, device="cpu")
    state = _coupled_state(system, coupled_parts)
    sharded = shard_state(state, make_mesh(4, device="cpu"))
    assert (sharded.shards[1].shell.M_inv.untyped_storage().data_ptr()
            == state.shell.M_inv.untyped_storage().data_ptr())
    back = gather_state(sharded)
    for name in ("fibers", "shell", "bodies"):
        a, b = getattr(state, name), getattr(back, name)
        for f in a._fields:
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None and vb is None) or torch.equal(va, vb), f
    light = gather_state(sharded, shell_operators=False)
    assert light.shell.M_inv is None and torch.equal(light.shell.nodes,
                                                     state.shell.nodes)
    assert tbd.as_buckets(back.bodies)[0].n_bodies == 1
