"""The port's s-step GMRES (``block_s > 1``) against the JAX package's.

* `gmres` / `gmres_ir` at ``block_s`` 2 and 4 on tests/test_gmres.py's
  systems: the same iterations, cycles and health as the JAX solver, x to
  1e-10 of its largest entry, the history rows, and the reductions counted
  at the ``rdot`` seam equal to `collective_rounds` (two batched Gram
  reductions a round, plus the entry norm and two norms a cycle);
* the rank-deficient block of tests/test_guard.py flags BREAKDOWN in both;
* `gmres_batched` / `gmres_ir_batched` lanes against lone solves;
* a shell-coupled `System.step` at ``gmres_block_s = 4`` against the JAX
  package's at 1e-10, and `System.step_spmd` on 2 CPU shards against
  `System.step` at 5e-9 in "full", with its reductions counted (in
  "mixed" at tests/test_torch_spmd.py's mixed gates).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.solver import gmres as jgmres
from skellysim_tpu.solver import gmres_ir as jgmres_ir
from skellysim_tpu.solver.gmres import history_rows
from skellysim_tpu.system import System as JSystem
from skellysim_tpu.testing import make_coupled_parts as jcoupled_parts
from skellysim_tpu_torch.guard import verdict
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.parallel import make_mesh, shard_state
from skellysim_tpu_torch.parallel import spmd as tspmd
from skellysim_tpu_torch.solver import (gmres, gmres_batched, gmres_ir,
                                        gmres_ir_batched)
from skellysim_tpu_torch.solver.gmres import collective_rounds
from skellysim_tpu_torch.system import System
from torch_jax_state import port_state, port_system

#: the reference's backend-agreement gate (`kernel_test.cpp:93`)
GATE = 5e-9


def _system(n, seed, cond_boost=0.0):
    """tests/test_gmres.py's `_system`."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + (2.0 + cond_boost) * np.eye(n)
    b = rng.standard_normal(n)
    return A, b


def _counting(log):
    def rdot(A, w):
        log.append(w.ndim)
        return A @ w
    return rdot


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("n,seed,restart,boost,tol", [
    (80, 1, 80, 0.0, 1e-10), (100, 3, 12, 2.0, 1e-10),
    (100, 5, 12, 2.0, 1e-11)])
def test_sstep_gmres_matches_jax(s, n, seed, restart, boost, tol):
    A, b = _system(n, seed, boost)
    Aj = jnp.asarray(A)
    ref = jgmres(lambda v: Aj @ v, jnp.asarray(b), tol=tol, restart=restart,
                 maxiter=600, history=8, block_s=s)
    At = torch.as_tensor(A)
    log = []
    got = gmres(lambda v: At @ v, torch.as_tensor(b), tol=tol,
                restart=restart, maxiter=600, history=8, block_s=s,
                rdot=_counting(log))
    assert got.converged and bool(ref.converged)
    assert got.iters == int(ref.iters)
    assert got.cycles == int(ref.cycles)
    assert got.health == int(ref.health)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())
    rows = history_rows(ref.history, ref.cycles)
    assert len(got.history) == len(rows) == min(8, got.cycles)
    assert [r[0] for r in got.history] == [int(r[0]) for r in rows]
    # the implicit residuals to 1e-6; the explicit ones, ~1e-11 norms of a
    # residual recomputed from x, to 1e-4
    np.testing.assert_allclose(np.asarray(got.history)[:, 1],
                               np.asarray(rows)[:, 1], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.history)[:, 2],
                               np.asarray(rows)[:, 2], rtol=1e-4)
    # two batched Gram reductions a round; the entry norm and two norms a
    # restart cycle: collective_rounds, plus the entry norm
    assert log.count(2) == 2 * -(-got.iters // s)
    assert len(log) == collective_rounds(got.iters, got.cycles, s) + 1


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_gmres_ir_matches_jax(s):
    """tests/test_gmres.py's refinement system with the s-step inner
    solve: the same sweeps and inner iterations, x to 1e-10."""
    rng = np.random.default_rng(9)
    n = 96
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    b = rng.standard_normal(n)
    Aj, A32 = jnp.asarray(A), jnp.asarray(A, dtype=jnp.float32)
    ref = jgmres_ir(lambda v: Aj @ v,
                    lambda v: (A32 @ v.astype(jnp.float32)).astype(v.dtype),
                    jnp.asarray(b), tol=1e-10, inner_tol=1e-5, restart=48,
                    maxiter=200, block_s=s)
    At, At32 = torch.as_tensor(A), torch.as_tensor(A).float()
    got = gmres_ir(lambda v: At @ v,
                   lambda v: (At32 @ v.float()).to(v.dtype),
                   torch.as_tensor(b), tol=1e-10, inner_tol=1e-5,
                   restart=48, maxiter=200, block_s=s, history=4)
    assert got.converged and bool(ref.converged)
    assert (got.refines, got.iters) == (int(ref.refines), int(ref.iters))
    assert got.health == int(ref.health) == 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())
    assert got.history[-1][0] == got.iters


def test_sstep_breakdown_on_rank_deficient_block():
    """tests/test_guard.py's rank-1 operator: the monomial basis dies at
    the second candidate and both solvers flag BREAKDOWN (in float32, the
    ridge at float32's eps), without converging."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal(16)
    u /= np.linalg.norm(u)
    A = np.outer(u, u).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = jgmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=1e-6,
                 restart=8, maxiter=16, block_s=4)
    At = torch.as_tensor(A)
    got = gmres(lambda x: At @ x, torch.as_tensor(b), tol=1e-6, restart=8,
                maxiter=16, block_s=4)
    assert int(ref.health) & verdict.BREAKDOWN
    assert got.health & verdict.BREAKDOWN
    # (the iterations past the breakdown follow the small-matrix
    # arithmetic, float32 there and float64 on the host here)
    assert not got.converged and not bool(ref.converged)
    with pytest.raises(ValueError, match="block_s"):
        gmres(lambda x: At @ x, torch.as_tensor(b), block_s=0)


@pytest.mark.parametrize("s", [2, 4])
def test_sstep_batched_lanes_match_lone_solves(s):
    """Members of different conditioning through `gmres_batched` and
    `gmres_ir_batched` at ``block_s = s``: each member takes its lone
    solve's iterations and cycles and its x bit for bit (the batched
    operator is the lone one a row)."""
    rng = np.random.default_rng(11)
    n, B = 40, 3
    As = [torch.as_tensor(np.eye(n) + (0.1 + 0.4 * i)
                          * rng.standard_normal((n, n)) / np.sqrt(n))
          for i in range(B)]
    b = torch.as_tensor(rng.standard_normal((B, n)))

    def mv(v):
        return torch.stack([As[i] @ v[i] for i in range(B)])

    batched = gmres_batched(mv, b, tol=1e-12, restart=12, maxiter=200,
                            block_s=s, history=4)
    iters = set()
    for i in range(B):
        lone = gmres(lambda v, A=As[i]: A @ v, b[i], tol=1e-12, restart=12,
                     maxiter=200, block_s=s, history=4)
        iters.add(lone.iters)
        assert (batched.iters[i], batched.cycles[i]) == (lone.iters,
                                                         lone.cycles)
        assert batched.health[i] == lone.health
        assert torch.equal(batched.x[i], lone.x)
        assert batched.history[i] == lone.history
    assert len(iters) > 1
    lo = [A.float().double() for A in As]

    def mv_lo(v):
        return torch.stack([lo[i] @ v[i] for i in range(B)])

    ir = gmres_ir_batched(mv, mv_lo, b, tol=1e-12, inner_tol=1e-4,
                          restart=12, maxiter=200, block_s=s)
    for i in range(B):
        lone = gmres_ir(lambda v, A=As[i]: A @ v, lambda v, A=lo[i]: A @ v,
                        b[i], tol=1e-12, inner_tol=1e-4, restart=12,
                        maxiter=200, block_s=s)
        assert (ir.iters[i], ir.refines[i]) == (lone.iters, lone.refines)
        assert torch.equal(ir.x[i], lone.x)


def _coupled_jax(block_s):
    """A shell (120 nodes) + body (80 nodes) + one free fiber: the
    shell-coupled step of tests/test_torch_system.py."""
    shell, shape, bodies = jcoupled_parts(120, 80, jnp.float64)
    t = np.linspace(0, 1, 16)
    x = np.array([0.0, 2.5, 0.0]) + t[:, None] * np.array([0.0, 0.0, 1.0])
    fibers = jfc.make_group(x[None], lengths=1.0, bending_rigidity=0.01,
                            radius=0.0125, dtype=jnp.float64)
    jsys = JSystem(JParams(eta=1.0, dt_initial=0.05, gmres_tol=1e-11,
                           adaptive_timestep_flag=False,
                           gmres_block_s=block_s), shell_shape=shape)
    return jsys, jsys.make_state(fibers=fibers, shell=shell, bodies=bodies)


def test_sstep_coupled_step_matches_jax():
    """One shell-coupled step at ``gmres_block_s = 4`` ("full"): the same
    iterations and health word as the JAX package's step, the solution,
    fiber and body to 1e-10."""
    jsys, jstate = _coupled_jax(4)
    jn, jsol, ji = jsys.step(jstate)
    tsys = port_system(jsys)
    tn, tsol, ti = tsys.step(port_state(jstate))
    assert ti.converged and bool(ji.converged)
    assert ti.iters == int(ji.iters) and ti.cycles == int(ji.cycles)
    assert ti.health == int(ji.health)
    jsol = np.asarray(jsol)
    np.testing.assert_allclose(tsol.numpy(), jsol, rtol=0,
                               atol=1e-10 * np.abs(jsol).max())
    np.testing.assert_allclose(tn.fibers.x.numpy(), np.asarray(jn.fibers.x),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(tn.bodies.position.numpy(),
                               np.asarray(jn.bodies.position), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_sstep_spmd_matches_system_step(precision, monkeypatch):
    """`System.step_spmd` on 2 CPU shards at ``gmres_block_s = 4`` against
    `System.step` from the same state (the coupled scene of
    tests/test_torch_spmd.py) at the backend gate; in "full" the
    reductions of the sharded solve, counted at its ``rdot`` seam, are
    `collective_rounds` plus the entry norm."""
    from test_torch_spmd import SHAPE, _coupled_state
    from skellysim_tpu_torch.testing import make_coupled_parts

    p = Params(eta=1.0, dt_initial=1e-3, t_final=1e-2, gmres_tol=1e-10,
               adaptive_timestep_flag=False, gmres_block_s=4,
               solver_precision=precision)
    system = System(p, shell_shape=SHAPE, device="cpu")
    state = _coupled_state(system, make_coupled_parts(56, 50))
    ref = system.step(state)
    calls = []
    make = tspmd._make_rdot

    def counted(comm, nonrep_end):
        rdot = make(comm, nonrep_end)

        def wrapped(A, w):
            calls.append(1)
            return rdot(A, w)
        return wrapped

    monkeypatch.setattr(tspmd, "_make_rdot", counted)
    mesh = make_mesh(2, device="cpu")
    new, sol, info = system.step_spmd(shard_state(state, mesh), mesh)
    assert info.converged and ref[2].converged
    scale = float(ref[1].abs().max())
    if precision == "full":
        assert float((sol - ref[1]).abs().max()) <= GATE * scale
        assert info.iters == ref[2].iters
        assert len(calls) == collective_rounds(info.iters, info.cycles,
                                               4) + 1
    else:
        # tests/test_torch_spmd.py's mixed gates: the f32 interior's
        # sweeps leave the two solutions 1e-5 apart, both refined to tol
        assert info.residual_true <= p.gmres_tol
        assert info.refines == ref[2].refines
        assert abs(info.residual_true - ref[2].residual_true) <= GATE
        assert float((sol - ref[1]).abs().max()) <= 1e-5 * scale
    assert math.isfinite(info.residual_true)
