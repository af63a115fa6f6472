"""The port's host-driven GMRES against `skellysim_tpu.solver.gmres`.

One dense, well-conditioned operator made in numpy goes through both
solvers. The algorithms are the same step for step (ICGS, Givens, explicit
residual restarts), so the iteration counts must be equal and the
solutions agree to 1e-10 (the operator is well conditioned, so solutions
at tol 1e-12 differ only by roundoff-level residual differences).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.solver import gmres as jgmres, gmres_ir as jgmres_ir
from skellysim_tpu_torch.solver import gmres, gmres_ir


def _problem(n=90, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    b = rng.standard_normal(n)
    P = np.linalg.inv(A + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n))
    return A, b, P


@pytest.mark.parametrize("restart,precond", [(100, False), (7, False),
                                             (5, True)])
def test_gmres_matches_jax(restart, precond):
    A, b, P = _problem()
    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    Aj, Pj = jnp.asarray(A), jnp.asarray(P)
    ref = jgmres(lambda v: Aj @ v, jnp.asarray(b),
                 precond=(lambda v: Pj @ v) if precond else None,
                 tol=1e-12, restart=restart, maxiter=400)
    got = gmres(lambda v: At @ v, torch.as_tensor(b),
                precond=(lambda v: Pt @ v) if precond else None,
                tol=1e-12, restart=restart, maxiter=400, history=4)
    assert got.converged and bool(ref.converged)
    assert got.iters == int(ref.iters)
    assert got.cycles == int(ref.cycles)
    assert got.health == int(ref.health) == 0
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())
    assert abs(got.residual_true - float(ref.residual_true)) < 1e-12
    assert len(got.history) == min(4, got.cycles)
    assert got.history[-1][0] == got.iters


def test_gmres_ir_matches_jax():
    """Mixed precision: the inner operator is the f32 cast of A (the
    port's lo seam in miniature), the residual operator f64. Both
    frameworks' f32 products round alike here, so the sweep and inner
    iteration counts agree."""
    A, b, _ = _problem(n=120, seed=3)
    A32 = A.astype(np.float32)
    Aj, Aj32 = jnp.asarray(A), jnp.asarray(A32)
    At, At32 = torch.as_tensor(A), torch.as_tensor(A32)
    ref = jgmres_ir(lambda v: Aj @ v,
                    lambda v: (Aj32 @ v.astype(jnp.float32)).astype(v.dtype),
                    jnp.asarray(b), tol=1e-12, inner_tol=1e-5, restart=60,
                    maxiter=600)
    got = gmres_ir(lambda v: At @ v,
                   lambda v: (At32 @ v.to(torch.float32)).to(v.dtype),
                   torch.as_tensor(b), tol=1e-12, inner_tol=1e-5, restart=60,
                   maxiter=600)
    assert got.converged and bool(ref.converged)
    assert got.refines == int(ref.refines)
    assert got.iters == int(ref.iters)
    assert got.residual <= 1e-12
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())


def test_gmres_edge_cases():
    A = torch.eye(4, dtype=torch.float64)
    zero = gmres(lambda v: A @ v, torch.zeros(4, dtype=torch.float64))
    assert zero.converged and zero.iters == 0 and zero.health == 0
    bad = gmres(lambda v: A @ v,
                torch.tensor([1.0, float("nan"), 0.0, 0.0],
                             dtype=torch.float64))
    assert bad.health & 1  # nonfinite stamped at entry
    # the s-step cycle (tests/test_torch_sstep.py): the identity in one
    # round of two
    one = gmres(lambda v: v, torch.ones(4, dtype=torch.float64), block_s=2)
    assert one.converged and one.iters == 1 and one.health == 0
    assert torch.equal(one.x, torch.ones(4, dtype=torch.float64))
