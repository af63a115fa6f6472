"""The port's experimental Chebyshev penalty fiber against the JAX
package's (`fibers/chebyshev.py`, `fibers/chebyshev_fiber.py`), in float64
on the CPU:

* the cached matrices of `chebyshev.py` (points, Vandermonde and its
  inverse, derivative and integration matrices, representation toggles)
  and its vector operations within 1e-13, relative to each result's
  largest entry;
* `divide_and_construct` and the objective within 1e-12, the Jacobian
  (`torch.func.jacfwd`) within 1e-10 of `jax.jacfwd`'s, one `newton_step`
  within 1e-10, on states made from a numpy seed;
* `evolve` (N = 20, 20 steps, dt = 5e-3, shear 1) within 1e-9 of the JAX
  package's final state and extensibility errors; the JAX evolve runs once
  (a module-scoped fixture);
* the JAX tests' physical oracles through the port: the derivative chain
  of the integrated caches, the clamped end, the deflection and the
  penalty's inextensibility, and the exact single Newton step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import chebyshev as jcheb
from skellysim_tpu.fibers import chebyshev_fiber as jcf
from skellysim_tpu_torch.fibers import chebyshev as tcheb
from skellysim_tpu_torch.fibers import chebyshev_fiber as tcf

N, L, ZETA, DT, STEPS = 20, 1.0, 1.0, 5e-3, 20


def _close(got, ref, tol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max(initial=0.0)), 1e-300)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


MATRICES = {
    "chebyshev_points": lambda m: m.chebyshev_points(16),
    "chebyshev_points_scaled": lambda m: m.chebyshev_points(16, 0.0, 2.5),
    "vander": lambda m: m.vander(m.chebyshev_points(12), 11),
    "vandermonde": lambda m: m.vandermonde(14),
    "inverse_vandermonde": lambda m: m.inverse_vandermonde(14),
    "derivative_coeffs": lambda m: m.derivative_coeffs(
        np.random.default_rng(3).standard_normal(9)),
    "nth_derivative_of_Tn": lambda m: m.nth_derivative_of_Tn(11, 3),
    "derivative_matrix": lambda m: m.derivative_matrix(14, 2,
                                                       scale_factor=3.0),
    "derivative_matrix_n": lambda m: m.derivative_matrix(14, 1, m.N, m.N),
    "integration_matrix": lambda m: m.integration_matrix(12),
    "integration_matrix_cn": lambda m: m.integration_matrix(12, m.C, m.N,
                                                            2.0),
    "toggle_representation_matrix": lambda m: m.toggle_representation_matrix(
        m.derivative_matrix(10, 1), m.C, m.C, m.N, m.N),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matrices_match_jax(name):
    _close(MATRICES[name](tcheb), MATRICES[name](jcheb), 1e-13)


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


VECTOR_OPS = {
    "c2f": lambda m, a: m.c2f(a(_vec(12, 1))),
    "f2c": lambda m, a: m.f2c(a(_vec(12, 2))),
    "resize_up": lambda m, a: m.resize(a(_vec(8, 3)), 13, m.N, m.C),
    "resize_down": lambda m, a: m.resize(a(_vec(13, 4)), 8, m.C, m.N),
    "multiply": lambda m, a: m.multiply(a(_vec(6, 5)), a(_vec(6, 6)), "c",
                                        "c", "c", n_out=11, nm=16),
    "multiply_mixed": lambda m, a: m.multiply(a(_vec(9, 7)), a(_vec(7, 8)),
                                              "n", "c", "n"),
    "evalpoly": lambda m, a: m.evalpoly(-0.3, a(_vec(8, 9))),
    "left_right": lambda m, a: m.left_eval(a(_vec(8, 10)))
    + 2 * m.right_eval(a(_vec(8, 10))),
}


@pytest.mark.parametrize("name", sorted(VECTOR_OPS))
def test_vector_ops_match_jax(name):
    got = VECTOR_OPS[name](tcheb, torch.as_tensor)
    ref = VECTOR_OPS[name](jcheb, jnp.asarray)
    _close(got, ref, 1e-13)


@pytest.fixture(scope="module")
def solvers():
    js, jx = jcf.setup_solver_initialstate(N, L)
    ts, tx = tcf.setup_solver_initialstate(N, L, device="cpu")
    return js, jx, ts, tx


def _states(seed, size):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(size), 0.1 * rng.standard_normal(size))


def test_setup_and_divide_and_construct_match_jax(solvers):
    js, jx, ts, tx = solvers
    _close(tx, jx, 0.0)
    _close(ts.IM, js.IM, 1e-13)
    _close(ts.IMT, js.IMT, 1e-13)
    x, _ = _states(1, js.solution_size)
    jd = js.divide_and_construct(jnp.asarray(x), L)
    td = ts.divide_and_construct(torch.as_tensor(x), L)
    for name in jd._fields:
        _close(getattr(td, name), getattr(jd, name), 1e-12)


@pytest.mark.parametrize("seed", [2, 3])
def test_objective_and_jacobian_match_jax(solvers, seed):
    js, _, ts, _ = solvers
    x, old = _states(seed, js.solution_size)

    def jobj(v):
        return jcf.sheer_deflection_objective(v, js, jnp.asarray(old), L,
                                              ZETA, DT)

    def tobj(v):
        return tcf.sheer_deflection_objective(v, ts, torch.as_tensor(old), L,
                                              ZETA, DT)

    _close(tobj(torch.as_tensor(x)), jobj(jnp.asarray(x)), 1e-12)
    _close(torch.func.jacfwd(tobj)(torch.as_tensor(x)),
           jax.jacfwd(jobj)(jnp.asarray(x)), 1e-10)


def test_newton_step_matches_jax(solvers):
    js, jx, ts, tx = solvers
    x, _ = _states(4, js.solution_size)
    ref = jcf.newton_step(js, jnp.asarray(x), jx, L, ZETA, DT)
    got = tcf.newton_step(ts, torch.as_tensor(x), tx, L, ZETA, DT)
    _close(got, ref, 1e-10)


@pytest.fixture(scope="module")
def evolved(solvers):
    js, jx, ts, tx = solvers
    ref = jcf.evolve(js, jx, L=L, zeta=ZETA, dt=DT, n_steps=STEPS)
    got = tcf.evolve(ts, tx, L=L, zeta=ZETA, dt=DT, n_steps=STEPS)
    return ref, got


def test_evolve_matches_jax(evolved):
    (jfinal, jerr), (tfinal, terr) = evolved
    assert terr.shape == (STEPS,)
    _close(tfinal, jfinal, 1e-9)
    _close(terr, jerr, 1e-9)


def test_evolve_physics_through_the_port(solvers, evolved):
    """`tests/test_chebyshev_fiber.py::test_newton_shear_evolution`'s
    oracles on the port's final state."""
    _, _, ts, _ = solvers
    _, (final, errs) = evolved
    div = ts.divide_and_construct(final, L)
    assert abs(float(tcheb.left_eval(div.XC))) < 1e-8
    assert abs(float(tcheb.left_eval(div.YC))) < 1e-8
    assert abs(float(tcheb.left_eval(div.XsC))) < 1e-6
    assert abs(float(tcheb.left_eval(div.YsC)) - 1.0) < 1e-6
    assert float(tcheb.right_eval(div.XC)) > 1e-3
    assert float(tcheb.right_eval(div.YC)) > 0.9 * L
    assert float(errs[-1]) < 5e-2
    assert torch.isfinite(final).all()


def test_divide_and_construct_derivative_chain():
    """d/ds X^(k) = X^(k+1) with the [0, L] arclength scaling
    (`tests/test_chebyshev_fiber.py`'s case, through the port)."""
    n, length = 16, 2.0
    solver = tcf.FiberSolverChebyshevPenalty(n, n - 2, n - 4, n - 6,
                                             device="cpu")
    XX = torch.as_tensor(np.random.default_rng(13).standard_normal(
        solver.solution_size))
    div = solver.divide_and_construct(XX, length)
    for lo, hi in [(div.XC, div.XsC), (div.XsC, div.XssC),
                   (div.XssC, div.XsssC), (div.XsssC, div.XssssC),
                   (div.YC, div.YsC), (div.TC, div.TsC), (div.TsC, div.TssC)]:
        D = torch.as_tensor(np.array(tcheb.derivative_matrix(
            lo.shape[0], 1, scale_factor=2.0 / length)))
        np.testing.assert_allclose((D @ lo).numpy(),
                                   hi.numpy()[:lo.shape[0] - 1], atol=1e-9)


def test_initial_state_and_single_newton_step():
    """The straight vertical fiber, and one Newton step solving the
    linear backward-Euler step exactly (the JAX tests' oracles)."""
    solver, XX = tcf.setup_solver_initialstate(16, L, device="cpu")
    x, y = tcf.node_positions(solver, XX, L)
    np.testing.assert_allclose(x.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), tcheb.chebyshev_points(12, 0.0, L),
                               atol=1e-10)
    assert float(tcf.extensibility_error(solver, XX, L)) < 1e-12
    XC, YC, TC, err = tcf.extricate(solver, XX, L)
    assert XC.shape == YC.shape and float(err) < 1e-12
    r0 = tcf.sheer_deflection_objective(XX, solver, XX, L, 0.5, 0.01)
    x1 = tcf.newton_step(solver, XX, XX, L, 0.5, 0.01)
    r1 = tcf.sheer_deflection_objective(x1, solver, XX, L, 0.5, 0.01)
    assert float(r0.abs().max()) > 1e-6
    assert float(r1.abs().max()) < 1e-10
