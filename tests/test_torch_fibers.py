"""The port's fiber container against `skellysim_tpu.fibers.container`.

One scene (tests/test_fd_fiber.py's smooth bent fibers, here a batch with
every boundary-condition combination and one inactive slot) goes through
both packages in f64; inputs cross as numpy. Operator assembly is the same
arithmetic in another order, so 1e-12 relative to each quantity's largest
entry; the LU-based preconditioner amplifies that by the blocks' condition
number, so 1e-10 there. The literal reference transcription
(tests/ref_fiber.py) pins the port's BC-applied operator directly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu_torch.convert import group_from_numpy
from skellysim_tpu_torch.fibers import container as tfc
from tests.ref_fiber import RefFiber

N, NF = 16, 5
ETA, DT = 1.3, 0.013


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, N)
    xs = []
    for i in range(NF):
        x = np.stack([2.1 * t, 0.1 * np.sin(2.0 * t + i),
                      0.05 * t**2 + 0.02 * np.cos(3 * t)], axis=1)
        xs.append(x + 1e-3 * rng.standard_normal((N, 3))
                  + rng.uniform(-3, 3, 3))
    g = jfc.make_group(np.stack(xs), lengths=2.1, bending_rigidity=0.05,
                       radius=0.0125, force_scale=-0.05,
                       minus_clamped=np.array([False, True, False, True, False]),
                       dtype=jnp.float64)
    g = g._replace(plus_pinned=jnp.asarray([False, False, True, True, False]),
                   length_prev=jnp.full(NF, 2.05),
                   active=jnp.asarray([True, True, True, True, False]))
    return g, rng


def _port(g):
    return group_from_numpy({k: (None if v is None else np.asarray(v))
                             for k, v in g._asdict().items()}, device="cpu")


def _close(got, ref, tol=1e-12):
    got = got.numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


@pytest.fixture(scope="module")
def both():
    g, rng = _scene()
    v = rng.standard_normal((NF, N, 3))
    f_tot = rng.standard_normal((NF, N, 3))
    f_ext = rng.standard_normal((NF, N, 3))
    jc = jfc.update_cache(g, DT, ETA)
    jc = jfc.update_rhs_and_bc(g, jc, DT, ETA, jnp.asarray(v),
                               jnp.asarray(f_tot), jnp.asarray(f_ext))
    tg = _port(g)
    tc = tfc.update_cache(tg, DT, ETA)
    tc = tfc.update_rhs_and_bc(tg, tc, DT, ETA, torch.as_tensor(v),
                               torch.as_tensor(f_tot), torch.as_tensor(f_ext))
    return g, jc, tg, tc, rng


def test_update_cache(both):
    g, jc, tg, tc, _ = both
    for name in ("xs", "xss", "xsss", "xssss", "stokeslet", "force_op"):
        _close(getattr(tc, name), getattr(jc, name))


def test_update_rhs_and_bc(both):
    g, jc, tg, tc, _ = both
    _close(tc.A_bc, jc.A_bc)
    _close(tc.RHS, jc.RHS)


def test_bc_operator_matches_reference_transcription(both):
    """Fiber 3 (clamped minus end, pinned plus end) against the literal
    transcription of the reference's `apply_bc_rectangular`."""
    g, _, tg, tc, _ = both
    i = 3
    ref = RefFiber(np.asarray(g.x[i]).T, 2.1, 0.05, 0.0125, ETA,
                   length_prev=2.05)
    ref.update_linear_operator(DT)
    ref.update_RHS(DT, None, None)
    ref.apply_bc_rectangular(DT, None, None, "velocity", "velocity")
    _close(tc.A_bc[i], ref.A_bc)


def test_flow_multi_subtract_self(both):
    g, jc, tg, tc, rng = both
    forces = rng.standard_normal((NF, N, 3))
    extra = rng.uniform(-3, 3, (7, 3))
    r_trg = np.concatenate([np.asarray(g.x).reshape(-1, 3), extra])
    ref = jfc.flow_multi((g,), (jc,), jnp.asarray(r_trg),
                         (jnp.asarray(forces),), ETA, subtract_self=True)
    got = tfc.flow_multi((tg,), (tc,), torch.as_tensor(r_trg),
                         (torch.as_tensor(forces),), ETA, subtract_self=True)
    assert torch.isfinite(got).all()
    _close(got, ref)


def test_matvec_preconditioner_force(both):
    g, jc, tg, tc, rng = both
    x = rng.standard_normal((NF, 4 * N))
    v = rng.standard_normal((NF, N, 3))
    vb = rng.standard_normal((NF, 7))
    _close(tfc.matvec(tg, tc, torch.as_tensor(x), torch.as_tensor(v),
                      torch.as_tensor(vb)),
           jfc.matvec(g, jc, jnp.asarray(x), jnp.asarray(v), jnp.asarray(vb)))
    _close(tfc.apply_preconditioner(tg, tc, torch.as_tensor(x)),
           jfc.apply_preconditioner(g, jc, jnp.asarray(x)), tol=1e-10)
    _close(tfc.apply_fiber_force(tg, tc, torch.as_tensor(x)),
           jfc.apply_fiber_force(g, jc, jnp.asarray(x)))
    _close(tfc.weighted_forces(tg, torch.as_tensor(v)),
           jfc.weighted_forces(g, jnp.asarray(v)))
    _close(tfc.generate_constant_force(tg, tc),
           jfc.generate_constant_force(g, jc))


def test_preconditioner_in_f32(both):
    """Mixed precision stores the LU factors in f32 (precond_dtype)."""
    g, jc, tg, tc, rng = both
    v = torch.zeros((NF, N, 3), dtype=torch.float64)
    tc32 = tfc.update_rhs_and_bc(tg, tc, DT, ETA, v, v, v,
                                 precond_dtype=torch.float32)
    assert tc32.lu.dtype == torch.float32 and tc32.A_bc.dtype == torch.float64
    x = torch.as_tensor(rng.standard_normal((NF, 4 * N)))
    out = tfc.apply_preconditioner(tg, tc32, x)
    assert out.dtype == torch.float64 and torch.isfinite(out).all()


def test_step_and_fiber_error(both):
    g, jc, tg, tc, rng = both
    sol = rng.standard_normal((NF, 4 * N))
    js = jfc.step(g, jnp.asarray(sol))
    ts = tfc.step(tg, torch.as_tensor(sol))
    _close(ts.x, js.x)
    _close(ts.tension, js.tension)
    _close(ts.length_prev, js.length_prev)
    _close(tfc.fiber_error(tg), jfc.fiber_error(g))
    assert tfc.solution_size(tg) == jfc.solution_size(g)
