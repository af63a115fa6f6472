"""The port's rigid bodies against the JAX package, and the Stokes-drag
oracle.

The scenes are those of tests/test_bodies.py. Body operators are the same
f64 arithmetic in both packages up to operation order, so they agree to
1e-12 of their largest entry (the LU factors are compared through their
solves: pivoting may differ)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.bodies import bodies as jbd
from skellysim_tpu.fibers import container as jfc
from skellysim_tpu.periphery.precompute import precompute_body as jprecompute
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.bodies import bodies as tbd
from skellysim_tpu_torch.params import Params
from skellysim_tpu_torch.periphery.precompute import precompute_body
from skellysim_tpu_torch.system import System
from skellysim_tpu_torch.utils import quaternion as tquat
from skellysim_tpu.utils import quaternion as jquat


def _leaves(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


def _close(a, b, tol=1e-12):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def pair():
    """Two sphere bodies (200 nodes) in one bucket, rotated and moved, one
    oscillatory, with two nucleation sites each."""
    pre = jprecompute("sphere", 200, radius=0.5)
    q = np.array([[0.9, 0.1, -0.3, 0.2], [1.0, 0.0, 0.0, 0.0]])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    sites = np.array([[[0.0, 0.0, 0.5], [0.5, 0.0, 0.0]],
                      [[0.0, 0.5, 0.0], [0.0, 0.0, -0.5]]])
    kw = dict(position=np.array([[0.3, -0.2, 0.1], [-1.5, 0.4, 0.9]]),
              orientation=q, nucleation_sites_ref=sites,
              external_force=np.array([[0.0, 0.0, 1.0], [0.5, 0.0, 0.0]]),
              external_torque=np.array([[0.1, 0.0, 0.0], [0.0, 0.0, 0.3]]),
              ext_force_type=np.array([0, 1], dtype=np.int32),
              osc_amplitude=np.array([0.0, 2.0]),
              osc_omega=np.array([0.0, 2 * np.pi]),
              osc_phase=np.array([0.0, 0.3]), radius=0.5, kind="sphere")
    jg = jbd.make_group(np.stack([pre["node_positions_ref"]] * 2),
                        np.stack([pre["node_normals_ref"]] * 2),
                        np.stack([pre["node_weights"]] * 2), **kw)
    tg = convert.bodies_from_numpy(_leaves(jg), device="cpu")
    return jg, tg


def test_precompute_body_matches_jax():
    for shape, kw in (("sphere", dict(radius=0.5)),
                      ("ellipsoid", dict(a=0.6, b=0.3, c=0.4))):
        j = jprecompute(shape, 120, **kw)
        t = precompute_body(shape, 120, **kw)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-13, atol=1e-15)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = rng.standard_normal((2, 5, 4))
    phi = rng.standard_normal((5, 3))
    phi[0] = 0.0
    t = torch.as_tensor
    _close(tquat.multiply(t(q1), t(q2)), jquat.multiply(q1, q2))
    _close(tquat.rotation_matrix(t(q1)), jquat.rotation_matrix(q1))
    _close(tquat.from_rotation_vector(t(phi)), jquat.from_rotation_vector(phi))
    _close(tquat.normalize(t(q1)), jquat.normalize(q1))


def test_update_cache_and_operators_match_jax(pair):
    """place / update_cache (K, singularity vectors, lab frame), matvec,
    apply_preconditioner (through the LU solves, f64 and f32 factors),
    update_RHS, flow (stresslet + COM Stokeslet + rotlet) and the
    oscillatory force schedule at 1e-12."""
    jg, tg = pair
    eta = 0.9
    jc, tc = jbd.update_cache(jg, eta), tbd.update_cache(tg, eta)
    for k in ("nodes", "normals", "nucleation_sites", "K", "ex", "ey", "ez"):
        _close(getattr(tc, k), getattr(jc, k))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3 * 200 + 6))
    v = rng.standard_normal((2, 200, 3))
    _close(tbd.matvec(tg, tc, torch.as_tensor(x), torch.as_tensor(v)),
           jbd.matvec(jg, jc, jnp.asarray(x), jnp.asarray(v)))
    _close(tbd.apply_preconditioner(tg, tc, torch.as_tensor(x)),
           jbd.apply_preconditioner(jg, jc, jnp.asarray(x)), tol=1e-10)
    jc32 = jbd.update_cache(jg, eta, precond_dtype=jnp.float32)
    tc32 = tbd.update_cache(tg, eta, precond_dtype=torch.float32)
    assert tc32.lu.dtype == torch.float32
    _close(tbd.apply_preconditioner(tg, tc32, torch.as_tensor(x)),
           jbd.apply_preconditioner(jg, jc32, jnp.asarray(x)), tol=1e-4)
    _close(tbd.update_RHS(tg, torch.as_tensor(v)),
           jbd.update_RHS(jg, jnp.asarray(v)))
    for time in (0.0, 0.37):
        _close(tbd.external_forces_torques(tg, time),
               jbd.external_forces_torques(jg, jnp.asarray(time)))
    trg = np.concatenate([np.asarray(jc.nodes).reshape(-1, 3)[:50],
                          rng.uniform(-2, 2, (30, 3))])
    ft = rng.standard_normal((2, 6))
    _close(tbd.flow(tg, tc, torch.as_tensor(trg), torch.as_tensor(x),
                    torch.as_tensor(ft), eta),
           jbd.flow(jg, jc, jnp.asarray(trg), jnp.asarray(x), jnp.asarray(ft),
                    eta))


def test_link_conditions_step_and_repin_match_jax(pair):
    """link_conditions (the per-body force/torque sum is `index_add_`),
    the quaternion step and repin_to_bodies vs JAX at 1e-12, with fibers
    bound to both bodies' sites and one free fiber."""
    jg, tg = pair
    rng = np.random.default_rng(4)
    t = np.linspace(0, 1, 16)
    d = rng.standard_normal((4, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = rng.uniform(-1, 1, (4, 1, 3)) + 0.6 * t[None, :, None] * d[:, None]
    jf = jfc.make_group(x, lengths=0.6, bending_rigidity=0.01,
                        radius=0.0125, binding_body=np.array([0, 1, 1, -1]),
                        binding_site=np.array([1, 0, 1, -1]))
    tf = convert.group_from_numpy(_leaves(jf), device="cpu")
    jcache = jfc.update_cache(jf, 0.01, 1.0)
    from skellysim_tpu_torch.fibers import container as tfc
    tcache = tfc.update_cache(tf, 0.01, 1.0)
    jbc, tbc = jbd.update_cache(jg, 1.0), tbd.update_cache(tg, 1.0)
    sol = rng.standard_normal((4, 64))
    xb = rng.standard_normal((2, 606))
    jv, jft = jbd.link_conditions(jg, jbc, jbd.local_binding(jf, jg, 2),
                                  jcache, jnp.asarray(sol), jnp.asarray(xb))
    tv, tft = tbd.link_conditions(tg, tbc, tbd.local_binding(tf, tg, 2),
                                  tcache, torch.as_tensor(sol),
                                  torch.as_tensor(xb))
    _close(tv, jv)
    _close(tft, jft)
    assert np.abs(tv[3].numpy()).max() == 0.0
    jstep = jbd.step(jg, jnp.asarray(xb), 0.05)
    tstep = tbd.step(tg, torch.as_tensor(xb), 0.05)
    for k in ("position", "orientation", "velocity", "angular_velocity"):
        _close(getattr(tstep, k), getattr(jstep, k))
    _, _, jsites = jbd.place(jstep)
    _, _, tsites = tbd.place(tstep)
    _close(tbd.repin_to_bodies(tf, tsites, tstep).x,
           jbd.repin_to_bodies(jf, jsites, jstep).x)


def test_collisions_match_jax(pair):
    jg, tg = pair
    assert tbd.check_collision_pairwise_multi(tg, 0.0) == bool(
        jbd.check_collision_pairwise_multi(jg, 0.0))
    near = tg._replace(position=torch.tensor([[0.0, 0.0, 0.0],
                                              [0.0, 0.0, 0.8]]))
    assert tbd.check_collision_pairwise_multi((near,), 0.0)
    for radius in (1.2, 2.5):
        assert tbd.check_collision_shell_multi(tg, radius, 0.0) == bool(
            jbd.check_collision_shell_multi(jg, radius, 0.0))


def test_body_const_force_stokes_drag():
    """The reference's gate (tests/test_bodies.py): a 600-node sphere under
    a constant force moves at F / (6 pi eta r_eff) to < 1e-6, in "full"
    precision on the CPU."""
    eta, force = 0.9, 1.5
    pre = precompute_body("sphere", 600, radius=0.5)
    r_eff = np.linalg.norm(pre["node_positions_ref"][0])
    group = tbd.make_group(pre["node_positions_ref"], pre["node_normals_ref"],
                           pre["node_weights"], radius=0.5, kind="sphere",
                           external_force=[0.0, 0.0, force])
    system = System(Params(eta=eta, dt_initial=0.1, t_final=0.3,
                           gmres_tol=1e-10, adaptive_timestep_flag=False,
                           solver_precision="full"), device="cpu")
    state = system.make_state(bodies=group)
    z0, t0 = float(state.bodies.position[0, 2]), state.time
    state = system.run(state)
    v = (float(state.bodies.position[0, 2]) - z0) / (state.time - t0)
    rel_err = abs(1 - v / (force / (6 * math.pi * eta * r_eff)))
    assert rel_err < 1e-6, rel_err
