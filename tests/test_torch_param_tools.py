"""The port's config samplers against the JAX package's.

`skellysim_tpu_torch.config.param_tools` (all nine samplers and `r_surface`)
and `config.schema.perturbed_fiber_positions` are numpy only: on the cases
of `tests/test_config.py` (the helix, the sphere grid, the line, the closed
circle, the perturbed fiber), each with the same `numpy.random.Generator`
seed in both packages, every output equals the JAX function's within 1e-14
of its largest entry (the two are the same numpy arithmetic). The JAX
tests' physical oracles hold too, through the port.
"""

import numpy as np
import pytest

from skellysim_tpu.config import param_tools as jpt
from skellysim_tpu.config import perturbed_fiber_positions as j_perturbed
from skellysim_tpu_torch.config import param_tools as tpt
from skellysim_tpu_torch.config import perturbed_fiber_positions

TOL = 1e-14


def helix(t):
    t = np.asarray(t, dtype=float)
    return np.stack([np.cos(t), np.sin(t), 0.5 * t])


def line(t):
    t = np.asarray(t, dtype=float)
    return np.stack([2.0 * t, np.zeros_like(t), np.zeros_like(t)])


def circle(t):
    t = np.asarray(t, dtype=float)
    return np.stack([np.cos(t), np.sin(t), np.zeros_like(t)])


def sphere_surf(t, u):
    return np.stack([np.cos(t) * np.sin(u), np.sin(t) * np.sin(u), np.cos(u)])


def _helix_data():
    t = np.linspace(0, 4 * np.pi, 2000)
    return t, helix(t)


def _sphere_data():
    tg = np.linspace(0, 2 * np.pi, 160)
    ug = np.linspace(0, np.pi, 80)
    T, U = np.meshgrid(tg, ug)
    return T, U, sphere_surf(T, U)


# name -> (call(module, rng), physical oracle on the port's result or None)
CASES = {
    "arc_cumulative": (
        lambda m, rng: m.arc_cumulative(helix, 0, 4 * np.pi, precision=4000),
        None),
    "arc_length": (
        lambda m, rng: m.arc_length(helix, 0, 4 * np.pi, precision=4000),
        lambda L: abs(L - 4 * np.pi * np.sqrt(1.25)) / L < 1e-4),
    "r_arc": (
        lambda m, rng: m.r_arc(500, helix, 0, 4 * np.pi, rng=rng),
        lambda out: (out[0].shape == (3, 500)
                     and abs(out[1].mean() - 2 * np.pi) / (2 * np.pi) < 0.1)),
    "surface_area": (
        lambda m, rng: m.surface_area(sphere_surf, 0, 2 * np.pi, 0, np.pi,
                                      t_precision=60, u_precision=40),
        lambda a: abs(a - 4 * np.pi) / (4 * np.pi) < 5e-3),
    "arc_cumulator": (
        lambda m, rng: m.arc_cumulator(*_helix_data()),
        lambda out: abs(out[1][-1] - 4 * np.pi * np.sqrt(1.25))
        / (4 * np.pi * np.sqrt(1.25)) < 1e-4),
    "arc_cumulator:uniform_grid": (
        lambda m, rng: m.arc_cumulator(None, _helix_data()[1]), None),
    "r_arc_from_data": (
        lambda m, rng: m.r_arc_from_data(800, *_helix_data(), rng=rng),
        lambda out: (out[0].shape == (3, 800) and np.allclose(
            np.hypot(out[0][0], out[0][1]), 1.0, atol=1e-3))),
    "r_arc_from_data:no_interp": (
        lambda m, rng: m.r_arc_from_data(800, *_helix_data(), interp=False,
                                         rng=rng), None),
    "sample_to_arc:line": (
        lambda m, rng: m.sample_to_arc(np.array([-3.0, -1.0, 0.0, 0.5, 2.0]),
                                       line),
        lambda out: np.allclose(out[1], np.array([-3.0, -1.0, 0.0, 0.5, 2.0])
                                / 2.0, atol=1e-4)),
    "sample_to_arc:helix": (
        lambda m, rng: m.sample_to_arc(np.array([1.0, 5.0]), helix),
        lambda out: np.allclose(out[1], np.array([1.0, 5.0]) / np.sqrt(1.25),
                                rtol=1e-3)),
    "sample_to_arc:t0": (
        lambda m, rng: m.sample_to_arc(np.array([0.0]), line, t0=1.5),
        lambda out: np.allclose(out[1], [1.5], atol=1e-4)),
    "sample_to_arc:closed_curve": (
        lambda m, rng: m.sample_to_arc(np.array([1.0, 4.0]), circle,
                                       precision=4000),
        lambda out: np.allclose(out[1], [1.0, 4.0], rtol=1e-4)),
    "surface_cumulator": (
        lambda m, rng: m.surface_cumulator(*_sphere_data()),
        lambda out: abs(out[2][-1] - 4 * np.pi) / (4 * np.pi) < 5e-3),
    "r_surface_from_data": (
        lambda m, rng: m.r_surface_from_data(3000, *_sphere_data(), rng=rng),
        lambda out: (out[0].shape == (3, 3000) and np.allclose(
            np.linalg.norm(out[0], axis=0), 1.0, atol=2e-3))),
    "r_surface_from_data:no_interp": (
        lambda m, rng: m.r_surface_from_data(300, *_sphere_data(),
                                             interp=False, rng=rng), None),
    "r_surface": (
        lambda m, rng: m.r_surface(400, sphere_surf, 0, 2 * np.pi, 0, np.pi,
                                   rng=rng),
        lambda out: np.allclose(np.linalg.norm(out[0], axis=0), 1.0,
                                atol=1e-12)),
}


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_matches_jax(name):
    """The same call with the same seed in both packages: the same arrays
    (exact up to TOL), and the JAX test's oracle through the port."""
    call, oracle = CASES[name]
    got = call(tpt, np.random.default_rng(11))
    ref = call(jpt, np.random.default_rng(11))
    got_l, ref_l = _flat(got), _flat(ref)
    assert len(got_l) == len(ref_l)
    for g, r in zip(got_l, ref_l):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL * max(
            1.0, float(np.abs(r).max(initial=0.0))))
    if oracle is not None:
        assert oracle(got)


def test_every_jax_sampler_has_a_case():
    """Every public function of the JAX module has a case above and a
    counterpart in the port."""
    public = {n for n, v in vars(jpt).items() if not n.startswith("_")
              and callable(v) and v.__module__ == jpt.__name__}
    assert len(public) == 10
    assert public == {k.split(":")[0] for k in CASES}
    assert all(callable(getattr(tpt, n, None)) for n in public)


@pytest.mark.parametrize("ortho", [None, [1.0, 0.0, 0.0]])
def test_perturbed_fiber_positions_match_jax(ortho):
    """`perturbed_fiber_positions` (exported from `config`) draws the same
    orthogonal direction and places the same nodes as the JAX function;
    the JAX test's arc-length oracle holds."""
    args = (0.05, 1.0, np.array([1.0, 1.0, 1.0]), np.array([0.0, 0.0, 1.0]),
            64)
    got = perturbed_fiber_positions(*args, ortho=ortho,
                                    rng=np.random.default_rng(0))
    ref = j_perturbed(*args, ortho=ortho, rng=np.random.default_rng(0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert got.shape == (64, 3)
    seg = np.linalg.norm(np.diff(got, axis=0), axis=1)
    assert abs(seg.sum() - 1.0) < 1e-3 and seg.std() / seg.mean() < 1e-2
