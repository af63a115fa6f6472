"""Uniform random sampling on parametric surfaces.

The port's own copy of the part of `skellysim_tpu.config.param_tools` the
config schema uses (`r_surface` and what it calls): numpy only, the same
draws in the same order, so the same `numpy.random.default_rng` seed places
fibers exactly where the JAX package does.
"""

from __future__ import annotations

import numpy as np


def _area_elements(func, t0, t1, u0, u1, t_precision, u_precision):
    """Midpoint-rule area elements |x_t x x_u| dt du on a (t, u) grid."""
    t_edges = np.linspace(t0, t1, t_precision + 1)
    u_edges = np.linspace(u0, u1, u_precision + 1)
    tm = 0.5 * (t_edges[:-1] + t_edges[1:])
    um = 0.5 * (u_edges[:-1] + u_edges[1:])
    dt = t_edges[1] - t_edges[0]
    du = u_edges[1] - u_edges[0]
    T, U = np.meshgrid(tm, um, indexing="ij")
    eps_t = 1e-6 * (t1 - t0)
    eps_u = 1e-6 * (u1 - u0)
    x_t = (np.asarray(func(T + eps_t, U))
           - np.asarray(func(T - eps_t, U))) / (2 * eps_t)
    x_u = (np.asarray(func(T, U + eps_u))
           - np.asarray(func(T, U - eps_u))) / (2 * eps_u)
    dA = np.linalg.norm(np.cross(x_t, x_u, axis=0), axis=0) * dt * du
    return tm, um, dA


def r_surface(n: int, func, t0, t1, u0, u1, t_precision: int = 100,
              u_precision: int = 100, rng: np.random.Generator | None = None):
    """Sample n points uniformly by area on the surface func(t, u) ->
    (3, ...). Returns (coords[3, n], t[n], u[n])."""
    rng = rng or np.random.default_rng()
    tm, um, dA = _area_elements(func, t0, t1, u0, u1, t_precision, u_precision)
    p = dA.ravel() / dA.sum()
    cells = rng.choice(p.size, size=n, p=p)
    it, iu = np.unravel_index(cells, dA.shape)
    dt = (t1 - t0) / t_precision
    du = (u1 - u0) / u_precision
    ts = tm[it] + rng.uniform(-0.5, 0.5, n) * dt
    us = um[iu] + rng.uniform(-0.5, 0.5, n) * du
    return np.asarray(func(ts, us), dtype=float), ts, us
