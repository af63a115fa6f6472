"""Uniform random sampling on parametric curves and surfaces.

The port's own copy of `skellysim_tpu.config.param_tools` (the capability
mirror of the reference's vendored `param_tools`: `arc_cumulator`, `r_arc`,
`r_arc_from_data`, `arc_length`, `sample_to_arc`, `surface_cumulator`,
`r_surface`, `r_surface_from_data`, `surface_area`): sampling uniformly *by
arc length / surface area* via CDF inversion, in vectorized numpy (midpoint
field evaluation and `np.interp` inversion). Numpy only, the same draws in
the same order, so the same `numpy.random.Generator` seed gives the JAX
package's samples. The config schema places fibers on periphery surfaces
with `r_surface`.
"""

from __future__ import annotations

import numpy as np


def arc_cumulative(func, t0: float, t1: float, precision: int = 225):
    """Cumulative arc length of the curve func(t) -> (3, n) on [t0, t1]."""
    t = np.linspace(t0, t1, precision)
    coords = np.asarray(func(t), dtype=float)
    ds = np.linalg.norm(np.diff(coords, axis=-1), axis=0)
    return t, np.concatenate([[0.0], np.cumsum(ds)])


def arc_length(func, t0: float, t1: float, precision: int = 225) -> float:
    """Total arc length of func(t) on [t0, t1]."""
    return arc_cumulative(func, t0, t1, precision)[1][-1]


def r_arc(n: int, func, t0: float, t1: float, precision: int = 225,
          rng: np.random.Generator | None = None):
    """Sample n points uniformly by arc length on the curve func.

    Returns (coords[3, n], t[n], s[n]).
    """
    rng = rng or np.random.default_rng()
    t, cum_s = arc_cumulative(func, t0, t1, precision)
    s = rng.uniform(0.0, cum_s[-1], size=n)
    ts = np.interp(s, cum_s, t)
    return np.asarray(func(ts), dtype=float), ts, s


def _area_elements(func, t0, t1, u0, u1, t_precision, u_precision):
    """Midpoint-rule area elements |x_t × x_u| dt du on a (t, u) grid."""
    t_edges = np.linspace(t0, t1, t_precision + 1)
    u_edges = np.linspace(u0, u1, u_precision + 1)
    tm = 0.5 * (t_edges[:-1] + t_edges[1:])
    um = 0.5 * (u_edges[:-1] + u_edges[1:])
    dt = t_edges[1] - t_edges[0]
    du = u_edges[1] - u_edges[0]
    T, U = np.meshgrid(tm, um, indexing="ij")
    eps_t = 1e-6 * (t1 - t0)
    eps_u = 1e-6 * (u1 - u0)
    x_t = (np.asarray(func(T + eps_t, U)) - np.asarray(func(T - eps_t, U))) / (2 * eps_t)
    x_u = (np.asarray(func(T, U + eps_u)) - np.asarray(func(T, U - eps_u))) / (2 * eps_u)
    dA = np.linalg.norm(np.cross(x_t, x_u, axis=0), axis=0) * dt * du
    return tm, um, dA


def surface_area(func, t0, t1, u0, u1, t_precision: int = 25,
                 u_precision: int = 25) -> float:
    """Total area of the parametric surface func(t, u) -> (3, ...)."""
    return _area_elements(func, t0, t1, u0, u1, t_precision, u_precision)[2].sum()


def arc_cumulator(t, coords):
    """Cumulative arc length from sampled curve data (`param_tools.py:10-38`).

    ``coords`` is [d, n] positions at sorted parameters ``t`` (or None for a
    uniform [0, 1] grid). Returns (t, cum_s).
    """
    coords = np.asarray(coords, dtype=float)
    if t is None:
        t = np.linspace(0.0, 1.0, coords.shape[-1])
    t = np.asarray(t, dtype=float)
    if t.shape != coords.shape[1:]:
        raise ValueError("need same number of parameters as coordinates")
    ds = np.linalg.norm(np.diff(coords), axis=0)
    return t, np.concatenate([[0.0], np.cumsum(ds)])


def r_arc_from_data(n: int, t, coords, interp: bool = True,
                    rng: np.random.Generator | None = None):
    """Sample n points uniformly by arc length from curve *data*
    (`param_tools.py:41-123`). Returns (coords[d, n] if interp, t[n], s[n])."""
    rng = rng or np.random.default_rng()
    coords = np.asarray(coords, dtype=float)
    t, cum_s = arc_cumulator(t, coords)
    rand_s = rng.uniform(0.0, cum_s[-1], size=n)
    rand_t = np.interp(rand_s, cum_s, t)
    if not interp:
        return rand_t, rand_s
    rand_coords = np.stack([np.interp(rand_t, t, coords[i])
                            for i in range(coords.shape[0])])
    return rand_coords, rand_t, rand_s


def sample_to_arc(sample, func, t0: float = 0.0, precision: int = 225,
                  ub: float = 1e11):
    """Map arbitrary arc-length samples to points on the curve ``func``
    (`param_tools.py:154-234`): arc length 0 lands at parameter ``t0``,
    negative arc lengths map to parameters below it.

    Returns (sample_x [d, n], sample_t [n]).
    """
    sample = np.asarray(sample, dtype=float)
    if t0 != 0.0:
        sample = sample + arc_length(func, 0.0, t0, precision) * np.sign(t0)

    neg = sample < 0.0
    sample_t = np.empty_like(sample)

    max_pts = 1 << 22

    def converged_cum(t_lim, sign):
        """(grid, cum): arc length on [0, sign*t_lim], grid refined until the
        total converges (a fixed point count loses accuracy as t_lim grows)."""
        n = precision
        grid = np.linspace(0.0, sign * t_lim, n)
        _, cum = arc_cumulator(grid, np.atleast_2d(
            np.asarray(func(grid), dtype=float)))
        while n < max_pts:
            n = 2 * n
            grid2 = np.linspace(0.0, sign * t_lim, n)
            _, cum2 = arc_cumulator(grid2, np.atleast_2d(
                np.asarray(func(grid2), dtype=float)))
            done = abs(cum2[-1] - cum[-1]) <= 1e-9 * max(cum2[-1], 1e-300)
            grid, cum = grid2, cum2
            if done:
                break
        return grid, cum

    def one_sided(s_abs, sign):
        """Invert |arc length| -> t on one side of t=0."""
        s_max = s_abs.max()
        # grow the parameter range until the cumulative arc length covers
        # s_max (chord-based bracketing as in the reference fails on closed
        # curves, whose chord is bounded by the diameter)
        t_lim = max(s_max, 1e-6)
        while True:
            grid, cum = converged_cum(t_lim, sign)
            if cum[-1] >= s_max:
                return sign * np.interp(s_abs, cum, sign * grid)
            if t_lim >= ub:
                raise ValueError(f"curve does not reach arc length {s_max} "
                                 f"within parameter {ub}")
            t_lim = min(2.0 * t_lim, ub)

    if neg.any():
        sample_t[neg] = one_sided(np.abs(sample[neg]), -1.0)
    if (~neg).any():
        sample_t[~neg] = one_sided(sample[~neg], 1.0)
    return np.asarray(func(sample_t), dtype=float), sample_t


def surface_cumulator(t, u, coords):
    """Marginal cumulative surface areas from surface *data*
    (`param_tools.py:237-287`).

    ``coords`` is [d, nu, nt]; returns (t, u, cum_S_t [nt], cum_S_u [nu]) —
    the cumulative area marginalized over the other parameter.
    """
    coords = np.asarray(coords, dtype=float)
    if t is None:
        t, _ = np.meshgrid(np.linspace(0, 1, coords.shape[-1]),
                           np.linspace(0, 1, coords.shape[-2]))
    if u is None:
        _, u = np.meshgrid(np.linspace(0, 1, coords.shape[-1]),
                           np.linspace(0, 1, coords.shape[-2]))
    t = np.asarray(t, dtype=float)
    u = np.asarray(u, dtype=float)
    if not (t.shape == u.shape == coords.shape[1:]):
        raise ValueError("need same number of parameters as coordinates")

    # parallelogram areas, zero-padded on the leading edge so tiny cumulative
    # values still interpolate (`param_tools.py:274-283`)
    delta_t = np.zeros_like(coords)
    delta_u = np.zeros_like(coords)
    delta_t[:, :, 1:] = np.diff(coords, axis=2)
    delta_u[:, 1:, :] = np.diff(coords, axis=1)
    dS = np.linalg.norm(np.cross(delta_t, delta_u, axisa=0, axisb=0), axis=2)
    return t, u, np.cumsum(dS.sum(axis=0)), np.cumsum(dS.sum(axis=1))


def r_surface_from_data(n: int, t, u, coords, interp: bool = True,
                        rng: np.random.Generator | None = None):
    """Sample n points approximately uniformly by area from surface *data*
    via the marginal CDFs (`param_tools.py:290-394`).

    Returns (coords[d, n] if interp, t[n], u[n], S_t[n], S_u[n]).
    """
    rng = rng or np.random.default_rng()
    coords = np.asarray(coords, dtype=float)
    t, u, cum_S_t, cum_S_u = surface_cumulator(t, u, coords)

    rand_S_t = rng.random(n) * cum_S_t[-1]
    rand_S_u = rng.random(n) * cum_S_u[-1]
    rand_t = np.interp(rand_S_t, cum_S_t, t[0, :])
    rand_u = np.interp(rand_S_u, cum_S_u, u[:, 0])
    if not interp:
        return rand_t, rand_u, rand_S_t, rand_S_u

    # bilinear interpolation of each coordinate on the (u, t) grid
    tg, ug = t[0, :], u[:, 0]
    it = np.clip(np.searchsorted(tg, rand_t) - 1, 0, len(tg) - 2)
    iu = np.clip(np.searchsorted(ug, rand_u) - 1, 0, len(ug) - 2)
    wt = (rand_t - tg[it]) / (tg[it + 1] - tg[it])
    wu = (rand_u - ug[iu]) / (ug[iu + 1] - ug[iu])
    c00 = coords[:, iu, it]
    c01 = coords[:, iu, it + 1]
    c10 = coords[:, iu + 1, it]
    c11 = coords[:, iu + 1, it + 1]
    rand_coords = ((1 - wu) * ((1 - wt) * c00 + wt * c01)
                   + wu * ((1 - wt) * c10 + wt * c11))
    return rand_coords, rand_t, rand_u, rand_S_t, rand_S_u


def r_surface(n: int, func, t0, t1, u0, u1, t_precision: int = 100,
              u_precision: int = 100, rng: np.random.Generator | None = None):
    """Sample n points uniformly by area on the surface func(t, u) -> (3, ...).

    Returns (coords[3, n], t[n], u[n]) — same leading contract as the
    reference's `param_tools.r_surface` (coords first).
    """
    rng = rng or np.random.default_rng()
    tm, um, dA = _area_elements(func, t0, t1, u0, u1, t_precision, u_precision)
    p = dA.ravel() / dA.sum()
    cells = rng.choice(p.size, size=n, p=p)
    it, iu = np.unravel_index(cells, dA.shape)
    # jitter uniformly inside each chosen cell
    dt = (t1 - t0) / t_precision
    du = (u1 - u0) / u_precision
    ts = tm[it] + rng.uniform(-0.5, 0.5, n) * dt
    us = um[iu] + rng.uniform(-0.5, 0.5, n) * du
    return np.asarray(func(ts, us), dtype=float), ts, us
