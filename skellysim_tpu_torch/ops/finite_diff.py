"""Host-side numerics: Fornberg finite-difference weights and barycentric resampling.

These build the static differentiation/downsampling matrices cached per fiber
resolution; they run once at program start in NumPy (float64) and are then
copied to device tensors (`fibers.matrices.torch_mats`). A copy of
`skellysim_tpu.ops.finite_diff` (the port imports nothing of the JAX
package). Mirrors `utils::finite_diff` and
`utils::barycentric_matrix` (the reference `src/core/utils.cpp:12-105`), which
follow Fornberg, SIAM Rev. 40(3), 685 (1998) and the standard barycentric
interpolation formula.
"""

from __future__ import annotations

import numpy as np


def finite_diff(s: np.ndarray, M: int, n_s: int) -> np.ndarray:
    """Mth-derivative matrix on grid points ``s`` using ``n_s``-point stencils.

    Interior rows use centered stencils; rows near the ends fall back to one-sided
    stencils over the first/last ``n_s`` points, matching the reference's windowing
    (`src/core/utils.cpp:54-68`).
    """
    s = np.asarray(s, dtype=np.float64)
    npts = s.size
    if npts < n_s:
        raise ValueError(
            f"finite_diff needs at least n_s={n_s} grid points for an order-{M} "
            f"derivative with this stencil, got {npts}"
        )
    D = np.zeros((npts, npts))
    n_half = (n_s - 1) // 2
    n_s = n_s - 1

    for xi in range(npts):
        si = s[xi]
        if xi < n_half:
            xlow, xhigh = 0, n_s + 1
        elif xi > npts - n_half - 2:
            xlow, xhigh = npts - n_s - 1, npts
        else:
            xlow, xhigh = xi - n_half, xi - n_half + n_s + 1

        x = s[xlow:xhigh]

        # Fornberg's recursion for the weights of all derivatives up to order M
        c1 = 1.0
        c4 = x[0] - si
        c = np.zeros((n_s + 1, M + 1))
        c[0, 0] = 1.0
        for i in range(1, n_s + 1):
            mn = min(i, M)
            c2 = 1.0
            c5 = c4
            c4 = x[i] - si
            for j in range(i):
                c3 = x[i] - x[j]
                c2 = c2 * c3
                if j == i - 1:
                    for k in range(mn, 0, -1):
                        c[i, k] = c1 * (k * c[i - 1, k - 1] - c5 * c[i - 1, k]) / c2
                    c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
                for k in range(mn, 0, -1):
                    c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
                c[j, 0] = c4 * c[j, 0] / c3
            c1 = c2
        D[xi, xlow:xlow + n_s + 1] = c[:, M]

    return D


def barycentric_matrix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Resampling matrix P mapping values on grid ``x`` (size N) to grid ``y`` (size M).

    Uses the trapezoidal barycentric weights of the reference
    (`src/core/utils.cpp:12-36`): w = [0.5, -1, 1, ..., -0.5*(-1)^N].
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    N, M = x.size, y.size

    w = np.ones(N)
    w[1::2] = -1.0
    w[0] = 0.5
    w[N - 1] = -0.5 * (-1.0) ** N

    P = np.zeros((M, N))
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(M):
            diff = y[j] - x
            terms = w / diff
            S = terms.sum()
            P[j] = np.where(np.abs(diff) > np.finfo(np.float64).eps, terms / S, 1.0)
    return P
