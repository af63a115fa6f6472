"""Chebyshev spectral machinery for the experimental spectral fiber.

The port's copy of `skellysim_tpu.fibers.chebyshev`, the counterpart of
the reference's header-only Chebyshev toolkit
(`include/skelly_chebyshev.hpp:27-384`, itself a port of David Stein's
FiberTets.jl): quadrature points (reversed Chebyshev order), Vandermonde
transforms between coefficient (c) and node (n) space, spectral
derivative/integration matrices, dealiased products, and Clenshaw
evaluation.

The matrix builders run in float64 numpy and are cached; the vector
operations are torch, on the vector's device, and differentiable, so
`torch.func.jacfwd` through them gives the reference's autodiff Jacobian.
Each cached matrix goes onto a device once (`_on`), not once a call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# representation tags (`skelly_chebyshev.hpp:36` REPR enum)
C = "c"
N = "n"


def chebyshev_ratio(lb: float, ub: float) -> float:
    return (ub - lb) / 2.0


def chebyshev_points(order: int, lb: float = -1.0, ub: float = 1.0) -> np.ndarray:
    """Chebyshev points in reversed-traditional order, optionally scaled to
    [lb, ub] (`ChebyshevTPoints`, `skelly_chebyshev.hpp:68-84`)."""
    thetas = np.pi / 2.0 * (2.0 * np.linspace(order, 1.0, order) - 1.0) / order
    x = np.cos(thetas)
    if (lb, ub) == (-1.0, 1.0):
        return x
    return (x + 1.0) * chebyshev_ratio(lb, ub) + lb


def vander(x: np.ndarray, n: int) -> np.ndarray:
    """Chebyshev Vandermonde with columns T_0..T_n at points x
    (`vander_julia_chebyshev`, `skelly_chebyshev.hpp:90-102`)."""
    x = np.asarray(x, dtype=np.float64)
    A = np.empty((x.size, n + 1))
    A[:, 0] = 1.0
    if n > 0:
        A[:, 1] = x
        for i in range(2, n + 1):
            A[:, i] = 2.0 * x * A[:, i - 1] - A[:, i - 2]
    return A


def _frozen(a: np.ndarray) -> np.ndarray:
    """Cached builders hand out read-only arrays: a caller mutating the
    result would otherwise poison the cache process-wide. Callers that need
    to edit (e.g. zeroing the integration matrix's T_0 row) must copy."""
    a.setflags(write=False)
    return a


@lru_cache(maxsize=None)
def vandermonde(order: int) -> np.ndarray:
    return _frozen(vander(chebyshev_points(order), order - 1))


@lru_cache(maxsize=None)
def inverse_vandermonde(order: int) -> np.ndarray:
    return _frozen(np.linalg.inv(vandermonde(order)))


def toggle_representation_matrix(op: np.ndarray, op_in: str, op_out: str,
                                 req_in: str, req_out: str) -> np.ndarray:
    """Re-express an operator between c/n input/output spaces
    (`ToggleRepresentation`, `skelly_chebyshev.hpp:136-155`)."""
    nop = np.asarray(op, dtype=np.float64)
    if op_in == C and req_in == N:
        nop = nop @ inverse_vandermonde(nop.shape[1])
    elif op_in == N and req_in == C:
        nop = nop @ vandermonde(nop.shape[1])
    if op_out == C and req_out == N:
        nop = vandermonde(nop.shape[0]) @ nop
    elif op_out == N and req_out == C:
        nop = inverse_vandermonde(nop.shape[0]) @ nop
    return nop


def derivative_coeffs(p: np.ndarray) -> np.ndarray:
    """d/dx of a Chebyshev series in coefficient space
    (`derivative_julia_chebyshev`, `skelly_chebyshev.hpp:162-187`; equals
    numpy's chebder)."""
    q = np.array(p[1:], dtype=np.float64)
    n = q.size
    der = np.zeros(n)
    for j in range(n, 2, -1):
        der[j - 1] = 2.0 * j * q[j - 1]
        q[j - 3] += j * q[j - 1] / (j - 2)
    if n > 1:
        der[1] = 4.0 * q[1]
    if n > 0:
        der[0] = q[0]
    return der


def nth_derivative_of_Tn(n: int, D: int) -> np.ndarray:
    """Coefficients of the D-th derivative of T_n
    (`NthDerivativeOfChebyshevTn`, `skelly_chebyshev.hpp:196-216`)."""
    q = np.zeros(n + 1)
    q[-1] = 1.0
    der = derivative_coeffs(q)
    for _ in range(2, D + 1):
        der = derivative_coeffs(der)
    return der


@lru_cache(maxsize=None)
def derivative_matrix(n: int, D: int, in_type: str = C, out_type: str = C,
                      scale_factor: float = 1.0) -> np.ndarray:
    """Spectral derivative matrix [n-D, n] (`DerivativeMatrix`,
    `skelly_chebyshev.hpp:219-230`)."""
    DM = np.zeros((n - D, n))
    for i in range(D, n):
        col = nth_derivative_of_Tn(i, D)
        DM[:len(col), i] = col[:n - D]
    DM = DM * scale_factor ** D
    return _frozen(toggle_representation_matrix(DM, C, C, in_type, out_type))


@lru_cache(maxsize=None)
def integration_matrix(order: int, in_type: str = C, out_type: str = C,
                       scale_factor: float = 1.0) -> np.ndarray:
    """Spectral integration matrix: inverse of [derivative; eval-at(-1)]
    (`IntegrationMatrix`, `skelly_chebyshev.hpp:233-242`)."""
    DMat = derivative_matrix(order, 1, C, C, scale_factor)
    VM = vander(np.array([-1.0]), order - 1)
    A = np.vstack([DMat, VM])
    return _frozen(toggle_representation_matrix(np.linalg.inv(A), C, C,
                                                in_type, out_type))


# ------------------------------------------------ runtime (torch) vector ops

@lru_cache(maxsize=None)
def _on(builder, n: int, dtype, device):
    """A cached matrix builder's ``builder(n)`` as a tensor on ``device``,
    made once a (builder, n, dtype, device)."""
    return torch.as_tensor(np.array(builder(n)), dtype=dtype, device=device)


def c2f(xc, order: int | None = None):
    """Coefficient -> node space (`C2F`)."""
    n = order or xc.shape[-1]
    return _on(vandermonde, n, xc.dtype, xc.device) @ xc


def f2c(xf, order: int | None = None):
    """Node -> coefficient space (`F2C`)."""
    n = order or xf.shape[-1]
    return _on(inverse_vandermonde, n, xf.dtype, xf.device) @ xf


def toggle(x, in_type: str, out_type: str):
    if in_type == out_type:
        return x
    return f2c(x) if in_type == N else c2f(x)


def resize(x, n: int, in_type: str, out_type: str):
    """Pad/truncate a series in coefficient space (`Resize`,
    `skelly_chebyshev.hpp:307-323`)."""
    wx = toggle(x, in_type, C)
    m = wx.shape[-1]
    if n > m:
        wx = torch.cat([wx, wx.new_zeros(n - m)])
    else:
        wx = wx[:n]
    return toggle(wx, C, out_type)


def multiply(x, y, xt: str, yt: str, xyt: str, n_out: int | None = None,
             nm: int | None = None):
    """Dealiased pointwise product of two series (`Multiply`,
    `skelly_chebyshev.hpp:326-340`): upsample to nm nodes, multiply, resize."""
    nin = max(x.shape[-1], y.shape[-1])
    n_out = n_out if n_out is not None else nin
    nm = nm if nm is not None else 2 * nin
    xr = resize(x, nm, xt, N)
    yr = resize(y, nm, yt, N)
    return resize(xr * yr, n_out, N, xyt)


def evalpoly(x, ch):
    """Clenshaw evaluation of a Chebyshev series at scalar x (`evalpoly`,
    `skelly_chebyshev.hpp:343-356`)."""
    c0 = ch[-2]
    c1 = ch[-1]
    for i in range(ch.shape[-1] - 3, -1, -1):
        c0, c1 = ch[i] - c1, c0 + c1 * 2.0 * x
    return c0 + c1 * x


def left_eval(ch):
    return evalpoly(-1.0, ch)


def right_eval(ch):
    return evalpoly(1.0, ch)
