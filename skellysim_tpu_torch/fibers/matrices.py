"""Per-resolution static fiber matrices.

Counterpart of `skellysim_tpu.fibers.matrices`: for each supported node
count, the 4th-order finite-difference matrices D1..D4 on [-1, 1], the
barycentric downsampling P_X / P_T, the combined BC downsampling operator
P_down [4n-14, 4n] and the trapezoid weights. Built once in NumPy float64,
then copied to tensors of the state's dtype and device (`torch_mats`),
cached per (n, dtype, device). `FibMatsRT` / `padded_rt_mats` are the
runtime node-padded form a capacity bucket's groups carry (`system.buckets`
node ladder): the live resolution's matrices in the top-left block of
capacity-sized tensors, so groups of different live node counts share one
node capacity.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops.finite_diff import barycentric_matrix, finite_diff

VALID_NODE_COUNTS = (8, 16, 24, 32, 48, 64, 96, 128)

#: order of the finite differencing scheme (the reference hard-codes 4)
FD_ORDER = 4


@dataclass(frozen=True)
class FibMats:
    """Static matrices for one fiber resolution (all NumPy float64)."""

    n_nodes: int
    alpha: np.ndarray          # [n] equispaced nodes on [-1, 1]
    alpha_roots: np.ndarray    # [n-4]
    alpha_tension: np.ndarray  # [n-2]
    D1: np.ndarray             # [n, n] first-derivative matrix (unscaled)
    D2: np.ndarray
    D3: np.ndarray
    D4: np.ndarray
    P_X: np.ndarray            # [n-4, n]
    P_T: np.ndarray            # [n-2, n]
    P_down: np.ndarray         # [4n-14, 4n] block-diag(P_X, P_X, P_X, P_T)
    weights0: np.ndarray       # [n] trapezoid weights on [-1, 1]


class TorchMats(NamedTuple):
    """The matrices a fiber operator reads, as tensors of one dtype/device."""

    alpha: torch.Tensor
    D1: torch.Tensor
    D2: torch.Tensor
    D3: torch.Tensor
    D4: torch.Tensor
    P_down: torch.Tensor
    weights0: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.D1.shape[0]


@lru_cache(maxsize=None)
def get_mats(n_nodes: int) -> FibMats:
    if n_nodes not in VALID_NODE_COUNTS:
        raise ValueError(f"n_nodes must be one of {VALID_NODE_COUNTS}, got {n_nodes}")
    n = n_nodes
    alpha = np.linspace(-1.0, 1.0, n)
    n_roots = n - 4
    alpha_roots = 2 * (0.5 + np.arange(n_roots)) / n_roots - 1
    n_tension = n - 2
    alpha_tension = 2 * (0.5 + np.arange(n_tension)) / n_tension - 1

    D1 = finite_diff(alpha, 1, FD_ORDER + 1)
    D2 = finite_diff(alpha, 2, FD_ORDER + 2)
    D3 = finite_diff(alpha, 3, FD_ORDER + 3)
    D4 = finite_diff(alpha, 4, FD_ORDER + 4)

    P_X = barycentric_matrix(alpha, alpha_roots)
    P_T = barycentric_matrix(alpha, alpha_tension)

    P_down = np.zeros((4 * n - 14, 4 * n))
    P_down[0 * (n - 4):1 * (n - 4), 0 * n:1 * n] = P_X
    P_down[1 * (n - 4):2 * (n - 4), 1 * n:2 * n] = P_X
    P_down[2 * (n - 4):3 * (n - 4), 2 * n:3 * n] = P_X
    P_down[3 * (n - 4):3 * (n - 4) + n_tension, 3 * n:4 * n] = P_T

    weights0 = np.full(n, 2.0)
    weights0[0] = 1.0
    weights0[-1] = 1.0
    weights0 /= n - 1

    return FibMats(n, alpha, alpha_roots, alpha_tension, D1, D2, D3, D4,
                   P_X, P_T, P_down, weights0)


@lru_cache(maxsize=None)
def torch_mats(n_nodes: int, dtype: torch.dtype,
               device: torch.device) -> TorchMats:
    """`get_mats(n_nodes)` cast to ``dtype`` on ``device`` (the f64 NumPy
    build is the single source; f32 groups get f32 matrices, never a silent
    promotion)."""
    m = get_mats(n_nodes)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return TorchMats(t(m.alpha), t(m.D1), t(m.D2), t(m.D3), t(m.D4),
                     t(m.P_down), t(m.weights0))


class FibMatsRT(NamedTuple):
    """Runtime fiber matrices of a node-capacity bucket (the JAX package's
    `FibMatsRT`, whose docstring gives the layout): capacity-sized tensors
    whose top-left block is the live resolution's; padded rows and columns
    of every derivative matrix are exact zeros, ``P_down`` carries one
    one-hot row per padded solution entry, ``e_last`` selects the last LIVE
    node (the boundary conditions' plus end) and the masks mark the live
    nodes, the live rows of the BC'd row space and the live entries of the
    [x | y | z | T] solution layout."""

    alpha: torch.Tensor      # [n_cap] live alpha prefix (pad values unused)
    D1: torch.Tensor         # [n_cap, n_cap] live block top-left, zeros pad
    D2: torch.Tensor
    D3: torch.Tensor
    D4: torch.Tensor
    P_down: torch.Tensor     # [4n_cap-14, 4n_cap]
    weights0: torch.Tensor   # [n_cap] live trapezoid weights, zeros pad
    e_last: torch.Tensor     # [n_cap] one-hot at the last live node
    node_mask: torch.Tensor  # [n_cap] bool
    row_mask: torch.Tensor   # [4n_cap] bool over [P_down rows | 14 BC rows]
    sol_mask: torch.Tensor   # [4n_cap] bool over [x | y | z | T]

    @property
    def n_nodes(self) -> int:
        return self.D1.shape[0]

    def to(self, dtype=None, device=None) -> "FibMatsRT":
        """The float tensors in ``dtype`` (masks keep bool), all on
        ``device``; ``self`` when nothing changes."""
        if ((dtype is None or self.D1.dtype == dtype)
                and (device is None or self.D1.device == torch.device(device))):
            return self
        return FibMatsRT(*[t.to(device=device,
                                dtype=dtype if t.is_floating_point()
                                else t.dtype) for t in self])


def padded_rt_mats(n_live: int, n_cap: int, dtype=torch.float64,
                   device="cpu") -> FibMatsRT:
    """`FibMatsRT` for ``n_live`` live nodes in an ``n_cap`` bucket
    (``n_live == n_cap`` is valid: runtime mats with no padded rows); both
    counts must be in `VALID_NODE_COUNTS`."""
    if n_live > n_cap:
        raise ValueError(f"n_live {n_live} exceeds node capacity {n_cap}")
    live = get_mats(n_live)
    if n_cap not in VALID_NODE_COUNTS:
        raise ValueError(
            f"node capacity must be one of {VALID_NODE_COUNTS}, got {n_cap}")
    nl, nc = n_live, n_cap
    pad = nc - nl

    def pad_mat(m):
        out = np.zeros((nc, nc))
        out[:nl, :nl] = m
        return out

    alpha = np.zeros(nc)
    alpha[:nl] = live.alpha
    weights0 = np.zeros(nc)
    weights0[:nl] = live.weights0
    e_last = np.zeros(nc)
    e_last[nl - 1] = 1.0
    node_mask = np.zeros(nc, dtype=bool)
    node_mask[:nl] = True

    # per solution block (x, y, z, T): the live downsample rows, then one
    # one-hot row per padded entry
    P = np.zeros((4 * nc - 14, 4 * nc))
    row_mask = np.ones(4 * nc, dtype=bool)
    r = 0
    for b, (blk, nrow) in enumerate(
            [(live.P_X, nl - 4)] * 3 + [(live.P_T, nl - 2)]):
        P[r:r + nrow, b * nc:b * nc + nl] = blk
        r += nrow
        for j in range(pad):
            P[r, b * nc + nl + j] = 1.0
            row_mask[r] = False
            r += 1
    assert r == 4 * nc - 14

    def t(a, d=dtype):
        return torch.as_tensor(a, dtype=d, device=device)

    return FibMatsRT(
        alpha=t(alpha), D1=t(pad_mat(live.D1)), D2=t(pad_mat(live.D2)),
        D3=t(pad_mat(live.D3)), D4=t(pad_mat(live.D4)), P_down=t(P),
        weights0=t(weights0), e_last=t(e_last),
        node_mask=t(node_mask, torch.bool), row_mask=t(row_mask, torch.bool),
        sol_mask=t(np.tile(node_mask, 4), torch.bool))
