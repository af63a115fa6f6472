"""Barycentric Lagrange treecode: the hierarchical O(N log N) pair sums.

Counterpart of `skellysim_tpu.ops.treecode` (the runtime evaluator
"tree"): source clusters are compressed onto tensor-product Chebyshev grids
by barycentric Lagrange anterpolation, and well-separated clusters are
summed through the same pair kernel as the near field. The mathematics (the
fixed-depth octree over a cubic box, the index-based interaction lists, the
calibrated order rule) is documented in the JAX module and pinned there by
`tests/test_treecode.py`.

* `plan_tree` is host numpy and gives the JAX package's plan field for
  field; the static geometry (`_vlists`, `_interaction_lists`,
  `_neighbor_table`, `_transfer_np`) is the JAX package's, copied.
* `_bucket` and `_upward` (the leaf anterpolation and the child -> parent
  transfers) are plain tensor code on every device, as the JAX package
  runs them in plain XLA: a stable sort, scatters and batched products.
* The near and far pair sums run as ONE pass over per-target-leaf lists of
  source segments (`_segment_lists`): items of a target leaf's
  leaf-sorted targets against (start, length) runs of one source array
  that holds the bucketed sources and the proxies. On the card the pass is
  kernel G (Stokeslet) or H (stresslet), ``csrc/tree_sums.cu``
  (`ops.cuda_kernels.tree_stokeslet_f32` and its siblings); on the CPU it
  is their plain twin. A segment holds only a bucket's real slots, and a
  cell with no source below it gets no far segment: both add exact zeros
  in the JAX package's padded rows, so the sums agree up to summation
  order (ROADMAP.md §3, differences by design).
* What depends on the positions alone (the sort and bucket slots, the
  leaf anterpolation weights, the source array's positions, the lists) is
  a `TreeGeometry` (`tree_geometry`), which the step's
  `ops.evaluator.PairEvaluator` keeps for every later sum over the same
  positions; a sum then runs only its payload's part (`tree_payload`: the
  buckets' scatter, the anterpolation product, the transfers) and the
  pass, with no host sync. The JAX package rebuilds all of it inside every
  jitted matvec (ROADMAP.md §3).
* `oseen_tree`, which no flow calls and no kernel serves, runs the same
  lists through the plain twin's pair expansion with its own pair terms
  (the regularized Oseen near, the Stokeslet far).

``depth == 0`` plans are the dense sum: `ops.evaluator.PairEvaluator`
sends them to the dense seam (`ops.kernels`; kernel A / B / C / D on the
card) at the calling flow's tier. The plan's one anchor (``box_lo``)
enters as a [1, 3] tensor made once a plan by `ops.evaluator.make_pair`.

Chunking bounds memory, not the result beyond summation order:
`_ANTERP_BUDGET` caps the elements of one anterpolation weight tile
([leaves, slots, p^3]), set for an 80 GB card (the JAX package's budget,
3M, was set for TPU memory: at depth 5 and p = 6 its unchunked weights
would be 32,768 x 312 x 216 values); `_WEIGHTS_BUDGET` caps the weights a
geometry keeps (the rest are recomputed each sum, the same bits).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache, partial

import numpy as np
import torch

from ..obs.profile import phase
from . import kernels
from .ewald import _R2_ALPHAS, _ladder

__all__ = ["TreePlan", "plan_tree", "order_for_tol", "stokeslet_tree",
           "stresslet_tree", "oseen_tree", "fill_positions"]

#: the runtime evaluator name whose plans this module owns
EVALUATOR = "tree"
#: the plan's anchor fields, in the order of `ops.evaluator.make_pair`'s
#: anchor rows, and the row `fill_positions` is placed from
ANCHORS = ("box_lo",)
FILL_ANCHOR = 0


# ---------------------------------------------------------------------- plan

@dataclass(frozen=True)
class TreePlan:
    """Static tree geometry and resolution (the JAX package's `TreePlan`,
    field for field). Built on the host by `plan_tree`; ``depth == 0`` is
    the degenerate one-cell tree that dispatches to the dense sums."""

    depth: int       # leaf level L; 8^L leaves (0 = dense fallback)
    order: int       # p: Chebyshev points per dimension (p^3 per cluster)
    box_lo: tuple    # root-box lower corner
    box_L: float     # root-box edge (ladder-quantized)
    max_occ: int     # static per-leaf bucket capacity
    tol: float       # target field-normalized relative accuracy

    @property
    def n_leaves(self) -> int:
        return 8 ** self.depth

    @property
    def leaf_size(self) -> float:
        return self.box_L / (2 ** self.depth)


def fill_positions(plan: TreePlan, box_lo, n, dtype):
    """[n, 3] well-spread positions inside the root box (the R2 lattice),
    on the device of ``box_lo``, for inactive nodes whose strengths are
    zero: piled into one leaf they would pass its capacity."""
    t = torch.arange(n, dtype=dtype, device=box_lo.device) + 0.5
    # the constants as scalars: no host-to-device copy on a matvec's path
    frac = torch.remainder(torch.stack([t * a for a in _R2_ALPHAS], dim=1),
                           1.0)
    return box_lo.to(dtype) + frac * (0.999 * plan.box_L)


def _fill_positions_np(box_lo, box_L, n):
    """NumPy mirror of `fill_positions` for host-side occupancy counting."""
    t = (np.arange(n, dtype=np.float64) + 0.5)[:, None]
    frac = (t * np.asarray(_R2_ALPHAS)[None, :]) % 1.0
    return np.asarray(box_lo) + frac * (0.999 * box_L)


#: the JAX package's calibrated error contraction per interpolation order
#: (err(p) ~ 0.05 * 5^-(p-2), see its `order_for_tol`)
_ACC_BASE = 5.0
_ACC_C0 = 0.05


def order_for_tol(tol: float, max_order: int = 12) -> int:
    """Interpolation order p for a target relative accuracy (calibrated)."""
    p = 2 + math.ceil(math.log(max(_ACC_C0 / tol, 1.0)) / math.log(_ACC_BASE))
    return int(min(max(p, 2), max_order))


#: host plans and kept-geometry misses so far in this process (the audit's
#: retrace probe counts them: `audit.registry.rebuild_counts`)
REBUILDS = {"plan_tree": 0, "tree_geometry_miss": 0}


def plan_tree(points, tol=1e-4, target_occ=32.0, max_depth=5, n_fill=0,
              max_order=12):
    """Choose (depth, order, box, leaf capacity) for a target relative
    accuracy: the JAX package's `plan_tree`, rule for rule (its docstring
    gives the rules), on the host in numpy. ``n_fill`` reserves occupancy
    for that many zero-strength padding nodes placed by `fill_positions`."""
    REBUILDS["plan_tree"] += 1
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    extent = max(float((hi - lo).max()), 1e-3)
    N = len(pts) + int(n_fill)
    N_q = max(1, 2 ** math.ceil(math.log2(max(N, 1))))

    depth = math.ceil(math.log(max(N_q / target_occ, 1.0)) / math.log(8.0))
    depth = min(depth, max_depth)
    if depth < 2:
        return TreePlan(depth=0, order=order_for_tol(tol, max_order),
                        box_lo=(float(lo[0]), float(lo[1]), float(lo[2])),
                        box_L=_ladder(extent, 1e-3), max_occ=1,
                        tol=float(tol))

    order = order_for_tol(tol, max_order)
    L_box = _ladder(extent / (1.0 - 2.0 ** -depth) + 1e-9, 1e-3)
    cell = L_box / (2 ** depth)
    box_lo = tuple(float(cell * math.floor(a / cell)) for a in lo)

    C = 2 ** depth
    ci = np.clip(((pts - np.asarray(box_lo)) / cell).astype(int), 0, C - 1)
    if n_fill:
        fp = _fill_positions_np(box_lo, L_box, int(n_fill))
        cif = np.clip(((fp - np.asarray(box_lo)) / cell).astype(int), 0,
                      C - 1)
        ci = np.vstack([ci, cif])
    flat = (ci[:, 0] * C + ci[:, 1]) * C + ci[:, 2]
    occ = int(np.bincount(flat, minlength=C ** 3).max()) if len(flat) else 1
    need = occ * 1.15
    rung = 8.0
    while rung < need:
        rung *= 1.5
    occ = int(-8 * (-rung // 8))

    return TreePlan(depth=int(depth), order=int(order), box_lo=box_lo,
                    box_L=float(L_box), max_occ=occ, tol=float(tol))


# -------------------------------------------- host-side static tree geometry

_OCTS = np.array([(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                 dtype=np.int64)                      # [8, 3] child octants
_NBR_OFFSETS = np.array([(i, j, k) for i in (-1, 0, 1)
                         for j in (-1, 0, 1) for k in (-1, 0, 1)],
                        dtype=np.int64)               # [27, 3]


def _coords(level: int) -> np.ndarray:
    """[8^level, 3] integer cell coords in flat order (i*C + j)*C + k."""
    C = 2 ** level
    g = np.arange(C, dtype=np.int64)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"),
                    axis=-1).reshape(-1, 3)


@lru_cache(maxsize=None)
def _vlists(level: int) -> tuple:
    """Per-cell V-lists at one level: children of the parent's 27 neighbor
    cells (itself included) that are not neighbors of the cell. A tuple of
    per-cell int64 arrays of flat same-level cell ids."""
    C = 2 ** level
    co = _coords(level)
    parent = co >> 1
    cand = ((parent[:, None, None, :] + _NBR_OFFSETS[None, :, None, :]) * 2
            + _OCTS[None, None, :, :])                # [C3, 27, 8, 3]
    valid = np.all((cand >= 0) & (cand < C), axis=-1)
    cheb = np.abs(cand - co[:, None, None, :]).max(axis=-1)
    keep = valid & (cheb > 1)
    flat = (cand[..., 0] * C + cand[..., 1]) * C + cand[..., 2]
    return tuple(flat[i][keep[i]] for i in range(C ** 3))


@lru_cache(maxsize=None)
def _interaction_lists(depth: int):
    """Per-leaf far-field interaction lists over levels 2..depth: (ilist
    [n_leaves, maxI] int32 padded with ``total_cells`` — the zero-strength
    sentinel slot —, total_cells, level offsets, child index arrays per
    level for the upward pass)."""
    assert depth >= 2
    offsets = {}
    total = 0
    for lev in range(2, depth + 1):
        offsets[lev] = total
        total += 8 ** lev

    leaf_co = _coords(depth)
    n_leaves = 8 ** depth
    per_leaf = []
    vl = {lev: _vlists(lev) for lev in range(2, depth + 1)}
    for b in range(n_leaves):
        parts = []
        for lev in range(2, depth + 1):
            anc = leaf_co[b] >> (depth - lev)
            Cl = 2 ** lev
            anc_flat = (anc[0] * Cl + anc[1]) * Cl + anc[2]
            parts.append(vl[lev][anc_flat] + offsets[lev])
        per_leaf.append(np.concatenate(parts) if parts
                        else np.zeros(0, dtype=np.int64))
    maxI = max(1, max(len(p) for p in per_leaf))
    ilist = np.full((n_leaves, maxI), total, dtype=np.int32)
    for b, p in enumerate(per_leaf):
        ilist[b, :len(p)] = p

    child_idx = {}
    for lev in range(2, depth):
        co = _coords(lev)
        Cc = 2 ** (lev + 1)
        ch = co[:, None, :] * 2 + _OCTS[None, :, :]   # [8^lev, 8, 3]
        child_idx[lev] = ((ch[..., 0] * Cc + ch[..., 1]) * Cc
                          + ch[..., 2]).astype(np.int32)
    return ilist, total, offsets, child_idx


def _neighbor_table(depth: int):
    """[C3, 27] boundary-clipped neighbor cell ids + [C3, 27] first-
    occurrence mask (clipped duplicates would double-count sources)."""
    C = 2 ** depth
    co = _coords(depth)
    nb = np.clip(co[:, None, :] + _NBR_OFFSETS[None, :, :], 0, C - 1)
    nid = ((nb[..., 0] * C + nb[..., 1]) * C + nb[..., 2])    # [C3, 27]
    eq = nid[:, :, None] == nid[:, None, :]
    uniq = ~np.any(eq & np.tril(np.ones((27, 27), dtype=bool), k=-1)[None],
                   axis=2)
    return nid.astype(np.int32), uniq


#: the static geometry as tensors, by (depth, device): (neighbor ids, their
#: first-occurrence mask, interaction lists, child indices by level)
_geometry: dict = {}


def _device_geometry(depth: int, device):
    key = (depth, str(device))
    if key not in _geometry:
        nid, uniq = _neighbor_table(depth)
        ilist, _, _, child_idx = _interaction_lists(depth)
        _geometry[key] = (
            torch.as_tensor(nid, dtype=torch.int64, device=device),
            torch.as_tensor(uniq, device=device),
            torch.as_tensor(ilist, dtype=torch.int64, device=device),
            {lev: torch.as_tensor(c, dtype=torch.int64, device=device)
             for lev, c in child_idx.items()})
    return _geometry[key]


# ------------------------------------------------- barycentric interpolation

def _cheb_nodes_np(p: int) -> np.ndarray:
    """Chebyshev points of the 2nd kind on [-1, 1] (endpoints included)."""
    if p == 1:
        return np.zeros(1)
    return np.cos(np.pi * np.arange(p) / (p - 1))


def _bary_w_np(p: int) -> np.ndarray:
    """Barycentric weights for 2nd-kind Chebyshev points."""
    w = np.ones(p) * np.where(np.arange(p) % 2 == 0, 1.0, -1.0)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def _bary_1d(y, nodes, w):
    """Barycentric Lagrange basis values L_k(y): [..., n] -> [..., n, p].
    Near-node evaluations snap to the one-hot basis row (the raw formula
    overflows in f32 for |y - t| ~ 1e-38, and padded lanes may sit exactly
    on a node)."""
    diff = y[..., None] - nodes
    eps = torch.finfo(diff.dtype).eps
    hit = torch.abs(diff) < 64.0 * eps
    c = w / torch.where(hit, 1.0, diff)
    L = c / torch.sum(c, dim=-1, keepdim=True)
    any_hit = torch.any(hit, dim=-1, keepdim=True)
    return torch.where(any_hit, hit.to(diff.dtype), L)


def _bary_1d_np(y, p):
    """NumPy mirror of `_bary_1d` for the transfer matrices."""
    t = _cheb_nodes_np(p)
    w = _bary_w_np(p)
    diff = y[:, None] - t[None, :]
    hit = np.abs(diff) < 1e-13
    c = w[None, :] / np.where(hit, 1.0, diff)
    L = c / c.sum(axis=1, keepdims=True)
    return np.where(hit.any(axis=1, keepdims=True), hit.astype(float), L)


@lru_cache(maxsize=None)
def _transfer_np(p: int) -> np.ndarray:
    """Child -> parent anterpolation transfer: U[oct, n, m] = parent basis
    L_m at child proxy point n (octants ordered like `_OCTS`); the same
    [8, p^3, p^3] matrix serves every level."""
    t = _cheb_nodes_np(p)
    U1 = {h: _bary_1d_np((t + (2 * h - 1)) / 2.0, p) for h in (0, 1)}
    U = np.zeros((8, p ** 3, p ** 3))
    for o, (hx, hy, hz) in enumerate(_OCTS):
        U[o] = np.einsum("ax,by,cz->abcxyz", U1[hx], U1[hy], U1[hz]
                         ).reshape(p ** 3, p ** 3)
    return U


@lru_cache(maxsize=None)
def _nodes3_np(p: int) -> np.ndarray:
    """[p^3, 3] tensor-product Chebyshev offsets (unit half-width)."""
    t = _cheb_nodes_np(p)
    return np.stack(np.meshgrid(t, t, t, indexing="ij"),
                    axis=-1).reshape(-1, 3)


# --------------------------------------------------------------- device side

#: elements of one anterpolation weight tile ([leaves, slots, p^3]); a few
#: such temporaries are live at once (~1 GB in f64 at 32M)
_ANTERP_BUDGET = 32_000_000
#: elements of the leaf anterpolation weights a geometry keeps (~1 GB in
#: f32, 2 GB in f64); the chunks past it recompute theirs every call
_WEIGHTS_BUDGET = 256_000_000


def _cell_centers(plan: TreePlan, lo, level: int, dtype):
    """[8^level, 3] cell centers at one level, from the anchor ``lo``."""
    C = 2 ** level
    cell = plan.box_L / C
    idx = torch.arange(C ** 3, device=lo.device)
    ix, rem = idx // (C * C), idx % (C * C)
    iy, iz = rem // C, rem % C
    ijk = torch.stack([ix, iy, iz], dim=-1).to(dtype)
    return lo[None, :] + (ijk + 0.5) * cell


def _leaf_ids(plan: TreePlan, lo, pts):
    """Flat leaf index per point (boundary-clipped into the grid). The
    offset is scaled by the reciprocal of the leaf size, as the JAX
    package's compiled program does (XLA turns a division by a constant
    into that product), so a point on a leaf boundary (the anchor sits on
    the leaf lattice) lands in the same leaf in both."""
    C = 2 ** plan.depth
    cell = plan.box_L / C
    ci = torch.clamp(((pts - lo) * (1.0 / cell)).to(torch.int64), 0, C - 1)
    return (ci[:, 0] * C + ci[:, 1]) * C + ci[:, 2]


def _bucket_geometry(plan: TreePlan, lo, centers, pts):
    """The positions half of `_bucket`: (bucketed points [n_leaves,
    max_occ, 3], the sources' stable sort by leaf, each sorted source's
    slot, the sources a leaf, unclamped)."""
    C3 = plan.n_leaves
    mo = plan.max_occ
    flat = _leaf_ids(plan, lo, pts)
    order = torch.argsort(flat, stable=True)
    flat_s = flat[order]
    counts = torch.bincount(flat_s, minlength=C3)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_s.shape[0], device=pts.device) - starts[flat_s]
    rank = torch.clamp_max(rank, mo - 1)
    slot = flat_s * mo + rank
    bpts = torch.repeat_interleave(centers, mo, dim=0)
    bpts[slot] = pts[order]
    return bpts.reshape(C3, mo, 3), order, slot, counts


def _bucket_payload(plan: TreePlan, order, slot, payload):
    """The payload half of `_bucket`: [n_leaves, max_occ, ...], padded
    lanes zero."""
    bpay = payload.new_zeros((plan.n_leaves * plan.max_occ,)
                             + tuple(payload.shape[1:]))
    bpay[slot] = payload[order]
    return bpay.reshape((plan.n_leaves, plan.max_occ)
                        + tuple(payload.shape[1:]))


def _bucket(plan: TreePlan, lo, centers, pts, payload):
    """Sort sources into [n_leaves, max_occ] buckets, as the JAX package's
    `_bucket`: a stable sort by leaf, the rank in a leaf clamped at
    ``max_occ - 1``, padded lanes at their leaf's CENTER with zero payload.
    Returns (points, payload, the sources a leaf, unclamped)."""
    bpts, order, slot, counts = _bucket_geometry(plan, lo, centers, pts)
    return bpts, _bucket_payload(plan, order, slot, payload), counts


@dataclass(eq=False)
class _Upward:
    """What the upward pass needs besides the payload, on the device: the
    occupied leaves in chunks ``(leaf ids, slots, weights [leaves, slots,
    p^3] or None)`` (None: recomputed each call from ``src_b``), the
    interpolation nodes, weights and leaf centers they are computed from,
    the transfer matrix and the child indices."""

    plan: TreePlan
    src_b: torch.Tensor          # [n_leaves, max_occ, 3] bucketed points
    centers: torch.Tensor        # [n_leaves, 3] leaf centers
    nodes1: torch.Tensor         # [p] Chebyshev points
    bw: torch.Tensor             # [p] their barycentric weights
    U: torch.Tensor              # [8, p^3, p^3]
    child_idx: dict
    chunks: tuple = ()


def _leaf_weights(up: _Upward, ids, ms):
    """[len(ids), ms, p^3] anterpolation weights of leaves ``ids``' first
    ``ms`` slots: the tensor-product barycentric basis at each source."""
    plan = up.plan
    y = (up.src_b[ids, :ms] - up.centers[ids][:, None, :]) * (
        1.0 / (plan.leaf_size / 2.0))                     # as `_leaf_ids`
    Lx = _bary_1d(y[..., 0], up.nodes1, up.bw)            # [B, ms, p]
    Ly = _bary_1d(y[..., 1], up.nodes1, up.bw)
    Lz = _bary_1d(y[..., 2], up.nodes1, up.bw)
    return (Lx[:, :, :, None, None] * Ly[:, :, None, :, None]
            * Lz[:, :, None, None, :]).reshape(len(ids), ms,
                                               plan.order ** 3)


def _upward_geometry(plan: TreePlan, lo, src_b, counts, dtype):
    """The positions half of `_upward` (`_Upward`): the occupied leaves in
    order of occupancy, chunked so a weight tile holds at most
    `_ANTERP_BUDGET` values, each chunk's weights kept while their sum
    stays within `_WEIGHTS_BUDGET` elements. Reads the occupancy on the
    host."""
    p3 = plan.order ** 3
    dev = lo.device
    occ_np = torch.clamp_max(counts, plan.max_occ).cpu().numpy()
    leaves = np.flatnonzero(occ_np > 0)
    leaves = leaves[np.argsort(-occ_np[leaves], kind="stable")]
    p = plan.order
    _, _, _, child_idx = _device_geometry(plan.depth, dev)
    up = _Upward(plan, src_b, _cell_centers(plan, lo, plan.depth, dtype),
                 torch.as_tensor(_cheb_nodes_np(p), dtype=dtype, device=dev),
                 torch.as_tensor(_bary_w_np(p), dtype=dtype, device=dev),
                 torch.as_tensor(_transfer_np(p), dtype=dtype, device=dev),
                 child_idx)
    chunks, kept, i = [], 0, 0
    while i < len(leaves):
        ms = int(occ_np[leaves[i]])
        j = min(len(leaves), i + max(1, _ANTERP_BUDGET // (ms * p3)))
        ids = torch.as_tensor(leaves[i:j], device=dev)
        W = None
        if kept + (j - i) * ms * p3 <= _WEIGHTS_BUDGET:
            W = _leaf_weights(up, ids, ms)
            kept += W.numel()
        chunks.append((ids, ms, W))
        i = j
    up.chunks = tuple(chunks)
    return up


def _upward_payload(up: _Upward, pay_b):
    """The payload half of `_upward`: the proxies' strengths [T + 1, p^3,
    C] (levels 2..depth in `_interaction_lists` order, then the zero
    sentinel cell). A leaf's strengths are those of its occupied slots (its
    padded lanes carry zero payload, as in the JAX package, whose sum over
    every slot differs only in summation order); empty leaves get zero
    strengths without a product. No host sync."""
    plan = up.plan
    p3 = plan.order ** 3
    C = pay_b.shape[-1]
    fh = pay_b.new_zeros((plan.n_leaves, p3, C))
    for ids, ms, W in up.chunks:
        if W is None:
            W = _leaf_weights(up, ids, ms)
        fh[ids] = torch.einsum("bcm,bck->bmk", W, pay_b[ids, :ms])
    by_level = {plan.depth: fh}
    for lev in range(plan.depth - 1, 1, -1):
        g = by_level[lev + 1][up.child_idx[lev]]          # [8^lev, 8, p3, C]
        by_level[lev] = torch.einsum("onm,qonk->qmk", up.U, g)
    return torch.cat([by_level[lev] for lev in range(2, plan.depth + 1)]
                     + [pay_b.new_zeros((1, p3, C))])


def _proxy_geometry(plan: TreePlan, lo, counts, dtype):
    """The proxies' positions [T + 1, p^3, 3] (`_upward_payload`'s order,
    the sentinel at the origin) and the sources below each of those cells
    [T + 1]."""
    p = plan.order
    dev = lo.device
    _, _, _, child_idx = _device_geometry(plan.depth, dev)
    n_below = {plan.depth: counts}
    for lev in range(plan.depth - 1, 1, -1):
        n_below[lev] = n_below[lev + 1][child_idx[lev]].sum(dim=1)
    nodes3 = torch.as_tensor(_nodes3_np(p), dtype=dtype, device=dev)
    pts_parts = []
    for lev in range(2, plan.depth + 1):
        half = plan.box_L / (2 ** lev) / 2.0
        cen = _cell_centers(plan, lo, lev, dtype)
        pts_parts.append(cen[:, None, :] + half * nodes3[None, :, :])
    proxy_pts = torch.cat(
        pts_parts + [torch.zeros((1, p ** 3, 3), dtype=dtype, device=dev)])
    cell_n = torch.cat([n_below[lev] for lev in range(2, plan.depth + 1)]
                       + [counts.new_zeros(1)])
    return proxy_pts, cell_n


def _upward(plan: TreePlan, lo, src_b, pay_b, counts, dtype):
    """Leaf anterpolation + child -> parent transfers (`_upward_geometry`
    and `_upward_payload` in one call). Returns the flat cross-level proxy
    arrays, positions [T + 1, p^3, 3] and strengths [T + 1, p^3, C], and
    the sources below each of those cells [T + 1]."""
    with phase("upward"):
        up = _upward_geometry(plan, lo, src_b, counts, dtype)
        proxy_pts, cell_n = _proxy_geometry(plan, lo, counts, dtype)
        return proxy_pts, _upward_payload(up, pay_b), cell_n


#: an item's targets in units of 8 by the item sizes of the remainder of a
#: leaf after its items of 64 (`_items`): the binary digits of 0..7
_UNIT_SPLIT = ((0, 0, 0), (1, 0, 0), (2, 0, 0), (2, 1, 0), (4, 0, 0),
               (4, 1, 0), (4, 2, 0), (4, 2, 1))


def _items(n_t, t_first, g_first, n_seg, v1=False):
    """The items [n_items, 4] (first target, targets, first segment,
    segments) of leaves with ``n_t`` targets from ``t_first`` and
    ``n_seg`` segments from ``g_first``. Kernels G / H (`v1` False): a
    leaf's targets in 8s, split into items of 64 and then the binary digits
    of the rest (32, 16, 8), each item filled before the next, so an item's
    2 T target slots (`cuda_kernels.tree_item_lanes`) are the 8s it was
    cut for: a 37-target leaf is 32 + 5 in 32 + 8 slots. Their first
    design (``v1``): runs of `cuda_kernels.TREE_V1_ITEM_TARGETS`."""
    from .cuda_kernels import TREE_ITEM_TARGETS, TREE_V1_ITEM_TARGETS

    dev = n_t.device
    leaf_ids = torch.arange(n_t.shape[0], device=dev)
    if v1:
        per_leaf = -(-n_t // TREE_V1_ITEM_TARGETS)
        item_leaf = torch.repeat_interleave(leaf_ids, per_leaf)
        size = torch.full_like(item_leaf, TREE_V1_ITEM_TARGETS)
    else:
        units = -(-n_t // 8)
        big = units // (TREE_ITEM_TARGETS // 8)
        table = torch.tensor(_UNIT_SPLIT, dtype=torch.int64, device=dev)
        rest = table[units % (TREE_ITEM_TARGETS // 8)]      # [L, 3]
        per_leaf = big + (rest > 0).sum(dim=1)
        item_leaf = torch.repeat_interleave(leaf_ids, per_leaf)
        k = (torch.arange(item_leaf.shape[0], device=dev)
             - (torch.cumsum(per_leaf, 0) - per_leaf)[item_leaf])
        j = k - big[item_leaf]
        size = 8 * torch.where(j < 0, TREE_ITEM_TARGETS // 8,
                               rest[item_leaf, torch.clamp(j, 0, 2)])
    offset = torch.cumsum(size, 0) - size
    offset = offset - offset[(torch.cumsum(per_leaf, 0)
                              - per_leaf)[item_leaf]]
    first = t_first[item_leaf] + offset
    n_item = torch.minimum(n_t[item_leaf] - offset, size)
    return torch.stack([first, n_item, g_first[item_leaf],
                        n_seg[item_leaf]], dim=1).contiguous()


def _segment_lists(plan: TreePlan, counts, cell_n, leaf_s,
                   fields=("near", "far"), v1=False):
    """The lists kernels G and H walk, for targets sorted by leaf
    (``leaf_s``, their leaf ids) against one source array holding the
    bucketed sources ([n_leaves max_occ] slots) and then the flat proxies
    ([T + 1, p^3], `_upward_payload`'s order).

    Returns (items [n_items, 4] int64 (`_items`; ``v1``: the first
    design's), segments [n_seg, 2] int64: first source, sources). The
    items of a leaf share its segments: near, its 27 neighbor leaves (a
    boundary-clipped duplicate once, the `uniq` mask), each the bucket's
    occupied slots, and far, its interaction list's cells, each its p^3
    proxies. Segments that would add only exact zeros are left out: empty
    buckets, cells with no source below them, and the sentinel. ``fields``
    picks near, far or both (the smoke times them apart). Reads the lists'
    sizes on the host."""
    dev = leaf_s.device
    mo = plan.max_occ
    p3 = plan.order ** 3
    nid, uniq, ilist, _ = _device_geometry(plan.depth, dev)
    leaves, n_t = torch.unique_consecutive(leaf_s, return_counts=True)
    t_first = torch.cumsum(n_t, 0) - n_t

    starts, lens = [], []
    if "near" in fields:
        ids = nid[leaves]                                   # [L, 27]
        starts.append(ids * mo)
        lens.append(torch.where(uniq[leaves],
                                torch.clamp_max(counts[ids], mo), 0))
    if "far" in fields:
        cells = ilist[leaves]                               # [L, maxI]
        starts.append(plan.n_leaves * mo + cells * p3)
        lens.append(torch.where(cell_n[cells] > 0, p3, 0))
    start = torch.cat(starts, dim=1)
    length = torch.cat(lens, dim=1)
    keep = length > 0
    segs = torch.stack([start[keep], length[keep]], dim=1)
    n_seg = keep.sum(dim=1)
    g_first = torch.cumsum(n_seg, 0) - n_seg
    return _items(n_t, t_first, g_first, n_seg, v1), segs.contiguous()


@dataclass(eq=False)
class TreeGeometry:
    """What a pass of kernel G / H needs that depends on the positions
    alone, built once (`tree_geometry`) for one (source set, target set,
    dtype) and used by every sum over them (`tree_payload`): the buckets'
    scatter, the upward pass's weights, the source array's positions
    ([bucketed slots | proxies]), the leaf-sorted targets and the lists.
    ``r_src`` / ``r_trg`` are the positions it was built from."""

    plan: TreePlan
    r_src: torch.Tensor
    r_trg: torch.Tensor
    src_order: torch.Tensor      # the sources' stable sort by leaf
    slot: torch.Tensor           # each sorted source's bucket slot
    counts: torch.Tensor         # the sources a leaf, unclamped
    cell_n: torch.Tensor         # the sources below each proxy cell
    up: _Upward
    src: torch.Tensor            # [n_leaves max_occ + (T + 1) p^3, 3]
    trg: torch.Tensor            # [n_trg, 3] leaf-sorted
    trg_order: torch.Tensor
    items: torch.Tensor
    segs: torch.Tensor


def tree_geometry(plan: TreePlan, anchors, r_src, r_trg,
                  fields=("near", "far"), v1=False) -> TreeGeometry:
    """The `TreeGeometry` of a depth >= 2 plan over sources ``r_src`` and
    targets ``r_trg``, in ``r_trg``'s dtype (``fields``, ``v1``: as
    `_segment_lists`). Syncs with the host (the occupancy, the lists'
    sizes)."""
    dtype = r_trg.dtype
    lo = anchors[0].to(dtype)
    centers = _cell_centers(plan, lo, plan.depth, dtype)
    r_src = r_src.to(dtype)
    src_b, src_order, slot, counts = _bucket_geometry(plan, lo, centers,
                                                      r_src)
    with phase("upward"):
        up = _upward_geometry(plan, lo, src_b, counts, dtype)
        proxy_pts, cell_n = _proxy_geometry(plan, lo, counts, dtype)
    flat_t = _leaf_ids(plan, lo, r_trg)
    trg_order = torch.argsort(flat_t, stable=True)
    items, segs = _segment_lists(plan, counts, cell_n, flat_t[trg_order],
                                 fields, v1)
    src = torch.cat([src_b.reshape(-1, 3), proxy_pts.reshape(-1, 3)])
    up.src_b = src[:plan.n_leaves * plan.max_occ].view(src_b.shape)
    return TreeGeometry(plan, r_src, r_trg, src_order, slot, counts, cell_n,
                        up, src, r_trg[trg_order], trg_order, items, segs)


def tree_payload(geom: TreeGeometry, payload):
    """The source array's payload [bucketed slots | proxies, C] of one sum
    over ``geom`` (``payload`` [n_src, C] in the geometry's dtype): the
    buckets' scatter, the anterpolation product and the transfers. No host
    sync."""
    pay_b = _bucket_payload(geom.plan, geom.src_order, geom.slot, payload)
    with phase("upward"):
        proxy_f = _upward_payload(geom.up, pay_b)
    C = payload.shape[-1]
    return torch.cat([pay_b.reshape(-1, C), proxy_f.reshape(-1, C)])


def tree_operands(plan: TreePlan, anchors, r_src, payload, r_trg,
                  fields=("near", "far"), v1=False):
    """What one pass of kernel G / H takes, on a depth >= 2 plan, in
    ``r_trg``'s dtype, built in one call (`tree_geometry`, then
    `tree_payload`): (leaf-sorted targets, the source array [bucketed
    slots | proxies] and its payload, items, segments (`_segment_lists`;
    ``v1``: the first design's items), the targets' sort order, the sources
    a leaf). ``payload`` is [n, 3] forces or [n, 9] stresslet
    components."""
    geom = tree_geometry(plan, anchors, r_src, r_trg, fields, v1)
    pay = tree_payload(geom, payload.to(r_trg.dtype))
    return (geom.trg, geom.src, pay, geom.items, geom.segs, geom.trg_order,
            geom.counts)


def _tree_sum(family: str, plan: TreePlan, anchors, r_src, payload, r_trg,
              eta, geometry=None, site=()):
    """The scaled singular ``family`` sum ("stokeslet": payload [n, 3];
    "stresslet": [n, 9]) on a depth >= 2 plan: the positions' geometry
    (`tree_geometry`), then the payload's part (`tree_payload`) and ONE
    pass of kernel G / H (their plain twin on the CPU) over the leaf-sorted
    targets; returns [n_trg, 3] in caller order, in ``r_trg``'s dtype.

    ``geometry`` (a dict, `ops.evaluator.PairEvaluator.geometry`, one a
    step) keeps each geometry by (``site``, family, dtype, sources,
    targets) and serves the next sum with that key from it, so a sum after
    the first makes no host sync and gives the bits a fresh build would.
    ``site`` is the caller's call site (`PairEvaluator.at`: the fiber flow,
    the shell's, body bucket j's, a shard's), so the sums that share a key
    share their positions; should positions under a kept key differ all
    the same, the sum comes back NaN, which the solve reports, not wrong.

    Phases (`obs.profile.phase`): the geometry's and the payload's proxy
    work is ``upward``, as in the JAX package; the JAX package's ``near``
    and ``far`` are two passes, here they are one launch over both lists,
    so its phase reads ``near/far``."""
    from . import cuda_kernels

    dtype = r_trg.dtype
    key = (site, family, dtype, r_src.shape[0], r_trg.shape[0])
    geom = None if geometry is None else geometry.get(key)
    kept = geom is not None
    if not kept:
        geom = tree_geometry(plan, anchors, r_src, r_trg)
        if geometry is not None:
            REBUILDS["tree_geometry_miss"] += 1
            geometry[key] = geom
    pay = tree_payload(geom, payload.to(dtype))
    prec = "f32" if dtype == torch.float32 else "f64"
    kern = getattr(cuda_kernels, f"tree_{family}_{prec}")
    with phase("near"), phase("far"):
        u = kern(geom.trg, geom.src, pay, geom.items, geom.segs, eta)
    if kept:
        moved = (torch.ne(r_src.to(dtype), geom.r_src).any()
                 | torch.ne(r_trg, geom.r_trg).any())
        u = torch.where(moved, torch.nan, u)
    out = torch.empty_like(u)
    out[geom.trg_order] = u
    return out


# ------------------------------------------------------------------ the sums

def stokeslet_impl(plan: TreePlan, anchors, r_src, r_trg, f_src,
                   n_self: int, eta, geometry=None, site=()):
    """Stokeslet sum on a depth >= 2 ``plan`` with its [1, 3] ``anchors``
    (box_lo) at viscosity ``eta`` (``geometry``, ``site``: as
    `_tree_sum`). The tree needs no self correction (coincident pairs drop
    in the near field), so ``n_self`` is unused."""
    return _tree_sum("stokeslet", plan, anchors, r_src, f_src, r_trg, eta,
                     geometry, site)


def stresslet_impl(plan: TreePlan, anchors, r_dl, r_trg, f_dl, eta,
                   geometry=None, site=()):
    """Stresslet sum on a depth >= 2 ``plan`` (``f_dl`` [n, 3, 3])."""
    return _tree_sum("stresslet", plan, anchors, r_dl, f_dl.reshape(-1, 9),
                     r_trg, eta, geometry, site)


def stokeslet_tree(plan: TreePlan, r_src, r_trg, f_src, eta):
    """Singular Stokeslet sum via the treecode: the semantics of
    `kernels.stokeslet_direct` (coincident pairs drop in the near field, so
    no self term exists anywhere); ``depth == 0`` is the dense sum bit for
    bit."""
    from .evaluator import make_pair

    return make_pair(plan, r_src.device).stokeslet(r_src, r_trg, f_src, 0,
                                                   eta)


def stresslet_tree(plan: TreePlan, r_dl, r_trg, f_dl, eta):
    """Singular stresslet (double-layer) sum via the treecode, ``f_dl``
    [n_src, 3, 3]. It carries one more derivative than the Stokeslet, so
    its error runs a few x the Stokeslet-calibrated tol."""
    from .evaluator import make_pair

    return make_pair(plan, r_dl.device).stresslet(r_dl, r_trg, f_dl, eta)


def oseen_tree(plan: TreePlan, r_src, r_trg, density, eta,
               reg=kernels.DEFAULT_REG, epsilon_distance=kernels.DEFAULT_EPS):
    """Regularized-Oseen contraction via the treecode (the semantics of
    `kernels.oseen_contract`): the near lists through the regularized
    Oseen pair, already 1/(8 pi eta)-scaled, and the far lists through the
    plain Stokeslet (the regularization acts only within
    ``epsilon_distance``, far below a cell), both by the plain twin's pair
    expansion. No flow calls it, and no kernel serves it."""
    from .cuda_kernels import _tree_pair_terms, _tree_plain_sum
    from .evaluator import make_pair

    if plan.depth == 0:
        return kernels.oseen_contract(r_src, r_trg, density, eta, reg,
                                      epsilon_distance)

    def oseen_terms(d, q):
        fr, gr = kernels._regularized_frgr(torch.sum(d * d, dim=-1), eta,
                                           reg, epsilon_distance)
        return fr[:, None] * q + (gr * torch.sum(d * q, dim=-1))[:, None] * d

    anchors = make_pair(plan, r_src.device).anchors
    u = 0.0
    for field, terms, scale in (
            ("near", oseen_terms, 1.0),
            ("far", partial(_tree_pair_terms, "stokeslet"),
             1.0 / (8.0 * math.pi) / eta)):
        trg, src, pay, items, segs, order, _ = tree_operands(
            plan, anchors, r_src, density, r_trg, fields=(field,))
        u = u + _tree_plain_sum(terms, trg, src, pay, items, segs) * scale
    out = torch.empty_like(u)
    out[order] = u
    return out


# ---------------------------------------------------------------- the registry

def auditable_programs():
    """The ops layer's registry entry: the treecode Stokeslet (geometry,
    payload and one G pass) on a fiber-like clustered cloud of 32 x 16
    points, the JAX package's ``stokeslet_tree``."""
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice

    def retrace_probe(device=None):
        # a leaf-lattice anchor hop with drifted positions: the plan's
        # static tables serve both calls
        built = build(device)
        plan, anchors, r, _, f, n_self, eta = built.args
        leaf = plan.box_L / 2 ** plan.depth
        return probe_twice(
            lambda: stokeslet_impl(*built.args),
            lambda _: stokeslet_impl(plan, anchors + leaf, r + 0.01,
                                     r + 0.01, f, n_self, eta))

    def build(device=None):
        from ..device import resolve_device
        from .evaluator import make_pair

        dev = resolve_device(device)
        rng = np.random.default_rng(61)
        nf, nn = 32, 16
        origins = rng.uniform(-2, 2, (nf, 3))
        dirs = rng.normal(size=(nf, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        t = np.linspace(0, 1.0, nn)
        pts = (origins[:, None, :]
               + t[None, :, None] * dirs[:, None, :]).reshape(-1, 3)
        f = rng.standard_normal((len(pts), 3))
        plan = plan_tree(pts, tol=1e-4)
        # the depth's static tables are set-up, as the plan is: made here,
        # the count does not depend on what ran before in the process
        _device_geometry(plan.depth, dev)
        r = torch.as_tensor(pts, dtype=torch.float64, device=dev)
        return BuiltProgram(stokeslet_impl, (
            plan, make_pair(plan, dev).anchors, r, r,
            torch.as_tensor(f, dtype=torch.float64, device=dev), 0, 1.0),
            device=dev)

    return [AuditProgram(
        name="stokeslet_tree", layer="ops",
        summary="treecode Stokeslet evaluator (clustered fiber cloud, f64)",
        build=build, retrace_probe=retrace_probe)]


def auditable_kernels():
    """This module's entries in the kernel registry (`audit.kernels`): the
    treecode's pair passes G (``stokeslet_tree_pass``) and H
    (``stresslet_tree_pass``), the port's own names (the JAX package's tree
    is plain XLA, no Pallas kernel), each in f32 and f64 over the segment
    lists of a depth-2 plan of a clustered cloud of 1,999 points (ragged
    leaves: items of 64 / 32 / 16 / 8 targets)."""
    from ..audit.registry import AuditKernel, BuiltKernel, KernelCase
    from . import cuda_kernels

    def build(family, letter):
        def _build(device=None):
            from ..device import resolve_device
            from .evaluator import make_pair

            dev = resolve_device(device)
            rng = np.random.default_rng(23)
            pts = np.concatenate([rng.normal(c, 0.3, (n, 3)) for c, n in
                                  ((-1.0, 1000), (1.0, 999))])
            cols = 3 if family == "stokeslet" else 9
            pay = rng.standard_normal((len(pts), cols))
            plan = plan_tree(pts, tol=1e-4, max_depth=2)
            anchors = make_pair(plan, dev).anchors
            cases = []
            for prec, dtype, rtol in (("f32", torch.float32, 1e-4),
                                      ("f64", torch.float64, 1e-12)):
                r = torch.as_tensor(pts, dtype=dtype, device=dev)
                trg, src, p, items, segs, _, _ = tree_operands(
                    plan, anchors, r, torch.as_tensor(pay, dtype=dtype,
                                                      device=dev), r,
                    fields=("near", "far"))
                name = f"tree_{family}_{prec}"
                mangled = "f" if prec == "f32" else "d"   # float / double
                cases.append(KernelCase(
                    label=f"{letter} {name}",
                    wrapper=getattr(cuda_kernels, name),
                    plain=getattr(cuda_kernels, f"{name}_plain"),
                    args=(trg, src, p, items, segs, 1.0), rtol=rtol,
                    entries=(rf"11tree_kernelI{mangled}Li{cols}E",),
                    dynamic_smem=(cuda_kernels.tree_shared_bytes(family,
                                                                 prec)
                                  if dev.type == "cuda" else 0)))
            return BuiltKernel(source=cuda_kernels.TREE_SOURCE, cases=cases,
                               device=dev)
        return _build

    return [
        AuditKernel(name="stokeslet_tree_pass", layer="ops",
                    summary="treecode Stokeslet pass G (f32 / f64), "
                            "csrc/tree_sums.cu",
                    kernels="G", build=build("stokeslet", "G")),
        AuditKernel(name="stresslet_tree_pass", layer="ops",
                    summary="treecode stresslet pass H (f32 / f64), "
                            "csrc/tree_sums.cu",
                    kernels="H", build=build("stresslet", "H")),
    ]
