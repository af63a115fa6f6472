"""Free-space spectral Ewald Stokeslet and stresslet sums: O(N log N).

Counterpart of `skellysim_tpu.ops.ewald` (the reference's "FMM" slot): the
pair sum is split into a screened near field, summed as dense tiles over a
cell list or block-sparse tiles, and a smooth far field, spread onto a
grid, multiplied in Fourier space with `torch.fft` and interpolated back.
The mathematics (Hasimoto split, the truncated-kernel trick for free
space, the Gaussian window and its deconvolution) is documented in the JAX
module and pinned there by `tests/test_ewald.py`; this module computes the
same sums on the same plan, with the JAX package's ``.at[].add`` as
`index_add_`, ``lax.map`` / ``lax.scan`` over chunks as Python loops over
the same chunks and ``lax.top_k`` as `torch.topk`.

`plan_ewald` is host numpy and returns a plan equal field for field to the
JAX package's on the same points. The sums take the plan's two anchors
(``box_lo``, ``cell_lo``) as a [2, 3] tensor on their device, made once a
plan by `ops.evaluator.make_pair`.

Chunking bounds memory and launch count, not the result beyond summation
order: `_NEAR_TILE_BUDGET` caps the elements of one near-field tile
([chunk, targets, sources]) and `_GRID_CHUNK_BUDGET` those of one gridding
chunk ([chunk, P^3]); both are set for an 80 GB card (the JAX package's
values, 3M and 16M, were set for TPU memory). On CUDA, `index_add_` uses
float atomics, so two calls on the card can differ in the last bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["EwaldPlan", "plan_ewald", "stokeslet_ewald",
           "stresslet_ewald", "fill_positions", "stokeslet_near_block",
           "stokeslet_disp_block", "stresslet_disp_block_ewald",
           "g_far_pair", "bhat_far_trunc"]

_SQRT_PI = math.sqrt(math.pi)

#: the runtime evaluator name whose plans this module owns
EVALUATOR = "ewald"
#: the plan's anchor fields, in the order of `ops.evaluator.make_pair`'s
#: anchor rows, and the row `fill_positions` is placed from
ANCHORS = ("box_lo", "cell_lo")
FILL_ANCHOR = 1


# --------------------------------------------------------------- closed forms

def g_far_pair(rvec, xi, eta):
    """Far-field (screened) Stokeslet tensor for displacement(s) [..., 3]
    (tests and small direct checks; not on the fast path)."""
    r2 = torch.sum(rvec * rvec, dim=-1)
    r = torch.sqrt(r2)
    safe_r = torch.where(r > 0, r, 1.0)
    rhat = rvec / safe_r[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    erf_term = torch.special.erf(xi * r) / safe_r
    # r -> 0: erf(xi r)/r -> 2 xi / sqrt(pi)
    erf_term = torch.where(r > 0, erf_term, 2.0 * xi / _SQRT_PI)
    gauss = (2.0 * xi / _SQRT_PI) * torch.exp(-(xi * r) ** 2)
    rr = rhat[..., :, None] * rhat[..., None, :]
    G = (erf_term[..., None, None] * (eye + rr)
         + gauss[..., None, None] * (eye - rr))
    return G / (8.0 * math.pi * eta)


def stokeslet_near_block(trg, src, f_src, xi):
    """Unscaled screened near-field Stokeslet partial sum of (target,
    source) blocks ``trg`` [..., t, 3], ``src`` [..., s, 3] (leading batch
    axes allowed):
    ``u_i = sum_j [ erfc(xi r)(f/r + (d.f) d/r^3)
                    - (2 xi/sqrt(pi)) e^{-(xi r)^2} (f - (d.f) d/r^2) ]``
    (multiply by 1/(8 pi eta) outside). Coincident pairs drop."""
    return stokeslet_disp_block(trg[..., :, None, :] - src[..., None, :, :],
                                f_src, xi)


def stokeslet_disp_block(d, f_src, xi):
    """`stokeslet_near_block` on a displacement tile ``d`` [..., t, s, 3]
    (the periodic evaluator minimum-images ``d`` first)."""
    r2 = torch.sum(d * d, dim=-1)
    mask = r2 > 0.0
    r2s = torch.where(mask, r2, 1.0)
    rinv = torch.where(mask, torch.rsqrt(r2s), 0.0)
    r = r2 * rinv                      # = r, 0 at masked pairs
    live = mask.to(d.dtype)
    erfc = torch.special.erfc(xi * r) * live
    gauss = (2.0 * xi / _SQRT_PI) * torch.exp(-(xi * r) ** 2) * live
    df = torch.einsum("...tsk,...sk->...ts", d, f_src)
    rinv3 = rinv * rinv * rinv
    a = erfc * rinv                    # multiplies f
    b = erfc * rinv3                   # multiplies (d.f) d
    c = gauss                          # multiplies -(f - (d.f) d / r^2)
    return (torch.einsum("...ts,...sk->...tk", a - c, f_src)
            + torch.einsum("...ts,...tsk->...tk",
                           df * (b + c * rinv * rinv), d))


def stresslet_near_block_ewald(trg, src, S, xi):
    """Unscaled screened near-field stresslet partial sum of (target,
    source) blocks, ``S`` [..., s, 3, 3]: the exact double layer minus its
    far part (the coefficients in `skellysim_tpu.ops.ewald`); every
    coefficient vanishes at r = 0, so there is no self term. Coincident
    pairs drop."""
    return stresslet_disp_block_ewald(
        trg[..., :, None, :] - src[..., None, :, :], S, xi)


def stresslet_disp_block_ewald(d, S, xi):
    """`stresslet_near_block_ewald` on a displacement tile ``d``
    [..., t, s, 3]."""
    g = 2.0 * xi / _SQRT_PI
    r2 = torch.sum(d * d, dim=-1)
    mask = r2 > 0.0
    r2s = torch.where(mask, r2, 1.0)
    rinv = torch.where(mask, torch.rsqrt(r2s), 0.0)
    r = r2 * rinv
    rinv2 = rinv * rinv
    expf = torch.exp(-(xi * r) ** 2) * mask.to(d.dtype)
    erf_r = torch.special.erf(xi * r)
    p1 = erf_r * rinv                  # phi'/r (0 at masked pairs via rinv)
    p2 = g * expf                      # phi''
    p3 = -2.0 * xi * xi * r * g * expf  # phi'''
    a = (p2 - p1) * rinv
    c3 = p3 - 3.0 * a
    ame = -0.5 * p3                    # a - e simplifies to -phi'''/2

    Sd = torch.einsum("...sij,...tsj->...tsi", S, d)
    dSd = torch.sum(d * Sd, dim=-1)                    # d.S.d
    rhSrh = dSd * rinv2                                # rh.S.rh
    coeff_exact = -3.0 * rhSrh * rinv2                 # -3(rhSrh)/r^2
    chan1 = (coeff_exact + c3 * rhSrh) * rinv          # * rh_i = * d_i rinv
    Ssym_d = Sd + torch.einsum("...sji,...tsj->...tsi", S, d)  # (S + S^T) d
    trS = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    u = (chan1[..., None] * d
         + ame[..., None] * (Ssym_d + trS[..., None, :, None] * d)
         * rinv[..., None])
    return torch.sum(u, dim=-2)


def bhat_far_trunc(k, xi, R):
    """Screened transform of the truncated biharmonic kernel,
    ``T(k) (1 + k^2/(4 xi^2)) e^{-k^2/(4 xi^2)}`` with T the transform of
    ``r 1_{r<R}`` (series for small kR), in the dtype of ``k``."""
    kR = k * R
    small = kR < 0.5
    ks = torch.where(small, 1.0, k)    # safe denominators

    cos_kR = torch.cos(kR)
    sin_kR = torch.sin(kR)
    T_exact = 4.0 * math.pi * (2.0 * (cos_kR - 1.0) / ks**4
                               + 2.0 * R * sin_kR / ks**3
                               - R**2 * cos_kR / ks**2)
    kR2 = kR * kR
    T_series = 4.0 * math.pi * R**4 * (0.25 - kR2 / 36.0 + kR2**2 / 960.0
                                       - kR2**3 / 50400.0)
    T = torch.where(small, T_series, T_exact)

    x = k * k / (4.0 * xi * xi)
    ghat = (1.0 + x) * torch.exp(-x)
    return T * ghat


# ---------------------------------------------------------------------- plan

@dataclass(frozen=True)
class EwaldPlan:
    """Geometry and resolution of one Ewald evaluation (the JAX package's
    `EwaldPlan`, field for field). Built on the host by `plan_ewald`."""

    xi: float                 # splitting parameter
    rc: float                 # near-field cutoff
    R: float                  # kernel truncation radius (> cloud diameter)
    box_lo: tuple             # FFT box lower corner (an anchor)
    box_L: float              # FFT box edge (>= D + R + mollifier margin)
    M: int                    # grid points per dim
    P: int                    # window support (grid points per dim)
    tau: float                # Gaussian window variance parameter
    cell_lo: tuple            # near-field cell-lattice anchor
    cells3: tuple             # per-axis cell counts (cloud bbox + slack)
    cell_size: float
    max_occ: int              # per-cell capacity
    eta: float
    #: near-field backend: "cells" (27-neighbor buckets) or "blocks"
    #: (`block` consecutive nodes x the K nearest source blocks)
    near_mode: str = "cells"
    block: int = 128          # nodes per block in "blocks" mode
    K: int = 32               # source blocks kept per target block

    @property
    def h(self) -> float:
        return self.box_L / self.M


#: additive plastic-constant lattice (the R2 low-discrepancy sequence) that
#: spreads padding / inactive source nodes over the cell region
_R2_ALPHAS = (0.8191725133961645, 0.6710436067037893, 0.5497004779019703)


def fill_positions(plan: EwaldPlan, cell_lo, n, dtype):
    """[n, 3] well-spread positions inside the near-field cell region, on
    the device of ``cell_lo`` (the sequence the planner's occupancy count
    uses), for inactive nodes whose strengths are zero."""
    dev = cell_lo.device
    t = (torch.arange(n, dtype=dtype, device=dev) + 0.5)[:, None]
    alphas = torch.tensor(_R2_ALPHAS, dtype=dtype, device=dev)[None, :]
    frac = torch.remainder(t * alphas, 1.0)
    extent = (torch.tensor(plan.cells3, dtype=dtype, device=dev) - 0.01) \
        * plan.cell_size
    return cell_lo.to(dtype) + frac * extent


def _fill_positions_np(plan_like, n):
    """NumPy mirror of `fill_positions` for host-side occupancy counting."""
    t = (np.arange(n, dtype=np.float64) + 0.5)[:, None]
    frac = (t * np.asarray(_R2_ALPHAS)[None, :]) % 1.0
    cell_lo, cells3, cell_size = plan_like
    extent = (np.asarray(cells3, dtype=np.float64) - 0.01) * cell_size
    return np.asarray(cell_lo) + frac * extent


def _ladder(x, base, ratio=1.25):
    """Quantize x upward onto a geometric ladder (plan-stability helper)."""
    return base * ratio ** math.ceil(math.log(max(x, base) / base)
                                     / math.log(ratio))


#: target blocks a chunk of the planner's block-gap count (bounds its
#: [chunk, source blocks, 3] host arrays; the count is the same unchunked)
_PLAN_GAP_CHUNK = 256


def plan_ewald(points, eta, tol=1e-6, max_grid=448, target_occ=32.0,
               n_fill=0, n_src=None):
    """Choose (xi, rc, R, grid M, window P, cell lattice) for a target
    relative tolerance: the JAX package's `plan_ewald`, rule for rule (its
    docstring gives the calibrated rules), on the host in numpy.

    ``n_fill`` reserves occupancy for that many zero-strength padding nodes
    placed by `fill_positions`; ``n_src`` is the count of leading points
    that are sources (the blocks mode's K is measured for them).
    """
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    D = max(float(np.linalg.norm(hi - lo)), 1e-3)
    D = _ladder(D, 1e-3)
    N = len(pts) + int(n_fill)
    vol = float(np.prod(np.maximum(hi - lo, 1e-3)))
    vol = min(_ladder(vol, 1e-9), D**3)

    logtol = math.log(1.0 / tol)
    N_q = max(1, 2 ** math.ceil(math.log2(max(N, 1))))
    rc = (target_occ * vol / N_q) ** (1.0 / 3.0)
    rc = min(rc, D)
    xi = math.sqrt(max(logtol, 1.0)) / rc
    P = max(6, min(26, int(math.ceil(logtol / 1.2)) + 2))

    # fixed point for (xi, R, L_box, M) under the grid cap
    k_rule = 2.0 * math.sqrt(logtol + 4.0)
    for _ in range(4):
        R = D + (math.sqrt(logtol) + 3.0) / xi
        L_box = D + R + 4.0 / xi
        M_req = int(math.ceil(k_rule * xi * L_box / math.pi))
        if M_req <= max_grid:
            break
        xi = (math.pi * max_grid / L_box) / k_rule
    M = min(M_req, max_grid)
    M = max(M, 2 * P)
    M += M % 2
    rc = math.sqrt(max(logtol, 1.0)) / xi
    h = L_box / M
    tau = (P * h) ** 2 / (16.0 * logtol)

    # near-field cell lattice over the cloud's bbox, one slack cell a side,
    # anchored on the cell lattice
    cell_size = max(rc, 1e-6)
    ext_q = np.array([_ladder(float(e), 1e-3)
                      for e in np.maximum(hi - lo, 1e-3)])
    cells3 = tuple(int(math.ceil(e / cell_size)) + 2 for e in ext_q)
    cell_lo = tuple(float(cell_size * (math.floor(a / cell_size) - 1))
                    for a in lo)

    center = (lo + hi) / 2.0
    anchor = cell_size * np.floor(center / cell_size)
    box_lo = tuple(float(a) for a in (anchor - L_box / 2.0))

    ci = np.clip(((pts - np.asarray(cell_lo)) / cell_size).astype(int), 0,
                 np.asarray(cells3) - 1)
    if n_fill:
        fp = _fill_positions_np((cell_lo, cells3, cell_size), int(n_fill))
        cif = np.clip(((fp - np.asarray(cell_lo)) / cell_size).astype(int),
                      0, np.asarray(cells3) - 1)
        ci = np.vstack([ci, cif])
    flat = (ci[:, 0] * cells3[1] + ci[:, 1]) * cells3[2] + ci[:, 2]
    occ = int(np.bincount(flat, minlength=int(np.prod(cells3))).max()) \
        if len(flat) else 1
    # x1.5 / 8-aligned capacity rungs with 15% headroom
    need = occ * 1.15
    rung = 8.0
    while rung < need:
        rung *= 1.5
    occ = int(-8 * (-rung // 8))

    near_mode = "cells"
    block = 128
    K = 0
    n_src_eff = len(pts) if n_src is None else int(n_src)
    if (n_fill == 0 and n_src_eff >= 4 * block
            and occ > 6.0 * target_occ):
        near_mode = "blocks"

        def bboxes(a):
            nb = -(-len(a) // block)
            padded = np.concatenate(
                [a, np.repeat(a[-1:], nb * block - len(a), axis=0)])
            blk = padded.reshape(nb, block, 3)
            return blk.min(axis=1), blk.max(axis=1)

        # K counted with the runtime partitions: source blocks over the
        # leading n_src points, target blocks over the whole cloud
        s_lo, s_hi = bboxes(pts[:n_src_eff])
        t_lo, t_hi = bboxes(pts)
        most = 0
        for c0 in range(0, len(t_lo), _PLAN_GAP_CHUNK):
            tl = t_lo[c0:c0 + _PLAN_GAP_CHUNK, None]
            th = t_hi[c0:c0 + _PLAN_GAP_CHUNK, None]
            gap = np.maximum(0.0, np.maximum(s_lo[None] - th, tl - s_hi[None]))
            within = (gap**2).sum(-1) <= rc * rc
            most = max(most, int(within.sum(axis=1).max()))
        k_need = most * 1.3
        rung = 8.0
        while rung < k_need:
            rung *= 1.5
        K = int(min(-8 * (-rung // 8), len(s_lo)))

    return EwaldPlan(xi=float(xi), rc=float(rc), R=float(R),
                     box_lo=box_lo, box_L=float(L_box), M=int(M), P=int(P),
                     tau=float(tau), cell_lo=cell_lo, cells3=cells3,
                     cell_size=float(cell_size), max_occ=occ,
                     eta=float(eta), near_mode=near_mode, block=block,
                     K=int(K))


# ---------------------------------------------------------------- near field

def _bucket_points(plan, pts, payload, cell_index):
    """Sort points into [prod(cells3), max_occ] buckets (padded with far
    sentinels and zero payload); returns (points, payload, the points a
    cell). ``cell_index(pts) -> [n, 3]`` int64 cell coordinates, clipped.
    The rank in a cell comes from a stable sort, as `jnp.argsort`'s, and
    is clamped at ``max_occ - 1`` as in the JAX package (the plan sized
    the capacity with headroom)."""
    Cx, Cy, Cz = plan.cells3
    C3 = Cx * Cy * Cz
    ci = cell_index(pts)
    flat = (ci[:, 0] * Cy + ci[:, 1]) * Cz + ci[:, 2]
    order = torch.argsort(flat, stable=True)
    flat_s = flat[order]
    counts = torch.bincount(flat_s, minlength=C3)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_s.shape[0], device=pts.device) - starts[flat_s]
    rank = torch.clamp_max(rank, plan.max_occ - 1)
    slot = flat_s * plan.max_occ + rank
    B = C3 * plan.max_occ
    bpts = torch.full((B, 3), 1e8, dtype=pts.dtype, device=pts.device)
    bpts[slot] = pts[order]
    bpay = payload.new_zeros((B,) + tuple(payload.shape[1:]))
    bpay[slot] = payload[order]
    return (bpts.reshape(C3, plan.max_occ, 3),
            bpay.reshape((C3, plan.max_occ) + tuple(payload.shape[1:])),
            counts)


def _clip_cells(plan, ci):
    return torch.minimum(torch.clamp_min(ci, 0),
                         torch.tensor(plan.cells3, device=ci.device) - 1)


_NBR_OFFSETS = np.array([(i, j, k) for i in (-1, 0, 1)
                         for j in (-1, 0, 1) for k in (-1, 0, 1)],
                        dtype=np.int64)  # [27, 3]

#: pairs of one near-field tile ([chunk, targets, sources]); ~10 such
#: temporaries are live at once, so 32M is ~1.3 GB in f32, 2.6 GB in f64
_NEAR_TILE_BUDGET = 32_000_000


def _neighbor_ids(plan, periodic, device):
    """[C3, 27] neighbor cell ids (``periodic`` per axis: wrap, else clip)
    and the first-occurrence mask that de-duplicates clipped ids."""
    Cx, Cy, Cz = plan.cells3
    C3 = Cx * Cy * Cz
    cid = torch.arange(C3, device=device)
    cx, rem = cid // (Cy * Cz), cid % (Cy * Cz)
    cy, cz = rem // Cz, rem % Cz
    offs = torch.as_tensor(_NBR_OFFSETS, device=device)

    def move(c, off, C, wrap):
        n = c[:, None] + off[None, :]
        return n % C if wrap else torch.clamp(n, 0, C - 1)

    nx = move(cx, offs[:, 0], Cx, periodic[0])
    ny = move(cy, offs[:, 1], Cy, periodic[1])
    nz = move(cz, offs[:, 2], Cz, periodic[2])
    nid = (nx * Cy + ny) * Cz + nz
    eq = nid[:, :, None] == nid[:, None, :]
    tri = torch.tril(torch.ones((27, 27), dtype=torch.bool, device=device),
                     diagonal=-1)
    uniq = ~torch.any(eq & tri[None], dim=2)
    return nid, uniq


def _cell_near_field(plan, src_b, f_b, counts_s, trg_b, idx_b, counts_t,
                     n_trg, nid, uniq, tile_fn):
    """The cell-list near field from bucketed sources and targets: each
    cell's targets against its 27 neighbor cells' sources, then added back
    in target order (padded target slots masked by the cells' occupancy).
    ``tile_fn(t_pts [c, t, 3], s_pts [c, 27 s, 3], s_f [c, 27 s, ...]) ->
    [c, t, 3]``; returns the unscaled [n_trg, 3].

    A bucket's slots past its occupancy hold far sentinels with zero
    payload, whose pairs add exact zeros, so each chunk of cells takes
    only as many slots as its fullest target cell and its fullest
    neighbor source cell: the JAX package's sum over the padded
    [max_occ, 27 max_occ] tiles up to summation order, without the
    padding's work. Cells go in order of occupancy, chunked so a tile
    holds at most `_NEAR_TILE_BUDGET` pairs; the occupancies are read on
    the host once a call (a device sync)."""
    C3 = nid.shape[0]
    mo = plan.max_occ
    dev = trg_b.device
    occ_t = np.minimum(counts_t.cpu().numpy(), mo)
    occ_s = np.minimum(counts_s.cpu().numpy(), mo)
    reach = occ_s[nid.cpu().numpy()].max(axis=1)   # fullest neighbor cell
    cells = np.flatnonzero((occ_t > 0) & (reach > 0))
    cells = cells[np.argsort(-occ_t[cells], kind="stable")]
    u_b = torch.zeros((C3, mo, 3), dtype=trg_b.dtype, device=dev)
    pay_shape = tuple(f_b.shape[2:])
    i = 0
    while i < len(cells):
        mt = int(occ_t[cells[i]])
        ms = int(reach[cells[i]])
        j = i + 1
        while j < len(cells):
            grown = max(ms, int(reach[cells[j]]))
            if (j + 1 - i) * mt * 27 * grown > _NEAR_TILE_BUDGET:
                break
            ms = grown
            j += 1
        chunk = torch.as_tensor(cells[i:j], device=dev)
        ids = nid[chunk]                                # [c, 27]
        c = ids.shape[0]
        s_pts = src_b[:, :ms][ids].reshape(c, 27 * ms, 3)
        pay = f_b[:, :ms][ids]                          # [c, 27, ms, ...]
        mask = uniq[chunk].reshape((c, 27) + (1,) * (pay.ndim - 2))
        s_f = torch.where(mask, pay, 0.0).reshape((c, 27 * ms) + pay_shape)
        u_b[chunk, :mt] = tile_fn(trg_b[chunk, :mt], s_pts, s_f)
        i = j

    slot_rank = torch.arange(C3 * mo, device=dev) % mo
    valid = slot_rank < torch.repeat_interleave(counts_t, mo)
    out = torch.zeros((n_trg, 3), dtype=trg_b.dtype, device=dev)
    out.index_add_(0, idx_b.reshape(-1),
                   torch.where(valid[:, None], u_b.reshape(-1, 3), 0.0))
    return out


def _near_field(plan: EwaldPlan, cell_lo, r_src, f_src, r_trg,
                near_fn=None):
    """Cell-list near field: dense screened tiles over the 27 neighbor
    cells (boundary-clipped ids de-duplicated), chunked by cells.
    ``near_fn(trg, src, payload, xi) -> [..., t, 3]`` is the screened pair
    tile (Stokeslet by default; the stresslet evaluator passes its own)."""
    if near_fn is None:
        near_fn = stokeslet_near_block

    def cell_index(p):
        return _clip_cells(plan, ((p - cell_lo) / plan.cell_size).to(
            torch.int64))

    src_b, f_b, counts_s = _bucket_points(plan, r_src, f_src, cell_index)
    idx = torch.arange(r_trg.shape[0], device=r_trg.device)
    trg_b, idx_b, counts_t = _bucket_points(plan, r_trg, idx, cell_index)
    nid, uniq = _neighbor_ids(plan, (False, False, False), r_trg.device)
    out = _cell_near_field(plan, src_b, f_b, counts_s, trg_b, idx_b,
                           counts_t, r_trg.shape[0], nid, uniq,
                           lambda t, s, f: near_fn(t, s, f, plan.xi))
    return out / (8.0 * math.pi * plan.eta)


def _near_field_blocks(plan: EwaldPlan, r_src, f_src, r_trg):
    """Block-sparse near field: tiles of `plan.block` consecutive nodes,
    each target block against its `plan.K` nearest source blocks by
    bounding-box gap (`torch.topk`; a cut inside a tie may pick other
    blocks than `lax.top_k`, which lie beyond rc)."""
    B = plan.block
    K = min(plan.K, -(-r_src.shape[0] // B))

    def blockify(a, n):
        pad = -(-n // B) * B - n
        return torch.cat([a, a[-1:].expand(pad, 3)]) if pad else a

    n_s = r_src.shape[0]
    n_t = r_trg.shape[0]
    sp = blockify(r_src, n_s).reshape(-1, B, 3)
    # pad source rows carry zero strength (they duplicate the last point)
    sf = torch.cat([f_src, f_src.new_zeros((sp.shape[0] * B - n_s, 3))]
                   ).reshape(-1, B, 3)
    tp = blockify(r_trg, n_t).reshape(-1, B, 3)

    s_lo, s_hi = sp.amin(dim=1), sp.amax(dim=1)
    t_lo, t_hi = tp.amin(dim=1), tp.amax(dim=1)
    gap = torch.clamp_min(torch.maximum(s_lo[None] - t_hi[:, None],
                                        t_lo[:, None] - s_hi[None]), 0.0)
    d2 = torch.sum(gap * gap, dim=-1)                   # [TB, SB]
    del gap
    sidx = torch.topk(-d2, K, dim=1).indices            # [TB, K]

    TB = tp.shape[0]
    chunk = max(1, min(TB, _NEAR_TILE_BUDGET // max(B * K * B, 1)))
    u = torch.empty((TB, B, 3), dtype=r_trg.dtype, device=r_trg.device)
    for c0 in range(0, TB, chunk):
        idx = sidx[c0:c0 + chunk]
        c = idx.shape[0]
        u[c0:c0 + chunk] = stokeslet_near_block(
            tp[c0:c0 + chunk], sp[idx].reshape(c, K * B, 3),
            sf[idx].reshape(c, K * B, 3), plan.xi)
    return u.reshape(-1, 3)[:n_t] / (8.0 * math.pi * plan.eta)


# ----------------------------------------------------------------- far field

def _window_1d(x, h, tau, P, dtype):
    """One axis of the separable Gaussian window: (i0 [N] leftmost grid
    index, weights [N, P])."""
    u = x / h
    i0 = torch.floor(u - (P - 1) / 2.0).to(torch.int64)
    grid_pos = (i0[:, None] + torch.arange(P, device=x.device)[None, :]
                ).to(dtype) * h
    d = x[:, None] - grid_pos
    return i0, torch.exp(-d * d / (4.0 * tau))


def _window_indices(M3, h3, tau3, P, pts_local, dtype):
    """Flat grid indices [N, P^3] (wrapped mod the grid) and the separable
    weight products [N, P^3]; ``M3``, ``h3``, ``tau3`` per axis."""
    Mx, My, Mz = M3
    ix, wx = _window_1d(pts_local[:, 0], h3[0], tau3[0], P, dtype)
    iy, wy = _window_1d(pts_local[:, 1], h3[1], tau3[1], P, dtype)
    iz, wz = _window_1d(pts_local[:, 2], h3[2], tau3[2], P, dtype)
    p_idx = torch.arange(P, device=pts_local.device)
    gx = (ix[:, None] + p_idx[None, :]) % Mx
    gy = (iy[:, None] + p_idx[None, :]) % My
    gz = (iz[:, None] + p_idx[None, :]) % Mz
    flat = ((gx[:, :, None, None] * My + gy[:, None, :, None]) * Mz
            + gz[:, None, None, :])
    w3 = (wx[:, :, None, None] * wy[:, None, :, None]
          * wz[:, None, None, :])
    n = pts_local.shape[0]
    return flat.reshape(n, -1), w3.reshape(n, -1)


#: elements of one gridding chunk ([chunk, P^3]): the int64 indices, the
#: weights and the [chunk, P^3, C] values, ~2-4 GB at 64M
_GRID_CHUNK_BUDGET = 64_000_000


def _grid_geometry(plan):
    """(M3, h3, tau3) of an Ewald plan (isotropic)."""
    return (plan.M,) * 3, (plan.h,) * 3, (plan.tau,) * 3


def _spread_grid(M3, h3, tau3, P, pts_local, values, dtype):
    """Type-1 gridding: scatter values [N, C] onto a [C, Mx, My, Mz] grid,
    in point chunks."""
    n = pts_local.shape[0]
    C = values.shape[-1]
    chunk = max(1, min(n, _GRID_CHUNK_BUDGET // P**3))
    grid = torch.zeros((math.prod(M3), C), dtype=dtype,
                       device=pts_local.device)
    for p0 in range(0, n, chunk):
        flat, w3 = _window_indices(M3, h3, tau3, P, pts_local[p0:p0 + chunk],
                                   dtype)
        contrib = w3[..., None] * values[p0:p0 + chunk, None, :]
        grid.index_add_(0, flat.reshape(-1), contrib.reshape(-1, C))
    return grid.T.reshape((C,) + tuple(M3))


def _interp_grid(M3, h3, tau3, P, pts_local, grid, dtype):
    """Type-2 interpolation: gather the [C, Mx, My, Mz] grid at points
    [N, 3] -> [N, C], chunked like `_spread_grid`."""
    n = pts_local.shape[0]
    C = grid.shape[0]
    chunk = max(1, min(n, _GRID_CHUNK_BUDGET // P**3))
    flat_grid = grid.reshape(C, -1).T.contiguous()       # [M^3, C]
    out = torch.empty((n, C), dtype=dtype, device=pts_local.device)
    for p0 in range(0, n, chunk):
        flat, w3 = _window_indices(M3, h3, tau3, P, pts_local[p0:p0 + chunk],
                                   dtype)
        vals = flat_grid[flat]                            # [c, P^3, C]
        out[p0:p0 + chunk] = torch.einsum("np,npk->nk", w3, vals)
    return out


def _spread(plan: EwaldPlan, pts_local, values, dtype):
    return _spread_grid(*_grid_geometry(plan), plan.P, pts_local, values,
                        dtype)


def _interp(plan: EwaldPlan, pts_local, grid, dtype):
    return _interp_grid(*_grid_geometry(plan), plan.P, pts_local, grid,
                        dtype)


def _kgrid(plan: EwaldPlan, dtype, device):
    """(kx, ky, kz, k2, scalar): the wave vectors on the half spectrum and
    the scalar folding the truncated screened transform, the h^3
    quadrature factor, the window deconvolution and 1/(8 pi eta)."""
    M = plan.M
    h = plan.h
    f64 = torch.float64
    k_full = (2.0 * math.pi * torch.fft.fftfreq(M, d=h, dtype=f64,
                                                device=device)).to(dtype)
    k_half = (2.0 * math.pi * torch.fft.rfftfreq(M, d=h, dtype=f64,
                                                 device=device)).to(dtype)
    kx = k_full[:, None, None]
    ky = k_full[None, :, None]
    kz = k_half[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    Bhat = bhat_far_trunc(torch.sqrt(k2), plan.xi, plan.R)
    what = ((4.0 * math.pi * plan.tau) ** 1.5) * torch.exp(-plan.tau * k2)
    scalar = Bhat * (h ** 3) / (what * what) / (8.0 * math.pi * plan.eta)
    return kx, ky, kz, k2, scalar


def _stokeslet_multiplier(kx, ky, kz, k2, coeff, Hk):
    """-(k^2 I - k k^T) applied to the [3, ...] half spectrum ``Hk`` times
    ``coeff`` (the Stokeslet's k-space multiplier)."""
    kdotF = kx * Hk[0] + ky * Hk[1] + kz * Hk[2]
    return torch.stack([coeff * (k2 * Hk[0] - kx * kdotF),
                        coeff * (k2 * Hk[1] - ky * kdotF),
                        coeff * (k2 * Hk[2] - kz * kdotF)])


def _stresslet_multiplier(kv, k2, coeff, Hk):
    """The stresslet's k-space multiplier on the [9, ...] half spectrum
    (row-major jk channels): coeff [k_i (k.S.k) - (k^2/2)(((S + S^T) k)_i
    + tr(S) k_i)]."""
    kSk = sum(kv[j] * kv[k] * Hk[3 * j + k]
              for j in range(3) for k in range(3))
    trS = Hk[0] + Hk[4] + Hk[8]
    return torch.stack([
        coeff * (kv[i] * kSk
                 - 0.5 * k2 * (sum(kv[k] * (Hk[3 * i + k] + Hk[3 * k + i])
                                   for k in range(3))
                               + trS * kv[i]))
        for i in range(3)])


def _fourier_stokeslet(plan: EwaldPlan, H):
    """rfftn of the spread [3, M, M, M] grid, the Stokeslet multiplier,
    irfftn: the velocity grid [3, M, M, M]."""
    M = plan.M
    Hk = torch.fft.rfftn(H, dim=(1, 2, 3))
    kx, ky, kz, k2, scalar = _kgrid(plan, H.dtype, H.device)
    Uk = _stokeslet_multiplier(kx, ky, kz, k2, -scalar, Hk)
    del Hk
    return torch.fft.irfftn(Uk, s=(M, M, M), dim=(1, 2, 3))


def _fourier_stresslet(plan: EwaldPlan, H):
    """The stresslet's Fourier stage on the spread [9, M, M, M] grid."""
    M = plan.M
    Hk = torch.fft.rfftn(H, dim=(1, 2, 3))
    kx, ky, kz, k2, scalar = _kgrid(plan, H.dtype, H.device)
    Uk = _stresslet_multiplier((kx, ky, kz), k2, 1j * scalar, Hk)
    del Hk
    return torch.fft.irfftn(Uk, s=(M, M, M), dim=(1, 2, 3))


def _far_field(plan: EwaldPlan, lo, r_src, f_src, r_trg):
    """Gridded Stokeslet far field: spread, Fourier stage, interpolate
    (the normalization is the JAX module's)."""
    dtype = r_src.dtype
    H = _spread(plan, r_src - lo, f_src, dtype)           # [3, M, M, M]
    U = _fourier_stokeslet(plan, H)
    del H
    return _interp(plan, r_trg - lo, U.to(dtype), dtype)


def _far_field_stresslet(plan: EwaldPlan, lo, r_dl, f_dl, r_trg):
    """Gridded stresslet far field: the 9-component source spread, the
    stresslet multiplier, interpolated back."""
    dtype = r_dl.dtype
    H = _spread(plan, r_dl - lo, f_dl.reshape(-1, 9), dtype)
    U = _fourier_stresslet(plan, H)
    del H
    return _interp(plan, r_trg - lo, U.to(dtype), dtype)


def stresslet_impl(plan: EwaldPlan, anchors, r_dl, r_trg, f_dl, eta):
    """Stresslet sum on ``plan`` with its [2, 3] ``anchors`` (box_lo,
    cell_lo) at viscosity ``eta``, as `stokeslet_impl`: always the cells
    near field (blocks mode's K was measured for the fiber-node
    sources)."""
    lo_box = anchors[0].to(r_dl.dtype)
    lo_cell = anchors[1].to(r_dl.dtype)
    u_near = _near_field(plan, lo_cell, r_dl, f_dl, r_trg,
                         near_fn=stresslet_near_block_ewald)
    u_far = _far_field_stresslet(plan, lo_box, r_dl, f_dl, r_trg)
    # no self term: every coefficient of the screened double layer
    # vanishes at r = 0
    return (u_near + u_far) * (plan.eta / eta)


def stresslet_ewald(plan: EwaldPlan, r_dl, r_trg, f_dl):
    """Singular stresslet (double-layer) sum via spectral Ewald: the
    semantics of `kernels.stresslet_direct` (``f_dl`` [n_src, 3, 3],
    coincident pairs drop, factor 1/(8 pi eta))."""
    from .evaluator import make_pair

    return make_pair(plan, r_dl.device).stresslet(r_dl, r_trg, f_dl,
                                                  plan.eta)


def stokeslet_impl(plan: EwaldPlan, anchors, r_src, r_trg, f_src,
                   n_self: int, eta):
    """Stokeslet sum on ``plan`` with its [2, 3] ``anchors`` (box_lo,
    cell_lo) at viscosity ``eta`` (the plan baked its own eta in; the
    screened kernels scale as 1 / eta)."""
    lo_box = anchors[0].to(r_src.dtype)
    lo_cell = anchors[1].to(r_src.dtype)
    # blocks mode only when the targets are the sources, all of them or a
    # leading run of them (target blocks the plan measured K for: the
    # rows of such a run are those of the whole sum); disjoint probe sets
    # take the cells path. (The JAX package takes blocks mode only for
    # all of the sources.)
    if plan.near_mode == "blocks" and n_self and n_self in (
            r_src.shape[0], r_trg.shape[0]):
        u_near = _near_field_blocks(plan, r_src, f_src, r_trg)
    else:
        u_near = _near_field(plan, lo_cell, r_src, f_src, r_trg)
    u_far = _far_field(plan, lo_box, r_src, f_src, r_trg)
    if n_self:
        self_coeff = 4.0 * plan.xi / (_SQRT_PI * 8.0 * math.pi * plan.eta)
        u_far[:n_self] += -self_coeff * f_src[:n_self]
    return (u_near + u_far) * (plan.eta / eta)


def stokeslet_ewald(plan: EwaldPlan, r_src, r_trg, f_src,
                    n_self: int | None = None):
    """Singular Stokeslet sum via spectral Ewald: near + far.

    The semantics of `kernels.stokeslet_direct`: coincident self pairs
    drop (the near tile masks them, and the far field's smooth self term
    ``4 xi/(sqrt(pi) 8 pi eta) f`` is subtracted for the first ``n_self``
    targets, which must be ``r_src[:n_self]`` in order). ``n_self=None``
    means all targets when ``r_trg is r_src`` and none otherwise.
    """
    from .evaluator import make_pair

    if n_self is None:
        n_self = r_src.shape[0] if r_trg is r_src else 0
    return make_pair(plan, r_src.device).stokeslet(r_src, r_trg, f_src,
                                                   int(n_self), plan.eta)
