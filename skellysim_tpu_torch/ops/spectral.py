"""Periodic and slab-confined spectral Ewald Stokeslet and stresslet sums.

Counterpart of `skellysim_tpu.ops.spectral` (the reference's "PVFMM"
slot): triply periodic boxes ("tp", 3 lengths) and doubly periodic slabs
("dp", x/y periodic, z free, 2 lengths). The near field is `ops.ewald`'s
screened tiles summed over minimum images on a cell list that wraps on
the periodic axes; the far field is the periodic Hasimoto multiplier on an
anisotropic grid (the k = 0 mode dropped: zero mean flow), and for a slab
the kperp = 0 column takes the truncated 1D kernel. The mathematics is
documented in the JAX module and pinned there by `tests/test_spectral.py`
against dense lattice oracles; this module computes the same sums on the
same plan with `torch.fft`.

`plan_spectral` is host numpy and returns a plan equal field for field to
the JAX package's on the same points. Grid dims snap onto the
FFT-friendly `GRID_RUNGS` (or a caller's ladder). The sums take the
plan's anchors as a [2, 3] tensor, as in `ops.ewald`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.profile import phase
from .ewald import (_bucket_points, _cell_near_field, _interp_grid,
                    _ladder, _neighbor_ids, _spread_grid,
                    _stokeslet_multiplier, _stresslet_multiplier,
                    stokeslet_disp_block, stresslet_disp_block_ewald)

__all__ = ["SpectralPlan", "plan_spectral", "stokeslet_spectral",
           "stresslet_spectral", "fill_positions", "GRID_RUNGS"]

_SQRT_PI = math.sqrt(math.pi)

#: the runtime evaluator name whose plans this module owns
EVALUATOR = "spectral"
#: the plan's anchor fields, in the order of `ops.evaluator.make_pair`'s
#: anchor rows, and the row `fill_positions` is placed from
ANCHORS = ("box_lo", "cell_lo")
FILL_ANCHOR = 1

#: FFT-friendly grid-dimension ladder (2^a 3^b, ~x1.5 geometric)
GRID_RUNGS = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def _grid_rung(n, ladder):
    """Smallest ladder rung >= n (the top rung caps oversized requests)."""
    for r in ladder:
        if r >= n:
            return int(r)
    return int(ladder[-1])


# ---------------------------------------------------------------------- plan

@dataclass(frozen=True)
class SpectralPlan:
    """Geometry and resolution of one periodic spectral-Ewald evaluation
    (the JAX package's `SpectralPlan`, field for field): per-axis grid
    dims, extents, window variances and cell sizes."""

    mode: str                 # "tp" (triply periodic) | "dp" (slab)
    xi: float                 # splitting parameter
    rc: float                 # near-field cutoff (<= min periodic L / 2)
    Rz: float                 # dp kperp=0 column truncation radius (tp: 0)
    box_lo: tuple             # FFT grid anchor
    box_L: tuple              # per-axis grid extents
    M3: tuple                 # per-axis grid points (GRID_RUNGS rungs)
    P: int                    # window support (grid points per dim)
    tau3: tuple               # per-axis Gaussian window variances
    cell_lo: tuple            # near-field cell-lattice anchor
    cells3: tuple             # per-axis cell counts
    cell_size3: tuple         # per-axis cell sizes (>= rc)
    max_occ: int              # per-cell capacity
    eta: float

    @property
    def h3(self) -> tuple:
        return tuple(L / m for L, m in zip(self.box_L, self.M3))

    @property
    def Lper(self) -> tuple:
        """Periodic lengths with 0.0 marking the free axis."""
        if self.mode == "tp":
            return self.box_L
        return (self.box_L[0], self.box_L[1], 0.0)


#: the R2 low-discrepancy lattice `ops.ewald` uses for padding placement
_R2_ALPHAS = (0.8191725133961645, 0.6710436067037893, 0.5497004779019703)


def fill_positions(plan: SpectralPlan, cell_lo, n, dtype):
    """[n, 3] well-spread positions inside the near-field cell region for
    zero-strength padding nodes (`ewald.fill_positions`, per-axis sizes)."""
    dev = cell_lo.device
    t = (torch.arange(n, dtype=dtype, device=dev) + 0.5)[:, None]
    alphas = torch.tensor(_R2_ALPHAS, dtype=dtype, device=dev)[None, :]
    frac = torch.remainder(t * alphas, 1.0)
    extent = ((torch.tensor(plan.cells3, dtype=dtype, device=dev) - 0.01)
              * torch.tensor(plan.cell_size3, dtype=dtype, device=dev))
    return cell_lo.to(dtype) + frac * extent


def _fill_positions_np(plan_like, n):
    """NumPy mirror of `fill_positions` for host-side occupancy counting."""
    t = (np.arange(n, dtype=np.float64) + 0.5)[:, None]
    frac = (t * np.asarray(_R2_ALPHAS)[None, :]) % 1.0
    cell_lo, cells3, cell_size3 = plan_like
    extent = (np.asarray(cells3, dtype=np.float64) - 0.01) \
        * np.asarray(cell_size3, dtype=np.float64)
    return np.asarray(cell_lo) + frac * extent


#: host plans made so far in this process (the audit's retrace probe
#: counts them: `audit.registry.rebuild_counts`)
REBUILDS = {"plan_spectral": 0}


def plan_spectral(points, box, eta, tol=1e-6, max_grid=512, target_occ=32.0,
                  n_fill=0, grid_ladder=()):
    """Choose (xi, rc, grid M3, window P, cell lattice) for a target
    relative tolerance on a periodic box: the JAX package's
    `plan_spectral`, rule for rule, on the host in numpy.

    ``box``: 3 lengths -> triply periodic, 2 lengths (Lx, Ly) -> doubly
    periodic slab with z free (extent measured from the cloud).
    """
    REBUILDS["plan_spectral"] += 1
    box = tuple(float(b) for b in box)
    if len(box) not in (2, 3):
        raise ValueError(
            f"periodic box must have 2 (slab) or 3 (triply periodic) "
            f"lengths, got {len(box)}")
    if min(box) <= 0.0:
        raise ValueError(f"periodic box lengths must be positive: {box}")
    mode = "tp" if len(box) == 3 else "dp"
    rungs = tuple(int(r) for r in (grid_ladder or GRID_RUNGS))
    rungs_capped = tuple(r for r in rungs if r <= max_grid) or rungs[:1]

    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    lo = pts.min(axis=0) if len(pts) else np.zeros(3)
    hi = pts.max(axis=0) if len(pts) else np.zeros(3)
    logtol = math.log(1.0 / tol)
    N = max(len(pts) + int(n_fill), 1)
    N_q = max(1, 2 ** math.ceil(math.log2(N)))

    if mode == "dp":
        Dz = _ladder(max(float(hi[2] - lo[2]), 1e-3), 1e-3)
        vol = box[0] * box[1] * Dz
        min_Lper = min(box[0], box[1])
    else:
        Dz = 0.0
        vol = box[0] * box[1] * box[2]
        min_Lper = min(box)

    rc = (target_occ * vol / N_q) ** (1.0 / 3.0)
    rc = min(rc, min_Lper / 2.0)
    xi = math.sqrt(max(logtol, 1.0)) / rc
    P = max(6, min(26, int(math.ceil(logtol / 1.2)) + 2))

    # fixed point for (xi, Rz, Lz_grid, M3) under the grid cap
    k_rule = 2.0 * math.sqrt(logtol + 4.0)
    Rz = 0.0
    for _ in range(4):
        if mode == "dp":
            Rz = Dz + (math.sqrt(logtol) + 3.0) / xi
            pad_k = (logtol + 3.0) * max(box[0], box[1]) / (2.0 * math.pi)
            Lz_grid = Dz + max(Rz + 4.0 / xi, pad_k)
            L3 = (box[0], box[1], Lz_grid)
        else:
            L3 = box
        M_req = [int(math.ceil(k_rule * xi * L / math.pi)) for L in L3]
        if max(M_req) <= max_grid:
            break
        xi = (math.pi * max_grid / max(L3)) / k_rule
        rc = min(math.sqrt(max(logtol, 1.0)) / xi, min_Lper / 2.0)
        xi = math.sqrt(max(logtol, 1.0)) / rc
    M3 = tuple(max(_grid_rung(m, rungs_capped),
                   _grid_rung(2 * P, rungs_capped)) for m in M_req)
    tau3 = tuple((P * L / M) ** 2 / (20.0 * logtol)
                 for L, M in zip(L3, M3))

    # near-field cell lattice: periodic axes tile the box exactly; the
    # free axis clips like `plan_ewald`
    cell_size3 = []
    cells3 = []
    cell_lo = []
    for ax in range(3):
        if mode == "tp" or ax < 2:
            L = box[ax]
            C = max(int(L / rc), 1)
            s = L / C
            a = s * math.floor(float(lo[ax]) / s)
        else:
            s = max(rc, 1e-6)
            ext_q = _ladder(max(float(hi[2] - lo[2]), 1e-3), 1e-3)
            C = int(math.ceil(ext_q / s)) + 2
            a = s * (math.floor(float(lo[2]) / s) - 1)
        cell_size3.append(float(s))
        cells3.append(int(C))
        cell_lo.append(float(a))
    cell_size3 = tuple(cell_size3)
    cells3 = tuple(cells3)
    cell_lo = tuple(cell_lo)

    if mode == "dp":
        center_z = float(lo[2] + hi[2]) / 2.0
        anchor_z = cell_size3[2] * math.floor(center_z / cell_size3[2])
        box_lo = (cell_lo[0], cell_lo[1], float(anchor_z - L3[2] / 2.0))
    else:
        box_lo = cell_lo

    def cell_index(p):
        idx = np.empty((len(p), 3), dtype=np.int64)
        for ax in range(3):
            x = p[:, ax] - cell_lo[ax]
            if mode == "tp" or ax < 2:
                x = x - box[ax] * np.floor(x / box[ax])
            i = np.floor(x / cell_size3[ax]).astype(np.int64)
            idx[:, ax] = np.clip(i, 0, cells3[ax] - 1)
        return idx

    ci = cell_index(pts) if len(pts) else np.zeros((0, 3), np.int64)
    if n_fill:
        fp = _fill_positions_np((cell_lo, cells3, cell_size3), int(n_fill))
        ci = np.vstack([ci, cell_index(fp)])
    flat = (ci[:, 0] * cells3[1] + ci[:, 1]) * cells3[2] + ci[:, 2]
    occ = int(np.bincount(flat, minlength=int(np.prod(cells3))).max()) \
        if len(flat) else 1
    need = occ * 1.15
    rung = 8.0
    while rung < need:
        rung *= 1.5
    occ = int(-8 * (-rung // 8))

    return SpectralPlan(mode=mode, xi=float(xi), rc=float(rc), Rz=float(Rz),
                        box_lo=box_lo, box_L=tuple(float(L) for L in L3),
                        M3=M3, P=int(P), tau3=tau3, cell_lo=cell_lo,
                        cells3=cells3, cell_size3=cell_size3, max_occ=occ,
                        eta=float(eta))


# ---------------------------------------------------------------- near field

def _wrap_positions(plan: SpectralPlan, cell_lo, pts):
    """Periodic coordinates wrapped into [cell_lo, cell_lo + L); the free
    axis passes through."""
    L = torch.tensor(plan.Lper, dtype=pts.dtype, device=pts.device)
    per = L > 0
    Ls = torch.where(per, L, 1.0)
    return torch.where(per, pts - Ls * torch.floor((pts - cell_lo) / Ls),
                       pts)


def _min_image(d, Lper):
    """Minimum-image displacement per periodic axis (free axes untouched)."""
    L = torch.tensor(Lper, dtype=d.dtype, device=d.device)
    per = L > 0
    Ls = torch.where(per, L, 1.0)
    return torch.where(per, d - Ls * torch.round(d / Ls), d)


def _near_field_per(plan: SpectralPlan, cell_lo, r_src, f_src, r_trg,
                    near_fn):
    """Periodic cell-list near field: screened tiles over the 27 wrap/clip
    neighbor cells with minimum-image displacements. ``near_fn(d,
    payload, xi)`` is a displacement-tile kernel; positions must already
    be wrapped (`_wrap_positions`)."""
    cs = torch.tensor(plan.cell_size3, dtype=r_trg.dtype,
                      device=r_trg.device)
    top = torch.tensor(plan.cells3, device=r_trg.device) - 1

    def cell_index(p):
        ci = torch.floor((p - cell_lo) / cs).to(torch.int64)
        return torch.minimum(torch.clamp_min(ci, 0), top)

    src_b, f_b, counts_s = _bucket_points(plan, r_src, f_src, cell_index)
    idx = torch.arange(r_trg.shape[0], device=r_trg.device)
    trg_b, idx_b, counts_t = _bucket_points(plan, r_trg, idx, cell_index)
    nid, uniq = _neighbor_ids(plan, (True, True, plan.mode == "tp"),
                              r_trg.device)
    Lper = plan.Lper

    def tile(t_pts, s_pts, s_f):
        d = _min_image(t_pts[..., :, None, :] - s_pts[..., None, :, :],
                       Lper)
        return near_fn(d, s_f, plan.xi)

    out = _cell_near_field(plan, src_b, f_b, counts_s, trg_b, idx_b,
                           counts_t, r_trg.shape[0], nid, uniq, tile)
    return out / (8.0 * math.pi * plan.eta)


# ----------------------------------------------------------------- far field

def _spread(plan: SpectralPlan, pts_local, values, dtype):
    """Type-1 gridding onto the [C, Mx, My, Mz] grid, point-chunked."""
    return _spread_grid(plan.M3, plan.h3, plan.tau3, plan.P, pts_local,
                        values, dtype)


def _interp(plan: SpectralPlan, pts_local, grid, dtype):
    """Type-2 interpolation of the [C, Mx, My, Mz] grid at points."""
    return _interp_grid(plan.M3, plan.h3, plan.tau3, plan.P, pts_local,
                        grid, dtype)


def _kgrid_per(plan: SpectralPlan, dtype, device):
    """(kx, ky, kz, k2, scalar): the periodic Hasimoto multiplier
    Bhat_per = -8 pi Phi/k^4 (k = 0 dropped), the anisotropic quadrature
    factor, the separable window deconvolution and 1/(8 pi eta)."""
    Mx, My, Mz = plan.M3
    hx, hy, hz = plan.h3
    tx, ty, tz = plan.tau3
    f64 = torch.float64

    def freq(fn, M, h):
        return (2.0 * math.pi * fn(M, d=h, dtype=f64, device=device)).to(
            dtype)

    kx = freq(torch.fft.fftfreq, Mx, hx)[:, None, None]
    ky = freq(torch.fft.fftfreq, My, hy)[None, :, None]
    kz = freq(torch.fft.rfftfreq, Mz, hz)[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    x = k2 / (4.0 * plan.xi * plan.xi)
    ghat = (1.0 + x) * torch.exp(-x)
    k2s = torch.where(k2 > 0, k2, 1.0)
    Bhat = torch.where(k2 > 0, -8.0 * math.pi * ghat / (k2s * k2s), 0.0)
    what = (((4.0 * math.pi) ** 1.5) * math.sqrt(tx * ty * tz)
            * torch.exp(-(tx * kx * kx + ty * ky * ky + tz * kz * kz)))
    scalar = Bhat * (hx * hy * hz) / (what * what) / (8.0 * math.pi
                                                      * plan.eta)
    return kx, ky, kz, k2, scalar


def _t1_trunc(k, R):
    """1D transform of ``|z| 1_{|z|<R}``: T1(k) = 2(cos kR - 1)/k^2
    + 2 R sin(kR)/k, series R^2 (1 - (kR)^2/4 + (kR)^4/72) for small kR."""
    kR = k * R
    small = kR < 0.5
    ks = torch.where(small, 1.0, k)
    T_exact = 2.0 * (torch.cos(kR) - 1.0) / (ks * ks) \
        + 2.0 * R * torch.sin(kR) / ks
    kR2 = kR * kR
    T_series = R * R * (1.0 - kR2 / 4.0 + kR2 * kR2 / 72.0)
    return torch.where(small, T_series, T_exact)


def _column_geometry(plan: SpectralPlan, dtype, device):
    """The dp kperp = 0 column's (kz [Mzh], Phi(kz), grid scale
    hx hy hz / what(0, 0, kz)^2)."""
    hx, hy, hz = plan.h3
    tx, ty, tz = plan.tau3
    Mz = plan.M3[2]
    kz = (2.0 * math.pi * torch.fft.rfftfreq(
        Mz, d=hz, dtype=torch.float64, device=device)).to(dtype)
    x = kz * kz / (4.0 * plan.xi * plan.xi)
    ghat = (1.0 + x) * torch.exp(-x)
    what = (((4.0 * math.pi) ** 1.5) * math.sqrt(tx * ty * tz)
            * torch.exp(-tz * kz * kz))
    return kz, ghat, (hx * hy * hz) / (what * what)


def _column_stokeslet(plan: SpectralPlan, Hcol, dtype):
    """dp kperp = 0 Stokeslet column on ``Hcol`` [3, Mzh]: the truncated
    1D kernel -(T1(kz)/2) Phi(kz) on the x/y channels; z is zero."""
    kz, ghat, scale = _column_geometry(plan, dtype, Hcol.device)
    s0 = (-0.5 * _t1_trunc(kz, plan.Rz)) * ghat * scale / plan.eta
    return torch.stack([s0 * Hcol[0], s0 * Hcol[1],
                        torch.zeros_like(Hcol[2])])


def _column_stresslet(plan: SpectralPlan, Hcol, dtype):
    """dp kperp = 0 stresslet column on ``Hcol`` [9, Mzh]: multiplier
    i Phi/(2 eta kz) with the truncation (1 - cos kz R)/kz; u_x <- S_xz +
    S_zx, u_y <- S_yz + S_zy, u_z <- tr S (row-major 9)."""
    kz, ghat, scale = _column_geometry(plan, dtype, Hcol.device)
    kzs = torch.where(kz > 0, kz, 1.0)
    Ts = torch.where(kz > 0, (1.0 - torch.cos(kz * plan.Rz)) / kzs, 0.0)
    s0 = 1j * Ts * ghat * scale / (2.0 * plan.eta)
    return torch.stack([s0 * (Hcol[2] + Hcol[6]),
                        s0 * (Hcol[5] + Hcol[7]),
                        s0 * (Hcol[0] + Hcol[4] + Hcol[8])])


def _fourier_stokeslet(plan: SpectralPlan, H):
    """rfftn of the spread [3, Mx, My, Mz] grid, the periodic Stokeslet
    multiplier (and the dp column), irfftn."""
    dtype = H.dtype
    with phase("fft"):
        Hk = torch.fft.rfftn(H, dim=(1, 2, 3))
    with phase("kspace"):
        kx, ky, kz, k2, scalar = _kgrid_per(plan, dtype, H.device)
        Uk = _stokeslet_multiplier(kx, ky, kz, k2, -scalar, Hk)
        if plan.mode == "dp":
            Uk[:, 0, 0] = _column_stokeslet(plan, Hk[:, 0, 0], dtype)
    del Hk
    with phase("fft"):
        return torch.fft.irfftn(Uk, s=plan.M3, dim=(1, 2, 3))


def _fourier_stresslet(plan: SpectralPlan, H):
    """The stresslet's Fourier stage on the spread [9, Mx, My, Mz] grid."""
    dtype = H.dtype
    with phase("fft"):
        Hk = torch.fft.rfftn(H, dim=(1, 2, 3))
    with phase("kspace"):
        kx, ky, kz, k2, scalar = _kgrid_per(plan, dtype, H.device)
        Uk = _stresslet_multiplier((kx, ky, kz), k2, 1j * scalar, Hk)
        if plan.mode == "dp":
            Uk[:, 0, 0] = _column_stresslet(plan, Hk[:, 0, 0], dtype)
    del Hk
    with phase("fft"):
        return torch.fft.irfftn(Uk, s=plan.M3, dim=(1, 2, 3))


def _far_field(plan: SpectralPlan, lo, r_src, f_src, r_trg):
    """Gridded periodic Stokeslet far field (tp: the lattice multiplier;
    dp: the mixed lattice and the truncated kperp = 0 column)."""
    dtype = r_src.dtype
    with phase("spread"):
        H = _spread(plan, r_src - lo, f_src, dtype)
    U = _fourier_stokeslet(plan, H)
    del H
    with phase("interp"):
        return _interp(plan, r_trg - lo, U.to(dtype), dtype)


def _far_field_stresslet(plan: SpectralPlan, lo, r_dl, f_dl, r_trg):
    """Gridded periodic stresslet far field (9 channels, the dp column)."""
    dtype = r_dl.dtype
    with phase("spread"):
        H = _spread(plan, r_dl - lo, f_dl.reshape(-1, 9), dtype)
    U = _fourier_stresslet(plan, H)
    del H
    with phase("interp"):
        return _interp(plan, r_trg - lo, U.to(dtype), dtype)


# ------------------------------------------------------------ entry points

def stokeslet_impl(plan: SpectralPlan, anchors, r_src, r_trg, f_src,
                   n_self: int, eta):
    """Periodic Stokeslet sum on ``plan`` with its [2, 3] ``anchors``
    (box_lo, cell_lo) at viscosity ``eta`` (the plan baked its own eta in;
    the screened kernels scale as 1 / eta)."""
    lo_box = anchors[0].to(r_src.dtype)
    lo_cell = anchors[1].to(r_src.dtype)
    src_w = _wrap_positions(plan, lo_cell, r_src)
    trg_w = _wrap_positions(plan, lo_cell, r_trg)
    with phase("near"):
        u_near = _near_field_per(plan, lo_cell, src_w, f_src, trg_w,
                                 near_fn=stokeslet_disp_block)
    u_far = _far_field(plan, lo_box, src_w, f_src, trg_w)
    if n_self:
        # a coincident target's wave-space sum holds only the p = 0
        # image's smooth G_far(0): the free-space self coefficient
        self_coeff = 4.0 * plan.xi / (_SQRT_PI * 8.0 * math.pi * plan.eta)
        u_far[:n_self] += -self_coeff * f_src[:n_self]
    return (u_near + u_far) * (plan.eta / eta)


def stokeslet_spectral(plan: SpectralPlan, r_src, r_trg, f_src,
                       n_self: int | None = None):
    """Singular periodic Stokeslet sum via spectral Ewald, with the
    calling convention of `ewald.stokeslet_ewald`, summed over the
    periodic images of `plan`'s box (zero mean flow). Positions may be
    unwrapped."""
    from .evaluator import make_pair

    if n_self is None:
        n_self = r_src.shape[0] if r_trg is r_src else 0
    return make_pair(plan, r_src.device).stokeslet(r_src, r_trg, f_src,
                                                   int(n_self), plan.eta)


def stresslet_impl(plan: SpectralPlan, anchors, r_dl, r_trg, f_dl, eta):
    """Periodic stresslet sum on ``plan`` with its [2, 3] ``anchors`` at
    viscosity ``eta``."""
    lo_box = anchors[0].to(r_dl.dtype)
    lo_cell = anchors[1].to(r_dl.dtype)
    src_w = _wrap_positions(plan, lo_cell, r_dl)
    trg_w = _wrap_positions(plan, lo_cell, r_trg)
    with phase("near"):
        u_near = _near_field_per(plan, lo_cell, src_w, f_dl, trg_w,
                                 near_fn=stresslet_disp_block_ewald)
    u_far = _far_field_stresslet(plan, lo_box, src_w, f_dl, trg_w)
    # no self term: every screened double-layer coefficient vanishes at 0
    return (u_near + u_far) * (plan.eta / eta)


def stresslet_spectral(plan: SpectralPlan, r_dl, r_trg, f_dl):
    """Singular periodic stresslet (double-layer) sum via spectral Ewald
    (``f_dl`` [n_src, 3, 3], the semantics of `ewald.stresslet_ewald`)."""
    from .evaluator import make_pair

    return make_pair(plan, r_dl.device).stresslet(r_dl, r_trg, f_dl,
                                                  plan.eta)


# ---------------------------------------------------------------- the registry

def auditable_programs():
    """The periodic fast path's registry entry: the spectral Stokeslet on
    a triply periodic cloud of 256 points (FFT far field and wrapped near
    tiles, f64), the JAX package's ``stokeslet_spectral``."""
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice

    def retrace_probe(device=None):
        # a cell-lattice anchor hop with drifted positions (the JAX
        # package's probe)
        built = build(device)
        plan, anchors, r, _, f, n_self, eta = built.args
        return probe_twice(
            lambda: stokeslet_impl(*built.args),
            lambda _: stokeslet_impl(plan, anchors + plan.cell_size3[0],
                                     r + 0.01, r + 0.01, f, n_self, eta))

    def build(device=None):
        from ..device import resolve_device
        from .evaluator import make_pair

        dev = resolve_device(device)
        rng = np.random.default_rng(17)
        pts = rng.uniform(0.0, 4.0, (256, 3))
        f = rng.standard_normal((256, 3))
        plan = plan_spectral(pts, (4.0, 4.0, 4.0), eta=1.0, tol=1e-4)
        r = torch.as_tensor(pts, dtype=torch.float64, device=dev)
        return BuiltProgram(stokeslet_impl, (
            plan, make_pair(plan, dev).anchors, r, r,
            torch.as_tensor(f, dtype=torch.float64, device=dev),
            pts.shape[0], plan.eta), device=dev)

    return [AuditProgram(
        name="stokeslet_spectral", layer="ops",
        summary="periodic spectral-Ewald Stokeslet evaluator (triply "
                "periodic cloud, FFT far field + wrapped near tiles, f64)",
        build=build, retrace_probe=retrace_probe)]
