"""Pairwise Stokes kernels: the pair-kernel seam and its plain torch forms.

Counterpart of `skellysim_tpu.ops.kernels` for the families this slice runs:
the singular Stokeslet sum (`stokeslet_direct`, the matvec's hot loop), the
regularized Oseen tensor (`oseen_tensor`, each fiber's dense self-mobility
block) and the point-source flows (`oseen_contract`, `rotlet`). Arrays are
row-major ``[n, 3]`` like the JAX package; conventions are documented there.

On the card every Stokeslet sum runs on a hand-written kernel
(`ops.cuda_kernels`): float32 operands on kernel A, float64 operands (and the
f64-grade "pallas_df" tier) on kernel B. The plain blocked forms here are
what those kernels are held against, and what runs for CPU tensors.
"""

from __future__ import annotations

import math

import torch

DEFAULT_REG = 5e-3
DEFAULT_EPS = 1e-5

#: pairs per plain-form chunk: bounds the [t, s, 3] displacement tensors at
#: ~100 MB in f64 whatever the target/source counts
_PAIR_BUDGET = 1 << 22
_DEFAULT_SRC_BLOCK = 8192


def _pair_sum(pair_fn, r_trg, src_arrays, block_size: int | None = None,
              source_block: int | None = None):
    """Target-blocked, source-chunked pairwise sum.

    ``pair_fn(trg_block, *src_chunk_arrays) -> [t, 3]``; chunks are sized so
    each holds at most ``_PAIR_BUDGET`` pairs, which keeps the memory of the
    plain forms bounded at any scale (640k sources included).
    """
    n_trg, n_src = r_trg.shape[0], src_arrays[0].shape[0]
    out = torch.zeros((n_trg, 3), dtype=r_trg.dtype, device=r_trg.device)
    if n_trg == 0 or n_src == 0:
        return out
    sb = source_block or min(n_src, _DEFAULT_SRC_BLOCK)
    tb = block_size or max(1, min(n_trg, _PAIR_BUDGET // sb))
    for t0 in range(0, n_trg, tb):
        trg = r_trg[t0:t0 + tb]
        acc = torch.zeros((trg.shape[0], 3), dtype=r_trg.dtype,
                          device=r_trg.device)
        for s0 in range(0, n_src, sb):
            acc += pair_fn(trg, *(a[s0:s0 + sb] for a in src_arrays))
        out[t0:t0 + tb] = acc
    return out


def stokeslet_block(trg, src, f_src):
    """Unscaled Stokeslet partial sum of one (target-block, source-block)
    pair, in the displacement form of `skellysim_tpu.ops.kernels
    .stokeslet_block`; coincident pairs (r == 0) are dropped by a select."""
    d = trg[:, None, :] - src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    mask = r2 > 0.0
    rinv = torch.where(mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)
    rinv3 = rinv * rinv * rinv
    df = torch.einsum("tsk,sk->ts", d, f_src)
    return rinv @ f_src + torch.einsum("ts,tsk->tk", df * rinv3, d)


def pallas_impl_for(impl: str, *arrays) -> str:
    """Resolve ``impl="pallas"`` against the f32 tier's dtype contract: any
    float64 operand downgrades it to "exact", as in the JAX package (where
    the Pallas tile is f32-only). Other names pass through."""
    if impl == "pallas" and any(a.dtype == torch.float64 for a in arrays):
        return "exact"
    return impl


def stokeslet_direct(r_src, r_trg, f_src, eta, *, impl: str = "exact"):
    """Singular Stokeslet sum: [n_src,3] sources, [n_trg,3] targets ->
    [n_trg,3] in ``r_trg.dtype``; exactly coincident pairs contribute zero.

    ``impl``: "exact" and "pallas" evaluate in the operands' own precision —
    float32 through kernel A, float64 through kernel B on the card (the
    plain forms on the CPU), "pallas" with any f64 operand resolving to
    "exact" first (`pallas_impl_for`). "pallas_df" is the f64-grade tier:
    kernel B on the card whatever the input dtype, cast back to
    ``r_trg.dtype`` at this seam (the JAX package's DF contract: an f32
    solve must not silently promote to f64). "df" and "mxu" are not ported
    yet (ROADMAP §1 item 9 / item 1).
    """
    from . import cuda_kernels

    if impl == "pallas_df":
        return cuda_kernels.stokeslet_f64(r_src, r_trg, f_src,
                                          eta).to(r_trg.dtype)
    if impl in ("df", "mxu"):
        raise NotImplementedError(
            f"kernel impl {impl!r} is not ported yet (ROADMAP.md §1 item 9, "
            "mixed precision); use 'exact', 'pallas' or 'pallas_df'")
    impl = pallas_impl_for(impl, r_trg, r_src, f_src)
    if impl not in ("exact", "pallas"):
        raise ValueError(f"unknown kernel impl {impl!r}")
    if r_trg.dtype == torch.float32:
        return cuda_kernels.stokeslet_f32(r_src, r_trg, f_src, eta)
    return cuda_kernels.stokeslet_f64(r_src, r_trg, f_src, eta)


def _reg_rinv(r2, reg, epsilon_distance, *, inclusive: bool, drop_self: bool):
    """1/r with the reference's near-field regularization (see
    `skellysim_tpu.ops.kernels._reg_rinv`)."""
    eps2 = epsilon_distance * epsilon_distance
    near = (r2 <= eps2) if inclusive else (r2 < eps2)
    r2_eff = torch.where(near, r2 + reg * reg, r2)
    if drop_self:
        nonzero = r2 > 0.0
        return torch.where(nonzero,
                           torch.rsqrt(torch.where(nonzero, r2_eff, 1.0)), 0.0)
    return torch.rsqrt(torch.clamp_min(r2_eff, torch.finfo(r2.dtype).tiny))


def _regularized_frgr(r2, eta, reg, epsilon_distance):
    """fr = 1/(8 pi eta r), gr = 1/(8 pi eta r^3), regularized; r == 0 -> 0."""
    factor = 1.0 / (8.0 * math.pi * eta)
    rinv = _reg_rinv(r2, reg, epsilon_distance, inclusive=True, drop_self=True)
    return factor * rinv, factor * rinv * rinv * rinv


def oseen_tensor(r_src, r_trg, eta, reg=DEFAULT_REG,
                 epsilon_distance=DEFAULT_EPS):
    """Dense regularized Oseen tensor ``[..., n_trg, 3, n_src, 3]``.

    Leading batch dimensions broadcast (the fiber axis: one self-mobility
    block per fiber, the explicit-batch form of the JAX package's vmap);
    reshape to ``(3 n_trg, 3 n_src)`` for the interleaved-xyz layout.
    """
    d = r_trg[..., :, None, :] - r_src[..., None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    fr, gr = _regularized_frgr(r2, eta, reg, epsilon_distance)
    eye = torch.eye(3, dtype=r_src.dtype, device=r_src.device)
    G = (fr[..., None, None] * eye
         + gr[..., None, None] * d[..., :, None] * d[..., None, :])
    return G.transpose(-3, -2)


def oseen_contract(r_src, r_trg, density, eta, reg=DEFAULT_REG,
                   epsilon_distance=DEFAULT_EPS):
    """Regularized Oseen tensor contracted with a density -> [n_trg, 3]."""
    def block(trg, src, dens):
        d = trg[:, None, :] - src[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        fr, gr = _regularized_frgr(r2, eta, reg, epsilon_distance)
        df = torch.einsum("tsk,sk->ts", d, dens)
        return fr @ dens + torch.einsum("ts,tsk->tk", gr * df, d)

    return _pair_sum(block, r_trg, (r_src, density))


def rotlet(r_src, r_trg, density, eta, reg=DEFAULT_REG,
           epsilon_distance=DEFAULT_EPS):
    """Rotlet sum ``u = 1/(8 pi eta) sum_j (rho_j x d)/r^3`` -> [n_trg, 3]."""
    factor = 1.0 / (8.0 * math.pi * eta)

    def block(trg, src, dens):
        d = trg[:, None, :] - src[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        rinv = _reg_rinv(r2, reg, epsilon_distance, inclusive=False,
                         drop_self=False)
        cross = torch.linalg.cross(dens[None, :, :].expand_as(d), d, dim=-1)
        return torch.einsum("ts,tsk->tk", rinv * rinv * rinv, cross)

    return _pair_sum(block, r_trg, (r_src, density)) * factor
