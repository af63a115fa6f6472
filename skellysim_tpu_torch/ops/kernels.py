"""Pairwise Stokes kernels: the pair-kernel seam and its plain torch forms.

Counterpart of `skellysim_tpu.ops.kernels` for the families the port runs:
the singular Stokeslet sum (`stokeslet_direct`, the matvec's hot loop), the
singular stresslet double-layer sum (`stresslet_direct`, the shell and body
flows), the regularized Oseen tensor (`oseen_tensor`, each fiber's dense
self-mobility block; `oseen_block`, one block pair of its contraction), the
point-source flows (`oseen_contract`, `rotlet`) and the dense shell/body
operator builders (`stresslet_times_normal` and its row-blocked form
`stresslet_times_normal_blocked`,
`stresslet_times_normal_times_density`, `subtract_singularity_columns`).
Arrays are row-major ``[n, 3]`` like the JAX package; conventions are
documented there.

On the card every Stokeslet and stresslet sum of the "exact", "pallas" and
"pallas_df" tiers runs on a hand-written kernel (`ops.cuda_kernels`):
float32 operands on kernels A / C, float64 operands (and the f64-grade
"pallas_df" tier) on kernels B / D. The JAX package's plain-XLA tiles,
"df" (double-float, `ops.df_kernels`) and "mxu" (matmul form,
`stokeslet_block_mxu` / `stresslet_block_mxu`), are plain torch here
too. The plain blocked
forms here are what those kernels are held against, and what runs for CPU
tensors. The operator builders stay plain tensor code on every device, as
in the JAX package (which builds them outside any Pallas kernel).
"""

from __future__ import annotations

import math

import torch

from ..obs import cost as _cost

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


def stresslet_block(trg, src, S):
    """Unscaled stresslet partial sum ``sum_s -3 (d.S_s.d) d / r^5`` of one
    (target-block, source-block) pair (`skellysim_tpu.ops.kernels
    .stresslet_block`); ``S`` is [s, 3, 3]; coincident pairs are dropped by a
    select."""
    d = trg[:, None, :] - src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    mask = r2 > 0.0
    rinv = torch.where(mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)
    rinv5 = rinv * rinv * rinv * rinv * rinv
    Sd = torch.einsum("sij,tsj->tsi", S, d)
    dSd = torch.sum(d * Sd, dim=-1)
    return torch.einsum("ts,tsk->tk", -3.0 * dSd * rinv5, d)


def _mxu_frame(trg, src, center):
    """The matmul-form tiles' shared start: targets and sources recentered
    on ``center`` (default: the source block's first point, not its mean:
    the ring pads sources at 1e7), and 1/r from r2 = |t'|^2 + |s'|^2 -
    2 t'.s', pairs with r2 <= 16 eps (|t'|^2 + |s'|^2) dropped as
    coincident."""
    center = src[0] if center is None else center
    trg = trg - center
    src = src - center
    eps = torch.finfo(trg.dtype).eps
    t2 = torch.sum(trg * trg, dim=1)
    s2 = torch.sum(src * src, dim=1)
    scale = t2[:, None] + s2[None, :]
    r2 = torch.clamp_min(scale - 2.0 * (trg @ src.T), 0.0)
    mask = r2 > 16.0 * eps * scale
    return trg, src, torch.where(
        mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)


def stokeslet_block_mxu(trg, src, f_src, center=None):
    """`stokeslet_block` in matmul form (`skellysim_tpu.ops.kernels
    .stokeslet_block_mxu`): d.f = t.f - s.f and u = rinv @ f + t rowsum(c)
    - c @ s with c = (d.f) / r^3, so the O(t s) contractions are matrix
    products (`torch.matmul`, as the JAX package computes them; TF32
    stays off, `skellysim_tpu_torch`), recentered as `_mxu_frame` says."""
    trg, src, rinv = _mxu_frame(trg, src, center)
    rinv3 = rinv * rinv * rinv
    df = trg @ f_src.T - torch.sum(src * f_src, dim=1)[None, :]
    c = df * rinv3
    return rinv @ f_src + trg * torch.sum(c, dim=1, keepdim=True) - c @ src


def stresslet_block_mxu(trg, src, S, center=None):
    """`stresslet_block` in matmul form (`skellysim_tpu.ops.kernels
    .stresslet_block_mxu`): d.S.d = T9 @ S9^T - t @ (S s + S^T s)^T +
    s.S.s and u = t rowsum(c) - c @ s with c = -3 (d.S.d) / r^5;
    recentered as `_mxu_frame` says."""
    trg, src, rinv = _mxu_frame(trg, src, center)
    rinv5 = (rinv * rinv) ** 2 * rinv
    T9 = (trg[:, :, None] * trg[:, None, :]).reshape(trg.shape[0], 9)
    S9 = S.reshape(S.shape[0], 9)
    Ss = torch.einsum("sij,sj->si", S, src)
    STs = torch.einsum("sij,si->sj", S, src)
    sSs = torch.einsum("si,si->s", src, Ss)
    dSd = T9 @ S9.T - trg @ (Ss + STs).T + sSs[None, :]
    c = -3.0 * dSd * rinv5
    return trg * torch.sum(c, dim=1, keepdim=True) - c @ src


#: the JAX package's source chunking of its dense sums: sources beyond
#: 32,768 are summed in chunks of 8,192 (`_SRC_CHUNK_THRESHOLD`,
#: `_DEFAULT_SRC_BLOCK`). The matmul-form tiles recenter on each chunk's
#: first point, so the port chunks its sources the same way.
_MXU_CHUNK_THRESHOLD = 32768
_MXU_SOURCE_BLOCK = 8192

_MXU_BLOCKS = {"stokeslet": stokeslet_block_mxu,
               "stresslet": stresslet_block_mxu}


def mxu_sum(family: str, r_src, r_trg, payload, *, centered_chunk=None):
    """The unscaled matmul-form sum of ``family`` over source chunks that
    each recenter on their first point: the JAX package's chunks
    (`_MXU_CHUNK_THRESHOLD`) by default, or ``centered_chunk`` sources a
    chunk (the ring's one centre a shard block: ``n_src``). Each chunk is
    summed in sub-tiles of at most ``_PAIR_BUDGET`` pairs that keep its
    centre."""
    block = _MXU_BLOCKS[family]
    n_trg, n_src = r_trg.shape[0], r_src.shape[0]
    out = torch.zeros((n_trg, 3), dtype=r_trg.dtype, device=r_trg.device)
    if n_trg == 0 or n_src == 0:
        return out
    chunk = centered_chunk or (_MXU_SOURCE_BLOCK
                               if n_src > _MXU_CHUNK_THRESHOLD else n_src)
    for c0 in range(0, n_src, chunk):
        src, pay = r_src[c0:c0 + chunk], payload[c0:c0 + chunk]
        center = src[0]
        out += _pair_sum(lambda t, s, p: block(t, s, p, center), r_trg,
                         (src, pay), source_block=min(src.shape[0],
                                                      _MXU_SOURCE_BLOCK))
    return out


def pallas_impl_for(impl: str, *arrays) -> str:
    """Resolve ``impl="pallas"`` against the f32 tier's dtype contract: any
    float64 operand downgrades it to "exact", as in the JAX package (where
    the Pallas tile is f32-only). Other names pass through."""
    if impl == "pallas" and any(a.dtype == torch.float64 for a in arrays):
        return "exact"
    return impl


def _direct_work(family, _family, r_src, r_trg, payload, *_):
    return _cost.dense_work(family, r_src, r_trg, payload)


@_cost.seamed(None, _direct_work)
def _direct(family: str, r_src, r_trg, payload, eta, impl: str):
    """The seam's one routing rule for a pair-sum ``family`` ("stokeslet"
    or "stresslet"): the f64-grade tier ("pallas_df") takes the f64 kernel
    whatever the input dtype and casts back to ``r_trg.dtype`` (the JAX
    package's DF contract: an f32 solve must not silently promote to f64);
    "exact" and "pallas" take the kernel of the operands' own precision,
    "pallas" with any f64 operand resolving to "exact" first. It is the
    pair seam `obs.cost` counts: one sum, whichever tile computes it."""
    from . import cuda_kernels

    # a leading member axis ([B, n, .] operands) takes the batched kernels
    suffix = "_batched" if r_trg.ndim == 3 else ""
    f32 = getattr(cuda_kernels, f"{family}_f32{suffix}")
    f64 = getattr(cuda_kernels, f"{family}_f64{suffix}")
    if impl == "pallas_df":
        return f64(r_src, r_trg, payload, eta).to(r_trg.dtype)
    if impl == "df":
        # double-float f32 arithmetic in plain torch (`ops.df_kernels`),
        # not kernel B; cast back like every tier
        from . import df_kernels

        fn = getattr(df_kernels, f"{family}_direct_df")
        return fn(r_src, r_trg, payload, eta).to(r_trg.dtype)
    if impl == "mxu":
        if r_trg.ndim == 3:
            return torch.stack([_direct(family, s, t, p, eta, impl)
                                for s, t, p in zip(r_src, r_trg, payload)])
        return mxu_sum(family, r_src, r_trg, payload) / (8.0 * math.pi
                                                         * eta)
    impl = pallas_impl_for(impl, r_trg, r_src, payload)
    if impl not in ("exact", "pallas"):
        raise ValueError(f"unknown kernel impl {impl!r}")
    kern = f32 if r_trg.dtype == torch.float32 else f64
    return kern(r_src, r_trg, payload, eta)


def stokeslet_direct(r_src, r_trg, f_src, eta, *, impl: str = "exact"):
    """Singular Stokeslet sum: [n_src,3] sources, [n_trg,3] targets ->
    [n_trg,3] in ``r_trg.dtype``; exactly coincident pairs contribute zero.
    With a leading member axis (sources, targets and forces [B, n, 3]) the
    B independent sums take one launch of the member-batched kernel and
    return [B, n_trg, 3].

    ``impl``: "exact" and "pallas" evaluate in the operands' own precision —
    float32 through kernel A, float64 through kernel B on the card (the
    plain forms on the CPU). "pallas_df" is the f64-grade tier: kernel B
    whatever the input dtype (`_direct`). "df" is the JAX package's XLA
    double-float tile (`ops.df_kernels`, plain torch on every device) and
    "mxu" its matmul-form tile (`stokeslet_block_mxu`, recentered on each
    source chunk's first point); neither is a hand-written kernel, as
    neither is a Pallas kernel there.
    """
    return _direct("stokeslet", r_src, r_trg, f_src, eta, impl)


def stresslet_direct(r_dl, r_trg, f_dl, eta, *, impl: str = "exact"):
    """Singular stresslet (double-layer) sum: [n_src,3] sources with
    ``f_dl`` [n_src,3,3] (``f_dl[s, i, j] = S_ij``), [n_trg,3] targets ->
    [n_trg,3] in ``r_trg.dtype``; exactly coincident pairs contribute zero.
    A leading member axis ([B, n, ...] operands) sums B members in one
    launch, as in `stokeslet_direct`.
    The same ``impl`` routing as `stokeslet_direct`, on kernels C (f32)
    and D (f64-grade).
    """
    return _direct("stresslet", r_dl, r_trg, f_dl, eta, impl)


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
        return oseen_block(trg, src, dens, eta, reg, epsilon_distance)

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


def oseen_block(trg, src, density, eta, reg, epsilon_distance):
    """Regularized-Oseen partial sum of one (target-block, source-block)
    pair -> [t, 3], eta-scaled through fr / gr
    (`skellysim_tpu.ops.kernels.oseen_block`)."""
    d = trg[:, None, :] - src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    fr, gr = _regularized_frgr(r2, eta, reg, epsilon_distance)
    df = torch.einsum("tsk,sk->ts", d, density)
    return fr @ density + torch.einsum("ts,tsk->tk", gr * df, d)


def stresslet_times_normal(r, normals, eta, reg=DEFAULT_REG,
                           epsilon_distance=DEFAULT_EPS):
    """Dense stresslet-contracted-with-normal operator [n, 3, n, 3]:
    ``M[i, :, j, :] = -3/(4 pi) (d.n_j) / r^5 d d^T`` with ``d = r_i -
    r_j`` and zero diagonal blocks (`skellysim_tpu.ops.kernels
    .stresslet_times_normal`; no eta dependence). The unblocked form of
    `stresslet_times_normal_blocked`, equal to it after ``.reshape(3n,
    3n)``; it holds [n, n, 3, 3] at once, so it suits small point sets."""
    factor = -3.0 / (4.0 * math.pi)
    n = r.shape[0]
    d = r[:, None, :] - r[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    offdiag = ~torch.eye(n, dtype=torch.bool, device=r.device)
    rinv = _reg_rinv(r2, reg, epsilon_distance, inclusive=False,
                     drop_self=False)
    dn = torch.einsum("ijk,jk->ij", d, normals)
    coeff = torch.where(offdiag, factor * dn * rinv**5, 0.0)
    M = coeff[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :]
    return M.permute(0, 2, 1, 3)


def _operator_rows(n: int) -> int:
    """Target rows per block of the dense operator builders: each block's
    [rows, n, 3, 3] intermediate stays near 150 MB in f64 whatever ``n``
    (a 24,000-row shell operator is built ~260 rows at a time)."""
    return max(1, min(n, _PAIR_BUDGET // (2 * max(n, 1))))


def stresslet_times_normal_blocked(r, normals, eta, reg=DEFAULT_REG,
                                   epsilon_distance=DEFAULT_EPS, *,
                                   block_size: int | None = None):
    """Dense stresslet-contracted-with-normal operator [3n, 3n]
    (interleaved-xyz layout): ``M[3i+a, 3j+b] = -3/(4 pi) (d.n_j) / r^5
    d_a d_b`` with ``d = r_i - r_j``, zero diagonal blocks (masked by index)
    and the regularized value kept at r = 0 (`skellysim_tpu.ops.kernels
    .stresslet_times_normal_blocked`; no eta dependence). Built row block by
    row block, so no [n, n, 3, 3] tensor ever exists."""
    factor = -3.0 / (4.0 * math.pi)
    n = r.shape[0]
    b = block_size or _operator_rows(n)
    M = torch.empty((3 * n, 3 * n), dtype=r.dtype, device=r.device)
    col = torch.arange(n, device=r.device)
    for r0 in range(0, n, b):
        trg = r[r0:r0 + b]
        nb = trg.shape[0]
        d = trg[:, None, :] - r[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        offdiag = (torch.arange(r0, r0 + nb, device=r.device)[:, None]
                   != col[None, :])
        rinv = _reg_rinv(r2, reg, epsilon_distance, inclusive=False,
                         drop_self=False)
        dn = torch.einsum("bjk,jk->bj", d, normals)
        coeff = torch.where(offdiag, factor * dn * rinv**5, 0.0)
        blk = coeff[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :]
        M[3 * r0:3 * (r0 + nb)] = blk.permute(0, 2, 1, 3).reshape(3 * nb,
                                                                   3 * n)
    return M


def subtract_singularity_columns(M, sing_vecs, weights):
    """Second-kind singularity subtraction on a [3n, 3n] interleaved
    matrix, IN PLACE: ``M[3i+a, 3i+k] -= e_k[i, a] / w_i`` for
    ``sing_vecs = (ex, ey, ez)`` (each [n, 3]) — the diagonal-block
    correction of `skellysim_tpu.ops.kernels.subtract_singularity_columns`.
    Returns ``M``."""
    n = weights.shape[0]
    idx = torch.arange(n, device=M.device)
    rows = 3 * idx[:, None] + torch.arange(3, device=M.device)[None, :]
    for k, e in enumerate(sing_vecs):
        cols = (3 * idx + k)[:, None].expand(n, 3)
        M[rows, cols] -= e / weights[:, None]
    return M


def stresslet_times_normal_times_density(r, normals, density, eta,
                                         reg=DEFAULT_REG,
                                         epsilon_distance=DEFAULT_EPS):
    """Contracted stresslet ``S_i = -3/(4 pi) sum_{j != i} (d.rho_j)(d.n_j)
    / r^5 d`` on one point set (sources = targets) -> [n, 3]; the self pair
    is dropped by value (r = 0), as in `skellysim_tpu.ops.kernels
    .stresslet_times_normal_times_density`."""
    factor = -3.0 / (4.0 * math.pi)

    def block(trg, src, nrm, dens):
        d = trg[:, None, :] - src[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        rinv = _reg_rinv(r2, reg, epsilon_distance, inclusive=False,
                         drop_self=True)
        dn = torch.einsum("tsk,sk->ts", d, nrm)
        dr = torch.einsum("tsk,sk->ts", d, dens)
        return torch.einsum("ts,tsk->tk", dn * dr * rinv**5, d)

    return _pair_sum(block, r, (r, normals, density)) * factor
