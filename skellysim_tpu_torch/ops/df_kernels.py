"""Double-float (compensated f32) pairwise sums: the ``"df"`` tiles.

Counterpart of `skellysim_tpu.ops.df_kernels`: every value is an
unevaluated (hi, lo) pair of float32 words carrying ~2 x 24 bits of
significand (Dekker / Knuth error-free transformations), so a pair's
contribution is good to ~1e-14 relative from float32 arithmetic alone;
pair contributions are converted exactly to float64 (hi + lo is
representable) only for the accumulation. The JAX package computes these
tiles in plain XLA, outside any Pallas kernel, and so does the port: plain
torch on the CPU and on the card alike. On the card this is the
double-float arithmetic itself, evaluated on float32 tensors; it is not
kernel B (native FP64), which ``"pallas_df"`` names.

No contraction barrier is needed here. The JAX package wraps rounded
intermediates in optimization barriers and selects (`_bar` / `_mbar`)
because XLA fuses its elementwise graph and LLVM may contract a product
into a following add (an FMA), which skips the rounding an error-free
transform depends on. Eager torch runs every ``*``, ``+`` and ``-`` below
as its own kernel and writes each rounded result to memory, so nothing
contracts across them. That holds only while the chain stays out of
fusing ops: no `torch.addcmul`, `torch.lerp`, `torch.baddbmm` or
`torch.compile` may enter it (the smoke checks the transforms' exactness
on the card).
"""

from __future__ import annotations

import math

import torch

__all__ = ["stokeslet_direct_df", "stresslet_direct_df",
           "stokeslet_block_df", "stresslet_block_df"]

#: the tile of the sums: 1,024 targets x 4,096 sources, the JAX package's
#: tile at its pair seam (`ops.kernels.stokeslet_direct(impl="df")`), so
#: that both packages add the pairs in the same order. A tile holds ~40
#: (hi, lo) temporaries of [1024, 4096] float32 (~1.3 GB at their peak).
DF_TARGET_BLOCK = 1024
DF_SOURCE_BLOCK = 4096

#: Dekker's split factor 2^ceil(p/2) + 1 for float32 (p = 24)
_SPLIT = float(2 ** 12 + 1)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no magnitude ordering needed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e by Dekker's split (no FMA used)."""
    p = a * b
    a_big = _SPLIT * a
    a_hi = a_big - (a_big - a)
    a_lo = a - a_hi
    b_big = _SPLIT * b
    b_hi = b_big - (b_big - b)
    b_lo = b - b_hi
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(xh, xl, yh, yl):
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def df_mul(xh, xl, yh, yl):
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def df_rsqrt(xh, xl):
    """1/sqrt(x) in double-float: the float32 estimate and one DF Newton
    step, y = y0 (3 - x y0^2) / 2. Assumes x > 0."""
    y0 = torch.rsqrt(xh)
    zero = torch.zeros_like(y0)
    th, tl = df_mul(xh, xl, y0, zero)
    th, tl = df_mul(th, tl, y0, zero)
    rh, rl = df_add(torch.full_like(th, 3.0), torch.zeros_like(th), -th, -tl)
    yh, yl = df_mul(rh, rl, y0, zero)
    return 0.5 * yh, 0.5 * yl


def df_sum(h, l, dim: int):
    """Sum (h, l) values along ``dim`` with renormalizing DF adds in a
    halving tree (padded with zeros to a power of two)."""
    n = h.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        shape = list(h.shape)
        shape[dim] = p - n
        h = torch.cat([h, h.new_zeros(shape)], dim=dim)
        l = torch.cat([l, l.new_zeros(shape)], dim=dim)
    while h.shape[dim] > 1:
        m = h.shape[dim] // 2
        h, l = df_add(h.narrow(dim, 0, m), l.narrow(dim, 0, m),
                      h.narrow(dim, m, m), l.narrow(dim, m, m))
    return h.squeeze(dim), l.squeeze(dim)


def df_split(x):
    """float64 -> a (hi, lo) float32 pair with hi + lo ~ x to ~2^-48;
    float32 passes with lo = 0."""
    if x.dtype == torch.float32:
        return x, torch.zeros_like(x)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def _displacements(trg_hl, src_hl):
    """The three displacement components t - s as DF pairs [t, s]."""
    trg_h, trg_l = trg_hl
    src_h, src_l = src_hl
    d = []
    for k in range(3):
        dh, de = two_sum(trg_h[:, None, k], -src_h[None, :, k])
        # full two_sum, not quick: for nearly coincident points the
        # lo-word difference can exceed |dh|
        d.append(two_sum(dh, de + (trg_l[:, None, k] - src_l[None, :, k])))
    return d


def _rinv(d):
    """(1/r as a DF pair, masked to 0 at r == 0) of DF displacements."""
    r2h, r2l = df_mul(*d[0], *d[0])
    r2h, r2l = df_add(r2h, r2l, *df_mul(*d[1], *d[1]))
    r2h, r2l = df_add(r2h, r2l, *df_mul(*d[2], *d[2]))
    mask = r2h > 0.0
    rih, ril = df_rsqrt(torch.where(mask, r2h, 1.0),
                        torch.where(mask, r2l, 0.0))
    return torch.where(mask, rih, 0.0), torch.where(mask, ril, 0.0)


def stokeslet_block_df(trg_hl, src_hl, f_hl):
    """One (target-block, source-chunk) Stokeslet partial sum from
    per-pair double-float contributions: operands are (hi, lo) float32
    pairs ([t, 3] / [s, 3]); returns [t, 3] float64, unscaled."""
    f_h, f_l = f_hl
    d = _displacements(trg_hl, src_hl)
    rih, ril = _rinv(d)
    r3h, r3l = df_mul(rih, ril, rih, ril)
    r3h, r3l = df_mul(r3h, r3l, rih, ril)
    fs = [(f_h[None, :, k], f_l[None, :, k]) for k in range(3)]
    dfh, dfl = df_mul(*d[0], *fs[0])
    dfh, dfl = df_add(dfh, dfl, *df_mul(*d[1], *fs[1]))
    dfh, dfl = df_add(dfh, dfl, *df_mul(*d[2], *fs[2]))
    ch, cl = df_mul(dfh, dfl, r3h, r3l)
    out = []
    for k in range(3):
        uh, ul = df_mul(rih, ril, *fs[k])
        uh, ul = df_add(uh, ul, *df_mul(ch, cl, *d[k]))
        sh, sl = df_sum(uh, ul, 1)
        out.append(sh.to(torch.float64) + sl.to(torch.float64))
    return torch.stack(out, dim=-1)


def stresslet_block_df(trg_hl, src_hl, S_hl):
    """One (target-block, source-chunk) stresslet partial sum ``sum_s -3
    (d.S_s.d) d / r^5`` in double-float; ``S_hl`` is the (hi, lo) pair of
    the [s, 3, 3] sources. Returns [t, 3] float64, unscaled."""
    S_h, S_l = S_hl
    d = _displacements(trg_hl, src_hl)
    rih, ril = _rinv(d)
    r2ih, r2il = df_mul(rih, ril, rih, ril)
    r4ih, r4il = df_mul(r2ih, r2il, r2ih, r2il)
    r5h, r5l = df_mul(r4ih, r4il, rih, ril)
    dSdh = dSdl = None
    for i in range(3):
        zh, zl = df_mul(S_h[None, :, i, 0], S_l[None, :, i, 0], *d[0])
        zh, zl = df_add(zh, zl, *df_mul(S_h[None, :, i, 1],
                                        S_l[None, :, i, 1], *d[1]))
        zh, zl = df_add(zh, zl, *df_mul(S_h[None, :, i, 2],
                                        S_l[None, :, i, 2], *d[2]))
        th, tl = df_mul(*d[i], zh, zl)
        dSdh, dSdl = (th, tl) if dSdh is None else df_add(dSdh, dSdl, th, tl)
    ch, cl = df_mul(dSdh, dSdl, r5h, r5l)
    out = []
    for k in range(3):
        uh, ul = df_mul(ch, cl, *d[k])
        sh, sl = df_sum(uh, ul, 1)
        # the -3 applies on the exact f64 value: scaling the words apart
        # by a non-power of two rounds each and breaks the compensation
        out.append(-3.0 * (sh.to(torch.float64) + sl.to(torch.float64)))
    return torch.stack(out, dim=-1)


def df_block_sum(block_fn, r_src, r_trg, payload):
    """The unscaled float64 sum of ``block_fn`` over DF_TARGET_BLOCK target
    blocks and DF_SOURCE_BLOCK source chunks (the last chunk padded with
    zero sources, as the JAX package pads it)."""
    n_trg, n_src = r_trg.shape[0], r_src.shape[0]
    out = torch.zeros((n_trg, 3), dtype=torch.float64, device=r_trg.device)
    if n_trg == 0 or n_src == 0:
        return out
    sb = min(DF_SOURCE_BLOCK, n_src)
    pad = (-n_src) % sb
    if pad:
        r_src = torch.cat([r_src, r_src.new_zeros((pad, 3))])
        payload = torch.cat([payload,
                             payload.new_zeros((pad,) + payload.shape[1:])])
    src = df_split(r_src)
    pay = df_split(payload)
    trg = df_split(r_trg)
    tb = DF_TARGET_BLOCK
    for t0 in range(0, n_trg, tb):
        t_hl = (trg[0][t0:t0 + tb], trg[1][t0:t0 + tb])
        acc = torch.zeros((t_hl[0].shape[0], 3), dtype=torch.float64,
                          device=r_trg.device)
        for s0 in range(0, src[0].shape[0], sb):
            acc = acc + block_fn(t_hl, (src[0][s0:s0 + sb],
                                        src[1][s0:s0 + sb]),
                                 (pay[0][s0:s0 + sb], pay[1][s0:s0 + sb]))
        out[t0:t0 + tb] = acc
    return out


def _direct_df(block_fn, r_src, r_trg, payload, eta):
    if r_trg.ndim == 3:
        # a leading member axis: one member at a time
        return torch.stack([_direct_df(block_fn, s, t, p, eta)
                            for s, t, p in zip(r_src, r_trg, payload)])
    u = df_block_sum(block_fn, r_src, r_trg, payload)
    return u / (8.0 * math.pi) / float(eta)


def stokeslet_direct_df(r_src, r_trg, f_src, eta):
    """Singular Stokeslet sum (`ops.kernels.stokeslet_direct`'s
    semantics) with double-float pair arithmetic: float32 or float64
    inputs (float64 split into (hi, lo) float32 words), float64 out."""
    return _direct_df(stokeslet_block_df, r_src, r_trg, f_src, eta)


def stresslet_direct_df(r_dl, r_trg, f_dl, eta):
    """Singular stresslet sum in double-float arithmetic; ``f_dl`` is
    [n_src, 3, 3]; float64 out."""
    return _direct_df(stresslet_block_df, r_dl, r_trg, f_dl, eta)
