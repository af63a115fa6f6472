"""The launch plan of kernels C and D (`pair_plan`), on the CPU.

Kernels C and D (`stresslet_f32` / `stresslet_f64`, csrc/stresslet_sums.cu)
share kernel A's and B's plan: targets a thread, source chunks of whole
tiles, and partial sums that a second pass adds in chunk order and scales
by -3 / (8 pi eta) (or -3 alone for the unscaled entry). These tests hold
the plan's cover of the pairs, and hold the plain stresslet sum taken chunk
by chunk in the plan's order, then reduced in that order, against the JAX
package (the Pallas f32 tile in interpret mode, the exact f64 path). The
kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.ops import kernels as jk
from skellysim_tpu.ops.pallas_kernels import (stresslet_pallas,
                                              stresslet_pallas_block)
from skellysim_tpu_torch.ops import cuda_kernels as ck

ETA = 1.3
#: (SMs, resident blocks an SM): the H100's 132 SMs at the occupancies the
#: instances can have, and a small card
CARDS = ((132, 2), (132, 4), (132, 6), (8, 3))
#: (targets, sources): one pair; the body scene's 600 nodes; the confined
#: path's 128,000 fiber nodes against the 8,000-node shell; kernel D's ring
#: hop (32,000 fiber nodes a shard against 2,000 shell nodes); ragged counts
#: either side of a tile and of R x 128 targets; one target or one source
SHAPES = ((1, 1), (600, 600), (128000, 8000), (32000, 2000), (1, 129),
          (513, 1000), (1000, 513), (777, 100), (1, 8000), (128000, 1))
_DT = {"f32": torch.float32, "f64": torch.float64}


def _covers(ranges, n):
    """The ranges are non-empty, in order, and tile [0, n) exactly once."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("n_trg,n_src", SHAPES)
def test_plan_covers_every_pair_once(n_trg, n_src, prec):
    """C's and D's plans: every target in exactly one block of R x 128,
    every source in exactly one chunk of whole tiles (bar the last), one
    block a (target block, chunk), the scratch chunks x n_trg x 3; the busy
    share the plan reports is the one its waves give, at least a half
    unless the split is at its limit."""
    for sms, per_sm in CARDS:
        plan = ck.pair_plan("stresslet", n_trg, n_src, sms, per_sm, prec)
        assert (plan.family, plan.r) == ("stresslet", ck.STRESSLET_R[prec])
        assert (plan.threads, plan.tile) == (ck.STRESSLET_THREADS,
                                             ck.STRESSLET_TILE)
        targets = plan.target_ranges()
        _covers(targets, n_trg)
        assert all(hi - lo <= plan.r * plan.threads for lo, hi in targets)
        sources = plan.source_ranges()
        _covers(sources, n_src)
        assert plan.chunk_len % plan.tile == 0
        assert all(hi - lo == plan.chunk_len for lo, hi in sources[:-1])
        assert plan.tiles == -(-n_src // plan.tile)
        assert plan.chunks == -(-plan.tiles // (plan.chunk_len // plan.tile))
        assert plan.grid == (len(targets), len(sources))
        assert plan.scratch_shape == (plan.chunks, n_trg, 3)
        assert plan.slots == sms * per_sm
        waves = -(-plan.target_blocks * plan.chunks // plan.slots)
        assert plan.busy == pytest.approx(
            plan.target_blocks * plan.tiles
            / (waves * plan.slots * (plan.chunk_len // plan.tile)))
        assert 0 < plan.busy <= 1
        most = -(-plan.tiles // -(-plan.tiles
                                  // min(plan.tiles, ck._MAX_CHUNKS)))
        assert plan.chunks <= most
        if plan.chunks < most:
            assert plan.busy >= 0.5


def test_plan_splits_where_targets_cannot_fill_the_card():
    """D's ring hop (32,000 targets at 2 x 128 a block: 125 blocks) and the
    body scene (600 targets: 2 or 3 blocks) leave most of the card's slots
    empty, so the plan splits their sources (the body's as far as one
    chunk a tile); the confined path's C at 128,000 x 8,000 (250 blocks)
    splits until the card is 95% busy."""
    hop = ck.pair_plan("stresslet", 32_000, 2_000, 132, 6, "f64")
    assert hop.target_blocks == 125 and hop.chunks > 1
    for prec in ("f32", "f64"):
        body = ck.pair_plan("stresslet", 600, 600, 132, 4, prec)
        assert body.chunks == body.tiles == 5
    confined = ck.pair_plan("stresslet", 128_000, 8_000, 132, 4, "f32")
    assert confined.target_blocks == 250 and confined.chunks > 1
    assert confined.busy >= 0.95
    assert ck.pair_plan("stresslet", 128_000, 100, 132, 4, "f32").chunks == 1


def test_plan_rejects_what_is_not_built():
    """A precision or family with no kernel, and empty or cardless counts,
    raise; each built precision plans its one instance's R."""
    for prec in ("f16", "bf16"):
        with pytest.raises(ValueError, match="no Stresslet kernel is built"):
            ck.pair_plan("stresslet", 10, 10, 132, 4, prec)
    with pytest.raises(ValueError, match="no pair kernel family"):
        ck.pair_plan("rotlet", 10, 10, 132, 4, "f32")
    for bad in ((0, 10, 132, 4), (10, 0, 132, 4), (10, 10, 0, 4),
                (10, 10, 132, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            ck.pair_plan("stresslet", *bad)
    assert ck.STRESSLET_R == {"f32": 4, "f64": 2}
    for prec, r in ck.STRESSLET_R.items():
        assert ck.pair_plan("stresslet", 10, 10, 132, 4, prec).r == r


#: kernel A's and B's plans at the main paths' shapes as the Stokeslet-only
#: plan gave them: (prec, n_trg, n_src, SMs, blocks an SM) -> (target
#: blocks, chunks, chunk_len, busy)
_STOKESLET_PLANS = {
    ("f32", 136000, 128000, 132, 4): (133, 19, 6784, 0.950543167524),
    ("f32", 128000, 136000, 132, 4): (125, 21, 6528, 0.986890968509),
    ("f32", 640000, 640000, 132, 4): (625, 5, 128000, 0.986426767677),
    ("f32", 4352, 4352, 8, 3): (5, 9, 512, 0.885416666667),
    ("f64", 136000, 128000, 132, 6): (532, 10, 12800, 0.959595959596),
    ("f64", 32000, 34000, 132, 6): (125, 19, 1792, 0.999579124579),
    ("f64", 640000, 640000, 132, 6): (2500, 4, 160000, 0.971250971251),
    ("f64", 600, 600, 132, 4): (3, 5, 128, 0.028409090909)}


@pytest.mark.parametrize("key", sorted(_STOKESLET_PLANS))
def test_stokeslet_plan_is_unchanged(key):
    """`stokeslet_plan` is `pair_plan` of the Stokeslet family, and gives
    the plans it gave before the plan served C and D too."""
    prec, *args = key
    plan = ck.stokeslet_plan(*args, prec)
    assert plan == ck.pair_plan("stokeslet", *args, prec)
    blocks, chunks, chunk_len, busy = _STOKESLET_PLANS[key]
    assert (plan.target_blocks, plan.chunks, plan.chunk_len) == (
        blocks, chunks, chunk_len)
    assert plan.busy == pytest.approx(busy, abs=1e-12)


def _cloud(kind, n_src, n_trg, payload, seed):
    """Sources with inactive zero-payload slots pinned at the origin,
    targets on sources and at the origin (coincident pairs the sum must
    drop). ``payload``: "general" (a random non-symmetric S) or "shell"
    (the rank-one double-layer density 2 eta n rho^T of
    `periphery.flow`, n a unit normal)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        r_src = rng.uniform(-2.0, 2.0, (n_src, 3))
    elif kind == "clustered":
        centers = rng.uniform(-3.0, 3.0, (6, 3))
        r_src = (centers[rng.integers(0, 6, n_src)]
                 + 1e-2 * rng.standard_normal((n_src, 3)))
    else:  # "coincident": duplicated source points
        base = rng.uniform(-1.0, 1.0, (n_src // 2, 3))
        r_src = np.concatenate([base, base[: n_src - n_src // 2]])
    if payload == "general":
        S = rng.standard_normal((n_src, 3, 3))
    else:
        normal = rng.standard_normal((n_src, 3))
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        rho = rng.standard_normal((n_src, 3))
        S = 2.0 * ETA * normal[:, :, None] * rho[:, None, :]
    r_src[-10:] = 0.0
    S[-10:] = 0.0
    r_trg = np.concatenate([r_src[: n_trg // 2],
                            rng.uniform(-2.0, 2.0,
                                        (n_trg - n_trg // 2 - 1, 3)),
                            np.zeros((1, 3))])
    return r_src, r_trg, S


def _chunked(prec, plan, r_src, r_trg, S, eta):
    """The plain sum over each of the plan's chunks, then the chunks added
    in order and scaled by -3 scale: the kernel's two passes, in plain
    form (the plain version, unscaled, holds the -3)."""
    dtype = _DT[prec]
    plain = getattr(ck, f"stresslet_{prec}_plain")
    src, trg, pay = (torch.as_tensor(a, dtype=dtype)
                     for a in (r_src, r_trg, S))
    part = torch.stack([plain(src[lo:hi], trg, pay[lo:hi])
                        for lo, hi in plan.source_ranges()])
    assert part.shape == plan.scratch_shape and part.dtype == dtype
    total = part[0].clone()
    for c in range(1, plan.chunks):
        total += part[c]
    scale = 1.0 if eta is None else 1.0 / (8.0 * math.pi * eta)
    return (total * scale).numpy()


@pytest.mark.parametrize("payload", ["general", "shell"])
@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_chunked_plain_f32_matches_pallas_tile(kind, payload):
    """f32, chunk by chunk in the plan's order (5 chunks of one tile: the
    split is on), against the Pallas f32 tile in interpret mode at the
    plain version's tolerance, 1e-5 of the largest velocity."""
    r_src, r_trg, S = (a.astype(np.float32)
                       for a in _cloud(kind, 600, 300, payload, seed=1))
    plan = ck.pair_plan("stresslet", 300, 600, 132, 4, "f32")
    assert plan.chunks == 5
    got = _chunked("f32", plan, r_src, r_trg, S, ETA)
    ref = np.asarray(stresslet_pallas(jnp.asarray(r_src), jnp.asarray(r_trg),
                                      jnp.asarray(S), ETA, interpret=True))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("payload", ["general", "shell"])
@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_chunked_plain_f64_matches_exact(kind, payload):
    """f64, chunk by chunk in the plan's order, against the JAX exact f64
    path at 1e-12 of the largest velocity."""
    r_src, r_trg, S = _cloud(kind, 1000, 513, payload, seed=2)
    plan = ck.pair_plan("stresslet", 513, 1000, 132, 4, "f64")
    assert plan.chunks > 1
    got = _chunked("f64", plan, r_src, r_trg, S, ETA)
    ref = np.asarray(jk.stresslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(S),
                                         ETA))
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_unscaled_entry_keeps_minus_three():
    """``eta=None`` (the ring's per-hop block) scales by 1 and keeps the
    stresslet's -3: the chunked plain sum against the JAX unscaled block
    (`stresslet_pallas_block`, f32) and the exact path at eta = 1/(8 pi)
    (f64), and the wrappers' plain versions alike."""
    r_src, r_trg, S = _cloud("random", 600, 300, "shell", seed=4)
    s32, t32, S32 = (a.astype(np.float32) for a in (r_src, r_trg, S))
    plan = ck.pair_plan("stresslet", 300, 600, 132, 4, "f32")
    got = _chunked("f32", plan, s32, t32, S32, None)
    ref = np.asarray(stresslet_pallas_block(jnp.asarray(t32), jnp.asarray(s32),
                                            jnp.asarray(S32), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    plan = ck.pair_plan("stresslet", 300, 600, 132, 4, "f64")
    got = _chunked("f64", plan, r_src, r_trg, S, None)
    ref = np.asarray(jk.stresslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(S),
                                         1.0 / (8.0 * math.pi)))
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    plain = ck.stresslet_f64(torch.as_tensor(r_src), torch.as_tensor(r_trg),
                             torch.as_tensor(S)).numpy()
    np.testing.assert_allclose(plain, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
