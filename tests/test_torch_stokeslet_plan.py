"""The launch plan of kernels A and B (`stokeslet_plan`), on the CPU.

The plan is the Python half of the redesigned Stokeslet kernels: it picks
the targets a thread, the source chunks and the grid, and sizes the
partial-sum scratch that the kernel's second pass reduces in chunk order.
These tests hold its cover of the pairs and its grid, and hold the plain
Stokeslet sum taken chunk by chunk in the plan's order, then reduced in
that order, against the JAX package (the Pallas f32 tile in interpret
mode, the exact f64 path). The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.ops import kernels as jk
from skellysim_tpu.ops.pallas_kernels import stokeslet_pallas
from skellysim_tpu_torch.ops import cuda_kernels as ck

ETA = 1.3
#: (SMs, resident blocks an SM): the H100's 132 SMs at the occupancies the
#: instances can have, and a small card
CARDS = ((132, 2), (132, 4), (132, 8), (8, 3))
#: (targets, sources): one pair; the body scene (600 nodes); the small
#: coupled scenes; ragged counts either side of a tile; the ellipsoid's
#: kernel C/D shape and its A/B shape; the 10k run's 640k x 640k; and the
#: extremes of one target or one source at full width
SHAPES = ((1, 1), (600, 600), (1, 129), (513, 1000), (1000, 513),
          (4352, 4352), (8000, 128000), (136000, 128000), (640000, 640000),
          (1, 640000), (640000, 1))


def _covers(ranges, n):
    """The ranges are non-empty, in order, and tile [0, n) exactly once."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("n_trg,n_src", SHAPES)
def test_plan_covers_every_pair_once(n_trg, n_src, prec):
    """Every target in exactly one target block, every source in exactly
    one non-empty chunk of whole tiles (bar the last), the grid one block a
    (target block, chunk), the scratch chunks x n_trg x 3; and the grid
    keeps the card busy: the busy share the plan reports is the one its
    waves give, and it is at least a half unless the split is already at
    its limit (one chunk a tile, or the most chunks a plan takes)."""
    for sms, per_sm in CARDS:
        plan = ck.stokeslet_plan(n_trg, n_src, sms, per_sm, prec)
        assert plan.r == ck.STOKESLET_R[prec]
        per_block = plan.r * ck.STOKESLET_THREADS
        targets = plan.target_ranges()
        _covers(targets, n_trg)
        assert all(hi - lo <= per_block for lo, hi in targets)
        sources = plan.source_ranges()
        _covers(sources, n_src)
        assert plan.chunk_len % ck.STOKESLET_TILE == 0
        assert all(hi - lo == plan.chunk_len for lo, hi in sources[:-1])
        assert plan.grid == (len(targets), len(sources))
        assert plan.grid[1] <= 65535  # the grid's y limit
        assert plan.scratch_shape == (plan.chunks, n_trg, 3)
        assert plan.slots == sms * per_sm
        tiles = -(-n_src // ck.STOKESLET_TILE)
        blocks = plan.target_blocks * plan.chunks
        waves = -(-blocks // plan.slots)
        assert plan.busy == pytest.approx(
            plan.target_blocks * tiles
            / (waves * plan.slots * (plan.chunk_len // ck.STOKESLET_TILE)))
        assert 0 < plan.busy <= 1
        most = -(-tiles // -(-tiles // min(tiles, ck._MAX_CHUNKS)))
        assert plan.chunks <= most
        if plan.chunks < most:
            assert plan.busy >= 0.5


def test_plan_splits_where_targets_cannot_fill_the_card():
    """At the ellipsoid's 136,000 targets x 128,000 sources the targets
    alone give 133 blocks of 8 x 128 (A) or 532 of 2 x 128 (B), one an SM or
    fewer than the slots at four resident: the plan splits the sources; at
    one source tile it cannot, and at the 10k run's shape the targets fill
    several waves already."""
    for prec, blocks in (("f32", 133), ("f64", 532)):
        small = ck.stokeslet_plan(136_000, 128_000, 132, 4, prec)
        assert small.target_blocks == blocks and small.chunks > 1
        assert small.busy >= 0.95
    assert ck.stokeslet_plan(136_000, 100, 132, 4, "f32").chunks == 1
    big = ck.stokeslet_plan(640_000, 640_000, 132, 4, "f32")
    assert big.target_blocks * big.chunks >= 2 * big.slots


def test_plan_rejects_what_is_not_built():
    """A precision with no kernel and empty or cardless counts raise; each
    built precision plans its one instance's R (A 8, B 2)."""
    for prec in ("f16", "bf16"):
        with pytest.raises(ValueError, match="no Stokeslet kernel is built"):
            ck.stokeslet_plan(10, 10, 132, 4, prec)
    for bad in ((0, 10, 132, 4), (10, 0, 132, 4), (10, 10, 0, 4),
                (10, 10, 132, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            ck.stokeslet_plan(*bad)
    assert ck.STOKESLET_R == {"f32": 8, "f64": 2}
    for prec, r in ck.STOKESLET_R.items():
        assert ck.stokeslet_plan(10, 10, 132, 4, prec).r == r


def _cloud(kind, n_src, n_trg, seed):
    """Sources with inactive zero-force slots pinned at the origin, targets
    on sources and at the origin (coincident pairs the sum must drop)."""
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
    f = rng.standard_normal((n_src, 3))
    r_src[-10:] = 0.0
    f[-10:] = 0.0
    r_trg = np.concatenate([r_src[: n_trg // 2],
                            rng.uniform(-2.0, 2.0, (n_trg - n_trg // 2 - 1, 3)),
                            np.zeros((1, 3))])
    return r_src, r_trg, f


def _chunked(prec, plan, r_src, r_trg, f):
    """The plain sum over each of the plan's chunks, then the chunks added
    in order and scaled: the kernel's reduction, in plain form."""
    dtype = {"f32": torch.float32, "f64": torch.float64}[prec]
    plain = getattr(ck, f"stokeslet_{prec}_plain")
    src, trg, frc = (torch.as_tensor(a, dtype=dtype) for a in (r_src, r_trg, f))
    part = torch.stack([plain(src[lo:hi], trg, frc[lo:hi])
                        for lo, hi in plan.source_ranges()])
    assert part.shape == plan.scratch_shape
    total = part[0].clone()
    for c in range(1, plan.chunks):
        total += part[c]
    return (total * (1.0 / (8.0 * np.pi * ETA))).numpy()


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_chunked_plain_f32_matches_pallas_tile(kind):
    """f32, chunk by chunk in the plan's order (5 chunks of one tile: the
    split is on), against the Pallas f32 tile in interpret mode at the
    plain version's tolerance, 1e-5 of the largest velocity."""
    r_src, r_trg, f = (a.astype(np.float32)
                       for a in _cloud(kind, 600, 300, seed=1))
    plan = ck.stokeslet_plan(300, 600, 132, 4, "f32")
    assert plan.chunks == 5
    got = _chunked("f32", plan, r_src, r_trg, f)
    ref = np.asarray(stokeslet_pallas(jnp.asarray(r_src), jnp.asarray(r_trg),
                                      jnp.asarray(f), ETA, interpret=True))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["random", "clustered", "coincident"])
def test_chunked_plain_f64_matches_exact(kind):
    """f64, chunk by chunk in the plan's order, against the JAX exact f64
    path at 1e-12 of the largest velocity."""
    r_src, r_trg, f = _cloud(kind, 1000, 513, seed=2)
    plan = ck.stokeslet_plan(513, 1000, 132, 4, "f64")
    assert plan.chunks > 1
    got = _chunked("f64", plan, r_src, r_trg, f)
    ref = np.asarray(jk.stokeslet_direct(jnp.asarray(r_src),
                                         jnp.asarray(r_trg), jnp.asarray(f),
                                         ETA))
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
