"""The work split of the fused ring kernels E and F (`ring_plan`), on the CPU.

Inside every ring step kernel E / F cuts the pairs of the step's slot into
items (a target block of R x 128 targets, a chunk of whole 128-source tiles
of the slot) that a persistent grid of blocks strides over; each item's
partial sums go to scratch that a second launch reduces step-major, then
chunk. The plan that picks R, the chunks and the grid is Python, so these
tests reach it here: its cover of every pair of every step, and the plain
ring sum taken in its item order, over the kernel's tile-major slot layout
with its pads, reduced in its order, against the JAX package's rings. The
kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.parallel import make_mesh as jmake_mesh
from skellysim_tpu.parallel import ring as jring
from skellysim_tpu_torch.ops import cuda_kernels as ck

#: (targets, sources) a shard: one pair; ragged counts either side of a
#: tile; the ring run's E (34,000 x 32,000) and F (32,000 x 2,000) shapes;
#: and phase 7's 640,000-node E on 4 shards
SHAPES = ((1, 1), (127, 129), (129, 127), (1025, 255), (34_000, 32_000),
          (32_000, 2_000), (160_000, 160_000))
#: (SMs, resident blocks an SM): the H100 at 4 and 3 blocks, a small card
CARDS = ((132, 4), (132, 3), (8, 2))
ETA = 1.2


def _covers(ranges, n):
    """The ranges are non-empty, in order, and tile [0, n) exactly once."""
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _busy(plan, grid, chunk_tiles):
    """A step's busy share of ``plan``'s items cut at ``chunk_tiles`` tiles
    on a grid of ``grid`` blocks."""
    rounds = -(-plan.target_blocks * -(-plan.tiles // chunk_tiles) // grid)
    return plan.target_blocks * plan.tiles / (rounds * grid * chunk_tiles)


def _best_busy(plan, grid):
    """The busiest split of a step any chunk length gives on a grid of
    ``grid`` blocks (brute force)."""
    return max(_busy(plan, grid, c) for c in range(1, plan.tiles + 1))


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
@pytest.mark.parametrize("n_trg,n_src", SHAPES)
def test_ring_plan_covers_every_pair_once(n_trg, n_src, family):
    """For 1-8 shards, one launch a shard or one for all of them: every
    (target, source) pair of every step in exactly one item (the items'
    target ranges and source ranges each tile their axis, and the blocks'
    items of a step are every item once); chunks of whole tiles bar a
    padded last one; the scratch n steps x chunks x n_trg x 3; the grid the
    card's block slots among the launch's shards; a step's busy share on
    the whole card's grid (one shard a card, which sets the split) at least
    0.95 unless no split reaches it; and the share on the launch's own grid
    no lower where that grid divides the card's."""
    for n in range(1, 9):
        for per_launch in sorted({1, n}):
            for sms, per_sm in CARDS:
                plan = ck.ring_plan(n_trg, n_src, n, per_launch, sms, per_sm,
                                    family)
                assert plan.r == ck.RING_R
                assert plan.grid == sms * per_sm // per_launch
                assert plan.tiles == -(-n_src // ck.RING_TILE)
                assert plan.scratch_shape == (n, plan.chunks, n_trg, 3)
                ranges = [plan.item_ranges(i) for i in range(plan.items)]
                targets = [ranges[b * plan.chunks][0]
                           for b in range(plan.target_blocks)]
                sources = [ranges[c][1] for c in range(plan.chunks)]
                _covers(targets, n_trg)
                _covers(sources, n_src)
                assert ranges == [(t, s) for t in targets for s in sources]
                per_block = plan.r * ck.RING_THREADS
                assert all(hi - lo <= per_block for lo, hi in targets)
                chunk_len = plan.chunk_tiles * ck.RING_TILE
                assert all(hi - lo == chunk_len for lo, hi in sources[:-1])
                assert plan.chunks * plan.chunk_tiles >= plan.tiles
                for step in range(n):
                    starts = [plan.block_items(b, step).start
                              for b in range(plan.grid)]
                    assert sorted(starts) == list(range(plan.grid))
                    assert all(plan.block_items(b, step).step == plan.grid
                               for b in (0, plan.grid - 1))
                card = sms * per_sm
                assert plan.busy == pytest.approx(
                    _busy(plan, plan.grid, plan.chunk_tiles))
                assert 0 < plan.busy <= 1
                whole = _busy(plan, card, plan.chunk_tiles)
                assert whole >= 0.95 or whole == pytest.approx(
                    _best_busy(plan, card))
                if card % per_launch == 0:
                    assert plan.busy >= whole - 1e-12


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
@pytest.mark.parametrize("n_trg,n_src", SHAPES)
def test_ring_plan_split_is_the_same_on_every_layout(n_trg, n_src, family):
    """The split of a step's sources, which sets the order of the f32 sums,
    is the same however many shards a launch serves (all on one card, one
    a card, or between): the same shards give the same bits in every
    layout; only the grid a shard changes."""
    for n in range(1, 9):
        for sms, per_sm in CARDS:
            plans = [ck.ring_plan(n_trg, n_src, n, s, sms, per_sm, family)
                     for s in range(1, n + 1)
                     if sms * per_sm // s >= 1]
            assert {(p.chunks, p.chunk_tiles, p.target_blocks, p.tiles)
                    for p in plans} == {(plans[0].chunks,
                                         plans[0].chunk_tiles,
                                         plans[0].target_blocks,
                                         plans[0].tiles)}
            assert [p.grid for p in plans] == [
                sms * per_sm // s for s in range(1, len(plans) + 1)]


def test_ring_plan_block_items_partition_each_step():
    """Enumerated in full at a small grid: every block's items of a step,
    taken together, are each item of that step once, and over the whole
    call no block takes more than one item more than another."""
    plan = ck.ring_plan(3000, 1000, 3, 3, 8, 3, "stokeslet")
    assert plan.items > plan.grid          # several rounds a step
    taken = np.zeros(plan.grid, dtype=int)
    for step in range(3):
        got = sorted(i for b in range(plan.grid)
                     for i in plan.block_items(b, step))
        assert got == list(range(plan.items))
        for b in range(plan.grid):
            taken[b] += len(plan.block_items(b, step))
    assert taken.max() - taken.min() <= 1


def test_ring_plan_splits_where_targets_cannot_fill_the_card():
    """At the H100's occupancies (E 3 resident blocks an SM, F 4) the ring
    run's E (34,000 targets a shard: 67 blocks of 4 x 128 on a grid of 99
    a shard) and F (63 blocks on 132), and phase 7's 640k E on one shard a
    card (313 blocks on 396 slots) need the source split to fill a step; a
    step of one tile cannot have it. The ring run's plans (4 shards of one
    card) are those of one shard a card: E 23 chunks of 11 tiles, F 8 of
    2, 640k E 5 of 250."""
    e = ck.ring_plan(34_000, 32_000, 4, 4, 132, 3, "stokeslet")
    f = ck.ring_plan(32_000, 2_000, 4, 4, 132, 4, "stresslet")
    big = ck.ring_plan(160_000, 160_000, 4, 1, 132, 3, "stokeslet")
    for plan in (e, f, big):
        assert plan.chunks > 1 and plan.busy >= 0.95
    assert (e.target_blocks, f.target_blocks, big.target_blocks) == (
        -(-34_000 // 512), -(-32_000 // 512), -(-160_000 // 512))
    assert (e.grid, f.grid, big.grid) == (99, 132, 396)
    assert [(p.chunks, p.chunk_tiles) for p in (e, f, big)] == [
        (23, 11), (8, 2), (5, 250)]
    assert ck.ring_plan(34_000, 100, 4, 4, 132, 3, "stokeslet").chunks == 1


def test_ring_plan_rejects_what_cannot_launch():
    """A family with no kernel, empty counts, more shards a launch than the
    ring has, more than 16 shards, and a grid of 0 raise; both families
    plan the built R."""
    with pytest.raises(ValueError, match="no ring kernel is built"):
        ck.ring_plan(10, 10, 2, 2, 132, 4, "rotlet")
    for bad in ((0, 10, 2, 2, 132, 4), (10, 0, 2, 2, 132, 4),
                (10, 10, 2, 2, 0, 4), (10, 10, 2, 2, 132, 0),
                (10, 10, 0, 1, 132, 4)):
        with pytest.raises(ValueError, match=">= 1"):
            ck.ring_plan(*bad, "stokeslet")
    for bad in ((10, 10, 2, 3, 132, 4), (10, 10, 17, 1, 132, 4)):
        with pytest.raises(ValueError, match="shards"):
            ck.ring_plan(*bad, "stresslet")
    with pytest.raises(ValueError, match="grid of 0"):
        ck.ring_plan(10, 10, 8, 8, 2, 3, "stokeslet")
    assert ck.RING_R == 4
    for family in ("stokeslet", "stresslet"):
        assert ck.ring_plan(10, 10, 2, 2, 132, 4, family).r == ck.RING_R


def test_ring_slot_layout_and_pads():
    """The plain slot: per 128-source tile its positions then its payload,
    row-major, the last tile padded with sources at RING_PAD_POSITION and
    zero payload; the stresslet's 12 words a source, the Stokeslet's 6."""
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.uniform(-1, 1, (130, 3)), dtype=torch.float32)
    for family, cols in (("stokeslet", 3), ("stresslet", 9)):
        pay = torch.as_tensor(rng.standard_normal((130, cols)),
                              dtype=torch.float32)
        slot = ck.ring_slot_plain(family, src, pay)
        assert slot.shape == (2, ck.RING_TILE * (3 + cols))
        assert ck._RING_RECORD_WORDS[f"ring_{family}_f32"] == 3 + cols
        pos = slot[:, :3 * ck.RING_TILE].reshape(-1, 3)
        got = slot[:, 3 * ck.RING_TILE:].reshape(-1, cols)
        assert torch.equal(pos[:130], src) and torch.equal(got[:130], pay)
        assert bool((pos[130:] == ck.RING_PAD_POSITION).all())
        assert bool((got[130:] == 0).all())


def _plan_ordered_ring(family, plan, trg, src, pay):
    """The plain ring sum in the kernel's order: each shard's slot in the
    tile-major layout with its pads; at step s shard k sums the slot of
    shard (k - s) mod n item by item in the blocks' order, each item's
    tiles one at a time (a tile's partial summed apart, then added), into
    scratch [n, chunks, nt, 3], which is then added step-major, then
    chunk. Unscaled (the stresslet's -3 inside, as in the plain block)."""
    cols = 3 if family == "stokeslet" else 9
    block = getattr(ck, f"{family}_f32_plain")
    words = 3 * ck.RING_TILE
    n = len(trg)
    slots = [ck.ring_slot_plain(family, s, p) for s, p in zip(src, pay)]
    out = []
    for k in range(n):
        part = torch.zeros(plan.scratch_shape, dtype=torch.float32)
        for step in range(n):
            slot = slots[(k - step) % n]
            for b in range(plan.grid):
                for i in plan.block_items(b, step):
                    (t0, t1), _ = plan.item_ranges(i)
                    c = i % plan.chunks
                    acc = torch.zeros((t1 - t0, 3), dtype=torch.float32)
                    for tile in range(c * plan.chunk_tiles,
                                      min(plan.tiles,
                                          (c + 1) * plan.chunk_tiles)):
                        acc += block(slot[tile, :words].reshape(-1, 3),
                                     trg[k][t0:t1],
                                     slot[tile, words:].reshape(-1, cols))
                    part[step, c, t0:t1] = acc
        total = part[0, 0].clone()
        for j in range(1, n * plan.chunks):
            total += part.reshape(-1, plan.n_trg, 3)[j]
        out.append(total)
    return out


def _coincident_cloud(n_points, seed):
    """Points i and n - 1 - i coincide (they lie in different shards), f32."""
    rng = np.random.default_rng(seed)
    half = rng.uniform(-2, 2, (n_points // 2, 3))
    return np.concatenate([half, half[::-1]]).astype(np.float32)


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_plan_ordered_ring_matches_jax_rings(family):
    """On 4 shards of 160 points (two tiles a slot, the second padded), on
    a card small enough that the plan splits every step into two chunks:
    the plain ring sum in the plan's order against the JAX ring with impl
    "pallas" (the ppermute ring over the Pallas tile in interpret mode) at
    JAX's own gate, 1e-5 of the norm, and against the exact f64 JAX ring at
    1e-5 too; points coincident across shards keep it finite."""
    n, m = 4, 160
    r = _coincident_cloud(n * m, seed=5)
    rng = np.random.default_rng(6)
    cols = 3 if family == "stokeslet" else 9
    pay = rng.standard_normal((n * m, cols)).astype(np.float32)
    plan = ck.ring_plan(m, m, n, n, 8, 1, family)
    assert (plan.tiles, plan.chunks, plan.grid) == (2, 2, 2)
    shards = [torch.as_tensor(b) for b in np.split(r, n)]
    pays = [torch.as_tensor(b) for b in np.split(pay, n)]
    got = torch.cat(_plan_ordered_ring(family, plan, shards, shards, pays))
    got = got.double().numpy() / (8 * math.pi * ETA)
    assert np.isfinite(got).all()
    jpay = pay if family == "stokeslet" else pay.reshape(-1, 3, 3)
    jfn = getattr(jring, f"ring_{family}")
    mesh = jmake_mesh(n)
    for ref in (jfn(jnp.asarray(r), jnp.asarray(r), jnp.asarray(jpay), ETA,
                    mesh=mesh, impl="pallas"),
                jfn(jnp.asarray(r, dtype=jnp.float64),
                    jnp.asarray(r, dtype=jnp.float64),
                    jnp.asarray(jpay, dtype=jnp.float64), ETA, mesh=mesh)):
        ref = np.asarray(ref, dtype=np.float64)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_plan_ordered_ring_coincident_pairs_are_exactly_zero(family):
    """A target whose only sources with payload sit exactly on it (its own
    point and its twin in another shard) gets exactly 0 in the plan's order,
    pads included; a target away from them gets their finite, nonzero sum."""
    n, m = 4, 160
    r = _coincident_cloud(n * m, seed=7)
    cols = 3 if family == "stokeslet" else 9
    pay = np.zeros((n * m, cols), dtype=np.float32)
    pay[[3, n * m - 4]] = np.arange(1, cols + 1)   # point 3 and its twin
    plan = ck.ring_plan(m, m, n, n, 8, 1, family)
    shards = [torch.as_tensor(b) for b in np.split(r, n)]
    pays = [torch.as_tensor(b) for b in np.split(pay, n)]
    u = torch.cat(_plan_ordered_ring(family, plan, shards, shards, pays))
    assert torch.isfinite(u).all()
    assert torch.equal(u[3], torch.zeros(3))
    assert torch.equal(u[n * m - 4], torch.zeros(3))
    assert float(u[0].abs().max()) > 0
