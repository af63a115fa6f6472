"""The port's treecode (`skellysim_tpu_torch.ops.treecode`) and its pair
pass (kernels G / H's plain twin) against the JAX package's treecode.

* `plan_tree` gives the JAX package's plan field for field (a uniform
  cloud, a fiber cloud, a depth-0 cloud, fill capacity), and the static
  geometry (`_interaction_lists`, `_neighbor_table`, `_transfer_np`) equal
  arrays;
* `_bucket` gives the same buckets bit for bit and `_upward` the same
  proxies to 1e-13;
* on the same plan, in f64, `stokeslet_tree`, `stresslet_tree` and
  `oseen_tree` agree with the JAX package's to 1e-12 relative, with the
  sources as targets, with disjoint targets and on a fiber cloud with
  boundary leaves; a depth-0 plan is the port's dense sum bit for bit;
* the plain twin of G / H over the segment lists equals the JAX package's
  row form (its `_tree_eval`, compiled as its sums compile it), and the
  lists cover every target once, skip empty buckets and cells, and count a
  clipped neighbor once;
* the redesigned G / H's items put each target in one lane slot of an
  item whose T covers it, keep the first design's segments (and sum), and
  a geometry kept a step by the `PairEvaluator` gives a fresh build's sums
  bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skellysim_tpu.ops import treecode as jtc
from skellysim_tpu_torch.ops import cuda_kernels as ck
from skellysim_tpu_torch.ops import evaluator as tev
from skellysim_tpu_torch.ops import kernels as tk
from skellysim_tpu_torch.ops import treecode as ttc


def _uniform_cloud(n, seed=3, box=1.5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-box, box, (n, 3)), rng.standard_normal((n, 3))


def _fiber_cloud(n_fib, n_nodes, seed=7, box=2.0):
    """Line-clustered nodes (the fiber geometry the evaluator serves):
    many leaves empty, many targets in boundary leaves."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-box, box, (n_fib, 3))
    dirs = rng.normal(size=(n_fib, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t = np.linspace(0, 1.0, n_nodes)
    pts = origins[:, None, :] + t[None, :, None] * dirs[:, None, :]
    return pts.reshape(-1, 3), rng.standard_normal((n_fib * n_nodes, 3))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _plans(pts, **kw):
    jp = jtc.plan_tree(pts, **kw)
    tp = ttc.plan_tree(pts, **kw)
    assert tp.__dict__ == jp.__dict__
    return jp, tp


@pytest.mark.parametrize("cloud,kw,depth", [
    ("uniform", dict(tol=1e-4), 3),
    ("uniform", dict(tol=1e-3, target_occ=4.0, max_depth=4), 4),
    ("fibers", dict(tol=1e-5), 2),
    ("small", dict(tol=1e-4), 0),
    ("uniform", dict(tol=1e-6, n_fill=900), 3),
])
def test_plan_equals_jax(cloud, kw, depth):
    pts = {"uniform": lambda: _uniform_cloud(3000)[0],
           "fibers": lambda: _fiber_cloud(40, 16)[0],
           "small": lambda: _uniform_cloud(150)[0]}[cloud]()
    jp, tp = _plans(pts, **kw)
    assert tp.depth == depth
    for tol in (1e-2, 1e-4, 1e-6, 1e-12):
        assert ttc.order_for_tol(tol) == jtc.order_for_tol(tol)
    pair = tev.make_pair(tp, "cpu")
    assert pair.evaluator == "tree"
    np.testing.assert_array_equal(pair.anchors.numpy(),
                                  np.asarray(jtc.plan_anchors(jp)))
    if kw.get("n_fill"):
        tf = pair.fill_positions(kw["n_fill"], torch.float64)
        jf = jtc.fill_positions(jp, jtc.plan_anchors(jp)[0], kw["n_fill"],
                                jnp.float64)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize("depth", [2, 3])
def test_static_geometry_equals_jax(depth):
    ji, jtotal, joff, jchild = jtc._interaction_lists(depth)
    ti, ttotal, toff, tchild = ttc._interaction_lists(depth)
    np.testing.assert_array_equal(ti, ji)
    assert (ttotal, toff) == (jtotal, joff)
    assert tchild.keys() == jchild.keys()
    for lev in jchild:
        np.testing.assert_array_equal(tchild[lev], jchild[lev])
    for a, b in zip(ttc._neighbor_table(depth), jtc._neighbor_table(depth)):
        np.testing.assert_array_equal(a, b)
    for p in (3, 5, 6):
        np.testing.assert_array_equal(ttc._transfer_np(p),
                                      jtc._transfer_np(p))
        np.testing.assert_array_equal(ttc._nodes3_np(p), jtc._nodes3_np(p))


def test_bucket_and_upward_match_jax():
    """The same buckets bit for bit (stable sort, padded lanes at the
    leaf's center with zero payload) and the same proxies to 1e-13, against
    the JAX package's functions compiled as its sums compile them (XLA
    turns their division by the leaf size into a product with its
    reciprocal, which the port repeats)."""
    pts, f = _fiber_cloud(60, 20, seed=5)
    pts[::7, 1] = 0.0          # on a leaf boundary (the anchor's lattice)
    plan = ttc.plan_tree(pts, tol=1e-3)
    assert plan.depth == 2
    assert any(abs(a / plan.leaf_size - round(a / plan.leaf_size)) < 1e-12
               for a in plan.box_lo)
    lo_t = tev.make_pair(plan, "cpu").anchors[0]
    lo_j = jtc.plan_anchors(plan)[0]
    cen_t = ttc._cell_centers(plan, lo_t, plan.depth, torch.float64)
    cen_j = jtc._cell_centers(plan, lo_j, plan.depth, jnp.float64)
    np.testing.assert_array_equal(cen_t.numpy(), np.asarray(cen_j))
    tb, tpay, counts = ttc._bucket(plan, lo_t, cen_t, torch.tensor(pts),
                                   torch.tensor(f))
    jb, jpay = jax.jit(jtc._bucket, static_argnums=0)(
        plan, lo_j, cen_j, jnp.asarray(pts), jnp.asarray(f))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    assert int(counts.sum()) == len(pts)
    tpp, tpf, cell_n = ttc._upward(plan, lo_t, tb, tpay, counts,
                                   torch.float64)
    jpp, jpf = jax.jit(jtc._upward, static_argnums=(0, 4))(
        plan, lo_j, jb, jpay, jnp.float64)
    np.testing.assert_allclose(tpp.numpy(), np.asarray(jpp), rtol=0,
                               atol=1e-14)
    assert _rel(tpf.numpy(), jpf) < 1e-13
    # a cell with no source below it has exactly zero proxies
    empty = (cell_n == 0).numpy()
    assert empty.any() and not np.abs(tpf.numpy()[empty]).any()


def _sum_both(family, plan, src, trg, pay, eta):
    P, T, Q = (torch.tensor(a) for a in (src, trg, pay))
    jP, jT, jQ = (jnp.asarray(a) for a in (src, trg, pay))
    if family == "stokeslet":
        return (ttc.stokeslet_tree(plan, P, T, Q, eta).numpy(),
                jtc.stokeslet_tree(plan, jP, jT, jQ, eta))
    if family == "stresslet":
        return (ttc.stresslet_tree(plan, P, T, Q, eta).numpy(),
                jtc.stresslet_tree(plan, jP, jT, jQ, eta))
    return (ttc.oseen_tree(plan, P, T, Q, eta).numpy(),
            jtc.oseen_tree(plan, jP, jT, jQ, eta))


@pytest.mark.parametrize("family", ["stokeslet", "stresslet", "oseen"])
@pytest.mark.parametrize("scene", ["self", "disjoint", "fibers"])
def test_sums_match_jax(family, scene):
    """The port's sums equal the JAX package's to 1e-12 in f64 on the same
    plan: the sources as targets (depth 2), probes off the cloud
    (disjoint targets) and a fiber cloud at depth 3 (empty leaves,
    boundary leaves, clipped neighbors)."""
    if scene == "fibers":
        src, f = _fiber_cloud(100, 24, seed=19)
        trg = src
        plan = ttc.plan_tree(src, tol=1e-3, target_occ=8.0)
        assert plan.depth == 3
    else:
        src, f = _uniform_cloud(1200, seed=13)
        trg = src
        if scene == "disjoint":
            trg = np.random.default_rng(17).uniform(-1.6, 1.6, (300, 3))
        plan = ttc.plan_tree(src if trg is src else np.vstack([src, trg]),
                             tol=1e-3)
        assert plan.depth == 2
    pay = f
    if family == "stresslet":
        pay = np.random.default_rng(8).standard_normal((len(src), 3, 3))
    u, ju = _sum_both(family, plan, src, trg, pay, 1.3)
    assert _rel(u, ju) < 1e-12


def test_depth0_is_the_dense_sum_bit_for_bit():
    pts, f = _uniform_cloud(150, seed=11)
    plan = ttc.plan_tree(pts, tol=1e-4)
    assert plan.depth == 0
    P, F = torch.tensor(pts), torch.tensor(f)
    S = torch.tensor(np.random.default_rng(2).standard_normal((150, 3, 3)))
    assert torch.equal(ttc.stokeslet_tree(plan, P, P, F, 1.3),
                       tk.stokeslet_direct(P, P, F, 1.3))
    assert torch.equal(ttc.stresslet_tree(plan, P, P, S, 1.3),
                       tk.stresslet_direct(P, P, S, 1.3))
    assert torch.equal(ttc.oseen_tree(plan, P, P, F, 1.3),
                       tk.oseen_contract(P, P, F, 1.3))
    pair = tev.make_pair(plan, "cpu")
    assert torch.equal(pair.stokeslet(P, P, F, 150, 1.3),
                       tk.stokeslet_direct(P, P, F, 1.3))


def _lists(plan, src, trg, pay, fields=("near", "far")):
    """`ops.treecode.tree_operands` and the proxy cells' source counts."""
    anchors = tev.make_pair(plan, "cpu").anchors
    ops = ttc.tree_operands(plan, anchors, src, pay, trg, fields)
    lo = anchors[0]
    cen = ttc._cell_centers(plan, lo, plan.depth, torch.float64)
    sb, pb, counts = ttc._bucket(plan, lo, cen, src, pay)
    cell_n = ttc._upward(plan, lo, sb, pb, counts, torch.float64)[2]
    return ops + (cell_n,)


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_plain_twin_on_segments_equals_row_form(family):
    """G's / H's plain twin over the segment lists equals the JAX
    package's row form (`_stokeslet_tree_impl` / `_stresslet_tree_impl`,
    its `_tree_eval`) to 1e-13, in f64 and (to 1e-5) in f32; the near and
    far lists apart add up to the whole."""
    src, f = _fiber_cloud(40, 20, seed=23)
    trg = np.vstack([src, np.random.default_rng(4).uniform(-2, 2, (200, 3))])
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-3)
    assert plan.depth == 2
    C = 3 if family == "stokeslet" else 9
    pay = np.random.default_rng(6).standard_normal((len(src), C))
    P, T, Q = (torch.tensor(a) for a in (src, trg, pay))
    jimpl = {"stokeslet": jtc._stokeslet_tree_impl,
             "stresslet": jtc._stresslet_tree_impl}[family]
    jpay = pay if family == "stokeslet" else pay.reshape(-1, 3, 3)
    ref = np.asarray(jimpl(jtc.strip_anchors(plan), jtc.plan_anchors(plan),
                           jnp.asarray(src), jnp.asarray(trg),
                           jnp.asarray(jpay), 0.7))
    trg_s, sa, pa, items, segs, order, _, _ = _lists(plan, P, T, Q)
    plain = {prec: getattr(ck, f"tree_{family}_{prec}_plain")
             for prec in ("f32", "f64")}
    u = torch.empty(len(trg), 3, dtype=torch.float64)
    u[order] = plain["f64"](trg_s, sa, pa, items, segs, 0.7)
    assert _rel(u.numpy(), ref) < 1e-13
    # the wrapper on CPU tensors is the plain twin
    wrapper = getattr(ck, f"tree_{family}_f64")
    assert torch.equal(wrapper(trg_s, sa, pa, items, segs, 0.7),
                       plain["f64"](trg_s, sa, pa, items, segs, 0.7))
    u32 = torch.empty(len(trg), 3, dtype=torch.float32)
    u32[order] = plain["f32"](trg_s.float(), sa.float(), pa.float(), items,
                              segs, 0.7)
    assert _rel(u32.numpy(), ref) < 1e-5
    parts = [plain["f64"](*_lists(plan, P, T, Q, (field,))[:5], 0.7)
             for field in ("near", "far")]
    u_parts = torch.empty(len(trg), 3, dtype=torch.float64)
    u_parts[order] = parts[0] + parts[1]
    assert _rel(u_parts.numpy(), ref) < 1e-13


def test_segment_lists_cover_targets_and_skip_zeros():
    """Every target lies in exactly one item of at most TREE_ITEM_TARGETS
    targets of one leaf; near segments are occupied buckets counted once
    (a clipped boundary neighbor is not repeated), far segments whole
    proxy cells with a source below them, never the sentinel; the lists
    hold the pairs the row form's non-zero terms need."""
    src, f = _fiber_cloud(30, 16, seed=2, box=1.0)
    # a target cluster in one corner leaf: more than one item there
    trg = np.vstack([src, np.full((70, 3), -0.95)
                     + 1e-3 * np.arange(70)[:, None]])
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-2)
    assert plan.depth == 2
    P, T, F = (torch.tensor(a) for a in (src, trg, f))
    trg_s, sa, pa, items, segs, order, counts, cell_n = _lists(plan, P, T, F)
    it = items.numpy()
    assert it[:, 1].max() <= ck.TREE_ITEM_TARGETS and it[:, 1].min() >= 1
    covered = np.concatenate([np.arange(a, a + n) for a, n, _, _ in it])
    np.testing.assert_array_equal(covered, np.arange(len(trg)))
    lo = tev.make_pair(plan, "cpu").anchors[0]
    leaf = ttc._leaf_ids(plan, lo, trg_s).numpy()
    for a, n, _, _ in it:
        assert len(set(leaf[a:a + n])) == 1
    assert len({tuple(r[2:]) for r in it}) < len(it)  # a leaf's items share
    sg = segs.numpy()
    mo, p3 = plan.max_occ, plan.order ** 3
    n_real = plan.n_leaves * mo
    assert (sg[:, 1] > 0).all()
    near = sg[:, 0] < n_real
    assert (sg[near, 0] % mo == 0).all()
    np.testing.assert_array_equal(
        sg[near, 1], np.minimum(counts.numpy()[sg[near, 0] // mo], mo))
    far_cell = (sg[~near, 0] - n_real) // p3
    assert (sg[~near, 1] == p3).all() and (cell_n.numpy()[far_cell] > 0).all()
    _, total, _, _ = ttc._interaction_lists(plan.depth)
    assert (far_cell < total).all()
    nid, uniq = ttc._neighbor_table(plan.depth)
    for a, n, g0, ng in it:
        ids = sg[g0:g0 + ng, 0][sg[g0:g0 + ng, 0] < n_real] // mo
        assert len(set(ids)) == len(ids)
        want = {i for i, u in zip(nid[leaf[a]], uniq[leaf[a]])
                if u and counts[i] > 0}
        assert set(ids) == want


def test_items_put_each_target_in_one_lane_slot():
    """The redesigned G / H's items (`_items`) on leaves of 1..200
    targets: each target in exactly one (item, target lane, slot) of its
    leaf, each item's T (`cuda_kernels.tree_item_lanes`) a power of two
    from 4 to 32 with 2 T >= its targets, a leaf's slots 8 ceil(n / 8),
    items of at most TREE_ITEM_TARGETS; the first design's runs of 32."""
    n_t = torch.arange(1, 201, dtype=torch.int64)
    t_first = torch.cumsum(n_t, 0) - n_t
    n_seg = torch.arange(200, dtype=torch.int64) % 7 + 1
    g_first = torch.cumsum(n_seg, 0) - n_seg
    for v1 in (False, True):
        it = ttc._items(n_t, t_first, g_first, n_seg, v1=v1)
        first, n, g0, ng = it.T
        assert int(n.min()) >= 1
        lanes = ck.tree_item_lanes(n)
        slots = ck.tree_item_slots(it, v1=v1)
        if v1:
            assert int(n.max()) <= ck.TREE_V1_ITEM_TARGETS
            assert (slots == ck.TREE_V1_ITEM_TARGETS).all()
        else:
            assert int(n.max()) <= ck.TREE_ITEM_TARGETS
            assert set(lanes.tolist()) <= {4, 8, 16, 32}
            assert (2 * lanes >= n).all() and (lanes * (32 // lanes)
                                               == 32).all()
            assert ((lanes == 4) | (lanes < n)).all()  # the smallest T
            assert (slots == 2 * lanes).all()
        # (item, lane t, slot r) of target first + r T + t, one each
        per_lane, n_slots = (1, 32) if v1 else (2, None)
        seen = torch.zeros(int(n_t.sum()), dtype=torch.int64)
        for (a, m), T in zip(it[:, :2].tolist(), lanes.tolist()):
            T = n_slots or T
            for k in range(m):
                t, r = k % T, k // T
                assert t < T and r < per_lane
                seen[a + k] += 1
        assert (seen == 1).all()
        # items stay inside their leaf and carry its segments
        leaf = torch.repeat_interleave(torch.arange(200), n_t)
        assert (leaf[first] == leaf[first + n - 1]).all()
        assert torch.equal(g0, g_first[leaf[first]])
        assert torch.equal(ng, n_seg[leaf[first]])
        if not v1:
            per_leaf = torch.zeros(200, dtype=torch.int64).index_add_(
                0, leaf[first], slots)
            assert torch.equal(per_leaf, 8 * (-(-n_t // 8)))


@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_lists_keep_the_first_designs_segments(family):
    """The redesigned items walk the first design's segments: the same
    segment array, each target seeing the same multiset of segments (its
    leaf's), and the plain twin over both lists the same sum to 1e-13."""
    src, f = _fiber_cloud(60, 24, seed=31)
    # a pile of 150 targets in one leaf: items of 64 and a remainder
    trg = np.vstack([src, np.full((150, 3), 0.3)
                     + 1e-4 * np.random.default_rng(9).standard_normal(
                         (150, 3))])
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-3, target_occ=8.0)
    assert plan.depth == 3
    C = 3 if family == "stokeslet" else 9
    pay = torch.tensor(np.random.default_rng(3).standard_normal((len(src),
                                                                 C)))
    P, T = torch.tensor(src), torch.tensor(trg)
    anchors = tev.make_pair(plan, "cpu").anchors
    new = ttc.tree_operands(plan, anchors, P, pay, T)
    old = ttc.tree_operands(plan, anchors, P, pay, T, v1=True)
    for a, b in zip(new[:3] + new[4:], old[:3] + old[4:]):
        assert torch.equal(a, b)
    items, v1_items = new[3], old[3]
    assert int(items[:, 1].max()) > ck.TREE_V1_ITEM_TARGETS

    def seen(it):
        rows = [(a + k, g0, ng) for a, n, g0, ng in it.tolist()
                for k in range(n)]
        return sorted(rows)
    assert seen(items) == seen(v1_items)
    plain = getattr(ck, f"tree_{family}_f64_plain")
    u_new = plain(*new[:3], items, new[4], 0.7)
    u_old = plain(*old[:3], v1_items, old[4], 0.7)
    assert _rel(u_new.numpy(), u_old.numpy()) < 1e-13
    # the redesign's lane slots: busier than one target a lane
    busy = {v1: float((it[:, 1] * 1.0).sum() / ck.tree_item_slots(it, v1)
                      .sum()) for v1, it in ((False, items), (True,
                                                             v1_items))}
    assert busy[False] > busy[True]


#: fresh builds' sums of `test_geometry_kept_a_step_gives_the_per_call_bits`
#: by (family, dtype, payload): the same for both weight modes
_FRESH_SUMS: dict = {}


@pytest.mark.parametrize("weights", ["kept", "recomputed"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_geometry_kept_a_step_gives_the_per_call_bits(family, dtype, weights,
                                                      monkeypatch):
    """A `PairEvaluator` keeps the tree's geometry after its first sum
    over a set of positions, and its later sums over them (two payloads,
    as two matvecs) equal a fresh build's bit for bit, whether the
    geometry keeps its anterpolation weights or (past `_WEIGHTS_BUDGET`)
    recomputes them each sum; positions that moved under a kept key give
    NaN, never a stale sum."""
    src, _ = _fiber_cloud(50, 20, seed=41)
    trg = np.vstack([src, np.random.default_rng(5).uniform(-2, 2, (90, 3))])
    plan = ttc.plan_tree(np.vstack([src, trg]), tol=1e-3)
    assert plan.depth == 3
    P, T = (torch.tensor(a, dtype=dtype) for a in (src, trg))
    rng = np.random.default_rng(12)
    shape = (len(src), 3) if family == "stokeslet" else (len(src), 3, 3)
    pays = [torch.tensor(rng.standard_normal(shape), dtype=dtype)
            for _ in range(2)]

    def run(pair, q):
        if family == "stokeslet":
            return pair.stokeslet(P, T, q, 0, 0.8)
        return pair.stresslet(P, T, q, 0.8)

    kept = tev.make_pair(plan, "cpu")
    for i, q in enumerate(pays):
        if weights == "recomputed":
            monkeypatch.setattr(ttc, "_WEIGHTS_BUDGET", 0)
        got = run(kept, q)
        (geom,) = kept.geometry.values()
        assert all((W is None) == (weights == "recomputed")
                   for _, _, W in geom.up.chunks)
        monkeypatch.undo()
        # a fresh build's sum, shared by the "kept" and "recomputed" cases
        key = (family, dtype, i)
        if key not in _FRESH_SUMS:
            _FRESH_SUMS[key] = run(tev.make_pair(plan, "cpu"), q)
        assert torch.equal(got, _FRESH_SUMS[key])
        assert torch.isfinite(got).all()
    moved = P.clone()
    moved[0, 0] += 0.01
    if family == "stokeslet":
        bad = kept.stokeslet(moved, T, pays[0], 0, 0.8)
    else:
        bad = kept.stresslet(moved, T, pays[0], 0.8)
    assert torch.isnan(bad).all()
