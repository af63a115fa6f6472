"""The port's cost counter and its baselines against the JAX package's gate.

`skellysim_tpu_torch.obs.cost` runs each registered program under a
`TorchDispatchMode` counter and gates its counts against
``obs/baselines/*.toml`` with the JAX package's rules: an uncovered
program, a drift beyond ``tol_pct``, a stale baseline and a malformed or
unused ``[[suppress]]`` entry are findings; ``--update`` re-baselines and
keeps the deliberate knobs. The cases of ``tests/test_obs.py``'s cost
section run here over toy programs; `apply_suppressions` and
`cost_findings` equal the JAX package's on the same dicts; the registry's
names equal the JAX package's; every registered program is within its
checked-in baseline, its pair seams' totals and collectives exactly; a
counted step gives the uncounted bits; and every pair sum counts 22 / 40
flops a pair (times the members) whatever tile computes it.
"""

import numpy as np
import pytest
import torch

from skellysim_tpu.audit import engine as jengine
from skellysim_tpu.obs import cost as jcost
from skellysim_tpu_torch.audit import engine as tengine
from skellysim_tpu_torch.audit.programs import all_programs, get_program
from skellysim_tpu_torch.audit.registry import AuditProgram, BuiltProgram
from skellysim_tpu_torch.config import toml_io
from skellysim_tpu_torch.obs import cost
from skellysim_tpu_torch.obs.cli import main as obs_main


def _toy_program(name="toy_prog", scale=1.0):
    def build(device=None):
        a = torch.ones((32, 32), dtype=torch.float64) * scale
        return BuiltProgram(lambda x: (x @ x).sum(), (a,), device="cpu")

    return AuditProgram(name=name, layer="solver", summary="toy",
                        build=build)


# ------------------------------------------------ the JAX package's cases

def test_cost_uncovered_then_update_then_pass(tmp_path):
    prog = _toy_program()
    bdir = str(tmp_path)
    rows, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert any("no cost baseline" in f.message for f in findings)
    assert rows[0]["flops"] > 0 and rows[0]["peak_bytes"] > 0

    rows, findings = cost.audit_costs([prog], baseline_dir=bdir, update=True)
    assert findings == []
    rows, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert findings == []  # measured == baseline: counts from shapes
    # 32 x 32 @ 32 x 32 (2 n^3) and the sum's 1,024 inputs
    assert rows[0]["flops"] == 2 * 32 ** 3 + 32 * 32


def test_cost_drift_flagged_and_suppressible(tmp_path):
    prog = _toy_program()
    bdir = str(tmp_path)
    cost.audit_costs([prog], baseline_dir=bdir, update=True)
    path = cost.baseline_path(prog.name, bdir)
    data = toml_io.load(path)
    data["cost"]["flops"] = data["cost"]["flops"] * 2.0  # fake a regression
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert any("flops drifted" in f.message and "improvement" in f.message
               for f in findings)

    # suppression with a reason absorbs it; an unused one is itself a finding
    data["suppress"] = [{"check": "cost-baseline", "match": "flops drifted",
                         "reason": "testing the suppress path"}]
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert findings == []
    data["cost"]["flops"] = data["cost"]["flops"] / 2.0  # back to truth
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert any("unused suppression" in f.message for f in findings)


def test_cost_suppress_requires_reason_and_match(tmp_path):
    prog = _toy_program()
    bdir = str(tmp_path)
    cost.audit_costs([prog], baseline_dir=bdir, update=True)
    path = cost.baseline_path(prog.name, bdir)
    data = toml_io.load(path)
    data["suppress"] = [{"check": "cost-baseline", "match": "flops"}]
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert any("missing its reason" in f.message for f in findings)
    data["suppress"] = [{"check": "cost-baseline", "match": "",
                         "reason": "a blanket match"}]
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert any("non-empty `match`" in f.message for f in findings)


def test_cost_stale_baseline_and_tol_pct(tmp_path):
    prog = _toy_program()
    bdir = str(tmp_path)
    cost.audit_costs([prog], baseline_dir=bdir, update=True)
    # a generous tol_pct absorbs a small nudge (and --update preserves it)
    path = cost.baseline_path(prog.name, bdir)
    data = toml_io.load(path)
    data["cost"]["tol_pct"] = 90.0
    data["cost"]["flops"] = data["cost"]["flops"] * 1.5
    toml_io.dump(data, path)
    _, findings = cost.audit_costs([prog], baseline_dir=bdir)
    assert findings == []
    cost.audit_costs([prog], baseline_dir=bdir, update=True)
    assert toml_io.load(path)["cost"]["tol_pct"] == 90.0
    # a baseline whose program vanished is a finding
    _, findings = cost.audit_costs([_toy_program(name="other")],
                                   baseline_dir=bdir)
    assert any("stale baseline" in f.message for f in findings)
    assert any("no cost baseline" in f.message for f in findings)


def test_cost_cli_exit_codes(tmp_path, capsys):
    """`obs cost --check` exits 1 on drift/uncovered, 0 once baselined, on
    the real registry restricted to its cheapest program (gmres_f32)."""
    bdir = str(tmp_path)
    common = ["--program", "gmres_f32", "--device", "cpu"]
    assert obs_main(["cost", "--check", *common,
                     "--baseline-dir", bdir]) == 1  # uncovered
    # findings exit 1 with or without --check
    assert obs_main(["cost", *common, "--baseline-dir", bdir]) == 1
    assert obs_main(["cost", "--update", *common,
                     "--baseline-dir", bdir]) == 0
    assert obs_main(["cost", "--check", *common,
                     "--baseline-dir", bdir]) == 0
    assert obs_main(["cost", "--check", "--update"]) == 2  # usage error
    assert obs_main(["cost", "--check", "--program", "nope",
                     "--baseline-dir", bdir]) == 2
    # against the REAL baseline dir, a single-program run must not read
    # the other programs' baselines as stale (the --program workflow)
    assert obs_main(["cost", "--check", *common]) == 0
    assert "within cost baselines (run on cpu)" in capsys.readouterr().out


def test_cost_stale_scan_uses_full_registry_names(tmp_path):
    a, b = _toy_program(name="prog_a"), _toy_program(name="prog_b")
    bdir = str(tmp_path)
    cost.audit_costs([a, b], baseline_dir=bdir, update=True)
    # auditing only prog_a with the full name set: prog_b's baseline is fine
    _, findings = cost.audit_costs([a], baseline_dir=bdir,
                                   registry_names={"prog_a", "prog_b"})
    assert findings == []
    # without the full set (a caller that filtered and forgot): stale
    _, findings = cost.audit_costs([a], baseline_dir=bdir)
    assert any("stale baseline" in f.message for f in findings)


# ----------------------------------------- the gate's rules, both packages

_SUPPRESS = [
    {"check": "cost-baseline", "match": "flops drifted", "reason": "r1"},
    {"check": "cost-baseline", "match": "temp_bytes", "reason": "r2"},
    {"check": "dtype-flow", "match": "float32", "reason": "r3"},
    {"check": "cost-baseline", "match": "flops"},          # no reason
]
_FINDINGS = [("p", "cost-baseline", "flops drifted +40.0% (regression)"),
             ("p", "cost-baseline", "bytes_accessed drifted -30.0%"),
             ("p", "dtype-flow", "float64->float32 x2"),
             ("p", "build", "entry point failed")]


@pytest.mark.parametrize("active", [None, {"cost-baseline"}])
def test_apply_suppressions_equals_jax(active):
    def run(engine):
        found = [engine.Finding(*f) for f in _FINDINGS]
        kept = engine.apply_suppressions("p", {"suppress": _SUPPRESS},
                                         found, active)
        return [(f.program, f.check, f.message) for f in kept]

    assert run(tengine) == run(jengine)


@pytest.mark.parametrize("scale", [1.0, 1.2, 2.0, 0.5, 0.0])
def test_cost_findings_equal_jax(scale):
    base = {"cost": {"flops": 1e9, "bytes_accessed": 4e8,
                     "argument_bytes": 9532, "temp_bytes": 0,
                     "peak_bytes": 10000, "tol_pct": 30.0}}
    measured = {"flops": 1e9 * scale, "bytes_accessed": 4e8 / max(scale,
                                                                  0.1),
                "argument_bytes": 9532, "output_bytes": 7, "temp_bytes": 3,
                "peak_bytes": 10000 * scale}

    def render(fs):
        return [(f.program, f.check, f.message) for f in fs]

    assert render(cost.cost_findings("p", measured, base)) == render(
        jcost.cost_findings("p", measured, base))
    assert cost.COST_KEYS == jcost.COST_KEYS
    assert cost.DEFAULT_TOL_PCT == jcost.DEFAULT_TOL_PCT


def test_registry_names_equal_jax():
    from skellysim_tpu.audit.programs import all_programs as jall

    names = [p.name for p in all_programs()]
    assert names == [p.name for p in jall()]
    assert {p.layer for p in all_programs()} == {
        "system", "solver", "ops", "parallel", "ensemble", "scenarios"}
    with pytest.raises(KeyError):
        get_program("nope")


# --------------------------------------------- the checked-in baselines

@pytest.fixture(scope="module")
def measured():
    """One counted run of every registered program on the CPU."""
    rows, findings = cost.audit_costs(all_programs(), device="cpu")
    return {r["name"]: r for r in rows}, findings


def test_every_program_within_its_checked_in_baseline(measured):
    """Acceptance: `obs cost --check`'s gate passes over all 12 programs,
    and the registry and ``obs/baselines/`` name the same programs."""
    import os

    rows, findings = measured
    assert findings == [], [f.render() for f in findings]
    files = {os.path.splitext(f)[0] for f in os.listdir(cost.BASELINE_DIR)
             if f.endswith(".toml")}
    assert files == set(rows)


@pytest.mark.parametrize("name", [p.name for p in all_programs()])
def test_pair_seams_and_collectives_equal_the_baseline(measured, name):
    """The pair seams' totals and the collectives' largest operands are
    the checked-in numbers exactly (they come from shapes and lists, not
    from timing or allocation)."""
    rows, _ = measured
    row = rows[name]
    base = toml_io.load(cost.baseline_path(name))
    assert {k: row[k] for k in cost.PAIR_KEYS} == base["pair_seam"]
    assert row["collectives"] == {
        k: v["max_bytes"] for k, v in base.get("collectives", {}).items()}
    assert row["flops"] >= row["pair_flops"] >= 0.0
    if name.startswith("step_spmd"):
        assert set(row["collectives"]) == {"all_reduce", "all_gather",
                                           "collective_permute"}


@pytest.mark.parametrize("name", ["step_single", "step_mixed"])
def test_counted_step_gives_the_uncounted_bits(name):
    prog = get_program(name)
    a, b = prog.build("cpu"), prog.build("cpu")
    ref = a.fn(*a.args)
    with cost.CostCounter() as counter:
        got = b.fn(*b.args)
    ref_t, got_t = list(cost._tensors(ref)), list(cost._tensors(got))
    assert len(ref_t) == len(got_t) > 0
    for x, y in zip(ref_t, got_t):
        assert torch.equal(x, y)
    assert ref[2].iters == got[2].iters
    assert counter.pairs > 0 and counter.ops > 0
    assert cost._ACTIVE is None


# ------------------------------------------------------ the pair seams

def _operands(members=None):
    rng = np.random.default_rng(3)
    lead = () if members is None else (members,)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(lead + shape))

    return t(50, 3), t(40, 3), t(50, 3), t(50, 3, 3)


@pytest.mark.parametrize("impl", ["exact", "df", "mxu", "pallas_df"])
@pytest.mark.parametrize("family", ["stokeslet", "stresslet"])
def test_a_pair_sum_counts_its_pairs_whatever_computes_it(family, impl):
    """22 / 40 flops a pair (times the members), the CostEstimate's bytes
    at the operands' item size, no aten op of the tile counted."""
    from skellysim_tpu_torch.ops import kernels

    fn = getattr(kernels, f"{family}_direct")
    per = cost.PAIR_FLOPS[family]
    for members in (None, 3):
        src, trg, f, S = _operands(members)
        pay = f if family == "stokeslet" else S
        with cost.CostCounter() as c:
            u = fn(src, trg, pay, 1.0, impl=impl)
        b = 1 if members is None else members
        assert u.shape == trg.shape
        assert c.pairs == b * 40 * 50
        assert c.flops == c.pair_flops == per * b * 40 * 50
        assert c.bytes_accessed == b * cost.pair_bytes(family, 40, 50, 8)
        assert c.ops == 0 and c.seams[family]["calls"] == 1


def test_ring_and_tree_seams_count_their_pairs():
    """A ring over 4 CPU shards counts every target against every source
    once, hop by hop through the per-hop blocks' seams, exactly as the
    fused E / F wrapper's seam counts the same call on the card; the
    treecode's pass counts the pairs its lists hold, near and far."""
    from skellysim_tpu_torch.ops import treecode
    from skellysim_tpu_torch.ops.evaluator import make_pair
    from skellysim_tpu_torch.parallel import make_mesh
    from skellysim_tpu_torch.parallel.ring import (ring_stokeslet,
                                                   ring_stresslet_df)

    src, trg, f, S = _operands()
    mesh = make_mesh(4, device="cpu")
    for fn, pay, fam, impl in (
            (ring_stokeslet, f[:48], "stokeslet", "exact"),
            (ring_stokeslet, f[:48], "stokeslet", "mxu"),
            (ring_stresslet_df, S[:48], "stresslet", "pallas_df"),
            (ring_stresslet_df, S[:48], "stresslet", "df")):
        with cost.CostCounter() as c:
            fn(src[:48], trg, pay, 1.0, mesh=mesh, impl=impl)
        fused = cost.ring_lists_work(fam, list(trg.chunk(4)),
                                     list(src[:48].chunk(4)))
        assert fused == (40 * 48, 16 * cost.pair_bytes(fam, 10, 12, 8))
        assert (c.pairs, c.pair_bytes) == fused, impl
        assert c.seams[fam]["pairs"] == 40 * 48
        assert c.pair_flops == cost.PAIR_FLOPS[fam] * 40 * 48
        assert c.flops > c.pair_flops   # the hops' adds count apart

    pts = np.random.default_rng(61).uniform(-2, 2, (600, 3))
    plan = treecode.plan_tree(pts, tol=1e-4)
    assert plan.depth >= 2
    r = torch.as_tensor(pts)
    anchors = make_pair(plan, "cpu").anchors
    trg_s, src_s, _, items, segs, _, _ = treecode.tree_operands(
        plan, anchors, r, r[:, :3], r)
    it, sg = items.numpy(), segs.numpy()
    want = sum(int(n) * int(sg[g:g + k, 1].sum()) for _, n, g, k in it)
    with cost.CostCounter() as c:
        treecode.stokeslet_impl(plan, anchors, r, r, r[:, :3], 0, 1.0)
    assert c.seams["stokeslet"] == {
        "calls": 1, "pairs": want, "flops": 22.0 * want,
        "bytes": float(cost.pair_bytes("stokeslet", 600, src_s.shape[0],
                                       8))}
    assert trg_s.shape[0] == 600
    assert cost._ACTIVE is None


def test_a_copy_between_devices_counts_no_bytes():
    """A copy between devices (here the CPU and the meta device: an upload
    on the card) is a transfer, not work: 0 bytes and 0 flops; a copy on
    one device counts its input and output."""
    x = torch.ones((64, 3), dtype=torch.float64)
    with cost.CostCounter() as c:
        x.to("meta")
    assert (c.ops, c.bytes_accessed, c.flops) == (1, 0.0, 0.0)
    with cost.CostCounter() as c:
        x.to(torch.float32)
    assert c.bytes_accessed == 64 * 3 * (8 + 4)


def test_a_count_does_not_depend_on_what_ran_before():
    """`stokeslet_tree`'s build makes the depth's static tables, so its
    count is the same with the process's table cache empty or full."""
    from skellysim_tpu_torch.ops import treecode

    prog = get_program("stokeslet_tree")
    treecode._geometry.clear()
    first = cost.measure_built(prog.build("cpu"))
    again = cost.measure_built(prog.build("cpu"))
    for key in (*cost.COST_KEYS, *cost.PAIR_KEYS, "ops"):
        assert first[key] == again[key], key
