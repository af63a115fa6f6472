"""The port's program auditor (`skellysim_tpu_torch.audit`) against the JAX
package's (`skellysim_tpu.audit`).

The port's checks observe one run of each registered program
(`audit.observe.Observer`) where the JAX package's read a lowered
program. Here: each of the nine checks fires on a seeded fault in a toy
program and is quiet on its clean twin (the cases of ``tests/test_audit.py``
and ``tests/test_dmaflow.py`` that a run can show); the contract
discipline (missing file, unknown section, a name that is not the file's,
a suppression without ``match`` or ``reason``, an unused suppression);
the CLI's usage paths and exit codes; a ``--dump-contract`` round trip;
the whole registry contract-clean on the CPU; and the observed inventory
against the JAX package's contract files, read as data from
``skellysim_tpu/audit/contracts/``, field by field. Where the port differs
by design the test asserts the port's own value and ROADMAP.md §3 gives
the reason.

One module-scoped run of the registry serves every test that reads a
registered program (the mask check's clean half is that run).
"""

import functools
import os
import shutil
from typing import NamedTuple

import pytest
import torch

from skellysim_tpu_torch.audit import checks, engine, maskflow, repflow
from skellysim_tpu_torch.audit.cli import main as audit_main
from skellysim_tpu_torch.audit.engine import (Finding, ProgramRun,
                                              load_contract,
                                              run_kernel_audit,
                                              run_program_audit)
from skellysim_tpu_torch.audit.kernels import all_kernels
from skellysim_tpu_torch.audit.programs import all_programs, get_program
from skellysim_tpu_torch.audit.registry import (AuditProgram, BuiltProgram,
                                                probe_twice)
from skellysim_tpu_torch.config import toml_io

JAX_CONTRACTS = os.path.join(os.path.dirname(__file__), os.pardir,
                             "skellysim_tpu", "audit", "contracts")


@pytest.fixture(scope="module")
def runs():
    """One observed CPU run of every registered program, on its contract's
    fixture (dead slots where the contract declares a mask axis)."""
    out = {}
    for prog in all_programs():
        contract, _ = load_contract(prog.name)
        out[prog.name] = ProgramRun(prog, "cpu", contract)
    return out


def _jax_contract(name):
    return toml_io.load(os.path.join(JAX_CONTRACTS, f"{name}.toml"))


# ---------------------------------------------------------------- toys

def _toy(fn, *args, name="toy", probe=None):
    prog = AuditProgram(name=name, layer="solver", summary="toy",
                        build=lambda device=None: BuiltProgram(
                            fn, args, device="cpu"),
                        retrace_probe=probe)
    return prog


def _audit(prog, contract, checks_=None):
    return run_program_audit(prog, contract=contract, checks=checks_,
                             device="cpu")


def _messages(findings, check=None):
    return [f.message for f in findings if check is None or f.check == check]


BASE = {"program": {"name": "toy"}, "donation": {"donated": False},
        "host_sync": {"allowed_callbacks": []}, "mask": {"axes": []}}


def _contract(**sections):
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in BASE.items()}
    out.update(sections)
    return out


# -------------------------------------------------------- check ids, CLI

def test_check_ids_and_sections_are_the_jax_packages():
    from skellysim_tpu.audit import checks as jchecks
    from skellysim_tpu.audit import engine as jengine

    assert [c.id for c in checks.CHECKS] == [c.id for c in jchecks.CHECKS]
    assert engine._KNOWN_SECTIONS == jengine._KNOWN_SECTIONS
    by_id = {c.id: c for c in checks.CHECKS}
    assert by_id["dma"].over_kernels and not by_id["dma"].over_programs
    assert by_id["mask"].over_kernels and by_id["mask"].over_programs
    assert by_id["retrace-budget"].wants_probe


def test_registry_names_match_the_jax_packages():
    from skellysim_tpu.audit.kernels import all_kernels as jkernels
    from skellysim_tpu.audit.programs import all_programs as jprograms

    assert [p.name for p in all_programs()] == [p.name for p in jprograms()]
    ported = {k.name for k in all_kernels()}
    assert {k.name for k in jkernels()} <= ported
    assert {k.kernels for k in all_kernels()} == {"A / B", "C / D", "E", "F",
                                                  "G", "H"}
    with_probe = {p.name for p in all_programs() if p.retrace_probe}
    assert with_probe == {p.name for p in jprograms() if p.retrace_probe}


def test_cli_usage_paths_and_exit_codes(capsys):
    assert audit_main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.strip().splitlines()] == [
        c.id for c in checks.CHECKS]
    assert audit_main(["--list-programs", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "step_spmd_d8" in out and "[ops/kernel A / B]" in out
    assert audit_main(["--check", "no-such-check"]) == 2
    assert "unknown check" in capsys.readouterr().err
    assert audit_main(["--program", "nope", "--device", "cpu"]) == 2
    assert "unknown program" in capsys.readouterr().err
    assert audit_main(["--dump-contract", "nope", "--device", "cpu"]) == 2
    capsys.readouterr()
    if not torch.cuda.is_available():
        assert audit_main(["--check", "dma"]) == 2
        assert "needs the card" in capsys.readouterr().err
        assert audit_main(["--dump-contract", "stokeslet_pallas_tiles"]) == 2
        capsys.readouterr()
        assert audit_main(["--device", "cuda", "--list-checks"]) == 0
        assert audit_main(["--device", "cuda", "--program", "gmres_f32"]) == 2
        capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        audit_main(["--bogus-flag"])
    assert e.value.code == 2


def test_cli_clean_run_says_dma_was_not_run_and_a_perturbed_contract_fails(
        tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--program", "gmres_f32", "--program",
            "stokeslet_pallas_tiles"]
    assert audit_main(argv) == 0
    out = capsys.readouterr().out
    assert "dma: not run on the CPU" in out and "not counted as clean" in out
    assert "contract-clean on cpu (without dma)" in out
    # a perturbed contract (a read site pinned that the run does not make)
    cdir = tmp_path / "contracts"
    shutil.copytree(engine.CONTRACT_DIR, cdir)
    data = toml_io.load(str(cdir / "gmres_f32.toml"))
    data["host_sync"]["read_sites"] += 1
    toml_io.dump(data, str(cdir / "gmres_f32.toml"))
    monkeypatch.setattr(engine, "CONTRACT_DIR", str(cdir))
    assert audit_main(argv) == 1
    assert "read_sites drifted" in capsys.readouterr().out
    # a kernel-only filter never runs a program
    assert audit_main(["--device", "cpu", "--check", "mask", "--program",
                       "ring_stokeslet_fused"]) == 0


# ---------------------------------------------------------- contracts

def test_contract_discipline(tmp_path):
    prog = _toy(lambda x: x + 1, torch.ones(3))
    missing = _audit_dir(prog, tmp_path)
    assert any("no contract file" in m for m in _messages(missing))
    path = tmp_path / "toy.toml"
    toml_io.dump(dict(BASE, bogus={"x": 1},
                      program={"name": "other"}), str(path))
    data, found = load_contract("toy", str(tmp_path))
    msgs = _messages(found)
    assert any("unknown contract section [bogus]" in m for m in msgs)
    assert any("copy-paste drift" in m for m in msgs)
    # an empty match and a missing reason are refused
    toml_io.dump(dict(BASE, suppress=[
        {"check": "dtype-flow", "match": "", "reason": "r"},
        {"check": "dtype-flow", "match": "float32"}]), str(path))
    _, found = load_contract("toy", str(tmp_path))
    msgs = _messages(found)
    assert any("non-empty `match`" in m for m in msgs)
    assert any("missing its reason" in m for m in msgs)
    # an unused suppression is a finding; a filtered run skips others'
    c = _contract(suppress=[{"check": "fft-inventory", "match": "fft",
                             "reason": "nothing to hide"}])
    assert any("unused suppression" in m for m in _messages(_audit(prog, c)))
    assert _audit(prog, c, ["donation"]) == []


def _audit_dir(prog, d):
    return run_program_audit(prog, device="cpu", contract_dir=str(d))


def test_build_failure_is_the_build_finding():
    def boom(x):
        raise ValueError("no such scene")

    found = _audit(_toy(boom, torch.ones(2)), _contract())
    assert [f.check for f in found] == ["build"]
    assert "no such scene" in found[0].message


# ------------------------------------------------------ collectives

def _toy_collectives(kinds):
    from skellysim_tpu_torch.parallel import make_mesh
    from skellysim_tpu_torch.parallel.spmd import Collectives

    comm = Collectives(make_mesh(2, device="cpu"))

    def fn(a, b):
        out = []
        for k in kinds:
            if k == "psum":
                out.append(comm.psum([a, b])[0])
            else:
                out.append(comm.all_gather([a, b])[0])
        return out

    return _toy(fn, torch.ones(4, dtype=torch.float64),
                torch.full((4,), 2.0, dtype=torch.float64))


def test_collective_contract_fires_and_is_clean():
    prog = _toy_collectives(["psum", "psum"])
    good = _contract(collectives={"all_reduce": {"count": 2, "sites": 1,
                                                 "max_bytes": 32}})
    assert _audit(prog, good) == []
    msgs = _messages(_audit(prog, _contract()), "collective-contract")
    assert any("uncontracted collective: 2 all_reduce" in m for m in msgs)
    drift = _contract(collectives={"all_reduce": {"count": 3,
                                                  "max_bytes": 16}})
    msgs = _messages(_audit(prog, drift))
    assert any("count drifted: contract pins 3" in m for m in msgs)
    assert any("over the contract bound of 16" in m for m in msgs)
    stale = _contract(collectives={"all_reduce": {"count": 2},
                                   "all_gather": {"count": 1}})
    assert any("stale contract: [collectives.all_gather]" in m
               for m in _messages(_audit(prog, stale)))
    no_count = _contract(collectives={"all_reduce": {"max_bytes": 32}})
    assert any("has no `count` pin" in m
               for m in _messages(_audit(prog, no_count)))


def test_collectives_report_divergent_shards():
    from skellysim_tpu_torch.audit.observe import Observer

    with Observer("cpu") as obs:
        import skellysim_tpu_torch.audit.observe as ob

        ob.ACTIVE.collective("all_reduce", [torch.ones(2)] * 2,
                             [torch.ones(2), torch.zeros(2)])
        ob.ACTIVE.collective("all_gather", [torch.ones(2)] * 2,
                             [torch.ones(2), torch.ones(2)])
    assert sum(obs.divergent.values()) == 1
    assert obs.collective_table()["all_gather"]["max_bytes"] == 8


# ------------------------------------------------------------ dtype

def test_dtype_flow_promotion_stale_and_suppressed():
    prog = _toy(lambda x: (x.to(torch.float64) * 2).sum(),
                torch.ones(8, dtype=torch.float32))
    msgs = _messages(_audit(prog, _contract()), "dtype-flow")
    assert any("1 float32->float64 float edge site(s)" in m for m in msgs)
    pinned = _contract(dtype={"promotions": {"float32->float64": 1}})
    assert _audit(prog, pinned) == []
    stale = _contract(dtype={"promotions": {"float32->float64": 1,
                                            "float64->float32": 2}})
    assert any("stale contract: [dtype.promotions] pins float64->float32"
               in m for m in _messages(_audit(prog, stale)))
    suppressed = _contract(suppress=[{
        "check": "dtype-flow", "match": "float32->float64",
        "reason": "the toy widens on purpose"}])
    assert _audit(prog, suppressed) == []
    # an op that mixes the widths without a cast is pinned apart
    mixed = _toy(lambda x, y: x + y, torch.ones(3, dtype=torch.float32),
                 torch.ones(3, dtype=torch.float64))
    msgs = _messages(_audit(mixed, _contract()), "dtype-flow")
    assert any("mixed float32 / float64 op" in m for m in msgs)


# -------------------------------------------------------- host syncs

def test_host_sync_added_read_and_stale_allowance():
    prog = _toy(lambda x: float(x.sum().item()), torch.ones(4))
    msgs = _messages(_audit(prog, _contract()), "host-sync")
    assert any("1 host read event(s)" in m for m in msgs)
    ok = _contract(host_sync={"allowed_callbacks": ["read"], "read_sites": 1,
                              "read_events": 1, "sync_op_sites": 0})
    assert _audit(prog, ok) == []
    clean = _toy(lambda x: x * 2, torch.ones(4))
    stale = _contract(host_sync={"allowed_callbacks": ["read", "sync-op"]})
    msgs = _messages(_audit(clean, stale), "host-sync")
    assert any("allows 'read'" in m for m in msgs)
    assert any("allows 'sync-op'" in m for m in msgs)
    # the card-only kinds are not stale on the CPU
    card = _contract(host_sync={"allowed_callbacks": ["upload"]})
    assert _audit(clean, card) == []
    # a boolean mask index waits to size its output; numpy() reads
    both = _toy(lambda x: (x[x > 0].sum(), x.numpy().sum()), torch.ones(4))
    seen = checks.host_sync_observed(
        ProgramRun(both, "cpu", _contract()).observation)
    assert seen["sync_op_sites"] == 1 and seen["read_sites"] == 1


# ---------------------------------------------------------- donation

def test_donation_both_directions():
    def consume(x):
        x.add_(1.0)
        return x

    prog = _toy(consume, torch.ones(4))
    msgs = _messages(_audit(prog, _contract()), "donation")
    assert any("NO donation" in m and "written at" in m for m in msgs)
    assert _audit(prog, _contract(donation={"donated": True})) == []
    keep = _toy(lambda x: x + 1.0, torch.ones(4))
    assert _audit(keep, _contract()) == []
    msgs = _messages(_audit(keep, _contract(donation={"donated": True})))
    assert any("donated but every argument has its bits" in m for m in msgs)


# ----------------------------------------------------- retrace budget

def _port_cache(monkeypatch):
    """A table builder cached in a module of the port (where the probe
    counts ``lru_cache`` misses), keyed by a value."""
    from skellysim_tpu_torch.ops import kernels

    def table(n, scale):
        return torch.arange(n, dtype=torch.float32) * scale

    table.__module__ = kernels.__name__
    cached = functools.lru_cache(maxsize=None)(table)
    monkeypatch.setattr(kernels, "_audit_toy_table", cached, raising=False)
    return cached


def test_retrace_budget_over_budget_and_missing_probe(monkeypatch):
    _table = _port_cache(monkeypatch)

    def keyed_by_value(x):          # rebuilds its table for a new value
        return x * _table(4, float(x[0]))

    def probe(device=None):
        return probe_twice(lambda: keyed_by_value(torch.ones(4)),
                           lambda _: keyed_by_value(torch.full((4,), 2.0)))

    def stable(x):                  # same table for any value
        return x * _table(4, 1.0)

    def stable_probe(device=None):
        return probe_twice(lambda: stable(torch.ones(4)),
                           lambda _: stable(torch.full((4,), 2.0)))

    c = _contract(retrace={"max_traces": 1},
                  host_sync={"allowed_callbacks": ["read"]})
    bad = _toy(keyed_by_value, torch.ones(4), probe=probe)
    msgs = _messages(_audit(bad, c), "retrace-budget")
    assert any("rebuilt 1 thing(s)" in m for m in msgs)
    assert _audit(_toy(stable, torch.ones(4), probe=stable_probe),
                  _contract(retrace={"max_traces": 1})) == []
    msgs = _messages(_audit(_toy(stable, torch.ones(4)),
                            _contract(retrace={"max_traces": 1})))
    assert any("registers no retrace probe" in m for m in msgs)


@pytest.mark.parametrize("name", ["step_single", "step_flight", "gmres_f32",
                                  "stokeslet_tree", "stokeslet_spectral",
                                  "step_spmd_d2", "ensemble_step"])
def test_registered_retrace_probes_rebuild_nothing(runs, name):
    """The JAX package's seven probes, the port's way: a second call of the
    same structure (positions drifted, the spectral anchor one cell on,
    the tree's one leaf on) loads no library, makes no plan, misses no
    kept geometry and builds no cached table (JAX: one trace)."""
    assert runs[name].traces() == 1
    assert _jax_contract(name)["retrace"]["max_traces"] == 1


# --------------------------------------------------------------- fft

def test_fft_inventory_fires_and_is_clean():
    prog = _toy(lambda x: torch.fft.irfft(torch.fft.rfft(x) * 2, n=16),
                torch.ones(16, dtype=torch.float64))
    msgs = _messages(_audit(prog, _contract()), "fft-inventory")
    assert any("2 fft site(s)" in m and "_fft_r2c x1" in m for m in msgs)
    assert _audit(prog, _contract(fft={"count": 2})) == []
    assert any("fft count drifted: contract pins 3" in m for m in _messages(
        _audit(prog, _contract(fft={"count": 3}))))
    assert any("has no `count` pin" in m for m in _messages(
        _audit(prog, _contract(fft={}))))


# -------------------------------------------------------------- mask

class _Slots(NamedTuple):
    x: torch.Tensor
    active: torch.Tensor


def _slots(n=6):
    x = torch.arange(1.0, 3 * n + 1, dtype=torch.float64).reshape(n, 3)
    return _Slots(x=x, active=torch.ones(n, dtype=torch.bool))


def _mask_contract(outputs):
    return _contract(mask={"axes": [{"name": "slot", "mask": "0.active",
                                     "scope": "0", "dim": 0}],
                           "outputs": outputs})


def test_mask_dead_slot_leaking_through_an_unmasked_sum():
    prog = _toy(lambda s: (s._replace(x=s.x * 2), s.x.sum()), _slots())
    msgs = _messages(_audit(prog, _mask_contract({
        "0.x": "pad-passthrough", "0.active": "pad-exact-zero",
        "1": "live-only"})), "mask")
    assert any("pad-escape: output '1' changed" in m and "(nan)" in m
               for m in msgs)


def test_mask_zero_times_inf():
    """``x * mask`` keeps NaN out of a finite pad, not inf: 0 * inf is
    NaN, which the sum carries into the live result."""
    def mul(s):
        return (s.x * s.active[:, None]).sum()

    def where(s):
        return torch.where(s.active[:, None], s.x, 0.0).sum()

    pins = {"result": "live-only"}
    msgs = _messages(_audit(_toy(mul, _slots()), _mask_contract(pins)))
    assert any("pad-escape" in m and "(inf)" in m for m in msgs)
    assert _audit(_toy(where, _slots()), _mask_contract(pins)) == []


def test_mask_pad_classes_and_pins():
    def step(s):
        live = s.active[:, None]
        return (s._replace(x=torch.where(live, s.x + 1.0, s.x)),
                torch.where(live, s.x, 0.0), s.active)

    prog = _toy(step, _slots())
    pins = {"0.x": "pad-passthrough", "0.active": "pad-exact-zero",
            "1": "live-only", "2": "live-only"}
    assert _audit(prog, _mask_contract(pins)) == []
    msgs = _messages(_audit(prog, _mask_contract(
        dict(pins, **{"0.x": "live-only", "9": "live-only"}))), "mask")
    assert any("'0.x' pad class drifted" in m for m in msgs)
    assert any("stale pin" in m and "'9'" in m for m in msgs)
    msgs = _messages(_audit(prog, _mask_contract({})))
    assert any("has no [mask.outputs] pin" in m for m in msgs)
    msgs = _messages(_audit(prog, _contract(mask={"axes": [],
                                                  "outputs": pins})))
    assert any("stale [mask.outputs] table" in m for m in msgs)
    assert any("no [mask] section" in m for m in _messages(_audit(
        prog, {k: v for k, v in _contract().items() if k != "mask"})))


def test_mask_fixture_gets_dead_slots_and_integer_poison_stays_in_range():
    s = _slots()
    axes, _ = maskflow.axes_from_contract(
        _mask_contract({})["mask"], "toy")
    (dead,) = maskflow.with_dead_slots((s,), axes)
    assert dead.active.tolist() == [True] * 3 + [False] * 3
    idx = torch.tensor([0, 1, 2, 3, 4, 5])
    bad = maskflow._poisoned(idx, ~dead.active, "nan")
    assert bad[:3].tolist() == [0, 1, 2]
    assert all(0 <= v <= 5 and v != i for i, v in
               zip(range(3, 6), bad[3:].tolist()))


def test_masking_of_registered_programs_keeps_live_bits(runs):
    """The mask check's poisoned runs over the registered fixtures with
    dead slots: no live output moves (`test_torch_buckets.py`'s poisoned
    padding test, generalised to every output of every padded
    program)."""
    for name in ("step_single", "step_mixed", "step_flight",
                 "ensemble_step", "di_device"):
        run = runs[name]
        assert run.axes, name
        assert run.mask_report().findings == [], name


# --------------------------------------------------------- replication

def test_replication_one_shard_diverging(runs):
    run = runs["step_spmd_d2"]
    assert repflow.analyze(run).findings == []
    new_state, sol, info = run.out
    shard1 = new_state.shards[1]
    bodies = shard1.bodies._replace(
        position=shard1.bodies.position + 1e-12)
    bad_state = new_state._replace(shards=(
        new_state.shards[0], shard1._replace(bodies=bodies)))
    found = repflow.analyze(run, out=(bad_state, sol, info)).findings
    assert found == ["replicated output 'state.bodies.position' differs "
                     "between shard 0 and shard 1"]
    msgs = _messages(checks.check_replication(
        "step_spmd_d2", run, {"replication": {"mesh_axes": ["fib"]}}, None))
    assert any("no `replicated_outputs` pin" in m for m in msgs)
    assert repflow.analyze(runs["step_single"]) is None
    assert any("stale contract" in m for m in _messages(
        checks.check_replication("step_single", runs["step_single"],
                                 {"replication": {}}, None)))


# ----------------------------------------------------- the registry

@pytest.mark.parametrize("name", [p.name for p in all_programs()])
def test_registered_program_is_contract_clean(runs, name):
    contract, found = load_contract(name)
    assert found == []
    assert run_program_audit(get_program(name), device="cpu",
                             run=runs[name]) == []


def test_kernel_contracts_are_clean_on_the_cpu():
    """Over the kernel matrix the CPU runs the mask declaration only (dma
    launches the kernels: the card's); every kernel family has its
    contract with its [dma] pins."""
    for kern in all_kernels():
        assert run_kernel_audit(kern, checks=["mask"], device="cpu") == []
        contract, found = load_contract(kern.name)
        assert found == [] and contract["mask"] == {"axes": []}
        assert {"registers", "smem_bytes", "spill_bytes", "repeats",
                "source"} <= set(contract["dma"])
        assert contract["dma"]["spill_bytes"] == 0


def test_dump_contract_round_trips(runs):
    for name in ("step_single", "step_spmd_d2", "stokeslet_spectral"):
        text = engine.dump_contract(get_program(name), "cpu",
                                    run=runs[name])
        data = toml_io.loads(text)
        assert data["program"]["name"] == name
        assert run_program_audit(get_program(name), contract=data,
                                 device="cpu", run=runs[name]) == []


# ------------------------------------------------ against the JAX package

#: (program, output) -> the port's class where the JAX contract's differs:
#: the static analysis over-approximates what the fixture's run shows
#: (ROADMAP.md §3, differences by design)
MASK_DIFFERENCES = {
    # the member rows' per-member metrics read only live lanes in the run
    **{("ensemble_step", f"1.{k}"): "live-only"
       for k in ("accepted", "fiber_error", "t", "dt_next", "health",
                 "failed")},
    **{("ensemble_step", f"0.states.{k}"): "live-only"
       for k in ("time", "dt", "background.uniform",
                 "background.components", "background.scale")},
    # the refreshed mask is exact zeros at the dead lanes of every member
    ("ensemble_step", "0.states.fibers.active"): "pad-exact-zero",
}
#: outputs the port has and the JAX package does not
MASK_PORT_ONLY = {("ensemble_step", "1.di_s")}


def _di_fill_differences(run):
    """di_device's fixture nucleates into every dead slot, so no slot stays
    padded: each guarded output is live-derived there (live-only), or
    exact zeros where the fill writes zeros."""
    return {k: v for k, v in run.mask_report().observed.items()
            if k.startswith("0.fibers.")}


@pytest.mark.parametrize("name", ["step_single", "step_mixed", "step_flight",
                                  "ensemble_step", "di_device"])
def test_mask_outputs_against_the_jax_contracts(runs, name):
    jax_pins = _jax_contract(name)["mask"]["outputs"]
    observed = runs[name].mask_report().observed
    di = _di_fill_differences(runs[name]) if name == "di_device" else {}
    for path, cls in observed.items():
        if (name, path) in MASK_PORT_ONLY:
            continue
        assert path in jax_pins, (name, path)
        want = MASK_DIFFERENCES.get((name, path), di.get(path,
                                                         jax_pins[path]))
        assert cls == want, (name, path, cls, jax_pins[path])
    assert set(jax_pins) <= set(observed), set(jax_pins) - set(observed)
    if name == "di_device":
        assert runs[name].out[1].nucleations == 5     # every dead slot


@pytest.mark.parametrize("name", ["step_single", "step_flight"])
def test_no_float_widening_in_the_f64_steps(runs, name):
    """As in the JAX package: no float promotion edge. The flight ring's
    narrowing writes (its rows are float32) are pinned apart."""
    assert "dtype" not in _jax_contract(name)
    edges = runs[name].observation.edge_sites()
    assert not any(e in edges for e in ("float32->float64",
                                        "float16->float32"))
    assert runs[name].observation.mixed_sites() == {}


def test_step_mixed_edges_against_the_jax_contract(runs):
    """JAX: 22 float32->float64 sites, every refinement merge of the f32
    Krylov correction and the double-float tiles. The port widens at 4
    sites (`System._lo_view` casts only the leaves the f32 operator reads,
    the df tiles' merges are 2 sites) and narrows at 8."""
    jax = _jax_contract("step_mixed")["dtype"]["promotions"]
    assert jax == {"float32->float64": 22}
    edges = runs["step_mixed"].observation.edge_sites()
    assert edges["float32->float64"] == 4
    assert load_contract("step_mixed")[0]["dtype"]["promotions"] == edges


def test_spectral_fft_count_is_the_jax_packages(runs):
    assert runs["stokeslet_spectral"].observation.fft_sites() \
        == _jax_contract("stokeslet_spectral")["fft"]["count"] == 2


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_spmd_replication_and_gathers_against_the_jax_contracts(runs, n_dev):
    name = f"step_spmd_d{n_dev}"
    jax = _jax_contract(name)
    rep = repflow.analyze(runs[name]).observed
    assert rep["mesh_axes"] == jax["replication"]["mesh_axes"] == ["fib"]
    assert rep["varying_outputs"] == jax["replication"]["varying_outputs"]
    # the port's StepInfo keeps the solver's residual history (a host
    # list); the JAX sharded step returns none
    assert rep["replicated_outputs"] == \
        jax["replication"]["replicated_outputs"] + 1 == 34
    # the all-gather carries at most the shell density (3 x 56), never a
    # fiber-cache-sized operand
    coll = runs[name].observation.collective_table()
    density = jax["collectives"]["all_gather"]["max_elems"]
    assert density == 168
    assert coll["all_gather"]["max_bytes"] // 8 <= density
    assert coll["all_gather"]["max_bytes"] // 8 == 168 // n_dev
    # the JAX ring's permuted blocks halve with the mesh; the port's too
    assert coll["collective_permute"]["max_bytes"] == 12288 // n_dev
    # donation: the JAX step donates its state, the port never aliases
    assert jax["donation"]["donated"] is True
    assert load_contract(name)[0]["donation"]["donated"] is False


def test_every_registered_contract_keeps_the_jax_sections(runs):
    """Each port contract names the sections the JAX contract has, except
    those the port drops by design (the SPMD ladder's [retrace] on d4/d8
    is the JAX package's too)."""
    for prog in all_programs():
        port, _ = load_contract(prog.name)
        jax = _jax_contract(prog.name)
        for section in jax:
            if section in ("suppress", "collectives", "dtype"):
                continue
            assert section in port, (prog.name, section)


def test_finding_renders_like_the_jax_packages():
    from skellysim_tpu.audit.engine import Finding as JFinding

    a = Finding("p", "mask", "m")
    assert a.render() == JFinding("p", "mask", "m").render()


def test_sharded_fiber_error_keeps_a_nan_from_any_shard(monkeypatch):
    """ROADMAP §3 fault 5: the sharded step read each shard's fiber error
    to the host and took a Python max, which drops a NaN that is not
    first, so shard 1's non-finite fibers reached no health bit. The
    step now takes one pmax over the shards (NaN wins) and reads it once
    (the d2 / d4 / d8 contracts pin the same read events on every mesh
    size)."""
    import math

    from skellysim_tpu_torch.fibers import container as tfc
    from skellysim_tpu_torch.guard import verdict

    orig = tfc.fiber_error

    def nan_on_shard_1(g):
        err = orig(g)
        return err * math.nan if int(g.config_rank[0]) >= 8 else err

    built = get_program("step_spmd_d2").build("cpu")
    monkeypatch.setattr(tfc, "fiber_error", nan_on_shard_1)
    _, _, info = built.fn(*built.args)
    assert math.isnan(info.fiber_error)
    assert info.health & verdict.NONFINITE
    reads = {n: load_contract(f"step_spmd_d{n}")[0]["host_sync"]
             for n in (2, 4, 8)}
    assert len({r["read_events"] for r in reads.values()}) == 1
