"""The port's roofline join (`obs roofline`) against the JAX package's.

The oracle cases of ``tests/test_roofline.py`` run on a hand-built Kineto
dump whose per-phase device walls are the JAX fixture's
(``tests/golden/profile_fixture``), so the same hand-derived values hold:
the compute-bound and memory-bound joins, the unknown kind, no cost table,
the sidecar and the program-baseline joins, the CLI's exit codes. The
port's `analyze`, `peaks_for_kind` and `render_roofline` equal the JAX
package's on the same trace, cost and peak inputs, exactly. "NVIDIA H100
80GB HBM3" rates as the table's "H100" row, and the device lanes are
counted from the dump's device events, not from every pid.
"""

import json
import os

import pytest

from skellysim_tpu.obs import profile as jprofile
from skellysim_tpu.obs import roofline as jroofline
from skellysim_tpu_torch.config import toml_io
from skellysim_tpu_torch.obs import cost, roofline
from skellysim_tpu_torch.obs.cli import main as obs_main
from skellysim_tpu_torch.obs.profile import DeviceTrace, load_device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURE = os.path.join(REPO, "tests", "golden", "profile_fixture")
SIDECAR = os.path.join(JAX_FIXTURE, "cost_sidecar.toml")

# the JAX fixture's per-phase rollup (tests/test_roofline.py), rebuilt
# below as a Kineto dump
PHASE_WALL_US = {
    "gmres/psum-dots": 371.292,
    "gmres/arnoldi": 150.438,
    "prep": 32.222,
    "(unattributed)": 22.216,
    "advance": 3.313,
}
PSUM_COMM_US = 313.476           # all_reduce dur inside gmres/psum-dots
PSUM_COMM_COUNT = 4
TOTAL_US = sum(PHASE_WALL_US.values())                       # 579.481
TOTAL_COMPUTE_US = TOTAL_US - PSUM_COMM_US                   # 266.005

# the sidecar's hand-sized table
FLOPS, BYTES, COMM_MAX_BYTES = 2.0e9, 1.0e9, 4096.0
# synthetic peaks chosen so ridge == 1.0 < AI == 2.0 (compute-bound)
PEAKS = {"peak_flops": 1e13, "hbm_gbps": 1e4, "ici_gbps": 1.0}

ALLREDUCE = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)"


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 7, "tid": 7}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1.0, "pid": 7, "tid": 7,
            "args": {"correlation": corr}}


def _dev(corr, ts, dur, name="k", pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": 7, "args": {"correlation": corr}}


def _write_dump(path, events, kind=None):
    os.makedirs(path)
    with open(os.path.join(path, "host_1.1.pt.trace.json"), "w") as fh:
        json.dump({"traceEvents": events}, fh)
    with open(os.path.join(path, "provenance.json"), "w") as fh:
        json.dump({"backend": "cuda", "device_kind": kind}, fh)
    return str(path)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The JAX fixture's phase walls as a card's Kineto dump: prep, two
    Arnoldi kernels, the psum phase's compute and four all-reduces,
    advance, and a last kernel whose launch was lost (unattributed: no
    neighbour after it)."""
    share = PSUM_COMM_US / PSUM_COMM_COUNT
    events = [
        _ann("prep", 0, 100), _launch(1, 10),
        _ann("gmres", 200, 600), _ann("arnoldi", 210, 190),
        _launch(2, 220), _launch(3, 230),
        _ann("psum-dots", 500, 200), _launch(4, 510),
        *[_launch(5 + i, 520 + i) for i in range(PSUM_COMM_COUNT)],
        _ann("advance", 900, 50), _launch(9, 910),
        _dev(1, 1000, 32.222), _dev(2, 1100, 100.0),
        _dev(3, 1200, 50.438), _dev(4, 1300, 371.292 - PSUM_COMM_US),
        *[_dev(5 + i, 1400 + 100 * i, share, ALLREDUCE)
          for i in range(PSUM_COMM_COUNT)],
        _dev(9, 1800, 3.313), _dev(99, 1900, 22.216),
    ]
    return _write_dump(tmp_path_factory.mktemp("roof") / "dump", events,
                       "NVIDIA H100 80GB HBM3")


def test_dump_rebuilds_the_jax_fixtures_walls(dump):
    trace = load_device_trace(dump)
    walls = {g["key"]: g["dur_us"] for g in trace.by_phase()}
    assert walls == pytest.approx(PHASE_WALL_US, abs=1e-3)
    jtrace = jprofile.load_device_trace(JAX_FIXTURE)
    assert {g["key"]: g["dur_us"] for g in jtrace.by_phase()} == \
        pytest.approx(walls, abs=1e-3)


# --------------------------------------------------------- rating table

def test_device_peaks_table_rows_complete():
    table = roofline.load_device_peaks()
    assert set(table) == {"H100", "cpu"}   # no TPU row in the port
    for key, row in table.items():
        for k in roofline.PEAK_KEYS:
            assert k in row and float(row[k]) > 0, (key, k)
    assert table["H100"] == {"peak_flops": 67e12, "hbm_gbps": 3350.0,
                             "ici_gbps": 900.0}


def test_h100_name_rates_as_h100():
    key, peaks = roofline.peaks_for_kind("NVIDIA H100 80GB HBM3")
    assert key == "H100" and peaks["peak_flops"] == 67e12
    assert roofline.peaks_for_kind("QPU v99") == (None, None)
    assert roofline.peaks_for_kind(None) == (None, None)
    assert roofline.peaks_for_kind("") == (None, None)


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H100 NVL", "h100 pcie", "TPU v5p-8",
    "TPU v5 lite", "cpu", "QPU v99", None, "", "H10"])
def test_peaks_for_kind_longest_substring_equals_jax(kind):
    table = {"H100": {"peak_flops": 1.0, "hbm_gbps": 1.0, "ici_gbps": 1.0},
             "H100 NVL": {"peak_flops": 2.0, "hbm_gbps": 2.0,
                          "ici_gbps": 2.0},
             "TPU v5": {"peak_flops": 3.0, "hbm_gbps": 3.0, "ici_gbps": 3.0},
             "TPU v5p": {"peak_flops": 4.0, "hbm_gbps": 4.0,
                         "ici_gbps": 4.0},
             "cpu": {"peak_flops": 5.0}}   # malformed: unrated
    got = roofline.peaks_for_kind(kind, table)
    assert got == jroofline.peaks_for_kind(kind, table)
    if kind == "NVIDIA H100 NVL":
        assert got[0] == "H100 NVL"      # not the shorter "H100" row


# -------------------------------------------------------- oracle: analyze

def test_analyze_matches_hand_computed_oracle(dump):
    trace = load_device_trace(dump)
    doc = roofline.analyze(
        trace, cost={"flops": FLOPS, "bytes_accessed": BYTES,
                     "peak_bytes": 123456},
        collective_bytes={"all_reduce": COMM_MAX_BYTES},
        peaks=PEAKS, executions=1)

    assert doc["n_devices"] == 1
    assert doc["ai"] == pytest.approx(2.0)
    assert doc["ridge_flops_per_byte"] == pytest.approx(1.0)
    assert doc["total_us"] == pytest.approx(TOTAL_US, abs=1e-3)
    assert doc["peak_memory_bytes"] == 123456
    by = {p["phase"]: p for p in doc["phases"]}
    assert set(by) == set(PHASE_WALL_US)

    psum = by["gmres/psum-dots"]
    assert psum["comm_frac"] == pytest.approx(
        PSUM_COMM_US / PHASE_WALL_US["gmres/psum-dots"], abs=1e-4)
    assert psum["verdict"] == "comms-bound"
    assert psum["comm_bytes"] == pytest.approx(
        PSUM_COMM_COUNT * COMM_MAX_BYTES)
    ici_bps = PSUM_COMM_COUNT * COMM_MAX_BYTES / (PSUM_COMM_US * 1e-6)
    assert psum["ici_bytes_per_s"] == pytest.approx(ici_bps, rel=1e-4)
    assert psum["achieved_vs_peak"] == pytest.approx(
        ici_bps / (PEAKS["ici_gbps"] * 1e9), rel=1e-3)

    arnoldi = by["gmres/arnoldi"]
    frac = PHASE_WALL_US["gmres/arnoldi"] / TOTAL_COMPUTE_US
    assert arnoldi["verdict"] == "compute-bound"
    assert arnoldi["flops"] == pytest.approx(FLOPS * frac, rel=1e-4)
    achieved = FLOPS / (TOTAL_COMPUTE_US * 1e-6)
    assert arnoldi["achieved_flops_per_s"] == pytest.approx(achieved,
                                                            rel=1e-4)
    assert arnoldi["achieved_vs_peak"] == pytest.approx(
        achieved / PEAKS["peak_flops"], rel=1e-3)

    assert doc["classified_frac"] == pytest.approx(
        (TOTAL_US - PHASE_WALL_US["(unattributed)"]) / TOTAL_US, abs=1e-4)
    assert doc["classified_frac"] == pytest.approx(doc["attributed_frac"],
                                                   abs=1e-4)
    assert doc["totals"]["mfu"] == pytest.approx(
        FLOPS / (TOTAL_US * 1e-6) / PEAKS["peak_flops"], rel=1e-3)


def test_analyze_memory_bound_when_ai_below_ridge(dump):
    # the H100 row: ridge 67e12 / 3.35e12 = 20 > AI 2.0
    trace = load_device_trace(dump)
    _, peaks = roofline.peaks_for_kind("NVIDIA H100 80GB HBM3")
    doc = roofline.analyze(
        trace, cost={"flops": FLOPS, "bytes_accessed": BYTES},
        collective_bytes={"all_reduce": COMM_MAX_BYTES}, peaks=peaks)
    assert doc["ridge_flops_per_byte"] == pytest.approx(20.0, rel=1e-3)
    by = {p["phase"]: p for p in doc["phases"]}
    assert by["gmres/arnoldi"]["verdict"] == "memory-bound"
    achieved_bps = BYTES / (TOTAL_COMPUTE_US * 1e-6)
    assert by["gmres/arnoldi"]["achieved_vs_peak"] == pytest.approx(
        achieved_bps / (3350.0 * 1e9), rel=1e-3)
    assert by["gmres/psum-dots"]["verdict"] == "comms-bound"


def test_analyze_unknown_device_kind_degrades_not_crashes(dump):
    trace = load_device_trace(dump)
    doc = roofline.analyze(
        trace, cost={"flops": FLOPS, "bytes_accessed": BYTES},
        collective_bytes={}, peaks=None)
    by = {p["phase"]: p for p in doc["phases"]}
    assert by["gmres/psum-dots"]["verdict"] == "comms-bound"
    for name in ("gmres/arnoldi", "prep", "advance"):
        assert by[name]["verdict"] == "unrated"
    assert all(p["achieved_vs_peak"] is None for p in doc["phases"])
    assert doc["classified_frac"] == 0.0
    assert doc["ridge_flops_per_byte"] is None


def test_analyze_without_cost_table_keeps_measured_facts(dump):
    trace = load_device_trace(dump)
    doc = roofline.analyze(trace, cost=None,
                           collective_bytes={"all_reduce": COMM_MAX_BYTES},
                           peaks=PEAKS)
    by = {p["phase"]: p for p in doc["phases"]}
    assert by["gmres/psum-dots"]["verdict"] == "comms-bound"
    assert by["gmres/psum-dots"]["ici_bytes_per_s"] is not None
    assert by["gmres/arnoldi"]["verdict"] == "unrated"
    assert doc["ai"] is None and doc["totals"]["mfu"] is None


# ------------------------------------------------ parity with the JAX join

_COSTS = {
    "sidecar": ({"flops": FLOPS, "bytes_accessed": BYTES,
                 "peak_bytes": 123456}, {"all_reduce": COMM_MAX_BYTES}),
    "no_pins": ({"flops": 3.3e11, "bytes_accessed": 1.7e9}, {}),
    "none": (None, {"all_reduce": COMM_MAX_BYTES}),
}
_PEAKS = {"synthetic": PEAKS, "none": None,
          "h100": {"peak_flops": 67e12, "hbm_gbps": 3350.0,
                   "ici_gbps": 900.0}}


@pytest.mark.parametrize("peaks", sorted(_PEAKS))
@pytest.mark.parametrize("costs", sorted(_COSTS))
def test_analyze_and_render_equal_jax(dump, costs, peaks):
    """On the same trace, cost, pins and peaks: the same document and the
    same text, exactly (the port's dump and the JAX fixture)."""
    c, coll = _COSTS[costs]
    p = _PEAKS[peaks]
    for trace in (load_device_trace(dump),
                  jprofile.load_device_trace(JAX_FIXTURE)):
        for executions in (1, 3):
            got = roofline.analyze(trace, cost=c, collective_bytes=coll,
                                   peaks=p, executions=executions,
                                   n_devices=1)
            want = jroofline.analyze(trace, cost=c, collective_bytes=coll,
                                     peaks=p, executions=executions,
                                     n_devices=1)
            assert got == want
            doc = dict(got, device_kind="NVIDIA H100 80GB HBM3",
                       rated_as="H100" if p else None)
            assert roofline.render_roofline(doc) == \
                jroofline.render_roofline(doc)


def test_n_devices_counts_device_lanes_not_pids(tmp_path):
    """A Kineto dump's host ops and the card's events carry different
    pids: the lanes are the device events' pids (kernels, memcpys,
    memsets), where the JAX package's count of every pid reads 2 on one
    card."""
    trace = DeviceTrace([], [
        {"op": "kernel", "pid": 0}, {"op": "gpu_memcpy", "pid": 0},
        {"op": "gpu_memset", "pid": 0}, {"op": "cpu_op", "pid": 4321}])
    assert roofline.device_lanes(trace) == 1
    assert len({e["pid"] for e in trace.events}) == 2   # JAX's default
    events = [_ann("gmres", 0, 100), _launch(1, 10), _launch(2, 20),
              _launch(3, 30), _dev(1, 200, 5.0, pid=0),
              _dev(2, 210, 5.0, pid=1),
              _dev(3, 220, 1.0, "Memcpy HtoD", pid=1, cat="gpu_memcpy")]
    two = load_device_trace(_write_dump(tmp_path / "two", events))
    assert roofline.device_lanes(two) == 2
    doc = roofline.analyze(two, cost={"flops": 1e6, "bytes_accessed": 1e3},
                           peaks=PEAKS)
    assert doc["n_devices"] == 2
    # a CPU dump (aten ops only) is one lane
    cpu = DeviceTrace([], [{"op": "cpu_op", "pid": 7, "tid": 7},
                           {"op": "cpu_op", "pid": 7, "tid": 8}])
    assert roofline.device_lanes(cpu) == 1


# -------------------------------------------------- report + CLI contract

def test_roofline_report_sidecar_join_and_rating(dump):
    doc = roofline.roofline_report(dump, cost_table=SIDECAR)
    assert doc["device_kind"] == "NVIDIA H100 80GB HBM3"   # provenance
    assert doc["rated_as"] == "H100"
    assert doc["ai"] == pytest.approx(2.0)
    by = {p["phase"]: p for p in doc["phases"]}
    assert by["gmres/psum-dots"]["comm_bytes"] == pytest.approx(
        PSUM_COMM_COUNT * COMM_MAX_BYTES)
    assert not by["gmres/psum-dots"]["unsized_collectives"]
    text = roofline.render_roofline(doc)
    assert "rated as 'H100'" in text and "comms-bound" in text

    unknown = roofline.roofline_report(dump, cost_table=SIDECAR,
                                       device_kind="QPU v99")
    assert unknown["rated_as"] is None
    assert {p["verdict"] for p in unknown["phases"]} <= {"unrated",
                                                         "comms-bound"}
    assert "UNRATED" in roofline.render_roofline(unknown)


def test_roofline_report_program_baseline_join(dump):
    """The checked-in step_spmd_d2 baseline joins without a sidecar:
    flops and bytes from its [cost], the all-reduce bytes from its
    [collectives] pin."""
    base = toml_io.load(cost.baseline_path("step_spmd_d2"))
    doc = roofline.roofline_report(dump, program="step_spmd_d2",
                                   device_kind="cpu")
    assert doc["rated_as"] == "cpu"
    assert doc["ai"] == pytest.approx(base["cost"]["flops"]
                                      / base["cost"]["bytes_accessed"],
                                      abs=1e-4)
    by = {p["phase"]: p for p in doc["phases"]}
    coll = by["gmres/psum-dots"]["collectives"]["all_reduce"]
    assert coll["bytes"] == pytest.approx(
        PSUM_COMM_COUNT * base["collectives"]["all_reduce"]["max_bytes"])
    with pytest.raises(KeyError):
        roofline.roofline_report(dump, program="no_such_program")


def test_roofline_cli_exit_codes(dump, tmp_path, capsys):
    assert obs_main(["roofline", str(tmp_path / "nope")]) == 2
    capsys.readouterr()
    assert obs_main(["roofline", dump, "--program", "no_such_program"]) == 2
    assert "no cost baseline" in capsys.readouterr().err
    rc = obs_main(["roofline", dump, "--cost-table", SIDECAR, "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    doc = json.loads(out)
    assert doc["rated_as"] == "H100"
    assert doc["phases"] and doc["classified_frac"] > 0.9
    assert obs_main(["roofline", dump, "--cost-table", SIDECAR,
                     "--executions", "2", "--n-devices", "1"]) == 0
    assert "window MFU" in capsys.readouterr().out
    # a card's dump with no device event is a usage error, not "0 ops"
    empty = _write_dump(tmp_path / "empty", [_ann("prep", 0, 10)])
    assert obs_main(["roofline", empty, "--cost-table", SIDECAR]) == 2
