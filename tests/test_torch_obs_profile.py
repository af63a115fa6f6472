"""The port's device-time attribution against the JAX package's.

The pure parts of `obs.profile` (the phase vocabulary, `phase_of`,
`collective_kind`, `_self_times`, the gap inference, `render_table`,
`profile_json`) equal the JAX package's on the same inputs; the port's
Kineto reader joins device events to their launches' phase scopes by
correlation id and refuses a dump taken on the card without device
events. A confined scene (a few fibers, a small shell, one body) runs two
steps through `System.run(profile_dir=, trace_path=)` on the CPU: its
frames are the unprofiled run's bits, its phases are the JAX package's
names, and its ``device_phase`` records carry the JAX package's keys.
Both run CLIs take ``--profile``; the obs CLI's `summarize`, `flight` and
`timeline` equal the JAX package's on the same files, and its benchmark
subcommands exit 2.
"""

import copy
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from skellysim_tpu.obs import cli as jcli
from skellysim_tpu.obs import profile as jprofile
from skellysim_tpu.obs import timeline as jtimeline
from skellysim_tpu_torch import config as tconfig
from skellysim_tpu_torch.obs import cli as tcli
from skellysim_tpu_torch.obs import profile as tprofile
from skellysim_tpu_torch.obs import timeline as ttimeline
from skellysim_tpu_torch.obs import tracer as ttracer

PROFILE_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden", "profile_fixture")

#: op and scope names of the JAX package's dumps (HLO instructions and
#: named_scope paths)
XLA_NAMES = [
    "jit(step)/jit(main)/prep/dot_general",
    "jit(step)/gmres/jit(gmres)/arnoldi/precond/mul",
    "a/ring-step/ring-step/b", "jit(f)/jit(main)/transpose/mul",
    "jit(step)/gmres/while/body/gram/psum-dots/all-reduce",
    "upward/near/far", "spread/fft/kspace/fft/interp", "collision",
    "dynamic-instability/prep", "", "all-reduce.17", "all-gather",
    "collective-permute.3", "all-reduce-start.5", "all-gather-done.2",
    "all-reduce-fusion", "dot.3", "reduce-scatter-start",
    "collective-broadcast.1", "all-to-all.4", "fusion.12",
]


# ------------------------------------------------------------ pure parts

def test_phase_vocabulary_equals_jax():
    assert tprofile.PHASE_SCOPES == jprofile.PHASE_SCOPES
    assert {k: v for k, v in tprofile.COLLECTIVE_KINDS.items()
            if k in jprofile.COLLECTIVE_KINDS} == jprofile.COLLECTIVE_KINDS


@pytest.mark.parametrize("name", XLA_NAMES)
def test_phase_of_and_collective_kind_equal_jax(name):
    assert tprofile.phase_of(name) == jprofile.phase_of(name)
    assert tprofile.collective_kind(name) == jprofile.collective_kind(name)


@pytest.mark.parametrize("name,kind", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "all_reduce"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)", "all_gather"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
     "collective_permute"),
    ("ncclDevKernel_ReduceScatter_Sum_f64_RING_LL", "reduce_scatter"),
    ("ncclDevKernel_Broadcast_RING_LL", "collective_broadcast"),
    ("void stokeslet_chunk_kernel<float, 8>(float const*)", None),
])
def test_nccl_kernel_names_take_the_contract_kinds(name, kind):
    assert tprofile.collective_kind(name) == kind


def _nested_events():
    """Complete events on two threads: nesting, siblings, a zero-length
    child and a non-"X" event."""
    return [
        {"ph": "X", "ts": 0.0, "dur": 100.0, "pid": 1, "tid": 1, "name": "a"},
        {"ph": "X", "ts": 10.0, "dur": 30.0, "pid": 1, "tid": 1, "name": "b"},
        {"ph": "X", "ts": 15.0, "dur": 5.0, "pid": 1, "tid": 1, "name": "c"},
        {"ph": "X", "ts": 50.0, "dur": 0.0, "pid": 1, "tid": 1, "name": "d"},
        {"ph": "X", "ts": 60.0, "dur": 50.0, "pid": 1, "tid": 1, "name": "e"},
        {"ph": "X", "ts": 5.0, "dur": 20.0, "pid": 1, "tid": 2, "name": "f"},
        {"ph": "i", "ts": 7.0, "pid": 1, "tid": 2, "name": "g"},
        {"ph": "X", "ts": 30.0, "dur": 4.0, "pid": 2, "tid": 2, "name": "h"},
    ]


def test_self_times_equal_jax():
    def shape(out):
        return sorted((ev["name"], s) for ev, s in out)

    assert shape(tprofile._self_times(_nested_events())) == \
        shape(jprofile._self_times(_nested_events()))


def test_gap_inference_equals_jax():
    phases = ["prep", None, "prep", None, None, "gmres/arnoldi", None,
              "advance", None]
    evs = [{"ts": float(i), "dur": 1.0, "phase": p, "inferred": False,
            "pid": 0, "tid": i % 2 if i > 6 else 0}
           for i, p in enumerate(phases)]
    a, b = copy.deepcopy(evs), copy.deepcopy(evs)
    tprofile._infer_gap_phases(a)
    jprofile._infer_gap_phases(b)
    assert a == b
    assert a[1]["phase"] == "prep" and a[1]["inferred"]


@pytest.mark.parametrize("by", ["phase", "collective", "op"])
def test_render_table_and_json_equal_jax(by):
    """The same rows and events give the same text and dicts."""
    j = jprofile.load_device_trace(PROFILE_FIXTURE)
    t = tprofile.DeviceTrace(copy.deepcopy(j.rows), copy.deepcopy(j.events))
    assert tprofile.render_table(t, by=by) == jprofile.render_table(j, by=by)
    assert tprofile.profile_json(t) == jprofile.profile_json(j)


# ------------------------------------------------------ the Kineto reader

def _kineto(tmp_path, events, backend=None, props=()):
    d = tmp_path / "dump"
    d.mkdir()
    (d / "host_1.1.pt.trace.json").write_text(json.dumps(
        {"deviceProperties": list(props), "traceEvents": events}))
    if backend:
        (d / "provenance.json").write_text(json.dumps({"backend": backend}))
    return str(d)


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 7, "tid": 7}


def _launch(corr, ts, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1.0,
            "pid": 7, "tid": 7, "args": {"correlation": corr}}


def _dev(corr, ts, dur, name, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def test_device_events_take_their_launch_scopes(tmp_path):
    """A kernel's phase is the stack of annotations around its launch on
    the host thread (a ``cuda_driver`` launch too), not when it ran;
    ``gpu_user_annotation`` ranges and ``cpu_op`` events are not ops; a
    kernel whose launch is missing is unattributed unless both its
    neighbours agree (then inferred)."""
    a_f32 = "void stokeslet_chunk_kernel<float, 8>(float const*)"
    c_f64 = "void stresslet_chunk_kernel<double, 2>(double const*)"
    events = [
        _ann("run", 0, 1000), _ann("step", 1, 900), _ann("prep", 2, 100),
        _launch(1, 10), _ann("gmres", 200, 600), _ann("arnoldi", 210, 100),
        _ann("precond", 220, 50), _launch(2, 230),
        _launch(3, 300, "cuda_driver", "cuLaunchKernel"),
        _launch(4, 320, name="cudaMemcpyAsync"), _ann("refine", 500, 100),
        _launch(5, 510), _launch(6, 950),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "gmres",
         "ts": 15, "dur": 2000, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 11,
         "dur": 5, "pid": 7, "tid": 7},
        _dev(1, 400, 40, c_f64), _dev(2, 450, 100, a_f32),
        _dev(3, 560, 10, a_f32), _dev(4, 580, 2, "Memcpy DtoH", "gpu_memcpy"),
        _dev(99, 590, 3, "elementwise"), _dev(5, 600, 20, c_f64),
        _dev(6, 1200, 5, "elementwise"),
    ]
    trace = tprofile.load_device_trace(_kineto(tmp_path, events, "cuda"))
    got = {(e["name"], e["ts"]): (e["phase"], e["inferred"])
           for e in trace.events}
    assert got == {
        (c_f64, 400): ("prep", False),
        (a_f32, 450): ("gmres/arnoldi/precond", False),
        (a_f32, 560): ("gmres/arnoldi", False),
        ("Memcpy DtoH", 580): ("gmres", False),
        ("elementwise", 590): (None, False),
        (c_f64, 600): ("gmres/refine", False),
        ("elementwise", 1200): (None, False)}
    ops = {g["key"]: g["count"] for g in trace.by_op()}
    assert ops[f"{a_f32}/kernel"] == 2 and ops["Memcpy DtoH/gpu_memcpy"] == 1
    assert trace.total_us == 180.0


def test_gap_inference_fills_a_lost_launch(tmp_path):
    events = [_ann("gmres", 0, 100), _launch(1, 10), _launch(2, 20),
              _dev(1, 200, 5, "k"), _dev(77, 210, 5, "k"),
              _dev(2, 220, 5, "k")]
    trace = tprofile.load_device_trace(_kineto(tmp_path, events))
    assert trace.attributed_frac == 1.0 and trace.inferred_us == 5.0
    assert "inferred from phase-contiguous neighbors" in \
        tprofile.render_table(trace)


def test_cpu_dump_takes_its_aten_ops_by_self_time(tmp_path):
    events = [_ann("prep", 0, 100),
              {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "ts": 10,
               "dur": 50, "pid": 7, "tid": 7},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 12,
               "dur": 40, "pid": 7, "tid": 7},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 150,
               "dur": 8, "pid": 7, "tid": 7}]
    trace = tprofile.load_device_trace(_kineto(tmp_path, events, "cpu"))
    rows = {(r["module"], r["phase"]): r["dur_us"] for r in trace.rows}
    assert rows == {("aten::matmul", "prep"): 10.0, ("aten::mm", "prep"): 40.0,
                    ("aten::add", None): 8.0}
    assert {r["op"] for r in trace.rows} == {"cpu_op"}


@pytest.mark.parametrize("how", ["provenance", "device_properties"])
def test_card_dump_without_device_events_is_an_error(tmp_path, capsys, how):
    """A dump taken on the card with no device event never reads as a CPU
    run: the parser raises, the run's tracer gets a
    ``device_phase_error`` event, `obs profile` exits 2."""
    events = [_ann("prep", 0, 100),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
               "dur": 5, "pid": 7, "tid": 7}]
    d = (_kineto(tmp_path, events, backend="cuda") if how == "provenance"
         else _kineto(tmp_path, events, props=[{"name": "NVIDIA H100"}]))
    with pytest.raises(ValueError, match="no device event"):
        tprofile.load_device_trace(d)
    tr = ttracer.Tracer()
    assert tprofile.emit_device_phases(d, tr) == 0
    assert [e["ev"] for e in tr.events[1:]] == ["device_phase_error"]
    assert tcli.main(["profile", d]) == 2
    assert "no device event" in capsys.readouterr().err


def test_missing_dump(tmp_path, capsys):
    assert tcli.main(["profile", str(tmp_path / "nope")]) == 2
    tr = ttracer.Tracer()
    assert tprofile.emit_device_phases(str(tmp_path), tr) == 0
    assert tr.events[-1]["ev"] == "device_phase_error"
    capsys.readouterr()


def test_phase_scope_is_a_record_function():
    """`phase` returns a fresh `torch.profiler.record_function` (nothing
    happens without a profiler)."""
    scope = tprofile.phase("gmres")
    assert isinstance(scope, torch.profiler.record_function)
    with scope:
        pass


# ----------------------------------------------------- a profiled System

@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """Two "mixed" steps of a confined scene (4 fibers, an 80-node shell,
    a 50-node body with 2 of them bound) on the CPU, unprofiled and then
    under `System.run(profile_dir=, trace_path=)`, each writing its
    frames."""
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    root = tmp_path_factory.mktemp("profiled")
    p = Params(dt_initial=0.02, dt_write=0.02, t_final=0.04,
               gmres_tol=1e-10, solver_precision="mixed")
    shell, shape, bodies, fibers = make_coupled_scene(
        shell_n=80, body_n=50, n_bound=2, n_free=2, device="cpu",
        precond_dtype=torch.float32)
    system = System(p, shell_shape=shape, device="cpu")
    state = system.make_state(fibers=fibers, shell=shell, bodies=bodies)
    frames = {"plain": [], "profiled": []}
    system.run(state, writer=lambda st, sol, **k: frames["plain"].append(
        (st.fibers.x.clone(), sol.clone())))
    dump, trace = str(root / "dump"), str(root / "trace.jsonl")
    system.run(state, writer=lambda st, sol, **k: frames["profiled"].append(
        (st.fibers.x.clone(), sol.clone())), profile_dir=dump,
        trace_path=trace)
    return {"frames": frames, "dump": dump, "trace": trace, "root": root,
            "dev": tprofile.load_device_trace(dump)}


def test_profiled_frames_are_the_unprofiled_bits(profiled):
    plain, prof = profiled["frames"]["plain"], profiled["frames"]["profiled"]
    assert len(plain) == len(prof) == 2
    for (xa, sa), (xb, sb) in zip(plain, prof):
        assert torch.equal(xa, xb) and torch.equal(sa, sb)


def test_profiled_run_phases_are_jax_names(profiled):
    phases = {g["key"] for g in profiled["dev"].by_phase()}
    assert {"prep", "gmres/arnoldi", "gmres/precond",
            "gmres/arnoldi/precond", "gmres/refine", "advance"} <= phases
    for key in phases - {"(unattributed)"}:
        assert set(key.split("/")) <= tprofile.PHASE_SCOPES, key


def test_profiled_run_attribution(profiled):
    dev = profiled["dev"]
    assert dev.attributed_frac >= 0.9, tprofile.render_table(dev)
    assert sum(g["share"] for g in dev.by_phase()) == pytest.approx(1.0)
    with open(os.path.join(profiled["dump"], "provenance.json")) as fh:
        assert json.load(fh)["backend"] == "cpu"


def test_profiled_run_device_phase_records_have_jax_keys(profiled):
    recs = [json.loads(line) for line in open(profiled["trace"])]
    dp = [r for r in recs if r["ev"] == "device_phase"]
    keys = set(jprofile.device_phase_events(PROFILE_FIXTURE)[0])
    assert dp and all(set(r) - {"ev", "ts", "pid", "host"} == keys
                      for r in dp)
    assert not [r for r in recs if r["ev"] == "device_phase_error"]
    # the run's stream: the header, then its spans, then the phases
    assert recs[-1]["ev"] == "device_phase"


def _stdout(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_summarize_equals_jax(profiled, capsys):
    rc_t, out_t = _stdout(tcli.main, ["summarize", profiled["trace"]], capsys)
    rc_j, out_j = _stdout(jcli.main, ["summarize", profiled["trace"]], capsys)
    assert rc_t == rc_j == 0 and out_t == out_j
    assert "== device time by phase ==" in out_t
    assert "gmres/arnoldi" in out_t


def test_timeline_events_equal_jax_without_a_dump(profiled):
    assert ttimeline.timeline_events(profiled["trace"]) == \
        jtimeline.timeline_events(profiled["trace"])


def test_timeline_with_the_dump(profiled, capsys):
    out = str(profiled["root"] / "tl.json")
    rc, text = _stdout(tcli.main, ["timeline", profiled["trace"],
                                   "--profile", profiled["dump"], "-o", out],
                       capsys)
    assert rc == 0 and "device slices" in text
    doc = json.load(open(out))
    evs = doc["traceEvents"]
    procs = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"host telemetry", "device (profiler)"} <= procs
    host = [e for e in evs if e.get("ph") == "X"
            and e["pid"] == ttimeline.HOST_PID]
    dev = [e for e in evs if e.get("ph") == "X"
           and e["pid"] == ttimeline.DEVICE_PID]
    assert {"run", "step"} <= {e["name"] for e in host} and dev
    threads = {e["args"]["name"] for e in evs if e.get("ph") == "M"
               and e.get("name") == "thread_name"
               and e.get("pid") == ttimeline.DEVICE_PID}
    assert "gmres/arnoldi" in threads
    # the first device op sits at the first step span's start
    first_step = min(e["ts"] for e in host if e["name"] == "step")
    assert min(e["ts"] for e in dev) == pytest.approx(first_step)


# ------------------------------------------------------------- the CLIs

def _scene(**params):
    """One free 8-node fiber in a uniform flow, the flight recorder armed
    (the tracer tests' scene)."""
    cfg = tconfig.Config()
    p = cfg.params
    p.eta, p.dt_initial, p.dt_write, p.t_final = 1.0, 0.005, 0.005, 0.01
    p.gmres_tol, p.adaptive_timestep_flag = 1e-10, False
    p.flight_window = 4
    for k, v in params.items():
        setattr(p, k, v)
    fib = tconfig.Fiber(n_nodes=8, length=1.0, bending_rigidity=0.01)
    fib.fill_node_positions(np.array([0.0, 0.0, 0.0]),
                            np.array([0.0, 0.0, 1.0]))
    cfg.fibers = [fib]
    cfg.background = tconfig.BackgroundSource(uniform=[1.0, 0.0, 0.0])
    return cfg


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """`python -m skellysim_tpu_torch --profile` and the ensemble CLI on
    a 2-member sweep with ``--profile``, each with a trace file."""
    from skellysim_tpu_torch import cli

    root = tmp_path_factory.mktemp("cli")
    _scene().save(str(root / "skelly_config.toml"))
    run = {"dump": str(root / "run_prof"), "trace": str(root / "run.jsonl")}
    cli.main([f"--config-file={root / 'skelly_config.toml'}",
              f"--trace-file={run['trace']}", f"--profile={run['dump']}",
              "--device=cpu", "--log-level=WARNING"])
    (root / "ensemble.toml").write_text(
        '[ensemble]\nbase_config = "skelly_config.toml"\n'
        "replicas = 2\nbatch = 2\n")
    ens = {"dump": str(root / "ens_prof"), "trace": str(root / "ens.jsonl")}
    argv = sys.argv
    sys.argv = ["skellysim_tpu_torch.ensemble",
                f"--sweep-file={root / 'ensemble.toml'}",
                f"--output-dir={root / 'out'}", f"--trace-file={ens['trace']}",
                f"--profile={ens['dump']}", "--device=cpu",
                "--log-level=WARNING"]
    try:
        runpy.run_module("skellysim_tpu_torch.ensemble", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = argv
    return {"run": run, "ensemble": ens, "root": root}


@pytest.mark.parametrize("which", ["run", "ensemble"])
def test_cli_profile_dump_parses(cli_runs, capsys, which):
    """The dump parses into the JAX package's phase names; the ops outside
    every phase (the flight rows, the frame writes, the scheduler's
    bookkeeping: a large share of so small a scene) stay in view as
    ``(unattributed)``."""
    d = cli_runs[which]
    rc, out = _stdout(tcli.main, ["profile", d["dump"], "--json"], capsys)
    doc = json.loads(out)
    assert rc == 0 and doc["total_us"] > 0
    keys = {g["key"] for g in doc["by_phase"]}
    assert {"prep", "gmres/arnoldi", "gmres/precond", "advance",
            "(unattributed)"} <= keys
    assert doc["attributed_frac"] == pytest.approx(
        1.0 - next(g["share"] for g in doc["by_phase"]
                   if g["key"] == "(unattributed)"), abs=1e-4)
    for by in ("phase", "collective", "op"):
        rc, out = _stdout(tcli.main, ["profile", d["dump"], "--by", by],
                          capsys)
        assert rc == 0 and "attributed to named phases" in out
    recs = [json.loads(line) for line in open(d["trace"])]
    assert any(r["ev"] == "device_phase" for r in recs)


def test_cli_timeline_loads_with_host_and_device_tracks(cli_runs, capsys):
    d = cli_runs["ensemble"]
    out = str(cli_runs["root"] / "ens_tl.json")
    rc, _ = _stdout(tcli.main, ["timeline", d["trace"], "--profile",
                                d["dump"], "-o", out], capsys)
    assert rc == 0
    evs = json.load(open(out))["traceEvents"]
    pids = {e["pid"] for e in evs if e.get("ph") == "X"}
    assert {ttimeline.HOST_PID, ttimeline.DEVICE_PID} <= pids
    rc, _ = _stdout(tcli.main, ["timeline", str(cli_runs["root"] / "no"),
                                "-o", out], capsys)
    assert rc == 2


@pytest.mark.parametrize("which", ["run", "ensemble"])
def test_timeline_events_equal_jax_on_cli_traces(cli_runs, which):
    path = cli_runs[which]["trace"]
    assert ttimeline.timeline_events(path) == \
        jtimeline.timeline_events(path)


def test_flight_report_equals_jax(cli_runs, capsys):
    """The run's flight rows plus a failed ensemble record with its tail
    and provenance."""
    recs = [json.loads(line) for line in open(cli_runs["run"]["trace"])]
    rows = [r for r in recs if r["ev"] == "flight"]
    assert rows
    failed = cli_runs["root"] / "failed.jsonl"
    tail = [{k: v for k, v in r.items() if k not in ("ev", "ts", "pid",
                                                     "host")}
            for r in rows]
    failed.write_text(json.dumps({
        "member": "m00001", "event": "failed", "verdict": ["nonfinite"],
        "health": 1, "flight": {"tail": tail, "provenance": {
            "field": "fibers.x", "fiber": 0, "node": 3}}}) + "\n"
        + '{"torn": \n')
    files = [cli_runs["run"]["trace"], str(failed)]
    rc_t, out_t = _stdout(tcli.main, ["flight", *files], capsys)
    rc_j, out_j = _stdout(jcli.main, ["flight", *files], capsys)
    assert rc_t == rc_j == 0 and out_t == out_j
    assert "FAULT" in out_t and "field=fibers.x" in out_t
    rc_t, _ = _stdout(tcli.main, ["flight", "nope.jsonl"], capsys)
    assert rc_t == 2


@pytest.mark.parametrize("argv", [
    ["cost", "--check", "--update"], ["roofline", "DIR", "--json"],
    ["perf", "--compare", "benchmarks"], ["campaign", "CAMPAIGN_r01.json"]])
def test_xla_and_benchmark_subcommands_exit_2(argv, capsys):
    """The benchmark's subcommands exit 2 naming the item that brings
    them; ``cost`` and ``roofline`` (ported since) exit 2 on a usage
    error or a missing dump, as the JAX package's do."""
    assert tcli.main(argv) == 2
    err = capsys.readouterr().err
    if argv[0] in ("perf", "campaign"):
        assert "ROADMAP.md §1 item 14" in err
    elif argv[0] == "cost":
        assert "mutually exclusive" in err
    else:
        assert "no *.pt.trace.json" in err
