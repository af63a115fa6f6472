"""The port's telemetry tracer, histograms and report against the JAX
package's.

The event kinds and span names of a `System.run` (``step`` /
``write_frame`` / ``run`` spans, ``flight`` rows), in order and with their
fields but without the clocks (``ts``, ``dur_s``, ``pid``, ``host``,
``queue_wait_s``, walls), equal the JAX package's; the JAX package's
``compile`` events (its XLA compiles) are left out, the port's being CUDA
libraries that the CPU never loads. (An ensemble round's events, through
the service, are held against the JAX server's in
`tests/test_torch_serve.py`.)
`LogHistogram`'s edges and percentiles and `render_prometheus`'s text
equal the JAX package's on the same inputs; `obs.summarize` renders a
stream as the JAX summarize does; with no tracer active nothing is
emitted and a span is inert; both CLIs' ``--trace-file`` write a stream
that `obs.summarize` renders, and ``--profile`` (refused until the
profiler session was ported) writes a dump `obs.profile` parses.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest

from skellysim_tpu import config as jconfig
from skellysim_tpu.builder import build_simulation as jbuild
from skellysim_tpu.obs import hist as jhist
from skellysim_tpu.obs import summarize as jsummarize
from skellysim_tpu.obs import tracer as jtracer
from skellysim_tpu.serve import protocol as jprotocol
from skellysim_tpu_torch import config as tconfig
from skellysim_tpu_torch.builder import build_simulation as tbuild
from skellysim_tpu_torch.ensemble import EnsembleRunner as TRunner
from skellysim_tpu_torch.ensemble import EnsembleScheduler as TScheduler
from skellysim_tpu_torch.ensemble import MemberSpec as TMember
from skellysim_tpu_torch.obs import hist as thist
from skellysim_tpu_torch.obs import summarize as tsummarize
from skellysim_tpu_torch.obs import tracer as ttracer
from skellysim_tpu_torch.serve import metrics as tmetrics
from skellysim_tpu_torch.serve import protocol as tprotocol

#: fields that carry clocks, process identity or backend provenance
CLOCKS = {"ts", "dur_s", "pid", "host", "queue_wait_s", "wall_s",
          "wall_ms", "jax_version", "torch_version", "cuda_version",
          "device_kind"}


def _scene(mod, shift=0.0, **params):
    """The JAX serve tests' tenant scene (`tests/test_serve.py`) in either
    package's schema, with the flight recorder armed."""
    cfg = mod.Config()
    p = cfg.params
    p.eta, p.dt_initial, p.dt_write, p.t_final = 1.0, 0.005, 0.005, 0.02
    p.gmres_tol, p.adaptive_timestep_flag = 1e-10, False
    p.flight_window = 4
    for k, v in params.items():
        setattr(p, k, v)
    fib = mod.Fiber(n_nodes=8, length=1.0, bending_rigidity=0.01)
    fib.fill_node_positions(np.array([shift, 0.0, 0.0]),
                            np.array([0.0, 0.0, 1.0]))
    cfg.fibers = [fib]
    cfg.background = mod.BackgroundSource(uniform=[1.0, 0.0, 0.0])
    return cfg


def _shape(events):
    """Events without clocks and without the JAX package's compiles; the
    floats of flight rows and span notes rounded to their physics (the
    two packages agree to ~1e-12 there, not bit for bit)."""
    out = []
    for e in events:
        if e["ev"] == "compile":
            continue
        rec = {}
        for k, v in e.items():
            if k in CLOCKS:
                continue
            if isinstance(v, float):
                v = float(f"{v:.6g}") if abs(v) > 1e-9 else 0.0
            rec[k] = v
        out.append(rec)
    return out


def _run_events(mod, build, tracer_mod, **build_kw):
    system, state, _ = build(_scene(mod, **build_kw.pop("params", {})),
                             **build_kw)
    tr = tracer_mod.Tracer()
    with tracer_mod.use(tr):
        system.run(state, writer=lambda *a, **k: None)
    return tr.events


def test_run_events_match_jax():
    """Kinds, span names and paths, step numbers, flight rows of a
    `System.run` in the JAX package's order."""
    j = _run_events(jconfig, jbuild, jtracer)
    t = _run_events(tconfig, tbuild, ttracer, device="cpu")
    assert [e["ev"] for e in j if e["ev"] != "compile"] == \
        [e["ev"] for e in t]
    assert [(e.get("name"), e.get("path")) for e in j if e["ev"] == "span"] \
        == [(e.get("name"), e.get("path")) for e in t if e["ev"] == "span"]
    js, ts = _shape(j), _shape(t)
    for a, b in zip(js, ts):
        assert set(a) == set(b), (a, b)
        if a["ev"] in ("span", "flight"):
            keep = {k: v for k, v in a.items()
                    if k not in ("residual", "residual_true", "max_strain")}
            assert keep == {k: b[k] for k in keep}, (a, b)


def _drain_events(members, runner_cls, sched_cls, member_cls, tracer_mod,
                  system):
    tr = tracer_mod.Tracer()
    with tracer_mod.use(tr):
        sched = sched_cls(runner_cls(system, batch_impl="unroll"), [], 2,
                          template=members[0][1])
        for mid, state in members:
            sched.admit(member_cls(member_id=mid, state=state,
                                   t_final=0.01))
        sched.run()
    return tr.events


@pytest.mark.parametrize("lo,hi,per_decade", [(1e-4, 1e3, 8),
                                              (1e-6, 1e2, 8),
                                              (1e-3, 10.0, 5)])
def test_histogram_edges_and_percentiles_match_jax(lo, hi, per_decade):
    rng = np.random.default_rng(3)
    samples = np.concatenate([10.0 ** rng.uniform(-7, 4, 500),
                              [0.0, lo, hi, np.inf, np.nan, -1.0]])
    jh = jhist.LogHistogram(lo, hi, per_decade)
    th = thist.LogHistogram(lo, hi, per_decade)
    assert th.edges == jh.edges
    for v in samples:
        jh.observe(v)
        th.observe(v)
    assert th.counts == jh.counts
    for q in (0.0, 1.0, 50.0, 95.0, 99.0, 100.0):
        assert th.percentile(q) == jh.percentile(q)
    assert th.to_wire() == jh.to_wire()
    assert thist.render_prometheus_histogram("x", th.to_wire(), "h") == \
        jhist.render_prometheus_histogram("x", jh.to_wire(), "h")


def test_prometheus_text_matches_jax():
    """The same stats dict renders to the same Prometheus page."""
    m = tmetrics.ServeMetrics()
    for i in range(5):
        m.observe("lane", {"action": "admit", "queue_wait_s": 0.01 * i})
        m.observe("span", {"name": "ensemble_step", "dur_s": 0.2 + i,
                           "live": 2, "lanes": 4})
        m.observe("span", {"name": "stream_frames", "dur_s": 1e-4,
                           "frames": 2, "tenant": f"t{i}"})
    m.observe("lane", {"action": "retire", "reason": "failed"})
    m.observe("fault", {"kind": "lane_failed", "prov_field": "fiber_x"})
    m.note_rejected()
    stats = dict(m.stats(), tenants=5)
    assert tprotocol.render_prometheus(stats) == \
        jprotocol.render_prometheus(stats)


def test_summarize_renders_like_jax():
    """A port stream (a run and a drain) renders to the JAX summarize's
    text, with the lanes table and the admission wait."""
    events = _run_events(tconfig, tbuild, ttracer, device="cpu")
    tsys, state, _ = tbuild(_scene(tconfig), device="cpu")
    events += _drain_events([("a", state), ("b", state), ("c", state)],
                            TRunner, TScheduler, TMember, ttracer, tsys)
    ts, js = tsummarize.Summary(), jsummarize.Summary()
    for e in events:
        ts.add_line(json.dumps(e))
        js.add_line(json.dumps(e))
    report = ts.render()
    assert report == js.render()
    assert "ensemble lanes" in report and "admission wait:" in report


def test_inactive_tracer_emits_nothing(monkeypatch):
    """With no tracer installed a run emits no event and its spans are
    the inert span (which ignores tensors registered to sync)."""
    import torch

    calls = []
    monkeypatch.setattr(ttracer.Tracer, "emit",
                        lambda self, ev, **f: calls.append(ev))
    assert ttracer.active() is None
    system, state, _ = tbuild(_scene(tconfig), device="cpu")
    system.run(state, writer=lambda *a, **k: None)
    with ttracer.span("x") as sp:
        sp.sync(torch.zeros(2))
        sp.note(a=1)
    ttracer.emit("lane", action="admit")
    assert calls == []


def test_span_syncs_only_its_tensors_while_active(monkeypatch):
    """An active span synchronizes the cards of the tensors registered
    with ``sync`` (CPU tensors: none) and reports its fields."""
    import torch

    synced = []
    monkeypatch.setattr(ttracer, "_sync_devices", synced.append)
    tr = ttracer.Tracer()
    t = torch.ones(3)
    with ttracer.use(tr):
        with ttracer.span("outer", a=1):
            with ttracer.span("inner") as sp:
                assert sp.sync(t) is t
                sp.note(b=2)
    spans = [e for e in tr.events if e["ev"] == "span"]
    assert [(e["name"], e["path"]) for e in spans] == \
        [("inner", "outer/inner"), ("outer", "outer")]
    assert spans[0]["b"] == 2 and spans[1]["a"] == 1
    assert synced == [t]


def _render(path):
    s = tsummarize.Summary()
    s.add_file(str(path))
    return s.render()


def test_run_cli_trace_file_and_profile_refusal(tmp_path):
    """`python -m skellysim_tpu_torch --trace-file` writes a stream that
    summarize renders; ``--profile`` is no longer refused: it writes a
    dump that `obs.profile` parses."""
    from skellysim_tpu_torch.obs import profile as tprofile
    from skellysim_tpu_torch import cli

    cfg_path = tmp_path / "skelly_config.toml"
    _scene(tconfig).save(str(cfg_path))
    trace = tmp_path / "trace.jsonl"
    cli.main([f"--config-file={cfg_path}", f"--trace-file={trace}",
              "--device=cpu", "--log-level=WARNING"])
    events = [json.loads(line) for line in open(trace)]
    assert events[0]["ev"] == "telemetry"
    assert [e["name"] for e in events if e["ev"] == "span"].count(
        "step") == 4
    report = _render(trace)
    assert "== spans ==" in report and "run/step" in report
    prof = tmp_path / "prof"
    cli.main([f"--config-file={cfg_path}", f"--profile={prof}",
              "--device=cpu", "--overwrite", "--log-level=WARNING"])
    assert tprofile.load_device_trace(str(prof)).total_us > 0


def test_ensemble_cli_trace_file_and_profile_refusal(tmp_path):
    """`python -m skellysim_tpu_torch.ensemble --trace-file` writes the
    drain's lane events and rounds; ``--profile`` is no longer refused:
    it writes a dump that `obs.profile` parses."""
    from skellysim_tpu_torch.obs import profile as tprofile
    _scene(tconfig).save(str(tmp_path / "skelly_config.toml"))
    sweep = tmp_path / "ensemble.toml"
    sweep.write_text('[ensemble]\nbase_config = "skelly_config.toml"\n'
                     "replicas = 3\nbatch = 2\n")
    trace = tmp_path / "trace.jsonl"
    argv = sys.argv
    sys.argv = ["skellysim_tpu_torch.ensemble", f"--sweep-file={sweep}",
                f"--trace-file={trace}", "--device=cpu",
                "--log-level=WARNING"]
    try:
        runpy.run_module("skellysim_tpu_torch.ensemble",
                         run_name="__main__", alter_sys=True)
        sys.argv[1:] = [f"--sweep-file={sweep}",
                        f"--output-dir={tmp_path / 'prof_out'}",
                        f"--profile={tmp_path / 'prof'}", "--device=cpu",
                        "--log-level=WARNING"]
        runpy.run_module("skellysim_tpu_torch.ensemble",
                         run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    events = [json.loads(line) for line in open(trace)]
    actions = [e["action"] for e in events if e["ev"] == "lane"]
    assert actions.count("admit") == 2 and actions.count("backfill") == 1
    assert actions.count("retire") == 3
    report = _render(trace)
    assert "ensemble lanes" in report and "admission wait:" in report
    assert os.path.exists(tmp_path / "ensemble_metrics.jsonl")
    assert tprofile.load_device_trace(str(tmp_path / "prof")).total_us > 0
