"""One merged Chrome-trace/Perfetto timeline from telemetry (+ profiler)
streams.

Counterpart of `skellysim_tpu.obs.timeline`. ``python -m
skellysim_tpu_torch.obs timeline TRACE.jsonl [--profile DIR] -o
out.perfetto.json`` renders a single artifact that chrome://tracing and
ui.perfetto.dev load directly, with three track families:

* **host** — every tracer span as a complete ("X") slice (the span event
  is emitted at scope EXIT carrying ``dur_s``, so the slice starts at
  ``ts - dur_s``), one process per telemetry source pid, one thread per
  source pid/stream; `lane`/`fault`/`resume` records as instants;
* **compile** — ``compile`` events (a CUDA library built or loaded,
  `ops.cuda_build.load`) as instants on a dedicated thread;
* **device** — when a ``--profile`` dump dir rides along, the per-op
  device events from `obs.profile.load_device_trace`, one thread per
  attributed PHASE (the phase-scope vocabulary), so the device track
  reads as a phase Gantt chart.

Clock caveat: host telemetry timestamps are `time.perf_counter` while the
profiler's are its own tracing clock — the two are rebased so the first
device op aligns with the start of the host stream's first ``step`` span
(falling back to the stream origin). Cross-track alignment is therefore
approximate; durations and within-track ordering are exact.

json only, like every obs parser: it touches neither torch nor the card.
"""

from __future__ import annotations

import json
import math

from . import profile as profile_mod

#: synthetic pids of the merged timeline's process tracks
HOST_PID = 1
DEVICE_PID = 100
#: host-track tid of the compile/instant lane
COMPILE_TID = 9999


def _load_jsonl(path: str) -> list:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def timeline_events(trace_paths, profile_dir=None) -> list:
    """The merged ``traceEvents`` list (Chrome trace-event JSON array
    form). ``trace_paths`` is one path or a list of telemetry JSONL
    paths; ``profile_dir`` optionally adds the device track."""
    if isinstance(trace_paths, str):
        trace_paths = [trace_paths]
    events: list = [{"ph": "M", "pid": HOST_PID, "name": "process_name",
                     "args": {"name": "host telemetry"}},
                    {"ph": "M", "pid": HOST_PID, "name":
                     "process_sort_index", "args": {"sort_index": 0}}]

    recs: list = []
    for i, path in enumerate(trace_paths):
        for rec in _load_jsonl(path):
            rec["_stream"] = i
            recs.append(rec)

    # origin: earliest span START (ts - dur_s) or event ts across streams
    starts = []
    first_step_start = None
    for rec in recs:
        ts = rec.get("ts")
        if ts is None:
            continue
        start = ts - float(rec.get("dur_s", 0.0)) \
            if rec.get("ev") == "span" else ts
        starts.append(start)
        if (rec.get("ev") == "span" and rec.get("name") == "step"
                and first_step_start is None):
            first_step_start = start
    t0 = min(starts) if starts else 0.0

    tids = {}

    def tid_of(rec) -> int:
        key = (rec.get("_stream", 0), rec.get("pid", 0))
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": HOST_PID, "tid": tids[key],
                           "name": "thread_name",
                           "args": {"name": f"pid {key[1]} "
                                            f"(stream {key[0]})"}})
        return tids[key]

    events.append({"ph": "M", "pid": HOST_PID, "tid": COMPILE_TID,
                   "name": "thread_name", "args": {"name": "compiles"}})

    n_spans = n_compiles = 0
    for rec in recs:
        ev = rec.get("ev")
        ts = rec.get("ts")
        if ts is None:
            continue
        us = lambda t: round((t - t0) * 1e6, 3)  # noqa: E731
        if ev == "span":
            dur_s = float(rec.get("dur_s", 0.0))
            args = {k: v for k, v in rec.items()
                    if k not in ("ev", "ts", "dur_s", "name", "_stream")
                    and isinstance(v, (str, int, float, bool))}
            events.append({"ph": "X", "pid": HOST_PID, "tid": tid_of(rec),
                           "ts": us(ts - dur_s), "dur": round(dur_s * 1e6,
                                                              3),
                           "name": rec.get("name", "?"), "args": args})
            n_spans += 1
        elif ev == "compile":
            events.append({
                "ph": "i", "s": "p", "pid": HOST_PID, "tid": COMPILE_TID,
                "ts": us(ts), "name": f"compile {rec.get('name', '?')}",
                "args": {k: v for k, v in rec.items()
                         if k in ("name", "wall_s", "trace_s", "traces",
                                  "arg_sig", "persistent_cache")}})
            n_compiles += 1
        elif ev == "flight":
            # flight recorder rows (`obs.flight`) as perfetto COUNTER
            # tracks (one per diagnostic, per member), so the physics
            # trajectory into a fault renders next to the host spans and
            # the device-phase tracks
            member = rec.get("member")
            suffix = f" [{member}]" if member not in (None, "run") else ""
            for field in ("max_strain", "max_speed", "min_clearance",
                          "solution_norm", "residual_true", "health"):
                v = rec.get(field)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if not math.isfinite(v):
                    # an inf strain (a blow-up row) would serialize as the
                    # bare `Infinity` token and make the WHOLE artifact
                    # unloadable in Perfetto — exactly the traces this
                    # counter exists to render; drop the point, the fault
                    # instant still marks the event
                    continue
                events.append({"ph": "C", "pid": HOST_PID,
                               "ts": us(ts),
                               "name": f"flight:{field}{suffix}",
                               "args": {"value": v}})
        elif ev in ("lane", "fault", "journal", "device_phase_error"):
            label = rec.get("action") or rec.get("kind") or ev
            events.append({
                "ph": "i", "s": "t", "pid": HOST_PID, "tid": tid_of(rec),
                "ts": us(ts), "name": f"{ev}:{label}",
                "args": {k: v for k, v in rec.items()
                         if isinstance(v, (str, int, float, bool))
                         and k not in ("ev", "ts", "_stream")}})
        elif ev is None and rec.get("resume"):
            events.append({"ph": "i", "s": "t", "pid": HOST_PID,
                           "tid": tid_of(rec), "ts": us(ts or 0.0),
                           "name": "resume", "args": {}})

    if profile_dir is not None:
        events.extend(_device_track(profile_dir, first_step_start, t0))
    return events


def _device_track(profile_dir: str, first_step_start, host_t0) -> list:
    """Device-phase track: op events re-based so the first device op
    aligns with the host stream's first ``step`` span (approximate — see
    module docstring), one thread per phase."""
    trace = profile_mod.load_device_trace(profile_dir)
    if not trace.events:
        return []
    out = [{"ph": "M", "pid": DEVICE_PID, "name": "process_name",
            "args": {"name": "device (profiler)"}},
           {"ph": "M", "pid": DEVICE_PID, "name": "process_sort_index",
            "args": {"sort_index": 1}}]
    dev_t0 = min(e["ts"] for e in trace.events)
    # offset in us: device ts are already us; host origin is seconds
    base_us = ((first_step_start - host_t0) * 1e6
               if first_step_start is not None else 0.0)
    # tids key on (phase, SOURCE thread): a profile of several streams or
    # cards runs the same phase concurrently on several device threads,
    # and chrome-trace expects per-tid slices to nest — merging them onto
    # one tid would produce overlapping non-nested slices that render wrong
    src_tids = sorted({(e["pid"], e["tid"]) for e in trace.events})
    src_idx = {st: i for i, st in enumerate(src_tids)}
    phase_tids: dict = {}
    for e in sorted(trace.events, key=lambda e: e["ts"]):
        phase = e["phase"] or "(unattributed)"
        key = (phase, e["pid"], e["tid"])
        tid = phase_tids.get(key)
        if tid is None:
            tid = len(phase_tids) + 1
            phase_tids[key] = tid
            label = (phase if len(src_tids) == 1
                     else f"{phase} [dev {src_idx[(e['pid'], e['tid'])]}]")
            out.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                        "name": "thread_name", "args": {"name": label}})
        args = {"module": e["module"], "self_us": round(e["self_us"], 3)}
        if e["collective"]:
            args["collective"] = e["collective"]
        if e.get("inferred"):
            args["inferred_phase"] = True
        out.append({"ph": "X", "pid": DEVICE_PID, "tid": tid,
                    "ts": round(base_us + e["ts"] - dev_t0, 3),
                    "dur": e["dur"], "name": e["name"], "args": args})
    return out


def write_timeline(trace_paths, out_path: str, profile_dir=None) -> dict:
    """Write the merged timeline JSON; returns summary counts for CLIs."""
    events = timeline_events(trace_paths, profile_dir=profile_dir)
    doc = {"displayTimeUnit": "ms", "traceEvents": events}
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    return {
        "events": len(events),
        "host_slices": sum(1 for e in events
                           if e.get("ph") == "X"
                           and e.get("pid") == HOST_PID),
        "instants": sum(1 for e in events if e.get("ph") == "i"),
        "counters": sum(1 for e in events if e.get("ph") == "C"),
        "device_slices": sum(1 for e in events
                             if e.get("ph") == "X"
                             and e.get("pid") == DEVICE_PID),
    }
