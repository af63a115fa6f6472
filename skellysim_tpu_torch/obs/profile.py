"""Device-time attribution from `torch.profiler` dumps.

Counterpart of `skellysim_tpu.obs.profile`. ``--profile DIR`` wraps a run
in `profile_session`, which exports Kineto's Chrome trace
(``*.pt.trace.json``) into DIR; `load_device_trace` folds it into
per-phase device-time totals:

* the hot path opens one `phase` scope (a `torch.profiler.record_function`
  range, category ``user_annotation``) at each counterpart of the JAX
  package's ``jax.named_scope`` sites, with the same names and nesting
  (`system.system`, `solver.gmres`, `parallel.spmd`, `parallel.ring`,
  `ops.treecode`, `ops.spectral`, `scenarios.di_device`, the ensemble
  runner);
* a device event (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``)
  carries no scope, only ``args.correlation``, the id of the host call
  that launched it (category ``cuda_runtime``, or ``cuda_driver`` for a
  ``cuLaunchKernel``); the stack of annotation ranges that contain that
  launch on its host thread, joined with "/" and passed through
  `phase_of`, is the event's phase. Kineto's ``gpu_user_annotation``
  ranges are not read: they span from a scope's first kernel to its last
  and overlap across nested scopes.

A dump with no device events (a run on the CPU) takes its ``cpu_op``
events (``aten::*``) as the ops, each by its self time. A dump taken on
the card with no device event (CUPTI missing, an empty device track)
raises: `emit_device_phases` turns that into a ``device_phase_error``
event, never a quiet "0 ops".

Importing this module touches neither CUDA nor the profiler: the parser
is json and gzip only, and `phase` / `profile_session` import torch when
called.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
from typing import Optional

#: the phase vocabulary of the hot path's scopes (the JAX package's set).
#: A scope-path component is a PHASE component iff it appears here.
PHASE_SCOPES = frozenset({
    # System step phases (system/system.py, parallel/spmd.py)
    "prep", "gmres", "precond", "refine", "advance",
    # solver phases inside the Krylov loop (solver/gmres.py)
    "arnoldi", "gram", "givens",
    # SPMD collective phases (parallel/spmd.py, parallel/ring.py)
    "ring-step", "allgather-density", "psum-dots",
    # treecode traversal phases (ops/treecode.py)
    "upward", "near", "far",
    # spectral-Ewald pipeline phases (ops/spectral.py; "near" is shared
    # with the treecode vocabulary above)
    "spread", "fft", "kspace", "interp",
    # auxiliaries: the device DI update (scenarios/di_device.py) and the
    # collision gate (system/system.py)
    "dynamic-instability", "collision",
})

#: collective op name -> the audit contract's collective kind names: the
#: JAX package's HLO opcodes, and the operation token of NCCL's kernel
#: names (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``,
#: ``ncclKernel_AllGather_RING_LL_Sum_int8_t``); the ring's hops across
#: processes are NCCL's send / receive kernels
COLLECTIVE_KINDS = {
    "all-reduce": "all_reduce",
    "all-gather": "all_gather",
    "collective-permute": "collective_permute",
    "all-to-all": "all_to_all",
    "reduce-scatter": "reduce_scatter",
    "collective-broadcast": "collective_broadcast",
    "AllReduce": "all_reduce",
    "AllGather": "all_gather",
    "SendRecv": "collective_permute",
    "ReduceScatter": "reduce_scatter",
    "Broadcast": "collective_broadcast",
}

_NCCL_KERNEL = re.compile(r"nccl(?:Dev)?Kernel_([A-Za-z]+?)(?:_|\(|$)")

#: Kineto categories of the device's own events and of the host calls
#: that launch them
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


# ------------------------------------------------------- trace-event reading

def find_profile_files(profile_dir: str) -> list:
    """[the newest ``*.pt.trace.json(.gz)``] under a `profile_session`
    dump directory (a repeated run into one directory leaves one file
    each), or [] when there is none."""
    if not os.path.isdir(profile_dir):
        return []
    traces = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir)
              if f.endswith(".pt.trace.json")
              or f.endswith(".pt.trace.json.gz")]
    return [max(traces, key=lambda p: (os.path.getmtime(p), p))] \
        if traces else []


def _load_trace_doc(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)


def _self_times(events: list) -> list:
    """Per-event SELF durations: each complete ("X") event's duration minus
    its same-thread children's — so nested op events never double-count.
    Returns [(event, self_dur_us)]."""
    by_tid: dict = {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev or "ts" not in ev:
            continue
        by_tid.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []   # (end_ts, child_sum_slot) — slot is a 1-elem list
        for ev in evs:
            ts, dur = ev["ts"], ev["dur"]
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            if stack:
                stack[-1][1][0] += dur
            slot = [0.0]
            stack.append((ts + dur, slot))
            out.append((ev, slot))
    return [(ev, max(ev["dur"] - slot[0], 0.0)) for ev, slot in out]


def phase_of(op_name: str) -> Optional[str]:
    """Slash-joined RECOGNIZED scope components of a scope path, or None —
    ``run/step/gmres/arnoldi/precond`` -> ``gmres/arnoldi/precond``.
    Dedupes immediate repeats (a scope re-entered per ring hop)."""
    comps = []
    for c in op_name.split("/"):
        if c in PHASE_SCOPES and (not comps or comps[-1] != c):
            comps.append(c)
    return "/".join(comps) if comps else None


def collective_kind(op_event_name: str) -> Optional[str]:
    """``all-reduce.17`` or ``ncclDevKernel_AllReduce_Sum_f32_RING_LL``
    -> ``all_reduce`` (audit-contract spelling).

    Prefix-matches past the HLO opcode so async pairs
    (``all-reduce-start.N`` / ``all-reduce-done.N``) and fused collective
    thunks (``all-reduce-fusion``) classify as their kind too; an NCCL
    kernel classifies by the operation token after ``Kernel_``."""
    base = op_event_name.split(".")[0].split(" ")[0]
    for opcode, kind in COLLECTIVE_KINDS.items():
        if base == opcode or base.startswith(opcode + "-"):
            return kind
    m = _NCCL_KERNEL.search(op_event_name)
    return COLLECTIVE_KINDS.get(m.group(1)) if m else None


class DeviceTrace:
    """Aggregated per-op device time from one profile dump.

    ``rows`` is a list of dicts: op (the event's category: ``kernel``,
    ``gpu_memcpy``, ``gpu_memset`` or ``cpu_op``), module (the kernel's or
    the aten op's name), phase (recognized scope path or None),
    collective (kind or None), scope (the full annotation path at the
    launch), dur_us (summed SELF time), count. ``events`` keeps the raw
    per-execution op events (ts/dur/self_us/phase/...) for the timeline
    renderer.
    """

    def __init__(self, rows: list, events: list):
        self.rows = rows
        self.events = events

    # ------------------------------------------------------------- totals

    @property
    def total_us(self) -> float:
        return sum(r["dur_us"] for r in self.rows)

    @property
    def attributed_us(self) -> float:
        return sum(r["dur_us"] for r in self.rows if r["phase"])

    @property
    def inferred_us(self) -> float:
        return sum(r["dur_us"] for r in self.rows
                   if r["phase"] and r.get("inferred"))

    @property
    def attributed_frac(self) -> float:
        tot = self.total_us
        return (self.attributed_us / tot) if tot > 0 else 0.0

    def _group(self, key_fn) -> list:
        groups: dict = {}
        for r in self.rows:
            key = key_fn(r)
            g = groups.setdefault(key, {"dur_us": 0.0, "count": 0,
                                        "collectives": {}})
            g["dur_us"] += r["dur_us"]
            g["count"] += r["count"]
            if r["collective"]:
                g["collectives"][r["collective"]] = (
                    g["collectives"].get(r["collective"], 0.0) + r["dur_us"])
        tot = self.total_us
        out = []
        for key, g in groups.items():
            out.append({"key": key, "dur_us": round(g["dur_us"], 3),
                        "count": g["count"],
                        "share": (g["dur_us"] / tot) if tot > 0 else 0.0,
                        "collectives": {k: round(v, 3) for k, v
                                        in sorted(g["collectives"].items())}})
        out.sort(key=lambda r: -r["dur_us"])
        return out

    def by_phase(self) -> list:
        """Per-phase totals; unattributed time reported under the explicit
        ``(unattributed)`` key, never hidden."""
        return self._group(lambda r: r["phase"] or "(unattributed)")

    def by_collective(self) -> list:
        """Collectives by kind + one ``(computation)`` row for the rest."""
        return self._group(lambda r: r["collective"] or "(computation)")

    def by_op(self) -> list:
        return self._group(lambda r: f"{r['module']}/{r['op']}")


def _annotation_paths(annotations: dict, queries: dict) -> dict:
    """{query id: "/"-joined names of the annotation ranges open at its
    time on its thread}. ``annotations``: {thread: [(start, end, name)]};
    ``queries``: {thread: [(ts, query id)]}. Ranges of one thread nest
    (each is a context manager), so one sweep with a stack serves every
    query of the thread."""
    out = {}
    for thread, qs in queries.items():
        anns = sorted(annotations.get(thread, ()),
                      key=lambda a: (a[0], -a[1]))
        stack: list = []
        i = 0
        for ts, qid in sorted(qs, key=lambda q: q[0]):
            while i < len(anns) and anns[i][0] <= ts:
                start = anns[i][0]
                while stack and stack[-1][1] <= start:
                    stack.pop()
                stack.append(anns[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[qid] = "/".join(a[2] for a in stack)
    return out


def _profiled_on_card(profile_dir: str, docs: list) -> bool:
    """True when the dump was taken with the card's activity on: its
    ``provenance.json`` says backend "cuda", or a trace lists the card's
    properties."""
    try:
        with open(os.path.join(profile_dir, "provenance.json")) as fh:
            if json.load(fh).get("backend") == "cuda":
                return True
    except (OSError, ValueError, AttributeError):
        pass
    return any(isinstance(d, dict) and d.get("deviceProperties")
               for d in docs)


def load_device_trace(profile_dir: str) -> DeviceTrace:
    """Parse a `profile_session` dump dir into a `DeviceTrace`.

    Raises FileNotFoundError when the dir holds no trace, and ValueError
    when a dump taken on the card holds no device event."""
    traces = find_profile_files(profile_dir)
    if not traces:
        raise FileNotFoundError(
            f"no *.pt.trace.json(.gz) under {profile_dir!r} — is this a "
            "`--profile DIR` dump?")
    kept_events = []
    docs = []
    for tpath in traces:
        doc = _load_trace_doc(tpath)
        docs.append(doc)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        kept_events.extend(_op_events(events))
    on_device = any(e["op"] != "cpu_op" for e in kept_events)
    if not on_device and _profiled_on_card(profile_dir, docs):
        raise ValueError(
            f"the dump under {profile_dir!r} was taken on the card but "
            "holds no device event (is CUPTI available to the profiler?)")
    _infer_gap_phases(kept_events)

    agg: dict = {}
    for e in kept_events:
        # inferred events row apart: one kernel name runs both attributed
        # and inferred, and the inferred share must count every one
        key = (e["module"], e["op"], e["phase"], e["inferred"])
        row = agg.setdefault(key, {
            "op": e["op"], "module": e["module"], "phase": e["phase"],
            "inferred": e["inferred"], "collective": e["collective"],
            "scope": e["scope"], "dur_us": 0.0, "count": 0})
        row["dur_us"] += e["self_us"]
        row["count"] += 1
    rows = sorted(agg.values(), key=lambda r: -r["dur_us"])
    for r in rows:
        r["dur_us"] = round(r["dur_us"], 3)
    return DeviceTrace(rows, kept_events)


def _op_events(events: list) -> list:
    """The kept per-execution op events of one trace (`load_device_trace`):
    name, op (category), module (name), ts, dur, self_us, phase, scope,
    inferred, collective, pid, tid."""
    annotations: dict = {}
    launches: dict = {}
    device, cpu = [], []
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X" \
                or "ts" not in ev:
            continue
        cat = ev.get("cat")
        if cat == "user_annotation":
            annotations.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (ev["ts"], ev["ts"] + ev.get("dur", 0.0), ev.get("name", "")))
        elif cat in LAUNCH_CATEGORIES:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ev
        elif cat in DEVICE_CATEGORIES:
            device.append(ev)
        elif cat == "cpu_op":
            cpu.append(ev)
    ops = device or cpu
    queries: dict = {}
    for i, ev in enumerate(ops):
        host = (launches.get((ev.get("args") or {}).get("correlation"))
                if device else ev)
        if host is not None:
            queries.setdefault((host.get("pid"), host.get("tid")),
                               []).append((host["ts"], i))
    paths = _annotation_paths(annotations, queries)
    index = {id(ev): i for i, ev in enumerate(ops)}
    # a dump repeats few scope paths and op names: classify each once
    phases: dict = {"": None}
    kinds: dict = {}
    out = []
    for ev, self_us in _self_times(ops):
        name = ev.get("name", "?")
        scope = paths.get(index[id(ev)], "")
        if scope not in phases:
            phases[scope] = phase_of(scope)
        if name not in kinds:
            kinds[name] = collective_kind(name)
        out.append({
            "name": name, "op": ev.get("cat"), "module": name,
            "ts": ev["ts"], "dur": ev.get("dur", 0.0), "self_us": self_us,
            "phase": phases[scope], "scope": scope, "inferred": False,
            "collective": kinds[name], "pid": ev.get("pid"),
            "tid": ev.get("tid")})
    return out


def _infer_gap_phases(events: list) -> None:
    """Temporal-locality gap fill for ops with no phase.

    A device event whose launch fell outside every scope, or whose launch
    the profiler lost, has no phase. The device thread executes serially
    in phase-contiguous segments, so an unmatched op whose nearest
    attributed neighbors ON BOTH SIDES (same thread) agree on a phase
    almost surely belongs to it: inherit, and mark the event ``inferred``
    so the table reports directly-attributed and inferred shares
    separately (never silently)."""
    by_tid: dict = {}
    for e in events:
        by_tid.setdefault((e["pid"], e["tid"]), []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        # prev_phase[i]: phase of the nearest attributed event at or before i
        n = len(evs)
        prev_ph = [None] * n
        last = None
        for i, e in enumerate(evs):
            if e["phase"]:
                last = e["phase"]
            prev_ph[i] = last
        nxt = None
        for i in range(n - 1, -1, -1):
            e = evs[i]
            if e["phase"]:
                nxt = e["phase"]
            elif prev_ph[i] is not None and prev_ph[i] == nxt:
                e["phase"] = nxt
                e["inferred"] = True


# -------------------------------------------------------------- rendering

def render_table(trace: DeviceTrace, by: str = "phase") -> str:
    """The `obs profile` text report."""
    groups = {"phase": trace.by_phase, "collective": trace.by_collective,
              "op": trace.by_op}[by]()
    rows = [(by, "time_ms", "share", "ops", "collectives")]
    for g in groups[:40]:
        colls = "  ".join(f"{k}={v / 1e3:.3f}ms"
                          for k, v in g["collectives"].items())
        rows.append((str(g["key"]), f"{g['dur_us'] / 1e3:.3f}",
                     f"{g['share']:.1%}", str(g["count"]), colls))
    widths = [max(len(r[i]) for r in rows) for i in range(5)]
    out = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
           for r in rows]
    if len(groups) > 40:
        out.append(f"... ({len(groups) - 40} more rows; --json for all)")
    out.append("")
    tot = trace.total_us
    inf_frac = (trace.inferred_us / tot) if tot > 0 else 0.0
    out.append(f"device op time: {tot / 1e3:.3f}ms over "
               f"{sum(r['count'] for r in trace.rows)} op executions; "
               f"{trace.attributed_frac:.1%} attributed to named phases "
               f"({trace.attributed_frac - inf_frac:.1%} via HLO metadata, "
               f"{inf_frac:.1%} inferred from phase-contiguous neighbors)")
    return "\n".join(out) + "\n"


def profile_json(trace: DeviceTrace) -> dict:
    return {
        "total_us": round(trace.total_us, 3),
        "attributed_us": round(trace.attributed_us, 3),
        "inferred_us": round(trace.inferred_us, 3),
        "attributed_frac": round(trace.attributed_frac, 4),
        "by_phase": trace.by_phase(),
        "by_collective": trace.by_collective(),
        "by_op": trace.by_op(),
    }


# ---------------------------------------------------------- capture context

def phase(name: str):
    """The scope of one phase of the hot path: a
    `torch.profiler.record_function` range named ``name`` (one of
    `PHASE_SCOPES`). It launches nothing and synchronizes nothing; with no
    profiler running it records nothing."""
    import torch

    return torch.profiler.record_function(name)


def _power_limit() -> Optional[str]:
    """The first card's ``name, power.limit`` as nvidia-smi prints them,
    or None where it does not answer."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _write_profile_provenance(profile_dir: str, backend: str) -> None:
    """Drop a ``provenance.json`` sidecar next to the dump: the tracer's
    `provenance`, the ``backend`` ("cuda" or "cpu"), and on the card its
    name and power limit as nvidia-smi reports them."""
    try:
        from .tracer import provenance

        info = provenance()
        info["backend"] = backend
        if backend == "cuda":
            import torch

            info["card"] = torch.cuda.get_device_name(0)
            info["nvidia_smi"] = _power_limit()
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "provenance.json"), "w") as fh:
            json.dump(info, fh)
    except Exception:
        pass   # a sidecar must never fail the capture it describes


@contextlib.contextmanager
def profile_session(profile_dir: str, device=None):
    """`torch.profiler.profile` around the block, tuned for device-time
    attribution, exported to ``profile_dir`` as Kineto's Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``) with a ``provenance.json``.

    Activities: the CPU (the phase scopes and the launches live there),
    plus CUDA when ``device`` is a card (None: when one is available).
    Shapes, stacks and memory are off — the counterpart of the JAX
    package's Python tracer being off: the dump is for the device, and
    host-side timing is the span tracer's job."""
    import socket
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities, record_shapes=False,
                   with_stack=False, profile_memory=False)
    prof.__enter__()
    try:
        yield prof
    finally:
        if on_card:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        try:
            host = socket.gethostname()
        except Exception:
            host = "host"
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"{host}_{os.getpid()}.{time.time_ns()}"
                         ".pt.trace.json"))
        _write_profile_provenance(profile_dir,
                                  "cuda" if on_card else "cpu")


# ------------------------------------------------- telemetry-stream bridge

def device_phase_events(profile_dir: str) -> list:
    """The ``device_phase`` telemetry records for a profile dump: one per
    phase (incl. ``(unattributed)``) with ``dur_s``/``share``/``ops`` and
    the per-kind collective split. Appended to the run's `--trace-file` by
    the CLIs so `obs summarize` renders device time next to host spans."""
    trace = load_device_trace(profile_dir)
    out = []
    for g in trace.by_phase():
        out.append({"phase": g["key"], "dur_s": round(g["dur_us"] / 1e6, 6),
                    "share": round(g["share"], 4), "ops": g["count"],
                    "collectives": {k: round(v / 1e6, 6)
                                    for k, v in g["collectives"].items()}})
    return out


def emit_device_phases(profile_dir: str, tracer=None) -> int:
    """Parse ``profile_dir`` and emit one ``device_phase`` event per phase
    into ``tracer`` (or the process-active tracer). Returns the number of
    events emitted; swallows parse errors into one ``device_phase_error``
    event (a broken profiler dump must never fail the run that produced
    it) but NOT tracer write errors."""
    from . import tracer as obs_tracer

    tr = tracer if tracer is not None else obs_tracer.active()
    if tr is None:
        return 0
    try:
        events = device_phase_events(profile_dir)
    except Exception as e:
        tr.emit("device_phase_error", error=f"{type(e).__name__}: {e}",
                profile_dir=str(profile_dir))
        return 0
    for rec in events:
        tr.emit("device_phase", **rec)
    return len(events)
