"""Render telemetry and metrics JSONL streams into a readable report.

Counterpart of `skellysim_tpu.obs.summarize` (a pure fold of JSON lines,
the same sections and the same text), over every line shape the port
emits:

* tracer events (``ev`` key): ``span`` / ``compile`` / ``lane`` /
  ``fault`` / ``flight`` / ``telemetry`` headers, from `obs.tracer` (the
  run loop, the ensemble scheduler, the service; a ``compile`` event is a
  CUDA library built or loaded, `ops.cuda_build`);
* run-loop step records (`system.METRICS_FIELDS`, no ``ev`` / ``event``
  key) and ensemble metrics records (``event`` = start/step/retire/...,
  `io.ensemble_io`);
* resume markers (``{"resume": true, ...}``).

Each section (span timings, compile events, faults, lane occupancy,
dynamic instability, physics diagnostics, solver convergence) is omitted
when its inputs are absent, so one call serves a metrics file, a trace
file, an ensemble metrics file, or all of them at once.
"""

from __future__ import annotations

import json


def _fmt_s(v: float) -> str:
    return f"{v:.4f}"


class Summary:
    """Accumulator over parsed JSONL records."""

    def __init__(self):
        #: span durations keyed (source stream id, path) — the source
        #: column only renders when more than one file was ingested
        self.spans: dict[tuple, list[float]] = {}
        self.compiles: list[dict] = []
        #: `device_phase` records (skelly-pulse: the profiler dump folded
        #: into the stream by the run CLIs — docs/observability.md
        #: "Device-time attribution")
        self.device_phases: list[dict] = []
        #: fault events by kind (`ev == "fault"` — solver health verdicts,
        #: lane quarantines, chaos injections, wire-frame rejects,
        #: fused-ring fallbacks; docs/robustness.md)
        self.faults: dict[str, int] = {}
        self.fault_verdicts: dict[str, int] = {}
        #: fused-ring fallback eligibility legs (``leg`` — budget vs
        #: platform vs missing-api, `parallel.compat._fused_fallback`)
        self.fault_legs: dict[str, int] = {}
        self.lane_events: dict[str, int] = {}
        self.lane_rounds: list[dict] = []
        #: admission latencies from lane admit/backfill events
        #: (`queue_wait_s`, emitted by the ensemble scheduler)
        self.queue_waits: list[float] = []
        self.steps: list[dict] = []
        #: flight-recorder rows keyed by member (skelly-flight): the
        #: metrics records' ``flight`` column and the telemetry stream's
        #: ``flight`` events both land here (docs/observability.md)
        self.flight_rows: dict[str, list[dict]] = {}
        #: fault-event offender fields (``prov_field`` — anomaly
        #: provenance, `obs.flight.PROV_FIELDS`)
        self.fault_fields: dict[str, int] = {}
        #: metrics-column vs telemetry-event flight-row pairing: the run
        #: loop writes the SAME trial row to both streams — summarizing
        #: the pair must count it once, while two separate
        #: (bitwise-identical) runs' rows must NOT collapse
        #: (`obs.flight.FlightRowDedup` credit matching)
        self._flight_dedup = None
        self.resumes = 0
        self.versions: set[int] = set()
        self.unparsed = 0
        #: torn trailing lines (kill-9 mid-write): tolerated, reported
        #: separately from mid-file garbage — the `serve/journal.py`
        #: replay discipline applied to report inputs
        self.torn_tails = 0
        #: source-stream id stamped on ingested step records: `round` ids
        #: restart at 0 per ensemble run, so wall dedupe must never merge
        #: round 0 of file A with round 0 of file B
        self._stream = 0
        #: stream id -> display label (file basename, "#N"-deduped) for
        #: the per-file provenance columns; direct `add_line` callers
        #: (tests) land on stream 0 / label "-"
        self.sources: dict[int, str] = {}

    # ------------------------------------------------------------- ingest

    def add_line(self, line: str):
        line = line.strip()
        if not line:
            return
        try:
            rec = json.loads(line)
        except ValueError:
            self.unparsed += 1
            return
        if not isinstance(rec, dict):
            self.unparsed += 1
            return
        self.add_record(rec)

    def add_record(self, rec: dict):
        ev = rec.get("ev")
        if ev == "telemetry":
            self.versions.add(rec.get("version"))
        elif ev == "span":
            key = (self._stream, rec.get("path") or rec.get("name", "?"))
            self.spans.setdefault(key, []).append(
                float(rec.get("dur_s", 0.0)))
            # ensemble batched-step spans carry lane-occupancy fields
            if "live" in rec and "lanes" in rec:
                self.lane_rounds.append(dict(rec, _stream=self._stream))
        elif ev == "device_phase":
            self.device_phases.append(dict(rec, _stream=self._stream))
        elif ev == "compile":
            self.compiles.append(rec)
        elif ev == "fault":
            kind = rec.get("kind", "?")
            self.faults[kind] = self.faults.get(kind, 0) + 1
            if rec.get("verdict"):
                v = str(rec["verdict"])
                self.fault_verdicts[v] = self.fault_verdicts.get(v, 0) + 1
            if rec.get("prov_field"):
                f = str(rec["prov_field"])
                self.fault_fields[f] = self.fault_fields.get(f, 0) + 1
            if rec.get("leg"):
                leg = str(rec["leg"])
                self.fault_legs[leg] = self.fault_legs.get(leg, 0) + 1
        elif ev == "flight":
            row = {k: rec.get(k) for k in rec
                   if k not in ("ev", "ts", "pid", "host")}
            self._add_flight_row(rec, row, "trace")
        elif ev == "lane":
            action = rec.get("action", "?")
            self.lane_events[action] = self.lane_events.get(action, 0) + 1
            if "queue_wait_s" in rec:
                self.queue_waits.append(float(rec["queue_wait_s"]))
        elif ev is None:
            if rec.get("resume"):
                self.resumes += 1
            elif "iters" in rec and rec.get("event", "step") == "step":
                # run-loop METRICS_FIELDS record, or an ensemble step record
                self.steps.append(dict(rec, _stream=self._stream))
                if isinstance(rec.get("flight"), dict):
                    self._add_flight_row(rec, rec["flight"], "metrics")

    def _add_flight_row(self, rec: dict, row: dict, kind: str):
        from .flight import FlightRowDedup, flight_row_key, member_of

        if self._flight_dedup is None:
            self._flight_dedup = FlightRowDedup()
        member = member_of(rec)
        if self._flight_dedup.is_duplicate(flight_row_key(member, row),
                                           kind):
            return
        self.flight_rows.setdefault(member, []).append(row)

    def add_file(self, path: str):
        import os

        self._stream += 1
        label = os.path.basename(path) or path
        if label in self.sources.values():
            label = f"{label}#{self._stream}"
        self.sources[self._stream] = label
        # torn-trailing-line tolerance (kill -9 mid-write, same replay
        # discipline as serve/journal.py): THE one rule lives in
        # `obs.flight.iter_jsonl_tolerant`, shared with `obs flight` — a
        # torn final line is a partial write, reported as such; mid-file
        # garbage stays an unparseable-line count
        from .flight import iter_jsonl_tolerant

        for rec, torn in iter_jsonl_tolerant(path):
            if rec is None:
                if torn:
                    self.torn_tails += 1
                else:
                    self.unparsed += 1
                continue
            self.add_record(rec)

    def _label(self, stream: int) -> str:
        return self.sources.get(stream, "-")

    @property
    def _multi_source(self) -> bool:
        return len(self.sources) > 1

    # ------------------------------------------------------------- render

    def _span_section(self, out: list[str]):
        if not self.spans:
            return
        out.append("== spans ==")
        # with several input files the span table carries per-file
        # provenance (a serve run's multiple --trace-files used to
        # interleave indistinguishably)
        multi = self._multi_source
        header = (("source",) if multi else ()) + (
            "span", "count", "total_s", "mean_s", "max_s")
        rows = [header]
        for stream, path in sorted(self.spans,
                                   key=lambda k: (k[1], self._label(k[0]))):
            durs = self.spans[(stream, path)]
            src = ((self._label(stream),) if multi else ())
            rows.append(src + (path, str(len(durs)), _fmt_s(sum(durs)),
                               _fmt_s(sum(durs) / len(durs)),
                               _fmt_s(max(durs))))
        widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
        out.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                   for r in rows)
        out.append("")

    def _device_phase_section(self, out: list[str]):
        """Device time by phase (skelly-pulse): the profiler dump's
        attribution table folded into the stream as `device_phase` events
        — rendered next to the host spans so one summarize answers both
        "where did the host wait" and "where did the device work"."""
        if not self.device_phases:
            return
        out.append("== device time by phase ==")
        multi = self._multi_source
        header = (("source",) if multi else ()) + (
            "phase", "time_s", "share", "ops", "collectives")
        rows = [header]
        for rec in sorted(self.device_phases,
                          key=lambda r: -float(r.get("dur_s", 0.0))):
            colls = "  ".join(f"{k}={float(v):.4f}s" for k, v in
                              sorted((rec.get("collectives") or {}).items()))
            src = ((self._label(rec.get("_stream", 0)),) if multi else ())
            rows.append(src + (str(rec.get("phase", "?")),
                               _fmt_s(float(rec.get("dur_s", 0.0))),
                               f"{float(rec.get('share', 0.0)):.1%}",
                               str(rec.get("ops", "?")), colls))
        widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
        out.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                   for r in rows)
        out.append("")

    def _compile_section(self, out: list[str]):
        if not self.compiles:
            return
        out.append("== compile events ==")
        for rec in self.compiles:
            # cache stamp: "cached" = the library was already built (the
            # JAX package's: a persistent compilation cache served it), so
            # the wall time is a load, not a cold build; streams without
            # the stamp render as "?"
            cache = rec.get("persistent_cache")
            cache_s = ("?" if cache is None
                       else ("cached" if cache else "cold"))
            out.append(
                f"{rec.get('name', '?')}: trace #{rec.get('traces', '?')} "
                f"wall={rec.get('wall_s', '?')}s "
                f"trace={rec.get('trace_s', '?')}s "
                f"cache={cache_s} "
                f"donated={rec.get('donated', [])} "
                f"sig={str(rec.get('arg_sig', ''))[:120]}")
        by_name: dict[str, int] = {}
        for rec in self.compiles:
            by_name[rec.get("name", "?")] = by_name.get(
                rec.get("name", "?"), 0) + 1
        retraced = {n: c for n, c in by_name.items() if c > 1}
        if retraced:
            out.append("RETRACES: " + ", ".join(
                f"{n} x{c}" for n, c in sorted(retraced.items())))
        out.append("")

    def _fault_section(self, out: list[str]):
        if not self.faults:
            return
        out.append("== faults ==")
        rows = [("kind", "count")]
        rows += [(k, str(v)) for k, v in sorted(self.faults.items())]
        widths = [max(len(r[i]) for r in rows) for i in range(2)]
        out.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                   for r in rows)
        if self.fault_verdicts:
            out.append("verdicts: " + ", ".join(
                f"{v}={n}" for v, n in sorted(self.fault_verdicts.items())))
        if self.fault_fields:
            # skelly-flight anomaly provenance: which FIELD blew up first
            out.append("offender fields: " + ", ".join(
                f"{f}={n}" for f, n in sorted(self.fault_fields.items())))
        if self.fault_legs:
            # which fused-ring eligibility leg failed (a layout refusal
            # reads differently from a platform one)
            out.append("legs: " + ", ".join(
                f"{leg}={n}" for leg, n in sorted(self.fault_legs.items())))
        out.append("")

    def _lane_section(self, out: list[str]):
        if not self.lane_events and not self.lane_rounds:
            return
        out.append("== ensemble lanes ==")
        if self.lane_events:
            out.append("events: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.lane_events.items())))
        if self.lane_rounds:
            by_stream: dict = {}
            for r in self.lane_rounds:
                by_stream.setdefault(r.get("_stream", 0), []).append(r)
            for stream in sorted(by_stream,
                                 key=lambda s: self._label(s)):
                rounds = by_stream[stream]
                live = [float(r["live"]) for r in rounds]
                lanes = max(float(r["lanes"]) for r in rounds)
                occ = sum(live) / (len(live) * lanes) if lanes else 0.0
                src = (f"[{self._label(stream)}] " if self._multi_source
                       else "")
                out.append(f"{src}rounds: {len(rounds)}  lanes: "
                           f"{int(lanes)}  mean occupancy: {occ:.1%}")
        if self.queue_waits:
            w = self.queue_waits
            out.append(f"admission wait: mean {sum(w) / len(w):.4f}s  "
                       f"max {max(w):.4f}s  (n={len(w)})")
        out.append("")

    def _scenario_section(self, out: list[str]):
        """Dynamic-instability table (docs/scenarios.md): per-member fiber
        population trajectory + growth-reseat events. Rendered only when
        the stream carries DI activity — the fields are all-zero on
        deterministic runs."""
        di_steps = [s for s in self.steps
                    if s.get("nucleations") or s.get("catastrophes")
                    or s.get("active_fibers")]
        # a ScenarioEnsemble trace carries BOTH the scheduler's "growth"
        # (lane froze) and the sweep's "growth_reseat" (member re-admitted)
        # for the same reseat; a serve trace carries "growth" only — take
        # the max, not the sum
        growths = max(self.lane_events.get("growth", 0),
                      self.lane_events.get("growth_reseat", 0))
        if not di_steps and not growths:
            return
        out.append("== dynamic instability ==")
        by_member: dict[str, list[dict]] = {}
        for s in self.steps:
            by_member.setdefault(s.get("member", "run"), []).append(s)
        rows = [("member", "steps", "nucleated", "catastrophes",
                 "active (first->last, max)")]
        for member in sorted(by_member):
            recs = by_member[member]
            act = [int(r.get("active_fibers", 0)) for r in recs]
            rows.append((
                member, str(len(recs)),
                str(sum(int(r.get("nucleations", 0)) for r in recs)),
                str(sum(int(r.get("catastrophes", 0)) for r in recs)),
                f"{act[0]} -> {act[-1]}, max {max(act)}" if act else "-"))
        widths = [max(len(r[i]) for r in rows) for i in range(5)]
        out.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                   for r in rows)
        total_n = sum(int(s.get("nucleations", 0)) for s in self.steps)
        total_c = sum(int(s.get("catastrophes", 0)) for s in self.steps)
        out.append(f"events: nucleations={total_n}  catastrophes={total_c}"
                   + (f"  growth-reseats={growths}" if growths else ""))
        out.append("")

    def _flight_section(self, out: list[str]):
        """Physics-diagnostics table (skelly-flight,
        docs/observability.md "Flight recorder"): per-member extrema of
        the recorder's per-step rows — strain, node speed, signed wall
        clearance, solution norm — plus any anomaly provenance. Rendered
        only when the stream carries flight rows (Params.flight_window >
        0)."""
        if not self.flight_rows:
            return
        out.append("== physics diagnostics (flight recorder) ==")
        rows = [("member", "steps", "max_strain", "max_speed",
                 "min_clear", "max_|x|", "flagged")]

        def vals(rs, key):
            return [r[key] for r in rs
                    if isinstance(r.get(key), (int, float))]

        for member in sorted(self.flight_rows):
            rs = self.flight_rows[member]
            strains = vals(rs, "max_strain")
            speeds = vals(rs, "max_speed")
            clears = vals(rs, "min_clearance")
            norms = vals(rs, "solution_norm")
            flagged = sum(1 for r in rs if r.get("health"))
            rows.append((
                member, str(len(rs)),
                f"{max(strains):.3g}" if strains else "-",
                f"{max(speeds):.3g}" if speeds else "-",
                f"{min(clears):.3g}" if clears else "-",
                f"{max(norms):.3g}" if norms else "-",
                str(flagged) if flagged else "-"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        out.extend("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                   for r in rows)
        provs = [(m, r["provenance"]) for m, rs in self.flight_rows.items()
                 for r in rs if isinstance(r.get("provenance"), dict)]
        for m, p in provs[-4:]:
            where = (f"fiber {p.get('fiber')} node {p.get('node')}"
                     if p.get("fiber", -1) not in (None, -1)
                     else f"row {p.get('node')}")
            out.append(f"provenance: {m}: first nonfinite in "
                       f"{p.get('field')} ({where})")
        out.append("")

    def _convergence_section(self, out: list[str]):
        if not self.steps:
            return
        out.append("== solver convergence ==")
        n = len(self.steps)
        accepted = sum(1 for s in self.steps if s.get("accepted"))
        iters = [int(s.get("iters", 0)) for s in self.steps]
        out.append(f"trial steps: {n}  accepted: {accepted}  "
                   f"rejected: {n - accepted}"
                   + (f"  (resume markers: {self.resumes})"
                      if self.resumes else ""))
        out.append(f"gmres iters: min {min(iters)}  "
                   f"mean {sum(iters) / n:.1f}  max {max(iters)}")
        cycles = [int(s["gmres_cycles"]) for s in self.steps
                  if "gmres_cycles" in s]
        if cycles:
            out.append(f"gmres restart cycles: mean "
                       f"{sum(cycles) / len(cycles):.1f}  max {max(cycles)}")
        # dot-product psum rounds per solve (`solver.gmres.collective_rounds`
        # — iters/block_s batched Gram rounds + per-cycle residual norms):
        # the s-step ladder lever, surfaced here so a collective-count
        # regression shows up in telemetry, not just in bench reruns
        rounds = [int(s["collective_rounds"]) for s in self.steps
                  if "collective_rounds" in s]
        if rounds:
            out.append(f"collective rounds/solve: mean "
                       f"{sum(rounds) / len(rounds):.1f}  max {max(rounds)}"
                       f"  total {sum(rounds)}")
        rt = [float(s["residual_true"]) for s in self.steps
              if s.get("residual_true") is not None]
        if rt:
            out.append(f"explicit residual: max {max(rt):.3e}  "
                       f"last {rt[-1]:.3e}")
        refines = [int(s.get("refines", 0)) for s in self.steps]
        if any(refines):
            out.append(f"refinement sweeps: total {sum(refines)}  "
                       f"max {max(refines)}")
        loa = sum(1 for s in self.steps if s.get("loss_of_accuracy"))
        if loa:
            out.append(f"LOSS-OF-ACCURACY steps: {loa}")
        # a SUCCESSFUL escalation replaces the health word with the healed
        # attempt's 0 (guard/verdict.py), so retries must be reported even
        # when no step stayed flagged — those are exactly the runs where
        # the ladder paid extra solves
        unhealthy = sum(1 for s in self.steps if s.get("health"))
        retries = sum(int(s.get("guard_retries", 0)) for s in self.steps)
        if unhealthy or retries:
            out.append(f"HEALTH-FLAGGED steps: {unhealthy}  "
                       f"(guard retries: {retries})")
        # ensemble step records share one batched round's wall across every
        # live lane (io.ensemble_io schema) — dedupe by (stream, round) so
        # the total is the drain's wall, not lanes x wall, while rounds
        # from DIFFERENT input files (ids restart at 0 per run) still
        # count separately
        walls: dict = {}
        for i, s in enumerate(self.steps):
            if "wall_ms" not in s:
                continue
            key = (("round", s.get("_stream", 0), s["round"])
                   if "round" in s else ("step", 0, i))
            walls[key] = float(s["wall_ms"])
        if walls:
            vals = list(walls.values())
            label = ("batched-round wall"
                     if any(k[0] == "round" for k in walls) else "step wall")
            out.append(f"{label}: total {sum(vals) / 1e3:.3f}s  mean "
                       f"{sum(vals) / len(vals):.1f}ms  "
                       f"max {max(vals):.1f}ms")
        hists = [s["gmres_history"] for s in self.steps
                 if s.get("gmres_history")]
        if hists:
            last = hists[-1]
            rows = ", ".join(f"({int(it)}it {im:.1e}/{ex:.1e})"
                             for it, im, ex in last[-4:])
            out.append(f"last step's restart history "
                       f"(iters implicit/explicit): {rows}")
        out.append("")

    def render(self) -> str:
        out: list[str] = []
        if self.versions:
            vs = ", ".join(str(v) for v in sorted(self.versions,
                                                  key=lambda v: str(v)))
            out.append(f"telemetry version(s): {vs}")
            out.append("")
        self._span_section(out)
        self._device_phase_section(out)
        self._compile_section(out)
        self._fault_section(out)
        self._lane_section(out)
        self._scenario_section(out)
        self._flight_section(out)
        self._convergence_section(out)
        if self.torn_tails:
            out.append(f"({self.torn_tails} torn trailing line(s) ignored "
                       "— partial write, e.g. kill -9 mid-record)")
        if self.unparsed:
            out.append(f"({self.unparsed} unparseable line(s) skipped)")
        if not out:
            out.append("no telemetry or metrics records found")
        return "\n".join(out).rstrip() + "\n"


def summarize_files(paths) -> str:
    s = Summary()
    for p in paths:
        s.add_file(p)
    return s.render()
