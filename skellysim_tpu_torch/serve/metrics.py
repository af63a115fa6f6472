"""SLO counters for the service, folded from the telemetry events.

Counterpart of `skellysim_tpu.serve.metrics`: `/stats` keeps no second
bookkeeping path. Every number it reports is folded from the events the
tracer already carries (`obs.tracer`): ``lane`` events (admissions,
backfills with their ``queue_wait_s``, retirements, growth), ``span``
events named ``ensemble_step`` (a round's lanes and wall) and
``stream_frames`` (a drain's frames and latency), ``fault`` events and
``compile`` events. `StatsTracer` tees the stream into the `ServeMetrics`
accumulator and on to the ordinary sink, so a service's ``--trace-file``
renders under `obs.summarize` like an ensemble sweep's. The three latency
streams (admission wait, round wall, frame-stream drain) fold into
fixed-bucket `obs.hist.LogHistogram`s: p50 / p95 / p99 in bounded memory,
and `serve.protocol.render_prometheus` renders the same buckets.

**Zero compiles after warm, in the port.** The JAX gate counts XLA
compiles after warm-up; the port runs eagerly, so its counterpart is
stated on what the port builds at run time, the CUDA libraries:

* `SimulationServer.warmup()` runs one round's batched trial on each
  bucket's masked template lanes (the lanes' kernels launch and their
  libraries load), then calls `mark_warm()`;
* after that, ``compiles_after_warm`` counts every CUDA library built or
  loaded (`ops.cuda_build.load` emits one ``compile`` event each);
* every admission lands on a bucket built during warm-up (the server
  builds no bucket later), so a tenant never waits on a build.

The acceptance gate is ``compiles_after_warm == 0``.
"""

from __future__ import annotations

from typing import Optional

from ..obs import tracer as obs_tracer
from ..obs.hist import LogHistogram

#: the /stats SLO histogram inventory: name -> (lo, hi) seconds. One
#: place, so the stats payload, the prometheus rendering, and the tests
#: agree on the set.
SLO_HISTOGRAMS = {
    "admission_wait_s": (1e-4, 1e3),
    "round_wall_s": (1e-4, 1e3),
    "frame_stream_s": (1e-6, 1e2),
}


class ServeMetrics:
    """Accumulator of serving SLO counters (see `stats`)."""

    def __init__(self):
        self.admitted = 0          # lane seats (admit + backfill actions)
        self.retired = 0           # lanes freed, by reason
        self.retire_reasons: dict[str, int] = {}
        self.rejected = 0          # admission rejections (server increments)
        self.rounds = 0            # batched ensemble_step rounds
        self.round_wall_s = 0.0
        self.occupancy_sum = 0.0   # sum of live/lanes per round
        self.steps = 0             # member trial steps (live lanes x rounds)
        self.compiles = 0
        self.compiles_after_warm = 0
        self.warm = False
        self.frames_streamed: dict[str, int] = {}
        #: fault events by kind (`ev == "fault"`: lane_failed /
        #: dt_underflow / chaos_nan / frame_oversized / ...)
        self.faults: dict[str, int] = {}
        #: fault localization: the offender field of each fault event
        #: carrying anomaly provenance (``prov_field``: fiber_x /
        #: shell_density / ..., `obs.flight`), so /stats answers "what
        #: keeps blowing up" across tenants
        self.fault_fields: dict[str, int] = {}
        #: steps flagged loss_of_accuracy across every tenant (server
        #: increments via `note_loss_of_accuracy`)
        self.loss_of_accuracy_steps = 0
        #: DI capacity-growth reseats (lane ``growth`` events)
        self.growth_reseats = 0
        #: SLO latency distributions: fixed log buckets, bounded memory
        #: under unbounded traffic
        self.hists = {name: LogHistogram(lo, hi)
                      for name, (lo, hi) in SLO_HISTOGRAMS.items()}

    # ------------------------------------------------------------ ingest

    def observe(self, ev: str, fields: dict):
        """Fold one telemetry event (called by `StatsTracer.emit`)."""
        if ev == "lane":
            action = fields.get("action")
            if action in ("admit", "backfill"):
                self.admitted += 1
                if "queue_wait_s" in fields:
                    self.hists["admission_wait_s"].observe(
                        float(fields["queue_wait_s"]))
            elif action == "retire":
                self.retired += 1
                reason = fields.get("reason", "finished")
                self.retire_reasons[reason] = (
                    self.retire_reasons.get(reason, 0) + 1)
            elif action == "growth":
                # a DI tenant's nucleation outgrew its capacity bucket and
                # the lane is being reseated onto a larger one
                self.growth_reseats += 1
        elif ev == "span" and fields.get("name") == "ensemble_step":
            self.rounds += 1
            dur = float(fields.get("dur_s", 0.0))
            self.round_wall_s += dur
            self.hists["round_wall_s"].observe(dur)
            live = fields.get("live")
            lanes = fields.get("lanes")
            if live is not None and lanes:
                self.occupancy_sum += float(live) / float(lanes)
                self.steps += int(live)
        elif ev == "span" and fields.get("name") == "stream_frames":
            # the `stream` request's drain span: frame accounting AND the
            # frame-stream latency distribution from ONE event
            n = int(fields.get("frames", 0))
            tenant = fields.get("tenant")
            if n and tenant:
                self.frames_streamed[tenant] = (
                    self.frames_streamed.get(tenant, 0) + n)
            if n:
                self.hists["frame_stream_s"].observe(
                    float(fields.get("dur_s", 0.0)))
        elif ev == "compile":
            self.compiles += 1
            if self.warm:
                self.compiles_after_warm += 1
        elif ev == "fault":
            kind = fields.get("kind", "?")
            self.faults[kind] = self.faults.get(kind, 0) + 1
            if fields.get("prov_field"):
                f = str(fields["prov_field"])
                self.fault_fields[f] = self.fault_fields.get(f, 0) + 1

    def mark_warm(self):
        """Every bucket has run its warm-up round: from here on a compile
        event (a CUDA library built or loaded) is an SLO violation."""
        self.warm = True

    def note_rejected(self):
        self.rejected += 1

    def note_loss_of_accuracy(self):
        self.loss_of_accuracy_steps += 1

    # ------------------------------------------------------------ report

    def stats(self) -> dict:
        """The `/stats` response body (also the shape tests pin).

        The three SLO latency keys each carry
        ``{n, mean, max, p50, p95, p99}`` (`LogHistogram.summary`);
        ``histograms`` carries the full cumulative buckets for scrapers
        (`serve.protocol.render_prometheus`)."""
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "retired": self.retired,
            "retire_reasons": dict(self.retire_reasons),
            "rounds": self.rounds,
            "steps": self.steps,
            "steps_per_s": (self.steps / self.round_wall_s
                            if self.round_wall_s > 0 else 0.0),
            "round_wall_s": round(self.round_wall_s, 6),
            "mean_occupancy": (self.occupancy_sum / self.rounds
                               if self.rounds else 0.0),
            "admission_wait_s": self.hists["admission_wait_s"].summary(),
            "round_wall_s_hist": self.hists["round_wall_s"].summary(),
            "frame_stream_s": self.hists["frame_stream_s"].summary(),
            "histograms": {name: h.to_wire()
                           for name, h in self.hists.items()},
            "compiles": self.compiles,
            "compiles_after_warm": self.compiles_after_warm,
            "warm": self.warm,
            "faults": dict(self.faults),
            "fault_fields": dict(self.fault_fields),
            "loss_of_accuracy_steps": self.loss_of_accuracy_steps,
            "growth_reseats": self.growth_reseats,
            "frames_streamed": dict(self.frames_streamed),
            "frames_streamed_total": sum(self.frames_streamed.values()),
        }


class StatsTracer(obs_tracer.Tracer):
    """A `Tracer` that tees every event into a `ServeMetrics` accumulator.

    ``path=None`` keeps the ordinary in-memory event list (tests assert on
    it); a path appends telemetry JSONL exactly like any other tracer.
    """

    def __init__(self, metrics: ServeMetrics, path: Optional[str] = None):
        # set before super().__init__: the base constructor emits the
        # telemetry header through our emit()
        self.metrics = metrics
        super().__init__(path)

    def emit(self, ev: str, **fields):
        self.metrics.observe(ev, fields)
        super().emit(ev, **fields)
