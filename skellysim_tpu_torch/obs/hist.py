"""Fixed-bucket log-scale latency histograms.

Counterpart of `skellysim_tpu.obs.hist`, with the same bucket edges,
percentile read-out and Prometheus rendering. The serving SLO story needs
distributions, not means: "mean admission wait 80 ms" hides the p99
tenant that waited 4 s. `LogHistogram` is the smallest structure that
answers p50/p95/p99 under continuous ingest:

* fixed geometric bucket edges (``lo * ratio^k`` up to ``hi``, default 8
  buckets/decade) — O(1) observe, O(buckets) percentile, bounded memory
  forever (a `/stats` accumulator must not grow with traffic);
* percentile read-out by geometric interpolation inside the covering
  bucket — relative error bounded by one bucket ratio (~33% at
  8/decade), held against the JAX package's in tests/test_torch_tracer.py;
* Prometheus-compatible cumulative rendering (`buckets()` yields
  ``(le, cumulative_count)`` with the ``+Inf`` terminal), consumed by
  `serve.protocol.render_prometheus` for scrape endpoints.

Import-light like the tracer: `serve.metrics` folds tracer events into
these on the event loop's hot path.
"""

from __future__ import annotations

import math


class LogHistogram:
    """Log-scale histogram over positive values (seconds, typically).

    ``lo``/``hi`` bound the resolved range: values below ``lo`` land in
    the underflow bucket (upper edge ``lo``), values at/above ``hi`` in
    the overflow bucket (edge ``+Inf``). ``per_decade`` sets resolution.
    """

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 per_decade: int = 8):
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_decade = int(per_decade)
        n = int(math.ceil(math.log10(hi / lo) * per_decade))
        #: bucket upper edges: [lo * r^1 ... >= hi], preceded by the
        #: underflow edge lo and followed by +Inf
        self.edges = [lo * 10.0 ** ((k + 1) / per_decade)
                      for k in range(n)]
        # counts[0] = (0, lo]; counts[1 + k] = (edge_{k-1}, edge_k];
        # counts[-1] = overflow
        self.counts = [0] * (n + 2)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    # -------------------------------------------------------------- ingest

    def observe(self, value: float) -> None:
        v = float(value)
        if not (v >= 0.0) or math.isinf(v):   # NaN/negative/inf -> clamp
            v = 0.0 if not (v >= 0.0) else self.hi
        self.n += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= self.lo:
            self.counts[0] += 1
        elif v >= self.hi:
            self.counts[-1] += 1
        else:
            k = int(math.log10(v / self.lo) * self.per_decade)
            k = min(max(k, 0), len(self.edges) - 1)
            # float rounding at an edge: keep the invariant v <= edge[k]
            while k + 1 < len(self.edges) and v > self.edges[k]:
                k += 1
            self.counts[1 + k] += 1

    # ------------------------------------------------------------- readout

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by geometric
        interpolation within the covering bucket; 0.0 when empty."""
        if self.n == 0:
            return 0.0
        rank = q / 100.0 * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo_edge = (0.0 if i == 0
                       else self.lo if i == 1
                       else self.edges[i - 2])
            hi_edge = (self.lo if i == 0
                       else self.edges[i - 1] if i - 1 < len(self.edges)
                       else self.max)
            if cum + c >= rank:
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                lo_e = max(lo_edge, self.min if i <= 1 else lo_edge,
                           1e-12)
                hi_e = max(min(hi_edge, self.max), lo_e)
                return lo_e * (hi_e / lo_e) ** frac
            cum += c
        return self.max

    def quantiles(self) -> dict:
        return {"p50": self.percentile(50.0), "p95": self.percentile(95.0),
                "p99": self.percentile(99.0)}

    def summary(self) -> dict:
        """The `/stats` SLO block: counts + moments + percentiles."""
        out = {"n": self.n, "mean": (self.sum / self.n) if self.n else 0.0,
               "max": self.max if self.n else 0.0}
        out.update(self.quantiles())
        return out

    def buckets(self) -> list:
        """Prometheus-style cumulative ``[(le, cumulative_count)]`` with
        the terminal ``("+Inf", n)``; only edges up to the last occupied
        bucket are listed (plus +Inf), keeping wire payloads small."""
        out = []
        cum = 0
        last_occupied = max((i for i, c in enumerate(self.counts) if c),
                            default=-1)
        for i, c in enumerate(self.counts[:-1]):
            cum += c
            if i > last_occupied:
                break
            edge = self.lo if i == 0 else self.edges[i - 1]
            out.append((edge, cum))
        out.append(("+Inf", self.n))
        return out

    def to_wire(self) -> dict:
        """msgpack/JSON-safe dict for the stats response (`from_wire`
        round-trips it client-side for prometheus rendering)."""
        return {"summary": self.summary(),
                "sum": self.sum,
                "buckets": [[le, c] for le, c in self.buckets()]}


def render_prometheus_histogram(name: str, wire: dict,
                                help_text: str = "") -> list:
    """Prometheus exposition lines for one `LogHistogram.to_wire` dict."""
    out = []
    if help_text:
        out.append(f"# HELP {name} {help_text}")
    out.append(f"# TYPE {name} histogram")
    for le, c in wire.get("buckets", []):
        le_s = "+Inf" if le == "+Inf" else f"{float(le):.6g}"
        out.append(f'{name}_bucket{{le="{le_s}"}} {int(c)}')
    summary = wire.get("summary", {})
    out.append(f"{name}_sum {float(wire.get('sum', 0.0)):.6g}")
    out.append(f"{name}_count {int(summary.get('n', 0))}")
    return out
