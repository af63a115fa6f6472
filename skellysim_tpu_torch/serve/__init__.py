"""The multi-tenant simulation service (`python -m skellysim_tpu_torch.serve`).

Counterpart of `skellysim_tpu.serve`: a long-lived server that keeps
capacity buckets of ensemble lanes warm and multiplexes many independent
client simulations onto them (tenant = lane). Layers:

* `protocol`: length-prefixed msgpack framing (shared with the listener)
  and the request / response schema (submit / status / stream / snapshot
  / cancel / stats / chaos / shutdown), with the Prometheus rendering;
* `tenants`: per-tenant lifecycle (admission against a bucket, snapshot /
  resume, eviction on disconnect);
* `server`: the event loop, client requests between batched rounds of the
  ensemble scheduler;
* `metrics`: SLO counters and latency histograms folded from the
  telemetry events (`obs.tracer`), reported by `/stats`;
* `journal`: the crash-safe write-ahead tenant journal, replayed on
  restart;
* `client`: `ServeClient` / `SpawnedServer`;
* `cli`: `python -m skellysim_tpu_torch.serve`.

`protocol` and `client` never touch a device; the other surfaces resolve
lazily on first use.
"""

from . import protocol  # noqa: F401


def __getattr__(name):
    if name in ("SimulationServer", "Bucket"):
        from . import server

        return getattr(server, name)
    if name in ("Tenant", "TenantRegistry"):
        from . import tenants

        return getattr(tenants, name)
    if name in ("ServeMetrics", "StatsTracer"):
        from . import metrics

        return getattr(metrics, name)
    if name in ("ServeClient", "SpawnedServer"):
        from . import client

        return getattr(client, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
