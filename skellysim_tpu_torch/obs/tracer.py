"""Span tracer: one JSONL event stream for runtime telemetry.

Counterpart of `skellysim_tpu.obs.tracer`: `System.run`, the ensemble
scheduler, the scenario sweep, the service (`serve`) and the CUDA library
loader (`ops.cuda_build`) emit through the same process-wide tracer, so
`obs.summarize` renders run metrics, lane churn and compile events from
one format. The event schema and `TELEMETRY_VERSION` are the JAX
package's; either package's stream renders under either summarize.

* **Inert when off.** The module-level `span()` / `emit()` consult the
  active tracer once and do nothing without one: instrumented code never
  branches, and with no tracer a span makes no host sync.
* **Device work in a span.** CUDA launches return before the card
  finishes, so a span that should absorb its device work registers the
  tensors it produced with ``sp.sync(tensors)``: at exit, and only while
  a tracer is active, the span synchronizes those tensors' card
  (`torch.cuda.synchronize`), so its ``dur_s`` covers the device
  execution. This is the counterpart of the JAX package's
  ``jax.block_until_ready``.

Event lines are JSON objects with ``ev`` (kind), ``ts`` (monotonic
seconds, deltas only), ``pid`` and ``host``. Kinds: ``telemetry`` (the
stream header, with ``version`` and `provenance`), ``span`` (``name``,
``path`` = the slash-joined stack of open spans, ``dur_s`` and the
caller's fields) and whatever callers pass to `emit` (``lane``, ``fault``,
``flight``, ``compile``, ``journal``).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Optional

#: version stamp of the event schema (the JAX package's)
TELEMETRY_VERSION = 1


def provenance(downscaled=None) -> dict:
    """The self-description stamp of a stream: ``torch_version``,
    ``cuda_version`` and ``device_kind`` (the first card's name, None
    without one), plus ``downscaled`` when the caller states it. Reads
    ``sys.modules`` rather than importing, like the JAX package's."""
    import sys

    torch = sys.modules.get("torch")
    info = {"torch_version": getattr(torch, "__version__", None),
            "cuda_version": (getattr(torch.version, "cuda", None)
                             if torch is not None else None)}
    kind = None
    if torch is not None:
        try:
            if torch.cuda.is_available():
                kind = torch.cuda.get_device_name(0)
        except Exception:
            kind = None
    info["device_kind"] = kind
    if downscaled is not None:
        info["downscaled"] = bool(downscaled)
    return info


def _sync_devices(tensors) -> None:
    """Synchronize every card that holds one of ``tensors`` (a tensor or a
    nested tuple / list / dict of them; other leaves are ignored)."""
    import torch

    seen, stack = set(), [tensors]
    while stack:
        obj = stack.pop()
        if torch.is_tensor(obj):
            if obj.device.type == "cuda" and obj.device not in seen:
                seen.add(obj.device)
                torch.cuda.synchronize(obj.device)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (tuple, list)):
            stack.extend(obj)


class _Span:
    """Handle yielded by `Tracer.span`: attach fields and tensors to
    synchronize at exit."""

    __slots__ = ("fields", "_sync")

    def __init__(self):
        self.fields = {}
        self._sync = None

    def note(self, **fields):
        """Attach fields to the span event emitted at exit."""
        self.fields.update(fields)

    def sync(self, tensors):
        """Register ``tensors`` to synchronize at span exit, so the device
        work producing them counts in THIS span (returns them unchanged).
        The inert span of an inactive tracer ignores them."""
        self._sync = tensors
        return tensors


class Tracer:
    """Append telemetry events to a JSONL file (or an in-memory list).

    ``path=None`` keeps events in ``self.events``. File mode appends and
    flushes each event, so a crashed run keeps every event up to the
    crash.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.events = [] if path is None else None
        self._fh = open(path, "a") if path else None
        self._stack: list[str] = []
        self._pid = os.getpid()
        try:
            self._host = socket.gethostname()
        except Exception:
            self._host = "unknown"
        self.emit("telemetry", version=TELEMETRY_VERSION, **provenance())

    def emit(self, ev: str, **fields):
        rec = {"ev": ev, "ts": round(time.perf_counter(), 6),
               "pid": self._pid, "host": self._host}
        rec.update(fields)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        elif self.events is not None:
            self.events.append(rec)

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Nestable timed scope; emits one ``span`` event at exit whose
        ``dur_s`` includes the synchronization of any registered
        tensors."""
        sp = _Span()
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            try:
                if sp._sync is not None:
                    _sync_devices(sp._sync)
            finally:
                dur = time.perf_counter() - t0
                path = "/".join(self._stack)
                self._stack.pop()
                self.emit("span", name=name, path=path,
                          dur_s=round(dur, 6), **{**fields, **sp.fields})

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: the process-wide active tracer (None: telemetry off)
_ACTIVE: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    return _ACTIVE


@contextlib.contextmanager
def use(tracer: Optional[Tracer]):
    """Install ``tracer`` as the active tracer for the block (None keeps
    telemetry off)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = prev


_NULL_SPAN = _Span()


@contextlib.contextmanager
def _null_span():
    # note() / sync() write into a shared throwaway that nobody reads
    _NULL_SPAN.fields.clear()
    _NULL_SPAN._sync = None
    yield _NULL_SPAN


def span(name: str, **fields):
    """`Tracer.span` on the active tracer, or an inert span (no event, no
    sync) when telemetry is off."""
    tr = _ACTIVE
    if tr is None:
        return _null_span()
    return tr.span(name, **fields)


def emit(ev: str, **fields):
    """`Tracer.emit` on the active tracer; nothing when telemetry is off."""
    tr = _ACTIVE
    if tr is not None:
        tr.emit(ev, **fields)
