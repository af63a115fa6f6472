"""Wire protocol: length-prefixed msgpack framing and the request schema.

Counterpart of `skellysim_tpu.serve.protocol`, and the one source of the
framing the listener (`listener`) and its client
(`io.listener_client`) speak: a message is a little-endian u64 byte count
and then that many bytes of msgpack, the reference listener's protocol
(`src/core/listener.cpp:86-136`). Messages pack through the
port's own `io.msgpack_lite` (the card's machine need not have the
`msgpack` package), arrays in the reference's ``__eigen__`` encoding
(`io.eigen`), so that either package's side decodes the other's.

Frame semantics (the reference's):

* a ZERO-LENGTH frame is in-band control: "terminate" from a client,
  "invalid request" from a server;
* end of stream, at a frame boundary or inside one, means the peer went
  away (`read_frame` returns None, never raises).

The serve request schema (`REQUEST_FIELDS`, `make_request`,
`validate_request`) and the Prometheus rendering of `/stats`
(`render_prometheus`) are the JAX package's, for the simulation service
(`serve.server`).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..io import eigen, msgpack_lite

#: little-endian u64 frame header (`listener.cpp:92`)
HEADER = struct.Struct("<Q")

#: sanity bound on one frame (a corrupt/hostile header must not make a
#: server try to buffer exabytes); generous vs real payloads — a 10k-fiber
#: 32-node f64 frame is ~8 MB
MAX_FRAME_BYTES = 1 << 31


def _ndencode(obj):
    if isinstance(obj, np.ndarray):
        return eigen.pack_matrix(obj)
    return obj


def pack_message(obj) -> bytes:
    """Message dict -> msgpack bytes (ndarrays via the ``__eigen__`` wire
    encoding, like every trajectory payload)."""
    return msgpack_lite.packb(obj, default=_ndencode)


def unpack_message(buf: bytes) -> dict:
    """msgpack bytes -> message dict with ``__eigen__``/``__quat__`` wire
    payloads decoded back to arrays."""
    return eigen.decode_tree(msgpack_lite.unpackb(buf))


# ------------------------------------------------------------ stream framing

def write_frame(stream, payload: bytes) -> None:
    """One framed message (header + payload) to a file-like stream."""
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    stream.write(HEADER.pack(len(payload)))
    if payload:
        stream.write(payload)
    stream.flush()


def write_empty(stream) -> None:
    """The in-band zero-length frame (terminate / invalid-request)."""
    write_frame(stream, b"")


def read_frame(stream) -> Optional[bytes]:
    """One framed payload from a file-like stream.

    Returns the payload bytes (``b""`` for the in-band zero-length frame) or
    None when the peer closed the stream at a frame boundary or mid-frame —
    a disconnect is an expected event, not an exception."""
    hdr = stream.read(HEADER.size)
    if hdr is None or len(hdr) < HEADER.size:
        return None
    (size,) = HEADER.unpack(hdr)
    if size == 0:
        return b""
    if size > MAX_FRAME_BYTES:
        raise ValueError(f"incoming frame header claims {size} bytes "
                         f"(> MAX_FRAME_BYTES {MAX_FRAME_BYTES})")
    chunks = []
    remaining = size
    while remaining:
        chunk = stream.read(remaining)
        if not chunk:
            return None
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def write_message(stream, obj) -> None:
    write_frame(stream, pack_message(obj))


def read_message(stream) -> Optional[dict]:
    """One message from a stream; None on disconnect, ``{}``-falsy empty
    dict NEVER happens (a zero-length frame decodes to None too — callers
    that must distinguish control frames use `read_frame` directly, like
    `listener.serve`)."""
    buf = read_frame(stream)
    if not buf:
        return None
    return unpack_message(buf)


class OversizedFrame:
    """Sentinel yielded by `FrameDecoder.feed` for a frame whose header
    exceeds the decoder's byte bound: the server answers a structured
    error and the CONNECTION SURVIVES (the decoder consumes the frame's
    declared bytes as they arrive, then resynchronizes on the next
    header)."""

    __slots__ = ("size",)

    def __init__(self, size: int):
        self.size = size

    def __repr__(self):
        return f"OversizedFrame(size={self.size})"


class FrameDecoder:
    """Incremental framing for non-blocking sockets.

    ``feed(data)`` buffers arbitrary byte chunks and returns every COMPLETE
    frame payload they finish (zero-length control frames come back as
    ``b""``); partial frames stay buffered until the next feed. The serve
    event loop reads whatever a socket has ready and feeds it here — the
    blocking read loop of `read_frame`, inverted.

    A header claiming more than ``max_frame_bytes`` yields one
    `OversizedFrame` sentinel IMMEDIATELY (so the server can answer a
    structured error before the body even arrives) and puts the decoder
    into skip mode: the declared bytes are discarded as they stream in,
    after which framing resynchronizes. Note a GARBAGE byte stream whose
    fake header claims an astronomical size therefore parks the
    connection in skip mode — framing cannot resync inside arbitrary
    garbage — but the server stays up and the client gets the error
    reply, which is the robustness contract (docs/robustness.md).
    """

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self._buf = bytearray()
        self.max_frame_bytes = int(max_frame_bytes)
        #: bytes of the current oversized frame still to discard
        self._skip = 0
        #: oversized frames seen (telemetry/debugging)
        self.oversized = 0

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        frames: list = []
        while True:
            if self._skip:
                take = min(self._skip, len(self._buf))
                del self._buf[:take]
                self._skip -= take
                if self._skip:
                    return frames
            if len(self._buf) < HEADER.size:
                return frames
            (size,) = HEADER.unpack(self._buf[:HEADER.size])
            if size > self.max_frame_bytes:
                del self._buf[:HEADER.size]
                self._skip = size
                self.oversized += 1
                frames.append(OversizedFrame(size))
                continue
            if len(self._buf) < HEADER.size + size:
                return frames
            frames.append(bytes(self._buf[HEADER.size:HEADER.size + size]))
            del self._buf[:HEADER.size + size]


# ----------------------------------------------------------- request schema

#: request type -> (required fields, optional fields). The serve server
#: rejects anything else up front — a typo'd request must answer with a
#: structured error, not a stack trace mid-event-loop.
REQUEST_FIELDS = {
    # enter the admission queue: a full run-config TOML as text (the same
    # contract `skelly_config.toml` satisfies), optionally resuming from a
    # previously snapshotted trajectory frame
    "submit": (("config",), ("tenant", "t_final", "resume_frame")),
    # tenant lifecycle + progress counters
    "status": (("tenant",), ()),
    # drain the tenant's pending trajectory frames (raw trajectory-v1 bytes)
    "stream": (("tenant",), ("max_frames",)),
    # the tenant's CURRENT state as one trajectory frame (the exact resume
    # point — newer than its last dt_write frame)
    "snapshot": (("tenant",), ()),
    # free the tenant's lane (running) or queue slot (queued) now
    "cancel": (("tenant",), ()),
    # server-wide SLO counters (serve.metrics)
    "stats": ((), ()),
    # fault injection (guard.chaos; REFUSED unless the server config sets
    # [serve] chaos_enabled — a production server must not expose it).
    # action: "nan_lane" poisons the tenant's lane state between rounds
    "chaos": (("action",), ("tenant",)),
    # stop the event loop after answering
    "shutdown": ((), ()),
}

#: tenant lifecycle states (`serve.tenants`); ``failed`` = quarantined on
#: a terminal solver health verdict (the `status` response carries the
#: decoded verdict — docs/robustness.md)
TENANT_STATES = ("queued", "running", "finished", "evicted", "cancelled",
                 "dt_underflow", "failed")


def make_request(rtype: str, **fields) -> dict:
    """Validated request dict (the client-side constructor)."""
    req = {"type": rtype, **fields}
    err = validate_request(req)
    if err:
        raise ValueError(err)
    return req


def validate_request(req) -> Optional[str]:
    """None when ``req`` is a well-formed request, else the error text the
    server answers with."""
    if not isinstance(req, dict):
        return f"request must be a msgpack map, got {type(req).__name__}"
    rtype = req.get("type")
    if rtype not in REQUEST_FIELDS:
        return (f"unknown request type {rtype!r}; valid types: "
                + ", ".join(sorted(REQUEST_FIELDS)))
    required, optional = REQUEST_FIELDS[rtype]
    missing = [f for f in required if f not in req]
    if missing:
        return f"request {rtype!r} missing required field(s): {missing}"
    unknown = sorted(set(req) - {"type"} - set(required) - set(optional))
    if unknown:
        return f"request {rtype!r} has unknown field(s): {unknown}"
    return None


def ok(**fields) -> dict:
    return {"ok": True, **fields}


def error(message: str, **fields) -> dict:
    return {"ok": False, "error": message, **fields}


# -------------------------------------------------- prometheus exposition

#: scalar /stats counters exported to scrapers: stats key ->
#: (metric name, TYPE, HELP)
PROMETHEUS_COUNTERS = [
    ("admitted", "skellysim_serve_admitted_total", "counter",
     "lane seats granted (admit + backfill)"),
    ("rejected", "skellysim_serve_rejected_total", "counter",
     "admission rejections"),
    ("retired", "skellysim_serve_retired_total", "counter",
     "lanes freed"),
    ("rounds", "skellysim_serve_rounds_total", "counter",
     "batched ensemble rounds"),
    ("steps", "skellysim_serve_member_steps_total", "counter",
     "member trial steps (live lanes x rounds)"),
    ("compiles", "skellysim_serve_compiles_total", "counter",
     "program compiles"),
    ("compiles_after_warm", "skellysim_serve_compiles_after_warm_total",
     "counter", "warm-path retraces (SLO violation when > 0)"),
    ("frames_streamed_total", "skellysim_serve_frames_streamed_total",
     "counter", "trajectory frames streamed to clients"),
    ("loss_of_accuracy_steps", "skellysim_serve_loss_of_accuracy_total",
     "counter", "steps flagged loss_of_accuracy"),
    ("growth_reseats", "skellysim_serve_growth_reseats_total", "counter",
     "DI capacity-growth reseats"),
    ("tenants", "skellysim_serve_tenants", "gauge",
     "tenant records currently held"),
    ("mean_occupancy", "skellysim_serve_mean_occupancy", "gauge",
     "mean live/lanes per round"),
]

#: /stats histogram key -> prometheus metric name (obs.hist wire dicts)
PROMETHEUS_HISTOGRAMS = {
    "admission_wait_s": "skellysim_serve_admission_wait_seconds",
    "round_wall_s": "skellysim_serve_round_wall_seconds",
    "frame_stream_s": "skellysim_serve_frame_stream_seconds",
}


def render_prometheus(stats: dict) -> str:
    """A `/stats` response body -> Prometheus text exposition (the
    ``GET /metrics``-style page; `ServeClient.stats_prometheus` and
    ``python -m skellysim_tpu_torch.serve.client stats --prometheus``
    render it for scrapers). The JAX package's text, line for line."""
    from ..obs.hist import render_prometheus_histogram

    out = []
    for key, name, mtype, help_text in PROMETHEUS_COUNTERS:
        if key not in stats:
            continue
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        out.append(f"{name} {float(stats[key]):.6g}")
    for reason, count in sorted((stats.get("retire_reasons") or {}).items()):
        out.append('skellysim_serve_retired_by_reason_total'
                   f'{{reason="{reason}"}} {int(count)}')
    for kind, count in sorted((stats.get("faults") or {}).items()):
        out.append(f'skellysim_serve_faults_total{{kind="{kind}"}} '
                   f'{int(count)}')
    hists = stats.get("histograms") or {}
    for key, name in PROMETHEUS_HISTOGRAMS.items():
        if key in hists:
            out.extend(render_prometheus_histogram(
                name, hists[key],
                help_text=f"{key} distribution (log buckets)"))
    return "\n".join(out) + "\n"
