"""Crash-safe write-ahead tenant journal for the service.

Counterpart of `skellysim_tpu.serve.journal`, in the same wire format, so
either package's server replays the other's journal. A SIGKILL of a
server must not lose its tenants: the server appends one entry (tenant
identity and a trajectory-v1 snapshot, the bytes `snapshot` requests and
``--resume`` consume) at every point tenant state becomes worth keeping:

* ``admit``: before the tenant is seated (write-ahead);
* ``checkpoint``: every ``[serve] journal_every`` rounds, one entry a
  seated tenant (a restart loses at most that many rounds);
* ``retire``: the terminal transition (finished / evicted / cancelled /
  dt_underflow / failed), with the final snapshot and the health verdict.

On restart `SimulationServer` replays the journal (`replay`), re-admits
every tenant whose last entry is live (queued / running) from its latest
snapshot, and restores terminal tenants' records.

Wire format: the length-prefixed msgpack framing of `serve.protocol`, one
frame an entry, appended and flushed each write. After a SIGKILL the OS
page cache still holds every flushed entry, so only a torn final frame is
possible and `replay` stops there.
"""

from __future__ import annotations

import os
from typing import Optional

from . import protocol

#: journal statuses considered live (re-admitted on recovery)
LIVE_STATES = ("queued", "running")


class TenantJournal:
    """Append-only journal at ``path`` (created, with parent dirs, on
    first use). ``truncate=True`` starts a fresh file — the
    compaction-on-recovery path (`SimulationServer` rewrites the replayed
    latest-entry-per-tenant set into a sibling file and atomically
    `os.replace`s it over the old journal, so a crash mid-compaction
    still finds a complete journal at ``path``).

    Growth bound: within one server lifetime the journal grows by one
    snapshot per seated tenant every `journal_every` rounds plus
    admit/retire entries — compaction happens at RESTART, not in-flight
    (an in-run compactor would have to quiesce appends; restart-time
    compaction keeps the event loop free). Size a long-lived server's
    journal disk for (live tenants) x (snapshot size) x (rounds /
    journal_every) between restarts, and pair terminal-record growth with
    `[serve] record_ttl_s`."""

    def __init__(self, path: str, *, truncate: bool = False):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "wb" if truncate else "ab")
        self._seq = 0

    def record(self, kind: str, tenant_id: str, *, bucket: int,
               t_final: float, status: str, frame: Optional[bytes] = None,
               health: int = 0, t: float = 0.0,
               flight: Optional[dict] = None):
        """Append one entry. ``frame`` is one trajectory-v1 snapshot (None
        only for terminal entries whose final frame is already journaled);
        ``flight`` is the flight recorder's blast-radius payload of a
        failed tenant (`obs.flight.failure_payload`), journaled so a
        restarted server still answers the fault's provenance on
        `status`."""
        entry = {
            "kind": kind, "tenant": tenant_id, "bucket": int(bucket),
            "t_final": float(t_final), "status": status, "t": float(t),
            "health": int(health), "seq": self._seq,
        }
        if frame is not None:
            entry["frame"] = bytes(frame)
        if flight is not None:
            entry["flight"] = flight
        self._seq += 1
        buf = protocol.pack_message(entry)
        self._fh.write(protocol.HEADER.pack(len(buf)) + buf)
        # flush to the OS: SIGKILL cannot lose page-cache data, so this is
        # the whole durability story short of power loss (fsync would
        # serialize the event loop on disk latency for no kill -9 benefit)
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replay(path: str) -> dict:
    """Journal file -> {tenant_id: last entry dict}, latest-wins.

    Entries keep the most recent ``frame`` seen for the tenant even when
    the last entry carries none (a terminal entry without a final frame
    falls back to the last checkpoint). Tolerates a torn final frame
    (crash mid-append) and a missing file (fresh journal) — both simply
    end the replay."""
    tenants: dict = {}
    if not os.path.exists(path):
        return tenants
    with open(path, "rb") as fh:
        while True:
            try:
                buf = protocol.read_frame(fh)
            except ValueError:
                break  # corrupt header: everything before it is intact
            if not buf:
                break
            try:
                entry = protocol.unpack_message(buf)
            except Exception:
                break  # torn msgpack tail
            if not isinstance(entry, dict) or "tenant" not in entry:
                continue
            tid = entry["tenant"]
            prev = tenants.get(tid)
            if prev is not None and "frame" not in entry:
                prev_frame = prev.get("frame")
                if prev_frame is not None:
                    entry = dict(entry, frame=prev_frame)
            tenants[tid] = entry
    return tenants
