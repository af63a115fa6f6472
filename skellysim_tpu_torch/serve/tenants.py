"""Per-tenant lifecycle: admission, capacity buckets, snapshot/resume, eviction.

Counterpart of `skellysim_tpu.serve.tenants`. A tenant is one independent
client simulation on an ensemble lane (tenant = lane). This module owns
everything about a tenant except the stepping (`ensemble.scheduler`):

* **Admission**: a submitted config becomes a `SimState` only if it can
  ride a bucket the server warmed: its `Params` must equal the server's up
  to the per-member knobs (seed, t_final; the ensemble sweep CLI's
  contract), and its padded state must match a capacity bucket's template
  leaf for leaf (shapes, dtypes, device). Smaller scenes are padded with
  inert masked fibers (`system.buckets.bucketize_to`).
* **Snapshot/resume**: a tenant's state round-trips through one
  trajectory-v1 frame (`io.trajectory.frame_bytes` / `frame_to_state`),
  byte-compatible with ``--resume`` and every reader of either package.
* **Eviction**: a tenant whose client disconnects is retired; its final
  state is kept as the snapshot a reconnecting client resumes from.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from ..config import schema
from ..config.toml_io import loads as toml_loads
from . import protocol

#: tenant lifecycle states (mirrored in `protocol.TENANT_STATES`):
#: queued -> running -> finished | evicted | cancelled | dt_underflow
TENANT_STATES = protocol.TENANT_STATES


@dataclasses.dataclass
class Tenant:
    """One client simulation's service-side record."""

    tenant_id: str
    bucket: int                       # capacity (padded fiber count)
    t_final: float
    status: str = "queued"
    #: owning connection key (server-side); None for in-process tenants.
    #: Disconnect of this connection evicts the tenant.
    conn: Optional[object] = None
    t: float = 0.0
    steps: int = 0
    #: pending trajectory-v1 frame bytes, drained by ``stream`` requests
    frames: deque = dataclasses.field(default_factory=deque)
    frames_total: int = 0
    frames_streamed: int = 0
    #: final-state snapshot (one frame), captured at retire/evict
    final_frame: Optional[bytes] = None
    #: serialized RNG streams (SimRNG.dump_state) stamped into every frame/
    #: snapshot, so serve trajectories resume with RNG continuity like a
    #: CLI-written one (free-space tenants never advance the streams, so
    #: the admission-time dump stays current)
    rng_state: Optional[object] = None
    #: monotonic timestamp of entry into a terminal state (finished /
    #: evicted / cancelled / dt_underflow / failed) — the `[serve]
    #: record_ttl_s` retention clock; None while queued/running (never
    #: expires)
    retired_at: Optional[float] = None
    #: accumulated packed health word (`guard.verdict` bit layout), ORed
    #: over every step record + the terminal verdict; surfaced (with its
    #: decoded bit names) in `status` responses
    health: int = 0
    #: steps whose solve converged implicitly but drifted explicitly
    #: (Belos' loss-of-accuracy analogue), surfaced in `status`/`stats`
    loss_of_accuracy_steps: int = 0
    #: the flight recorder's blast radius, captured at a failed/underflowed
    #: retirement: ``{"tail": [decoded diagnostic rows...], "provenance":
    #: {field, fiber, node} | None}`` (`obs.flight.failure_payload`) —
    #: the trajectory into the fault + the first nonfinite's coordinates,
    #: surfaced on ``status`` responses; None while healthy or with the
    #: recorder off (Params.flight_window == 0)
    flight: Optional[dict] = None

    def snapshot_pending(self) -> int:
        return len(self.frames)


class TenantRegistry:
    """Id -> Tenant map with server-assigned ids and per-connection index."""

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}
        self._next = 0

    def new_id(self) -> str:
        # skip ids a client already claimed explicitly — the server must
        # never invent a collision and reject its own assignment
        while True:
            tid = f"t{self._next:04d}"
            self._next += 1
            if tid not in self._tenants:
                return tid

    def add(self, tenant: Tenant):
        if tenant.tenant_id in self._tenants:
            raise ValueError(f"tenant id {tenant.tenant_id!r} already exists")
        self._tenants[tenant.tenant_id] = tenant

    def get(self, tenant_id: str) -> Optional[Tenant]:
        return self._tenants.get(tenant_id)

    def of_conn(self, conn) -> list[Tenant]:
        """Tenants owned by one connection (the disconnect-eviction set)."""
        return [t for t in self._tenants.values() if t.conn is conn]

    def expire(self, ttl_s: float, now: float) -> list[str]:
        """Drop terminal records older than ``ttl_s`` (the `[serve]
        record_ttl_s` retention bound); returns the expired ids. ``ttl_s
        <= 0`` disables expiry; live (queued/running) tenants never
        expire — only `Tenant.retired_at` starts the clock."""
        if ttl_s <= 0:
            return []
        dead = [tid for tid, t in self._tenants.items()
                if t.retired_at is not None and now - t.retired_at >= ttl_s]
        for tid in dead:
            del self._tenants[tid]
        return dead

    def __len__(self):
        return len(self._tenants)

    def values(self):
        return self._tenants.values()


# ------------------------------------------------------------- admission

#: the one-compiled-program contract (shared with the ensemble sweep CLI —
#: ONE definition in `config.schema`)
normalized_params = schema.normalized_member_params


def parse_tenant_config(config_text: str, di_enabled: bool = False):
    """Submitted TOML text -> validated `schema.Config`.

    Serve tenants are free-space scenes (fibers, background, point
    sources) plus, on a dynamic-instability server, analytic bodies: a
    periphery needs a server-side precompute npz a wire submission cannot
    carry, but a sphere's or ellipsoid's quadrature is rebuilt by the
    server (`builder.build_bodies(synthesize_precompute=True)`), so DI
    tenants bring their nucleation bodies over the wire (with their sites
    embedded in the TOML: site generation is random and belongs
    client-side). Everything else is rejected up front with the JAX
    package's messages."""
    try:
        data = toml_loads(config_text)
    except Exception as e:
        raise ValueError(f"config TOML parse error: {e}") from None
    cfg = schema.config_from_data(data)
    if getattr(cfg, "periphery", None) is not None:
        raise ValueError(
            "serve tenants cannot use a periphery: its precompute npz lives "
            "server-side; run periphery scenes through the batch CLIs")
    if cfg.bodies and not di_enabled:
        raise ValueError(
            "serve tenants cannot use bodies on a server without dynamic "
            "instability: run body scenes through the batch CLIs (a "
            "[dynamic_instability] server admits analytic nucleation "
            "bodies — docs/scenarios.md)")
    for j, b in enumerate(cfg.bodies):
        if b.shape not in ("sphere", "ellipsoid"):
            raise ValueError(
                f"bodies[{j}]: serve tenants can only bring analytic "
                f"(sphere/ellipsoid) bodies, not {b.shape!r} — other "
                "surfaces need a server-side precompute npz")
        if b.n_nucleation_sites > 0 and not b.nucleation_sites:
            raise ValueError(
                f"bodies[{j}]: embed generated nucleation_sites in the "
                "config (site generation is random and must happen "
                "client-side so the submitted scene is deterministic)")
    if not cfg.fibers and not (di_enabled and cfg.bodies):
        raise ValueError("tenant config has no fibers")
    problems = cfg.validate()
    if problems:
        raise ValueError("invalid tenant config:\n  " + "\n  ".join(problems))
    return cfg


def check_params_contract(tenant_params: schema.Params,
                          server_params: schema.Params) -> Optional[str]:
    """None when the tenant can share the server's compiled program, else
    the rejection text naming every differing param."""
    tn, sn = normalized_params(tenant_params), normalized_params(server_params)
    if tn == sn:
        return None
    diffs = [f.name for f in dataclasses.fields(schema.Params)
             if getattr(tn, f.name) != getattr(sn, f.name)]
    return ("tenant params differ from the server's compiled program in "
            f"{diffs}; only params.seed/params.t_final may vary per tenant "
            "(one-compiled-program contract)")


def pad_state_to_capacity(state, capacity):
    """State padded onto its admission bucket (inert masked padding).

    ``capacity`` is either a `system.buckets.BucketKey` (the policy path:
    mixed-resolution tuples and masked node / shell axes through
    `buckets.bucketize_to`) or a plain int fiber capacity (one group)."""
    from ..fibers import container as fc
    from ..system import buckets as bucket_mod

    if isinstance(capacity, bucket_mod.BucketKey):
        return bucket_mod.bucketize_to(state, capacity)
    if state.fibers is None or not isinstance(state.fibers, fc.FiberGroup):
        return state
    if state.fibers.n_fibers >= capacity:
        return state
    return state._replace(fibers=fc.grow_capacity(state.fibers, capacity))


def bucket_mismatch(template_state, state,
                    nearest: Optional[str] = None) -> Optional[str]:
    """None when ``state``'s tensors match the bucket template's shapes,
    dtypes and device (admissible), else the mismatch text: the ensemble
    runner's member check, the same predicate that guards `set_lane`.
    ``nearest`` (a bucket description from `BucketKey.describe`) is
    appended as the next step to take."""
    from ..ensemble.runner import _check_member

    try:
        _check_member(0, template_state, state)
    except ValueError as e:
        msg = str(e)
        if nearest:
            msg += f"; nearest admissible bucket: {nearest}"
        return msg
    return None


def state_snapshot(state, rng_state=None) -> bytes:
    """One trajectory-v1 frame of ``state`` — the tenant snapshot format."""
    from ..io.trajectory import frame_bytes

    return frame_bytes(state, rng_state=rng_state)


def state_from_snapshot(frame_buf: bytes, template_state):
    """Snapshot frame bytes -> (SimState, rng_state) over a bucket template
    (the resume half; the wire twin of `io.trajectory.resume_state`)."""
    from ..io.trajectory import frame_to_state

    frame = protocol.unpack_message(frame_buf)
    if not isinstance(frame, dict) or "time" not in frame:
        raise ValueError("resume_frame is not a trajectory-v1 frame")
    return frame_to_state(frame, template_state), frame.get("rng_state")
