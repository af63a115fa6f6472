"""The service's event loop: warm buckets, tenants joining between rounds.

Counterpart of `skellysim_tpu.serve.server`. `SimulationServer` composes
three subsystems into one long-lived process:

* the ensemble scheduler steps B lanes a bucket (on the card: kernels A-D
  over the member axis under "vmap", one member a launch under
  "unroll") and swaps members in and out between rounds
  (`ensemble.scheduler.EnsembleScheduler.admit` / `poll` / `evict`);
* the trajectory frames encode each tenant's frames and snapshots
  byte-compatible with every reader (`io.trajectory`);
* the telemetry stream carries the SLO numbers (`serve.metrics` folds the
  events `/stats` reports).

One thread, no locks: the socket loop answers whatever client requests
are pending (admission, streaming, snapshots, eviction), then runs one
batched round over every bucket with live lanes, then returns to the
sockets. Requests land at round boundaries, the only place the scheduler
allows lane churn, so a request waits at most one round.

Capacity buckets: each capacity is one `EnsembleScheduler` whose template
pads the base config's fibers to that capacity. `warmup()` runs one
round's batched trial on every bucket's template lanes before any tenant
arrives, so their kernels' libraries are loaded; a later ``compile``
event (a CUDA library built or loaded) counts in
`metrics.compiles_after_warm` (the port's meaning of the gate:
`serve.metrics`). The server runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..obs import tracer as obs_tracer
from . import protocol, tenants as tenants_mod
from .metrics import ServeMetrics, StatsTracer

logger = logging.getLogger("skellysim_tpu_torch")


class Bucket:
    """One capacity bucket: a padded template and its lanes.

    ``key`` (`system.buckets.BucketKey`) is the lanes' shape identity
    (per-group fiber and node capacities); admission tests scenes against
    it with `buckets.admits`. ``capacity`` is the total fiber-slot count
    (the wire's integer bucket id)."""

    def __init__(self, capacity: int, template, scheduler, key=None):
        self.capacity = capacity
        self.template = template
        self.scheduler = scheduler
        self.key = key
        self.warmed = False


class SimulationServer:
    """The serve core, socket-free: `handle_request` + `tick`.

    Tests drive these directly; `serve_forever` wraps them in the TCP event
    loop. ``config`` is the server's run-config TOML path (or a parsed
    `schema.Config` plus an explicit ``serve_cfg``): its fibers / params
    define the contract every tenant must match, its `[serve]` table sizes
    the service. ``device`` places every lane (None: the card).
    """

    def __init__(self, config, *, serve_cfg=None, trace_path: str = None,
                 config_dir: str = ".", warmup: bool = True, device=None):
        from ..builder import build_simulation
        from ..config import schema
        from ..ensemble.runner import EnsembleRunner
        from ..ensemble.scheduler import EnsembleScheduler

        runtime_cfg = None
        if isinstance(config, (str, os.PathLike)):
            if serve_cfg is None:
                serve_cfg = schema.load_serve_config(str(config))
            runtime_cfg = schema.load_runtime_config(str(config))
            config_dir = os.path.dirname(os.path.abspath(config)) or "."
            config = schema.load_config(str(config))
        elif serve_cfg is None:
            serve_cfg = schema.ServeConfig()
        self.base_config = config
        self.serve_cfg = serve_cfg
        self.metrics = ServeMetrics()
        self.tracer = StatsTracer(self.metrics, trace_path)
        self.registry = tenants_mod.TenantRegistry()
        self._shutdown = False
        self.address = None
        #: write-ahead tenant journal ([serve] journal_path;
        #: serve.journal) — None when journaling is off
        self.journal = None
        self._rounds_since_checkpoint = 0
        #: warm-up seconds by bucket capacity (`warmup`)
        self.warmup_s: dict = {}

        from ..fibers import container as fc
        from ..system import buckets as bucket_mod

        system, base_state, _ = build_simulation(
            config, config_dir=config_dir, synthesize_body_precompute=True,
            device=device)
        self.di_enabled = system.params.dynamic_instability.n_nodes > 0
        if self.di_enabled:
            # dynamic-instability serving: the base scene pre-allocates its
            # fiber capacity rung (fiber-less DI bases get the inert
            # placeholder group), so bucket templates carry the capacity
            # the device DI update flips masks over
            from ..scenarios import ensure_di_capacity

            base_state = ensure_di_capacity(base_state, system.params)
        if base_state.fibers is None:
            raise ValueError("serve needs a base config with fibers: they "
                             "define the compiled-program contract tenants "
                             "admit against")
        self.system = system
        # admission buckets derive from the shape policy ([runtime]
        # ladders of the server's config); [serve] bucket_capacities is
        # the manual single-resolution override
        self.policy = bucket_mod.BucketPolicy.from_runtime(runtime_cfg)
        # spectral grid rungs are plan data, not state shapes: they ride
        # the System (as in the CLIs)
        system.grid_ladder = self.policy.grid_ladder
        base_n = self._fiber_count(base_state)
        single = isinstance(base_state.fibers, fc.FiberGroup)
        caps = sorted(set(serve_cfg.bucket_capacities))
        if caps and not single:
            raise ValueError(
                "[serve] bucket_capacities applies to single-resolution "
                "base configs; a mixed-resolution base derives its one "
                "bucket from the [runtime] ladders")
        if caps and caps[0] < base_n:
            raise ValueError(
                f"[serve] bucket_capacities {caps} below the base config's "
                f"fiber count {base_n}; buckets PAD the base scene, so every "
                "capacity must be >= it")
        if not caps:
            if single:
                if (serve_cfg.bucket_count > 1
                        and not self.policy.fiber_ladder):
                    # identity policy: "the next rung" would be n+1, n+2...,
                    # one warm-up a single extra fiber slot
                    raise ValueError(
                        "[serve] bucket_count > 1 needs a fiber ladder to "
                        "take rungs from; set [runtime] bucket_ladder "
                        "(e.g. [-1] for the geometric ladder) or list "
                        "[serve] bucket_capacities explicitly")
                # bucket_count policy-ladder rungs, starting at the base
                # scene's own rung
                caps = [self.policy.fiber_capacity(base_n)]
                for _ in range(serve_cfg.bucket_count - 1):
                    caps.append(self.policy.fiber_capacity(caps[-1] + 1))
            else:
                caps = [None]   # one bucket at the tuple base's policy key
        self.buckets: list[Bucket] = []
        for cap in caps:
            template, key = bucket_mod.bucketize(
                base_state, self.policy, fiber_capacity=cap,
                pair_evaluator=system.params.pair_evaluator)
            runner = EnsembleRunner(system, batch_impl=serve_cfg.batch_impl)
            sched = EnsembleScheduler(
                runner, [], serve_cfg.max_lanes, template=template,
                writer=self._on_frame, metrics=self._on_sched_event,
                on_retire=self._on_retire, on_dt_underflow="retire",
                on_failure="retire", on_growth="retire")
            self.buckets.append(Bucket(
                sum(c for c, _ in key.fibers), template, sched, key=key))
        self.buckets.sort(key=lambda b: b.capacity)
        if warmup:
            self.warmup()
        if serve_cfg.journal_path:
            from .journal import TenantJournal

            # recover BEFORE opening for write: replay wants the file as
            # the dead server left it
            recovered = self._recover_from_journal(serve_cfg.journal_path)
            if len(self.registry):
                # COMPACT on recovery: rewrite latest-entry-per-tenant
                # (live tenants at their recovery snapshots, terminal ones
                # with their final frames) into a sibling file, then
                # atomically replace the old journal — unbounded append
                # growth resets at every restart, and a crash mid-compact
                # still finds the complete old journal in place. The open
                # fh keeps writing the replaced inode, which IS the file
                # now at journal_path.
                tmp = serve_cfg.journal_path + ".compact"
                self.journal = TenantJournal(tmp, truncate=True)
                live_frames = {t.tenant_id: f for t, f in recovered}
                for t in list(self.registry.values()):
                    if t.tenant_id in live_frames:
                        self._journal_record("checkpoint", t,
                                             frame=live_frames[t.tenant_id])
                    else:
                        self._journal_record("retire", t,
                                             frame=t.final_frame)
                os.replace(tmp, serve_cfg.journal_path)
                self.journal.path = serve_cfg.journal_path
            else:
                self.journal = TenantJournal(serve_cfg.journal_path)

    @staticmethod
    def _fiber_count(state) -> int:
        from ..fibers import container as fc

        return sum(g.n_fibers for g in fc.as_buckets(state.fibers))

    # ----------------------------------------------------------- warm path

    def warmup(self):
        """Run one round's batched trial on every bucket's template lanes
        (the idle lanes' states, whatever their t_final; the result is
        discarded and no lane advances), so each bucket's kernels launch
        and their libraries load, then arm the compiles-after-warm gate.
        Each bucket's seconds are `warmup_s`."""
        import time

        from ..ensemble.runner import lane_state, n_lanes

        with obs_tracer.use(self.tracer):
            for b in self.buckets:
                if not b.warmed:
                    t0 = time.perf_counter()
                    runner = b.scheduler.runner
                    states = b.scheduler.ens.states
                    lanes = list(range(n_lanes(states)))
                    runner._trial(lanes, [lane_state(states, i)
                                          for i in lanes])
                    if runner.system.device.type == "cuda":
                        import torch

                        torch.cuda.synchronize(runner.system.device)
                    self.warmup_s[b.capacity] = time.perf_counter() - t0
                    b.warmed = True
            self.metrics.mark_warm()
        logger.info("serve: %d bucket(s) warm (capacities %s, seconds %s)",
                    len(self.buckets), [b.capacity for b in self.buckets],
                    [round(self.warmup_s.get(b.capacity, 0.0), 3)
                     for b in self.buckets])

    def tick(self) -> bool:
        """One batched round over every bucket with live lanes; True when
        any stepping happened (the socket loop's idle signal)."""
        did = False
        with obs_tracer.use(self.tracer):
            for b in self.buckets:
                if b.scheduler.live:
                    b.scheduler.poll()
                    did = True
        if did and self.journal is not None:
            # journal checkpoint cadence: every journal_every rounds, one
            # snapshot per seated tenant — the bound on post-crash replay
            self._rounds_since_checkpoint += 1
            if self._rounds_since_checkpoint >= self.serve_cfg.journal_every:
                self._rounds_since_checkpoint = 0
                self._checkpoint_live()
        self._expire_records()
        return did

    def _expire_records(self):
        """Bounded tenant-record retention (`[serve] record_ttl_s`):
        terminal records expire `ttl` after retirement — a long-lived
        server under sustained traffic must not grow its registry (and the
        final-frame snapshots it holds) without bound. Runs on every tick
        AND every request, so idle servers expire too."""
        import time

        dead = self.registry.expire(self.serve_cfg.record_ttl_s,
                                    time.monotonic())
        for tid in dead:
            logger.info("serve: tenant record %s expired (record_ttl_s=%g)",
                        tid, self.serve_cfg.record_ttl_s)

    def any_live(self) -> bool:
        return any(b.scheduler.live for b in self.buckets)

    # --------------------------------------------- write-ahead journal

    def _journal_record(self, kind: str, tenant, *, frame=None):
        if self.journal is None:
            return
        self.journal.record(kind, tenant.tenant_id, bucket=tenant.bucket,
                            t_final=tenant.t_final, status=tenant.status,
                            frame=frame, health=tenant.health, t=tenant.t,
                            flight=tenant.flight)

    def _checkpoint_live(self):
        """One journal snapshot per seated tenant (queued tenants' admit
        snapshots are already current — they have not stepped)."""
        from ..ensemble.runner import lane_state

        for b in self.buckets:
            sched = b.scheduler
            for lane, ln in enumerate(sched.lanes):
                if ln is None:
                    continue
                t = self._tenant(ln.spec.member_id)
                if t is None:
                    continue
                state = lane_state(sched.ens.states, lane)
                frame = tenants_mod.state_snapshot(state,
                                                   rng_state=t.rng_state)
                self._journal_record("checkpoint", t, frame=frame)

    def _recover_from_journal(self, path: str) -> list:
        """Replay ``path`` and rebuild the tenant registry: live tenants
        re-admit from their latest snapshot (<= journal_every rounds of
        replay), terminal ones restore their record + final frame so
        clients can still fetch status/snapshot. Returns [(tenant,
        frame_bytes)] for the re-admitted set."""
        import time

        from ..ensemble.scheduler import MemberSpec
        from ..utils.rng import SimRNG
        from . import journal as journal_mod

        entries = journal_mod.replay(path)
        if not entries:
            return []
        recovered = []
        with obs_tracer.use(self.tracer):
            for tid, entry in entries.items():
                status = entry.get("status", "finished")
                frame = entry.get("frame")
                bucket = next((b for b in self.buckets
                               if b.capacity == entry.get("bucket")), None)
                tenant = tenants_mod.Tenant(
                    tenant_id=tid, bucket=int(entry.get("bucket", 0)),
                    t_final=float(entry.get("t_final", 0.0)),
                    t=float(entry.get("t", 0.0)),
                    health=int(entry.get("health", 0)),
                    # a failed tenant's blast radius survives the restart
                    # (journaled at retirement — `status` keeps answering
                    # the provenance after recovery)
                    flight=entry.get("flight"))
                live = (status in journal_mod.LIVE_STATES and frame
                        and bucket is not None)
                if live:
                    # one bad entry must not make the server UNBOOTABLE on
                    # its own journal (the exact outcome the WAL exists to
                    # prevent): a snapshot that no longer decodes against
                    # this server's template (scene config changed at the
                    # same capacity, bitrot) degrades to the terminal
                    # restore below, like the bucket-mismatch case
                    try:
                        state, rng_state = tenants_mod.state_from_snapshot(
                            bytes(frame), bucket.template)
                        # the wire carries no flight ring: arm the lanes'
                        state = self.system.ensure_flight(
                            tenants_mod.pad_state_to_capacity(
                                state, bucket.key))
                        mismatch = tenants_mod.bucket_mismatch(
                            bucket.template, state)
                        if mismatch:
                            raise ValueError(mismatch)
                        if self.di_enabled and not rng_state:
                            raise ValueError(
                                "DI tenant snapshot lacks rng_state")
                    except Exception as e:
                        logger.warning(
                            "serve: journal tenant %s snapshot does not "
                            "re-admit (%s) — restored as evicted", tid, e)
                        live = False
                if live:
                    tenant.rng_state = rng_state
                    tenant.t = float(state.time)
                    self.registry.add(tenant)
                    bucket.scheduler.admit(MemberSpec(
                        member_id=tid, state=state, t_final=tenant.t_final,
                        rng=(SimRNG.from_state(rng_state)
                             if rng_state else None)))
                    recovered.append((
                        tenant,
                        tenants_mod.state_snapshot(state,
                                                   rng_state=rng_state)))
                    logger.info("serve: tenant %s re-admitted from journal "
                                "(t=%.6g)", tid, tenant.t)
                else:
                    if status in journal_mod.LIVE_STATES:
                        # a live-status record we CANNOT re-admit (bucket
                        # capacities changed across the restart, the entry
                        # never carried a snapshot, or the snapshot failed
                        # to decode above): restoring it as "running"
                        # would leave a zombie no scheduler drives —
                        # clients polling wait()/status would hang on it
                        # forever. Terminal-evict instead; the last
                        # snapshot (if any) stays fetchable.
                        logger.warning(
                            "serve: journal tenant %s (bucket %s) not "
                            "re-admitted on buckets %s — restored as "
                            "evicted", tid, entry.get("bucket"),
                            [b.capacity for b in self.buckets])
                        tenant.status = "evicted"
                    else:
                        tenant.status = (status if status
                                         in tenants_mod.TENANT_STATES
                                         else "finished")
                    tenant.final_frame = bytes(frame) if frame else None
                    tenant.retired_at = time.monotonic()
                    self.registry.add(tenant)
            self.tracer.emit("journal", action="recover",
                             tenants=len(entries), live=len(recovered))
        logger.info("serve: journal recovery: %d record(s), %d live "
                    "tenant(s) re-admitted", len(entries), len(recovered))
        return recovered

    # ------------------------------------------------- scheduler callbacks

    def _tenant(self, member_id: str):
        return self.registry.get(member_id)

    def _on_frame(self, member_id: str, state, *, rng_state=None):
        t = self._tenant(member_id)
        if t is not None:
            t.frames.append(tenants_mod.state_snapshot(state,
                                                       rng_state=rng_state))
            t.frames_total += 1
            if rng_state is not None:
                # DI tenants advance their stream in-trace; keep the record
                # current so checkpoints/snapshots resume the exact counters
                t.rng_state = rng_state

    def _on_retire(self, member_id: str, state, reason: str, **extra):
        import time

        t = self._tenant(member_id)
        if extra.get("rng_state") is not None and t is not None:
            t.rng_state = extra["rng_state"]
        if reason == "growth":
            # not a terminal retirement: the tenant's nucleation outgrew
            # its capacity bucket; reseat onto the next bucket rung
            self._grow_tenant(member_id, state, extra)
            return
        if t is not None:
            t.final_frame = tenants_mod.state_snapshot(
                state, rng_state=t.rng_state)
            t.t = float(state.time)
            t.status = reason if reason in tenants_mod.TENANT_STATES \
                else "finished"
            t.health |= int(extra.get("health", 0))
            if extra.get("flight") is not None:
                # the flight recorder's blast radius (failed / dt_underflow
                # retires): the ring tail and provenance, on `status`
                t.flight = extra["flight"]
            t.retired_at = time.monotonic()   # [serve] record_ttl_s clock
            # terminal journal entry: the final snapshot + verdict, so a
            # restarted server still answers status/snapshot for this
            # tenant (and knows NOT to re-admit it)
            self._journal_record("retire", t, frame=t.final_frame)

    def _grow_tenant(self, member_id: str, state, extra: dict):
        """Reseat a DI tenant whose nucleation outgrew its bucket onto the
        next capacity bucket; with no larger bucket the tenant terminates
        as ``evicted`` (its current snapshot stays fetchable — resubmit it
        to a server with bigger buckets)."""
        import time

        from ..ensemble.scheduler import MemberSpec
        from ..system import buckets as bucket_mod
        from ..utils.rng import SimRNG

        t = self._tenant(member_id)
        if t is None:
            return
        nxt = next((b for b in self.buckets
                    if b.capacity > t.bucket
                    and bucket_mod.admits(b.key, state)), None)
        if nxt is None:
            self.tracer.emit("fault", kind="growth_overflow",
                             member=member_id, bucket=t.bucket)
            logger.warning(
                "serve: tenant %s outgrew the largest bucket (%d slots) — "
                "evicting with its current snapshot", member_id, t.bucket)
            t.status = "evicted"
            t.t = float(state.time)
            t.final_frame = tenants_mod.state_snapshot(
                state, rng_state=t.rng_state)
            t.retired_at = time.monotonic()
            self._journal_record("retire", t, frame=t.final_frame)
            return
        grown = bucket_mod.bucketize_to(state, nxt.key)
        old = t.bucket
        t.bucket = nxt.capacity
        rng = (SimRNG.from_state(t.rng_state) if t.rng_state else None)
        nxt.scheduler.admit(MemberSpec(member_id=member_id, state=grown,
                                       t_final=t.t_final, rng=rng))
        self._journal_record(
            "checkpoint", t,
            frame=tenants_mod.state_snapshot(grown, rng_state=t.rng_state))
        logger.info("serve: tenant %s reseated bucket %d -> %d",
                    member_id, old, nxt.capacity)

    def _on_sched_event(self, rec: dict):
        t = self._tenant(rec.get("member", ""))
        if t is None:
            return
        ev = rec.get("event")
        if ev == "start":
            t.status = "running"
        elif ev == "step":
            t.steps = int(rec["step"]) + 1
            t.t = float(rec["t"])
            # the per-step solver verdicts accumulate on the tenant record
            # and surface through `status` / `stats`
            t.health |= int(rec.get("health", 0))
            if rec.get("loss_of_accuracy"):
                t.loss_of_accuracy_steps += 1
                self.metrics.note_loss_of_accuracy()

    # ------------------------------------------------------------ requests

    def handle_request(self, req, conn=None) -> dict:
        """One request dict -> one response dict (never raises: admission
        rejections and malformed requests answer structured errors — one
        bad client must not kill the service)."""
        err = protocol.validate_request(req)
        if err:
            return protocol.error(err)
        self._expire_records()
        handler = getattr(self, f"_req_{req['type']}")
        try:
            with obs_tracer.use(self.tracer):
                return handler(req, conn)
        except Exception as e:  # defense for the event loop
            logger.exception("serve: %s request failed", req.get("type"))
            return protocol.error(f"{type(e).__name__}: {e}")

    def _req_submit(self, req, conn) -> dict:
        from ..builder import build_simulation
        from ..utils.rng import SimRNG

        if all(b.scheduler.live >= b.scheduler.batch
               and len(b.scheduler.queue) >= self.serve_cfg.queue_depth
               for b in self.buckets):
            # shed BEFORE the host-side scene build: a saturated server must
            # not pay build_simulation per rejected retry (overload is
            # exactly when the event loop can least afford it)
            self.metrics.note_rejected()
            return protocol.error(
                "admission queue full on every bucket — retry later",
                retry=True)
        try:
            cfg = tenants_mod.parse_tenant_config(req["config"],
                                                  di_enabled=self.di_enabled)
        except ValueError as e:
            self.metrics.note_rejected()
            return protocol.error(str(e))
        err = tenants_mod.check_params_contract(cfg.params,
                                                self.base_config.params)
        if err:
            self.metrics.note_rejected()
            return protocol.error(err)
        _, state, rng = build_simulation(cfg,
                                         synthesize_body_precompute=True,
                                         device=self.system.device)
        if self.di_enabled:
            # fiber-less DI scenes get the inert placeholder group (capacity
            # 1 here; bucketize_to below pads to the admitted bucket's)
            from ..scenarios import ensure_di_capacity

            try:
                state = ensure_di_capacity(state, self.system.params,
                                           capacity=1)
            except ValueError as e:
                self.metrics.note_rejected()
                return protocol.error(str(e))

        # capacity-bucket selection: smallest bucket whose key admits the
        # scene (per-group fiber AND node capacities — `buckets.admits`)
        from ..system import buckets as bucket_mod

        nearest = self.buckets[-1]
        bucket = next((b for b in self.buckets
                       if bucket_mod.admits(b.key, state)), None)
        if bucket is not None:
            try:
                state = bucket_mod.bucketize_to(state, bucket.key)
                if req.get("resume_frame") is not None:
                    # rebuild from the snapshot frame over the fresh state,
                    # then re-pad (frames carry ACTIVE fibers and LIVE node
                    # rows only); the frame's serialized RNG streams resume
                    # too, like cli's --resume
                    state, rng_state = tenants_mod.state_from_snapshot(
                        bytes(req["resume_frame"]), state)
                    if rng_state:
                        rng = SimRNG.from_state(rng_state)
                    state = self.system.ensure_flight(
                        bucket_mod.bucketize_to(state, bucket.key))
            except ValueError as e:
                bucket, mismatch = None, str(e)
            else:
                mismatch = tenants_mod.bucket_mismatch(
                    bucket.template, state,
                    nearest=nearest.key.describe())
        else:
            mismatch = (f"scene shape {bucket_mod.state_key(state).describe()}"
                        f" fits no bucket")
        if bucket is None or mismatch:
            self.metrics.note_rejected()
            # structured rejection: the nearest admissible bucket rides the
            # error payload so clients can resize / re-target
            return protocol.error(
                "no capacity bucket matches this scene: " + mismatch
                + f" (bucket capacities: {[b.capacity for b in self.buckets]})",
                nearest_bucket={
                    "capacity": nearest.capacity,
                    "bucket": nearest.key.describe(),
                    "fibers": [list(p) for p in nearest.key.fibers]})

        sched = bucket.scheduler
        if (sched.live >= sched.batch
                and len(sched.queue) >= self.serve_cfg.queue_depth):
            self.metrics.note_rejected()
            return protocol.error(
                f"admission queue full ({len(sched.queue)} waiting, "
                f"{sched.batch} lanes busy) — retry later", retry=True)

        tid = req.get("tenant") or self.registry.new_id()
        if self.registry.get(tid) is not None:
            self.metrics.note_rejected()
            return protocol.error(f"tenant id {tid!r} already exists")
        # explicit None check: a client-requested t_final of 0.0 means "admit
        # and stop immediately", not "use the config's"
        t_final = float(cfg.params.t_final if req.get("t_final") is None
                        else req["t_final"])
        tenant = tenants_mod.Tenant(
            tenant_id=tid, bucket=bucket.capacity, t_final=t_final,
            conn=conn, t=float(state.time),
            rng_state=rng.dump_state() if rng is not None else None)
        self.registry.add(tenant)
        # WRITE-AHEAD: journal the admission (with the admitted state as
        # the first snapshot) BEFORE seating — a crash from here on must
        # re-admit this tenant on restart
        self._journal_record(
            "admit", tenant,
            frame=tenants_mod.state_snapshot(state,
                                             rng_state=tenant.rng_state))
        if req.get("resume_frame") is None:
            # the initial-config frame, like a fresh CLI run (resumed
            # tenants skip it, like `--resume` appends)
            self._on_frame(tid, state, rng_state=tenant.rng_state)

        from ..ensemble.scheduler import MemberSpec

        lane = sched.admit(MemberSpec(member_id=tid, state=state,
                                      t_final=t_final, rng=rng))
        logger.info("serve: tenant %s -> bucket %d %s", tid, bucket.capacity,
                    f"lane {lane}" if lane is not None else "queued")
        return protocol.ok(tenant=tid, bucket=bucket.capacity,
                           status=tenant.status, lane=lane,
                           queued=lane is None)

    def _find(self, req):
        t = self.registry.get(req["tenant"])
        if t is None:
            return None, protocol.error(f"unknown tenant {req['tenant']!r}")
        return t, None

    def _bucket_of(self, tenant) -> Optional[Bucket]:
        """None for a journal-recovered tenant whose bucket no longer
        exists on this server (restored terminal — it holds no lane)."""
        return next((b for b in self.buckets
                     if b.capacity == tenant.bucket), None)

    def _req_status(self, req, conn) -> dict:
        from ..guard import verdict as _verdict

        t, err = self._find(req)
        if err:
            return err
        bucket = self._bucket_of(t)
        return protocol.ok(
            tenant=t.tenant_id, status=t.status, t=t.t, t_final=t.t_final,
            steps=t.steps,
            lane=(bucket.scheduler.lane_of(t.tenant_id)
                  if bucket is not None else None),
            bucket=t.bucket, frames_total=t.frames_total,
            frames_pending=len(t.frames),
            # solver health: the packed word and its decoded bit names,
            # plus the two flags of the metrics records
            health=t.health, verdict=_verdict.decode(t.health),
            loss_of_accuracy_steps=t.loss_of_accuracy_steps,
            dt_underflow=(t.status == "dt_underflow"
                          or bool(t.health & _verdict.DT_UNDERFLOW)),
            # the flight recorder's last-window tail and anomaly
            # provenance for failed tenants (None while healthy or with
            # the recorder off)
            flight=t.flight)

    def _req_stream(self, req, conn) -> dict:
        t, err = self._find(req)
        if err:
            return err
        limit = req.get("max_frames")
        # None = drain everything; an explicit 0 drains NOTHING (a client
        # probing eof/pending must not lose frames to a falsy check)
        limit = len(t.frames) if limit is None else int(limit)
        # the drain rides one `stream_frames` span: the frames-streamed
        # count and the frame-stream latency histogram both fold from it
        # (ServeMetrics.observe), and a --trace-file shows per-tenant
        # streaming under summarize
        with obs_tracer.span("stream_frames", tenant=t.tenant_id) as sp:
            frames = [t.frames.popleft()
                      for _ in range(min(limit, len(t.frames)))]
            t.frames_streamed += len(frames)
            sp.note(frames=len(frames))
        eof = (t.status not in ("queued", "running")) and not t.frames
        return protocol.ok(tenant=t.tenant_id, frames=frames, eof=eof,
                           pending=len(t.frames))

    def _req_snapshot(self, req, conn) -> dict:
        t, err = self._find(req)
        if err:
            return err
        bucket = self._bucket_of(t)
        # a recovered tenant whose bucket is gone holds no lane/queue slot;
        # its final_frame (if journaled) is still served below
        sched = bucket.scheduler if bucket is not None else None
        lane = sched.lane_of(t.tenant_id) if sched is not None else None
        t_now = t.t
        if lane is not None:
            from ..ensemble.runner import lane_state

            state = lane_state(sched.ens.states, lane)
            frame = tenants_mod.state_snapshot(state, rng_state=t.rng_state)
            t_now = float(state.time)
        elif t.final_frame is not None:
            frame = t.final_frame
        else:
            # queued: its initial frame is the snapshot
            for spec in (sched.queue if sched is not None else ()):
                if spec.member_id == t.tenant_id:
                    frame = tenants_mod.state_snapshot(
                        spec.state, rng_state=t.rng_state)
                    break
            else:
                return protocol.error(
                    f"tenant {t.tenant_id!r} has no snapshot yet")
        return protocol.ok(tenant=t.tenant_id, frame=frame, t=t_now,
                           status=t.status)

    def _req_cancel(self, req, conn) -> dict:
        t, err = self._find(req)
        if err:
            return err
        self._release(t, reason="cancelled")
        return protocol.ok(tenant=t.tenant_id, status=t.status)

    def _release(self, tenant, reason: str):
        """Free whatever the tenant holds (lane or queue slot); terminal
        states pass through untouched (incl. recovered tenants whose
        bucket no longer exists — they hold nothing to free)."""
        bucket = self._bucket_of(tenant)
        if bucket is None:
            return
        sched = bucket.scheduler
        lane = sched.lane_of(tenant.tenant_id)
        if lane is not None:
            sched.evict(lane, reason=reason)  # _on_retire stamps the status
        else:
            spec = sched.unqueue(tenant.tenant_id)
            if spec is not None:
                import time

                # a queued member's spec state IS its resume point — keep it
                # as the snapshot (resumed submits buffer no initial frame,
                # so dropping the spec here would lose the tenant entirely)
                tenant.final_frame = tenants_mod.state_snapshot(
                    spec.state, rng_state=tenant.rng_state)
                tenant.t = float(spec.state.time)
                tenant.status = reason
                tenant.retired_at = time.monotonic()
                self._journal_record("retire", tenant,
                                     frame=tenant.final_frame)

    def evict_conn(self, conn):
        """Graceful eviction on client disconnect: every tenant the
        connection owns frees its lane/queue slot, keeping its final
        snapshot for a later resume."""
        with obs_tracer.use(self.tracer):
            for t in self.registry.of_conn(conn):
                if t.status in ("queued", "running"):
                    logger.info("serve: evicting tenant %s (disconnect)",
                                t.tenant_id)
                    self._release(t, reason="evicted")

    def _req_stats(self, req, conn) -> dict:
        stats = self.metrics.stats()
        stats.update(
            tenants=len(self.registry),
            journal=bool(self.journal is not None),
            buckets=[{"capacity": b.capacity, "lanes": b.scheduler.batch,
                      "live": b.scheduler.live,
                      "queued": len(b.scheduler.queue),
                      "warmed": b.warmed} for b in self.buckets])
        return protocol.ok(stats=stats)

    def _req_chaos(self, req, conn) -> dict:
        """Fault injection (`guard.chaos`), config-gated: a production
        server rejects these outright."""
        if not self.serve_cfg.chaos_enabled:
            return protocol.error(
                "chaos requests are disabled ([serve] chaos_enabled)")
        action = req.get("action")
        if action == "nan_lane":
            from ..guard import chaos as chaos_mod

            if "tenant" not in req:
                return protocol.error("chaos action 'nan_lane' needs a "
                                      "tenant field")
            t, err = self._find(req)
            if err:
                return err
            bucket = self._bucket_of(t)
            if bucket is None:
                return protocol.error(
                    f"tenant {t.tenant_id!r} holds no lane on this server")
            try:
                lane = chaos_mod.nan_lane_of(bucket.scheduler, t.tenant_id)
            except ValueError as e:
                return protocol.error(str(e))
            self.tracer.emit("fault", kind="chaos_nan", tenant=t.tenant_id,
                             lane=lane)
            logger.warning("serve: CHAOS nan injected into tenant %s "
                           "(lane %d)", t.tenant_id, lane)
            return protocol.ok(tenant=t.tenant_id, lane=lane,
                               action=action)
        return protocol.error(f"unknown chaos action {action!r}; "
                              "valid actions: nan_lane")

    def _req_shutdown(self, req, conn) -> dict:
        self._shutdown = True
        return protocol.ok(shutdown=True)

    # ---------------------------------------------------------- socket loop

    def serve_forever(self, *, port_file: Optional[str] = None,
                      idle_wait_s: float = 0.05):
        """The TCP event loop (single thread): accept/read/answer pending
        client traffic, then run one batched round, repeat. Returns after a
        ``shutdown`` request."""
        import selectors
        import socket

        lsock = socket.create_server(
            (self.serve_cfg.host, self.serve_cfg.port))
        self.address = lsock.getsockname()
        if port_file:
            # atomic publish: spawners poll for this file to learn the port
            tmp = port_file + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(f"{self.address[1]}\n")
            os.replace(tmp, port_file)
        logger.info("serve: listening on %s:%d", *self.address[:2])
        lsock.setblocking(False)
        sel = selectors.DefaultSelector()
        sel.register(lsock, selectors.EVENT_READ)
        decoders: dict = {}
        try:
            while not self._shutdown:
                # step-bound request latency: zero timeout while simulations
                # are live (service sockets between rounds), short block when
                # fully idle
                for key, _ in sel.select(0.0 if self.any_live()
                                         else idle_wait_s):
                    if key.fileobj is lsock:
                        conn, addr = lsock.accept()
                        # bounded sends: a client that stops reading its
                        # responses (full TCP window) must not freeze the
                        # single-threaded loop — the timeout surfaces as
                        # OSError and drops only that connection
                        conn.settimeout(self.serve_cfg.send_timeout_s)
                        sel.register(conn, selectors.EVENT_READ)
                        decoders[conn] = protocol.FrameDecoder(
                            max_frame_bytes=self.serve_cfg.max_frame_bytes)
                        logger.info("serve: client %s connected", addr)
                    else:
                        self._service_conn(key.fileobj, decoders, sel)
                    if self._shutdown:
                        break
                if not self._shutdown:
                    self.tick()
        finally:
            for conn in list(decoders):
                self._drop_conn(conn, decoders, sel)
            sel.unregister(lsock)
            lsock.close()
            sel.close()
            if self.journal is not None:
                self.journal.close()
            self.tracer.close()

    def _drop_conn(self, conn, decoders, sel):
        self.evict_conn(conn)
        decoders.pop(conn, None)
        try:
            sel.unregister(conn)
        except KeyError:
            pass
        conn.close()

    def _service_conn(self, conn, decoders, sel):
        try:
            data = conn.recv(1 << 16)
        except (ConnectionError, OSError):
            data = b""
        if not data:
            self._drop_conn(conn, decoders, sel)
            return
        payloads = decoders[conn].feed(data)
        for payload in payloads:
            if isinstance(payload, protocol.OversizedFrame):
                # a hostile / corrupt header costs a structured error, not
                # the connection: the decoder skips the declared bytes and
                # resynchronizes
                self.tracer.emit("fault", kind="frame_oversized",
                                 size=payload.size,
                                 limit=self.serve_cfg.max_frame_bytes)
                logger.warning("serve: oversized frame header (%d bytes > "
                               "max_frame_bytes %d) — answered error, "
                               "connection kept", payload.size,
                               self.serve_cfg.max_frame_bytes)
                resp = protocol.error(
                    f"frame of {payload.size} bytes exceeds this server's "
                    f"max_frame_bytes ({self.serve_cfg.max_frame_bytes})",
                    oversized=True)
            elif not payload:
                # in-band goodbye (the listener protocol's terminate frame)
                self._drop_conn(conn, decoders, sel)
                return
            else:
                try:
                    req = protocol.unpack_message(payload)
                except Exception:
                    # garbled but well-framed bytes: structured error, the
                    # connection survives
                    self.tracer.emit("fault", kind="frame_undecodable",
                                     size=len(payload))
                    resp = protocol.error("undecodable msgpack request")
                else:
                    resp = self.handle_request(req, conn=conn)
            buf = protocol.pack_message(resp)
            try:
                conn.sendall(protocol.HEADER.pack(len(buf)) + buf)
            except (ConnectionError, OSError):
                self._drop_conn(conn, decoders, sel)
                return
