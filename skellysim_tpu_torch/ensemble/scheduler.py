"""Continuous-batching scheduler: queue -> lanes -> retire -> backfill.

Counterpart of `skellysim_tpu.ensemble.scheduler`: a fixed number of lanes
B, a work queue of pending members, and a drain loop that steps the batch
(`runner.EnsembleRunner`), writes each member's trajectory frames at
dt_write boundaries, retires members that reach their ``t_final`` and
backfills freed lanes from the queue (`runner.set_lane`). Record kinds and
keys are the JAX package's ("start", "step", "retire", "dt_underflow",
"failed", "growth"; `io.ensemble_io`). With ``Params.flight_window > 0``
each step record's ``flight`` is the member's decoded flight row and a
``failed`` / ``dt_underflow`` record's the ring's tail and provenance
(`obs.flight.failure_payload`); the rings are read once a round. The
telemetry events are the JAX package's (`obs.tracer`): ``lane`` admit /
backfill (with ``queue_wait_s``), retire and growth, ``fault``
``lane_failed`` / ``dt_underflow``, ``flight``, and one
``ensemble_step`` span a round (``round``, ``live``, ``lanes``), which
covers the round's device work (the runner reads its outcomes on the
host).
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from collections import deque
from typing import Callable, Optional

from ..guard import verdict as _verdict
from ..obs import flight as flight_mod
from ..obs import tracer as obs_tracer
from ..system.system import SimState, crossed_write_boundary
from ..utils.rng import SimRNG
from .runner import EnsembleRunner, lane_state, rng_carry, set_lane

logger = logging.getLogger("skellysim_tpu_torch")

#: t_final of an empty lane: `time < -inf` never holds, so idle lanes are
#: inert until the queue refills them
IDLE_T_FINAL = float("-inf")


def _fiber_capacity(state) -> int:
    """Fiber slots of a member state (the growth record's capacity)."""
    from ..fibers import container as fc

    return sum(g.n_fibers for g in fc.as_buckets(state.fibers))


@dataclasses.dataclass
class MemberSpec:
    """One queued simulation: initial state, end time, and an optional RNG
    (`SimRNG.member(i)`) whose dump rides in the member's frames."""

    member_id: str
    state: SimState
    t_final: float
    rng: Optional[SimRNG] = None
    #: perf_counter time of queue entry (stamped by the scheduler when
    #: absent): a start record's ``queue_wait_s`` is measured from it
    enqueued_at: Optional[float] = None


@dataclasses.dataclass
class _Lane:
    spec: MemberSpec
    steps: int = 0       # trial steps taken (accepted + rejected)
    frames: int = 0      # frames written (excluding the initial frame)
    t: float = 0.0       # entry time of the NEXT trial
    dt: float = 0.0      # entry dt of the NEXT trial


class EnsembleScheduler:
    """Drain a member queue through B lanes (the JAX package's
    `EnsembleScheduler`, whose docstring gives every option):
    ``writer(member_id, state, rng_state=None)`` receives each crossed
    frame, ``metrics`` one dict a record; ``on_dt_underflow`` /
    ``on_failure`` / ``on_growth`` choose "raise" or "retire" for a frozen
    lane; ``template`` allows an initially empty scheduler;
    ``on_retire(member_id, state, reason, **extra)`` receives a member's
    final state before its lane is freed."""

    def __init__(self, runner: EnsembleRunner, members, batch: int, *,
                 writer: Optional[Callable] = None,
                 metrics: Optional[Callable] = None,
                 step_fn: Optional[Callable] = None,
                 write_initial_frames: bool = False,
                 on_dt_underflow: str = "raise",
                 on_failure: str = "raise",
                 on_growth: str = "raise",
                 max_rounds: Optional[int] = None,
                 template: Optional[SimState] = None,
                 on_retire: Optional[Callable] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        for name, v in (("on_dt_underflow", on_dt_underflow),
                        ("on_failure", on_failure),
                        ("on_growth", on_growth)):
            if v not in ("raise", "retire"):
                raise ValueError(f"unknown {name} {v!r}; use 'raise' or "
                                 "'retire'")
        members = list(members)
        if not members and template is None:
            raise ValueError("ensemble needs at least one member (or a "
                             "template= state for an initially-empty service)")
        self.runner = runner
        self.batch = batch
        self.queue = deque()
        self.writer = writer
        self.metrics = metrics
        self.step_fn = step_fn or runner.step
        self.write_initial_frames = write_initial_frames
        self.on_dt_underflow = on_dt_underflow
        self.on_failure = on_failure
        self.on_growth = on_growth
        self.on_retire = on_retire
        self.max_rounds = max_rounds
        self.rounds = 0
        self.retired: list = []
        self._template = (template if template is not None
                          else members[0].state)
        self.lanes: list = [None] * batch
        self.ens = runner.make_ensemble([self._template] * batch,
                                        [IDLE_T_FINAL] * batch)
        for spec in members:
            self.admit(spec)

    # ----------------------------------------------------------- lane churn

    def _emit(self, record: dict):
        if self.metrics is not None:
            self.metrics(record)

    @staticmethod
    def _rng_state(spec: MemberSpec):
        return spec.rng.dump_state() if spec.rng is not None else None

    def _start_member(self, lane: int, spec: MemberSpec):
        # a state decoded from a frame carries no ring: arm it like the lanes
        spec.state = self.runner.system.ensure_flight(spec.state)
        if self.runner.di_enabled and spec.rng is None:
            raise ValueError(
                f"member {spec.member_id}: dynamic-instability members need "
                "a per-member SimRNG (SimRNG(seed).member(i)): the device "
                "DI update draws from its distributed stream")
        t_final = self.ens.t_final.copy()
        t_final[lane] = spec.t_final
        di_rng = self.ens.di_rng
        if self.runner.di_enabled:
            di_rng = di_rng.copy()
            di_rng[lane] = rng_carry(spec.rng)
        self.ens = self.ens._replace(
            states=set_lane(self.ens.states, lane, spec.state),
            t_final=t_final, di_rng=di_rng)
        self.lanes[lane] = _Lane(spec=spec, t=float(spec.state.time),
                                 dt=float(spec.state.dt))
        wait_s = (max(0.0, _time.perf_counter() - spec.enqueued_at)
                  if spec.enqueued_at is not None else 0.0)
        # "admit" seats a member before the first round, "backfill"
        # refills a lane freed mid-drain
        obs_tracer.emit("lane",
                        action="admit" if self.rounds == 0 else "backfill",
                        lane=lane, member=spec.member_id,
                        queue_wait_s=round(wait_s, 6))
        self._emit({"event": "start", "member": spec.member_id, "lane": lane,
                    "t": float(spec.state.time), "t_final": spec.t_final,
                    "queue_wait_s": round(wait_s, 6)})
        if self.write_initial_frames and self.writer is not None:
            self.writer(spec.member_id, spec.state,
                        rng_state=self._rng_state(spec))
        logger.info("ensemble start member=%s lane=%d t_final=%g",
                    spec.member_id, lane, spec.t_final)

    def _retire_member(self, lane: int, reason: str = "finished",
                       final_state=None, extra: Optional[dict] = None):
        ln = self.lanes[lane]
        extra = extra or {}
        if self.on_retire is not None:
            if final_state is None:
                final_state = lane_state(self.ens.states, lane)
            self.on_retire(ln.spec.member_id, final_state, reason,
                           rng_state=self._rng_state(ln.spec), **extra)
        obs_tracer.emit("lane", action="retire", lane=lane,
                        member=ln.spec.member_id, reason=reason,
                        steps=ln.steps, **extra)
        self._emit({"event": "retire" if reason == "finished" else reason,
                    "member": ln.spec.member_id, "lane": lane, "t": ln.t,
                    "steps": ln.steps, "frames": ln.frames, **extra})
        logger.info("ensemble retire member=%s lane=%d t=%.6g steps=%d (%s)",
                    ln.spec.member_id, lane, ln.t, ln.steps, reason)
        self.retired.append(ln.spec.member_id)
        if (self.writer is not None and hasattr(self.writer, "close_member")
                and reason != "growth"):
            # a growth reseat keeps streaming to the same file
            self.writer.close_member(ln.spec.member_id)
        self.lanes[lane] = None
        t_final = self.ens.t_final.copy()
        t_final[lane] = IDLE_T_FINAL
        self.ens = self.ens._replace(t_final=t_final)
        if self.queue:
            self._start_member(lane, self.queue.popleft())

    # -------------------------------------------------- incremental service

    def admit(self, spec: MemberSpec):
        """Enqueue one member and seat it at once when a lane is free;
        returns its lane, or None when it queued."""
        if spec.enqueued_at is None:
            spec.enqueued_at = _time.perf_counter()
        self.queue.append(spec)
        seated = None
        for lane in range(self.batch):
            if not self.queue:
                break
            if self.lanes[lane] is None:
                nxt = self.queue.popleft()
                self._start_member(lane, nxt)
                if nxt is spec:
                    seated = lane
        return seated

    def evict(self, lane: int, reason: str = "evicted") -> SimState:
        """Free an occupied lane and return the member's current state."""
        if not 0 <= lane < self.batch or self.lanes[lane] is None:
            raise ValueError(f"evict: lane {lane} is not occupied")
        state = lane_state(self.ens.states, lane)
        self._retire_member(lane, reason=reason, final_state=state)
        return state

    def lane_of(self, member_id: str):
        """Lane index running ``member_id``, or None."""
        for lane, ln in enumerate(self.lanes):
            if ln is not None and ln.spec.member_id == member_id:
                return lane
        return None

    def unqueue(self, member_id: str) -> Optional[MemberSpec]:
        """Drop a still-queued member; returns its spec, or None."""
        for spec in self.queue:
            if spec.member_id == member_id:
                self.queue.remove(spec)
                return spec
        return None

    @property
    def live(self) -> int:
        """Occupied lane count."""
        return sum(1 for ln in self.lanes if ln is not None)

    # ------------------------------------------------------------ the drain

    def run(self) -> list:
        """Drain the queue and the lanes; returns the retired member ids in
        retirement order."""
        while any(ln is not None for ln in self.lanes):
            if self.max_rounds is not None and self.rounds >= self.max_rounds:
                break
            self.poll()
        return self.retired

    def poll(self) -> list:
        """One batched round over the lanes: step, record, write crossed
        frames, retire and backfill. Returns the ids retired this round."""
        if not any(ln is not None for ln in self.lanes):
            return []
        p = self.runner.system.params
        retired_before = len(self.retired)
        live = sum(1 for ln in self.lanes if ln is not None)
        with obs_tracer.span("ensemble_step", round=self.rounds,
                             live=live, lanes=self.batch):
            wall0 = _time.perf_counter()
            self.ens, info = self.step_fn(self.ens)
            dev = self.runner.system.device
            if dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            # the members' rings ([B, K, 13] and [B]), one read a round:
            # the step records' rows and the failure payloads
            fl = self.ens.states.flight
            flight_rows = flight_counts = None
            if fl is not None:
                flight_rows, flight_counts = flight_mod.read_rows(fl)
            wall_s = _time.perf_counter() - wall0
        self.rounds += 1

        def payload(lane):
            return (None if flight_rows is None else
                    flight_mod.failure_payload(flight_rows[lane],
                                               flight_counts[lane]))

        if self.runner.di_enabled:
            # keep each seated member's SimRNG current with its stream
            # carry: frames and snapshots resume where the draws left off
            for lane, ln in enumerate(self.lanes):
                if ln is not None and ln.spec.rng is not None:
                    ln.spec.rng.distributed.counter = int(
                        self.ens.di_rng[lane, 2])

        for lane, ln in enumerate(self.lanes):
            if ln is None:
                continue
            if not bool(info.running[lane]):
                # seated at or past its t_final: retire unstepped
                self._retire_member(lane)
                continue
            health = int(info.health[lane])
            if bool(info.needs_growth[lane]):
                cap = _fiber_capacity(lane_state(self.ens.states, lane))
                obs_tracer.emit("lane", action="growth", lane=lane,
                                member=ln.spec.member_id, capacity=cap,
                                t=ln.t)
                if self.on_growth == "raise":
                    raise RuntimeError(
                        f"ensemble member {ln.spec.member_id}: nucleation "
                        f"outgrew its fiber capacity bucket ({cap} slots) at "
                        f"t={ln.t:.6g}; drive the sweep through scenarios."
                        "ScenarioEnsemble for automatic growth reseats, or "
                        "start at a larger capacity")
                self._retire_member(lane, reason="growth",
                                    extra={"capacity": cap})
                continue
            if bool(info.failed[lane]):
                verdict_s = _verdict.describe(health)
                fail = payload(lane)
                prov = (fail or {}).get("provenance")
                prov_fields = ({"prov_field": prov.get("field"),
                                "prov_fiber": prov.get("fiber"),
                                "prov_node": prov.get("node")}
                               if prov else {})
                obs_tracer.emit("fault", kind="lane_failed", lane=lane,
                                member=ln.spec.member_id, health=health,
                                verdict=verdict_s, t=ln.t, **prov_fields)
                if self.on_failure == "raise":
                    raise RuntimeError(
                        f"ensemble member {ln.spec.member_id}: terminal "
                        f"solver health verdict '{verdict_s}' "
                        f"(health={health:#x}) at t={ln.t:.6g}"
                        + ("" if not prov else
                           f"; first offender: field={prov['field']} "
                           f"fiber={prov['fiber']} node={prov['node']}"))
                self._retire_member(lane, reason="failed",
                                    extra={"health": health,
                                           "verdict": verdict_s,
                                           "flight": fail})
                continue
            if bool(info.dt_underflow[lane]):
                if self.on_dt_underflow == "raise":
                    raise RuntimeError(
                        f"ensemble member {ln.spec.member_id}: timestep "
                        f"smaller than dt_min ({p.dt_min}) at t={ln.t:.6g}")
                obs_tracer.emit("fault", kind="dt_underflow", lane=lane,
                                member=ln.spec.member_id, health=health,
                                t=ln.t)
                self._retire_member(lane, reason="dt_underflow",
                                    extra={"health": health,
                                           "verdict":
                                               _verdict.describe(health),
                                           "flight": payload(lane)})
                continue
            accepted = bool(info.accepted[lane])
            dt_used = float(info.dt_used[lane])
            t_new = float(info.t[lane])
            flight_row = (None if flight_rows is None else
                          flight_mod.last_row(flight_rows[lane],
                                              flight_counts[lane]))
            ln.steps += 1
            self._emit({
                "event": "step", "member": ln.spec.member_id,
                "lane": lane, "round": self.rounds - 1,
                "step": ln.steps - 1, "t": ln.t,
                "dt": dt_used, "iters": int(info.iters[lane]),
                "gmres_cycles": int(info.cycles[lane]),
                "residual": float(info.residual[lane]),
                "residual_true": float(info.residual_true[lane]),
                "fiber_error": float(info.fiber_error[lane]),
                "accepted": accepted,
                "refines": int(info.refines[lane]),
                "loss_of_accuracy": bool(info.loss_of_accuracy[lane]),
                "health": health,
                "guard_retries": int(info.guard_retries[lane]),
                "nucleations": int(info.nucleations[lane]),
                "catastrophes": int(info.catastrophes[lane]),
                "active_fibers": int(info.active_fibers[lane]),
                "wall_s": round(wall_s, 4),
                "wall_ms": round(wall_s * 1e3, 3),
                "gmres_history": (info.history[lane]
                                  if info.history is not None else []),
                "flight": flight_row})
            if flight_row is not None:
                obs_tracer.emit("flight", member=ln.spec.member_id,
                                lane=lane, **flight_row)
            ln.t = t_new
            ln.dt = float(info.dt_next[lane])
            if (accepted and self.writer is not None
                    and crossed_write_boundary(t_new, dt_used, p.dt_write)):
                self.writer(ln.spec.member_id,
                            lane_state(self.ens.states, lane),
                            rng_state=self._rng_state(ln.spec))
                ln.frames += 1
            if t_new >= ln.spec.t_final:
                self._retire_member(lane)
        return self.retired[retired_before:]


def run_ensemble(system, members, batch: int = 8, *, batch_impl: str = "vmap",
                 writer=None, metrics=None, write_initial_frames: bool = False,
                 on_dt_underflow: str = "raise", on_failure: str = "raise",
                 max_rounds=None) -> list:
    """Build an `EnsembleRunner` over ``system`` and drain ``members`` (a
    MemberSpec iterable) through ``batch`` lanes; returns the retired ids."""
    runner = EnsembleRunner(system, batch_impl=batch_impl)
    return EnsembleScheduler(
        runner, members, batch, writer=writer, metrics=metrics,
        write_initial_frames=write_initial_frames,
        on_dt_underflow=on_dt_underflow, on_failure=on_failure,
        max_rounds=max_rounds).run()
