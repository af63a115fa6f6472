"""Scenario front-end: dynamic-instability ensembles across capacity rungs.

Counterpart of `skellysim_tpu.scenarios.sweep`. The device DI update
(`scenarios.di_device`) flips masks inside a member's fixed fiber capacity,
which cannot grow within a round. This module keeps every member on a
geometric capacity rung (`system.buckets.next_fiber_capacity`), drains
each rung through its own `EnsembleScheduler` (all sharing one
`EnsembleRunner`), and when a member's bucket fills (``needs_growth``) the
scheduler hands it back and `ScenarioEnsemble` reseats it on the next rung
(`fibers.container.grow_capacity`) under the same id and RNG stream: its
frozen round then re-runs there with the counter untouched.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from ..ensemble.runner import EnsembleRunner
from ..ensemble.scheduler import EnsembleScheduler, MemberSpec
from ..fibers import container as fc
from ..system import buckets as bucket_mod
from ..obs import tracer as obs_tracer
from ..system import di_rates, dynamic_instability
from ..system.system import state_placement
from .di_device import check_di_state

logger = logging.getLogger("skellysim_tpu_torch")


def ensure_di_capacity(state, params, capacity: Optional[int] = None,
                       node_multiple: int = 1,
                       policy: Optional[bucket_mod.BucketPolicy] = None):
    """The state padded onto a capacity rung the device DI update can run
    on: one fixed-capacity group at the DI resolution. A scene without
    fibers gets one inactive placeholder slot seeded from its first
    nucleation site (finite caches before anything nucleates).
    ``capacity`` overrides the rung; the default is the smallest geometric
    rung (or the policy's) holding the scene."""
    di = params.dynamic_instability
    if di.n_nodes == 0:
        return state
    fibers = state.fibers
    if fibers is not None and not isinstance(fibers, fc.FiberGroup):
        raise ValueError(
            "device dynamic instability supports a single fiber resolution "
            "bucket; mixed-resolution tuples run the host loop")
    if fibers is None:
        tab = dynamic_instability.host_site_table(state.bodies)
        if not tab:
            raise ValueError(
                "cannot pre-allocate DI capacity: the scene has no fibers "
                "and no body nucleation sites to seed a placeholder from")
        _, _, origin, com = tab[0]
        x = di_rates.nucleated_nodes(origin, com, di.min_length,
                                     di.n_nodes)
        dtype, device = state_placement(state)
        group = fc.make_group(x[None], lengths=di.min_length,
                              bending_rigidity=di.bending_rigidity,
                              radius=di.radius, minus_clamped=True,
                              dtype=dtype, device=device)
        # the placeholder is inert capacity, not a fiber
        fibers = group._replace(
            active=torch.zeros(1, dtype=torch.bool, device=device),
            config_rank=torch.full((1,), -1, dtype=torch.int32,
                                   device=device))
    cap = (capacity if capacity is not None
           else bucket_mod.next_fiber_capacity(fibers.n_fibers, policy))
    state = state._replace(
        fibers=fc.grow_capacity(fibers, cap, node_multiple=node_multiple))
    check_di_state(state, params)
    return state


class ScenarioEnsemble:
    """Drain dynamic-instability members through one scheduler a capacity
    rung, the rungs sharing one runner. Every member needs its own
    `SimRNG`. A member whose bucket fills is reseated on the next rung and
    re-admitted under its id with its synced RNG, so its trajectory stream
    continues; ``on_retire`` fires for final retirements only."""

    def __init__(self, system, members, batch: int, *,
                 batch_impl: str = "vmap",
                 policy: Optional[bucket_mod.BucketPolicy] = None,
                 writer: Optional[Callable] = None,
                 metrics: Optional[Callable] = None,
                 step_fn: Optional[Callable] = None,
                 write_initial_frames: bool = False,
                 on_dt_underflow: str = "retire",
                 on_failure: str = "retire",
                 on_retire: Optional[Callable] = None,
                 node_multiple: int = 1,
                 runner: Optional[EnsembleRunner] = None):
        if not system.params.dynamic_instability.n_nodes:
            raise ValueError(
                "ScenarioEnsemble drives dynamic-instability sweeps; for "
                "deterministic members use ensemble.EnsembleScheduler")
        self.system = system
        self.runner = runner or EnsembleRunner(system, batch_impl=batch_impl)
        self.batch = batch
        self.policy = policy
        self.node_multiple = node_multiple
        self.writer = writer
        self.metrics = metrics
        self.step_fn = step_fn
        self.write_initial_frames = write_initial_frames
        self.on_dt_underflow = on_dt_underflow
        self.on_failure = on_failure
        self.user_on_retire = on_retire
        self._scheds: dict[int, EnsembleScheduler] = {}
        self._specs: dict[str, MemberSpec] = {}
        self.finished: list[str] = []
        self.reseats = 0
        self.rounds = 0
        for spec in members:
            self.admit(spec)

    def _sched_for(self, capacity: int, template) -> EnsembleScheduler:
        sched = self._scheds.get(capacity)
        if sched is None:
            sched = EnsembleScheduler(
                self.runner, [], self.batch, template=template,
                writer=self.writer, metrics=self.metrics,
                step_fn=self.step_fn, write_initial_frames=False,
                on_dt_underflow=self.on_dt_underflow,
                on_failure=self.on_failure, on_growth="retire",
                on_retire=self._on_retire)
            self._scheds[capacity] = sched
            logger.info("scenario: capacity rung %d opened (%d rung(s))",
                        capacity, len(self._scheds))
        return sched

    def admit(self, spec: MemberSpec):
        """Pad ``spec`` onto its capacity rung and seat or queue it."""
        if spec.rng is None:
            raise ValueError(
                f"member {spec.member_id}: scenario members need a "
                "per-member SimRNG (SimRNG(seed).member(i))")
        state = ensure_di_capacity(spec.state, self.system.params,
                                   node_multiple=self.node_multiple,
                                   policy=self.policy)
        spec = MemberSpec(member_id=spec.member_id, state=state,
                          t_final=spec.t_final, rng=spec.rng,
                          enqueued_at=spec.enqueued_at)
        self._specs[spec.member_id] = spec
        if self.write_initial_frames and self.writer is not None:
            self.writer(spec.member_id, state,
                        rng_state=spec.rng.dump_state())
        return self._sched_for(state.fibers.n_fibers, state).admit(spec)

    def _on_retire(self, member_id: str, state, reason: str,
                   rng_state=None, **extra):
        spec = self._specs.get(member_id)
        if reason == "growth":
            # the member's current (frozen) state grows inert slots and
            # re-admits under its id; the scheduler synced its SimRNG, so
            # the re-run draws what the frozen round would have
            old_cap = extra.get("capacity", state.fibers.n_fibers)
            new_cap = bucket_mod.next_fiber_capacity(old_cap + 1, self.policy)
            grown = state._replace(fibers=fc.grow_capacity(
                state.fibers, new_cap, node_multiple=self.node_multiple))
            self.reseats += 1
            obs_tracer.emit("lane", action="growth_reseat",
                            member=member_id, capacity=new_cap)
            logger.info("scenario: member %s reseated %d -> %d fiber slots",
                        member_id, old_cap, new_cap)
            self._sched_for(new_cap, grown).admit(MemberSpec(
                member_id=member_id, state=grown, t_final=spec.t_final,
                rng=spec.rng))
            return
        if reason == "finished":
            self.finished.append(member_id)
        if self.user_on_retire is not None:
            self.user_on_retire(member_id, state, reason,
                                rng_state=rng_state, **extra)

    def poll(self) -> bool:
        """One batched round of every rung with live lanes; True when any
        rung stepped."""
        stepped = False
        for cap in sorted(self._scheds):
            sched = self._scheds[cap]
            if sched.live:
                sched.poll()
                stepped = True
        if stepped:
            self.rounds += 1
        return stepped

    def run(self, max_rounds: Optional[int] = None) -> list:
        """Drain every rung, growth reseats included; returns the finished
        member ids in retirement order."""
        while self.poll():
            if max_rounds is not None and self.rounds >= max_rounds:
                break
        return self.finished
