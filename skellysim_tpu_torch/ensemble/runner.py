"""Batched member stepping: stacked states, per-member adaptive accept/reject.

Counterpart of `skellysim_tpu.ensemble.runner`, whose docstring gives the
design. B members ride one stacked `SimState` (every tensor with a leading
member axis; ``time`` and ``dt`` float64 numpy arrays [B], each value in
the state's dtype), and one round steps every running lane once:

* ``"vmap"`` (the default, the throughput plan): one batched trial over the
  lanes (`ensemble.batched.BatchedTrial`): fibers and bodies folded over
  the member axis, the shell's operators as batched products, every pair
  sum one member-batched launch a family (kernels A-D over the member axis
  on the card) and a member-batched GMRES. Members agree with their solo
  runs to roundoff, as in the JAX package's vmap plan.
* ``"unroll"``: each lane through the unbatched `System.trial_step`, so
  every member gives the bits of the port's sequential `System.run`.

The accept / reject / dt ladder runs in float64 on the host exactly as
`System.run` does, lane by lane; a rejected lane rolls back to its state
before the round, a lane past its ``t_final`` is inert, a lane whose
adaptive dt falls below ``dt_min`` freezes (``dt_underflow``) and one with
a terminal health verdict is quarantined (``failed``). With dynamic
instability each running lane first takes the device update
(`scenarios.di_device.di_update`) from its stream carry (`rng_carry`); a
lane whose nucleation outgrows its capacity freezes with ``needs_growth``
for the scheduler to reseat. The ``"ewald"`` and ``"tree"`` evaluators,
whose plans are rebuilt each step, are refused as in the JAX package; a
spectral plan is built once from the first member and serves every lane.
"""

from __future__ import annotations

import time as _time
from typing import NamedTuple

import numpy as np
import torch

from ..guard import escalate
from ..guard import verdict as _verdict
from ..system.system import SimState, System, _in_dtype


class EnsembleState(NamedTuple):
    """B members as one stacked state."""

    states: SimState
    #: [B] float64 member end times; a lane with time >= t_final is inert
    t_final: np.ndarray
    #: [B, 3] int64 stream carries (seed, stream id, counter) of the device
    #: dynamic instability (`scenarios.di_device`); None without it
    di_rng: np.ndarray | None = None


class EnsembleStepInfo(NamedTuple):
    """Per-member outcome of one round (numpy arrays [B] unless noted)."""

    running: np.ndarray
    accepted: np.ndarray
    converged: np.ndarray
    iters: np.ndarray
    residual: np.ndarray
    residual_true: np.ndarray
    fiber_error: np.ndarray
    refines: np.ndarray
    loss_of_accuracy: np.ndarray
    collided: np.ndarray
    #: the adaptive dt fell below dt_min: the lane froze un-advanced
    dt_underflow: np.ndarray
    dt_used: np.ndarray
    t: np.ndarray          # member time after the round
    dt_next: np.ndarray    # member dt after the round
    solutions: torch.Tensor  # [B, n] (zeros where the lane did not run)
    cycles: np.ndarray
    #: a list of B per-cycle row lists, or None when params.gmres_history
    #: is 0
    history: list | None
    health: np.ndarray
    #: terminal verdict: the lane froze for the scheduler to retire
    failed: np.ndarray
    guard_retries: np.ndarray
    #: dynamic-instability events applied this round (0 on a rejected or
    #: frozen lane) and the live fiber count after it
    nucleations: np.ndarray
    catastrophes: np.ndarray
    active_fibers: np.ndarray
    #: a nucleation burst outgrew the lane's capacity: the lane froze
    needs_growth: np.ndarray
    #: host seconds of the round's dynamic-instability updates (their
    #: draws and the counts read back from the device)
    di_s: float = 0.0


def _leaves(obj):
    """(structure, flat tensor leaves) of a nested NamedTuple / tuple."""
    if obj is None:
        return None, []
    if torch.is_tensor(obj):
        return "t", [obj]
    if isinstance(obj, tuple):
        subs = [_leaves(v) for v in obj]
        return ((type(obj), tuple(s for s, _ in subs)),
                [leaf for _, ls in subs for leaf in ls])
    raise TypeError(f"unsupported leaf {type(obj).__name__}")


def _map(fn, *objs):
    """Apply ``fn`` to corresponding tensor leaves of same-structured
    nested tuples (None passes)."""
    o = objs[0]
    if o is None:
        return None
    if torch.is_tensor(o):
        return fn(*objs)
    parts = [_map(fn, *vs) for vs in zip(*objs)]
    return type(o)(*parts) if hasattr(o, "_fields") else tuple(parts)


def _components(state: SimState):
    return state._replace(time=None, dt=None)


def _check_member(i, template, state):
    ts, tl = _leaves(_components(template))
    ss, sl = _leaves(_components(state))
    if ts != ss:
        raise ValueError(
            f"member {i}: state structure differs from member 0 (ensemble "
            "members share one bucket: pad fiber capacity to a common size)")
    for j, (a, b) in enumerate(zip(tl, sl)):
        if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
            raise ValueError(
                f"member {i}: leaf {j} is {tuple(b.shape)}/{b.dtype}/"
                f"{b.device} vs member 0's {tuple(a.shape)}/{a.dtype}/"
                f"{a.device}; ensemble members share shapes, dtypes and a "
                "device (pad fiber capacity to a common size)")


def stack_states(states) -> SimState:
    """[SimState, ...] -> one SimState whose tensors carry a leading member
    axis and whose ``time`` / ``dt`` are float64 arrays [B]. Every member
    must share the structure, shapes, dtypes and device."""
    states = list(states)
    if not states:
        raise ValueError("stack_states needs at least one member state")
    for i, s in enumerate(states[1:], start=1):
        _check_member(i, states[0], s)
    comps = _map(lambda *ls: torch.stack(ls), *[_components(s)
                                                  for s in states])
    return comps._replace(
        time=np.array([float(s.time) for s in states], dtype=np.float64),
        dt=np.array([float(s.dt) for s in states], dtype=np.float64))


def lane_state(bstates: SimState, lane: int) -> SimState:
    """Member ``lane``'s SimState view of a stacked batch."""
    comps = _map(lambda leaf: leaf[lane], _components(bstates))
    return comps._replace(time=float(bstates.time[lane]),
                          dt=float(bstates.dt[lane]))


def n_lanes(bstates: SimState) -> int:
    return len(bstates.time)


def set_lane(bstates: SimState, lane: int, state: SimState) -> SimState:
    """``bstates`` with lane ``lane`` replaced by ``state`` (a new stacked
    state; shapes and dtypes must match the lanes')."""
    _check_member(lane, lane_state(bstates, 0), state)

    def put(leaf, s):
        out = leaf.clone()
        out[lane] = s
        return out

    comps = _map(put, _components(bstates), _components(state))
    time, dt = bstates.time.copy(), bstates.dt.copy()
    time[lane], dt[lane] = float(state.time), float(state.dt)
    return comps._replace(time=time, dt=dt)


def slice_lanes(ens: "EnsembleState", lo: int, hi: int, device=None):
    """Lanes ``lo:hi`` of an `EnsembleState` (its tensors on ``device``,
    default: where they lie)."""
    st = ens.states
    comps = _map(lambda leaf: leaf[lo:hi].to(device or leaf.device),
                 _components(st))
    return EnsembleState(
        states=comps._replace(time=st.time[lo:hi].copy(),
                              dt=st.dt[lo:hi].copy()),
        t_final=ens.t_final[lo:hi].copy(),
        di_rng=None if ens.di_rng is None else ens.di_rng[lo:hi].copy())


def _device_of(bstates: SimState):
    """The device of a stacked state's tensors."""
    return _leaves(_components(bstates))[1][0].device


def concat_lanes(parts, device=None) -> "EnsembleState":
    """The `EnsembleState` of ``parts``' lanes in order, on ``device``
    (default: the first part's)."""
    dev = device or _device_of(parts[0].states)
    comps = _map(lambda *ls: torch.cat([leaf.to(dev) for leaf in ls]),
                 *[_components(p.states) for p in parts])
    return EnsembleState(
        states=comps._replace(
            time=np.concatenate([p.states.time for p in parts]),
            dt=np.concatenate([p.states.dt for p in parts])),
        t_final=np.concatenate([p.t_final for p in parts]),
        di_rng=(None if parts[0].di_rng is None
                else np.concatenate([p.di_rng for p in parts])))


def _concat_infos(infos, device) -> "EnsembleStepInfo":
    """One `EnsembleStepInfo` of the shards' infos, lanes in order."""
    fields = {}
    for f in EnsembleStepInfo._fields:
        vals = [getattr(i, f) for i in infos]
        if f == "di_s":
            fields[f] = sum(vals)
        elif f == "solutions":
            fields[f] = torch.cat([v.to(device) for v in vals])
        elif f == "history":
            fields[f] = (None if vals[0] is None
                         else [row for v in vals for row in v])
        else:
            fields[f] = np.concatenate(vals)
    return EnsembleStepInfo(**fields)


def rng_carry(rng) -> np.ndarray:
    """A member `SimRNG` -> its ``distributed`` stream carry (seed, stream
    id, counter); None -> an inert zero stream (idle lanes)."""
    if rng is None:
        return np.zeros(3, dtype=np.int64)
    s = rng.distributed
    return np.array([s.seed, s.stream_id, s.counter], dtype=np.int64)


class EnsembleRunner:
    """The batched round with per-member adaptive dt (see the module
    docstring). ``di_sample_fn`` replaces the natural DI draws
    (`scenarios.di_device.sample_draws`), the injection seam of the
    tests."""

    def __init__(self, system: System, batch_impl: str = "vmap",
                 di_sample_fn=None):
        if batch_impl not in ("vmap", "unroll"):
            raise ValueError(
                f"unknown batch_impl {batch_impl!r}; use 'vmap' (throughput) "
                "or 'unroll' (bit-reproducible lanes)")
        p = system.params
        if p.pair_evaluator in ("ewald", "tree"):
            raise ValueError(
                "ensemble batching does not support pair_evaluator="
                f"{p.pair_evaluator!r}: the fast-summation plan is rebuilt "
                "host-side per step; use 'direct' (small-N members are below "
                "the fast-evaluator crossover anyway) or 'spectral' for "
                "periodic scenes (its plan is built once)")
        if p.pair_evaluator == "ring" and system.mesh is not None:
            raise ValueError(
                "ensemble batching does not support the ring pair evaluator "
                "(a ring inside the member batch axis); shard the MEMBER "
                "axis instead (parallel.shard_ensemble): batch parallelism "
                "is the outer axis for small-N members")
        self.system = system
        self.batch_impl = batch_impl
        self.di_enabled = p.dynamic_instability.n_nodes > 0
        self._di_sample_fn = di_sample_fn
        self._pair = None
        #: the runner of each other device a member mesh's shards lie on
        self._on_device = {}
        if batch_impl == "vmap":
            from .batched import BatchedTrial

            self._batched = BatchedTrial(system)

    # ------------------------------------------------------------ assembly

    def make_ensemble(self, states, t_finals, rngs=None) -> EnsembleState:
        """Stack member states and end times into an `EnsembleState`; with
        dynamic instability ``rngs`` (one `SimRNG` or None a member) seeds
        the stream carries (only idle lanes, t_final = -inf, may go
        without)."""
        # every lane armed (or stripped) alike: the stacked ring needs one
        # structure
        states = [self.system.ensure_flight(s) for s in states]
        if self.system.params.pair_evaluator == "spectral":
            self._pair = self.system._pair_args(states[0])
        stacked = stack_states(states)
        t_final = np.asarray(list(t_finals), dtype=np.float64)
        if t_final.shape != (len(states),):
            raise ValueError(f"t_finals has shape {t_final.shape}, expected "
                             f"({len(states)},)")
        di_rng = None
        if self.di_enabled:
            from ..scenarios.di_device import check_di_state

            check_di_state(states[0], self.system.params)
            rngs = list(rngs) if rngs is not None else [None] * len(states)
            if len(rngs) != len(states):
                raise ValueError(
                    f"rngs has {len(rngs)} entries for {len(states)} members")
            missing = [i for i, r in enumerate(rngs)
                       if r is None and t_final[i] > float("-inf")]
            if missing:
                raise ValueError(
                    f"members {missing}: dynamic-instability members need a "
                    "per-member SimRNG (SimRNG(seed).member(i)); rng-less "
                    "lanes are only legal as idle templates")
            di_rng = np.stack([rng_carry(r) for r in rngs])
        return EnsembleState(states=stacked, t_final=t_final, di_rng=di_rng)

    # ------------------------------------------------------------ the round

    def _lane_alone(self, trial, **overrides):
        """One lane's batched trial on its own (the guard ladder's
        re-solve in the "vmap" plan)."""
        new_b, sols, infos = self._batched(stack_states([trial]),
                                           pair=self._pair, **overrides)
        return lane_state(new_b, 0), sols[0], infos[0]

    def _trial(self, lanes: list, pre: list):
        """(new state, solution, StepInfo, collided) of each lane in
        ``lanes`` from its state ``pre[lane]``. With the guard ladder armed
        a lane that needs a retry re-solves alone (`guard.escalate`); its
        siblings are not re-solved and keep their bits."""
        sys_ = self.system
        if self.batch_impl == "vmap":
            new_b, sols, infos = self._batched(
                stack_states([pre[i] for i in lanes]), pair=self._pair)
            news = [lane_state(new_b, j) for j in range(len(lanes))]
            if escalate.armed(sys_.params):
                for j, i in enumerate(lanes):
                    news[j], sols[j], infos[j] = escalate.escalate(
                        sys_, pre[i], (news[j], sols[j], infos[j]),
                        resolve=self._lane_alone)
            if sys_.params.flight_window > 0:
                # one row a member, after its ladder, each reduced over
                # the member's own fibers (`System.trial_step` records
                # the "unroll" lanes' itself)
                for j, i in enumerate(lanes):
                    news[j], sols[j], infos[j] = sys_._record_flight(
                        pre[i], news[j], sols[j], infos[j])
        else:
            outs = [sys_.trial_step(pre[i], pair=self._pair) for i in lanes]
            news = [o[0] for o in outs]
            sols = [o[1] for o in outs]
            infos = [o[2] for o in outs]
        collided = [bool(info.converged) and sys_.collision(new)
                    if sys_.params.adaptive_timestep_flag else False
                    for new, info in zip(news, infos)]
        return news, sols, infos, collided

    def _runner_on(self, device):
        """This runner on ``device``: itself, or a copy whose system is
        the same configuration on that device (a member mesh's shard)."""
        if device == self.system.device:
            return self
        run = self._on_device.get(device)
        if run is None:
            sys_ = self.system
            twin = System(sys_.params, sys_.shell_shape, device=device)
            twin.grid_ladder = sys_.grid_ladder
            run = EnsembleRunner(twin, self.batch_impl, self._di_sample_fn)
            self._on_device[device] = run
        return run

    def _step_sharded(self, ens):
        """A round of a `parallel.ShardedEnsemble`: each local shard's
        lanes as one batched trial on its device, one shard after the
        other (no collectives); the info covers the local lanes in
        order."""
        from ..parallel.mesh import ShardedEnsemble

        parts, infos = [], []
        for part in ens.parts:
            run = self._runner_on(_device_of(part.states))
            if (self.system.params.pair_evaluator == "spectral"
                    and run._pair is None):
                run._pair = run.system._pair_args(lane_state(part.states,
                                                             0))
            new, info = run.step(part)
            parts.append(new)
            infos.append(info)
        return (ShardedEnsemble(tuple(parts), ens.mesh),
                _concat_infos(infos, _device_of(parts[0].states)))

    def step(self, ens: EnsembleState):
        """(EnsembleState, EnsembleStepInfo) after one round. A
        `parallel.ShardedEnsemble` (`parallel.shard_ensemble`) steps shard
        by shard and stays sharded."""
        if not isinstance(ens, EnsembleState):
            return self._step_sharded(ens)
        p = self.system.params
        states = ens.states
        B = n_lanes(states)
        dtype = self.system._dtype(lane_state(states, 0))
        running = states.time < ens.t_final
        base = [lane_state(states, i) for i in range(B)]
        pre = list(base)
        growth = np.zeros(B, dtype=bool)
        nuc = np.zeros(B, dtype=np.int64)
        cat = np.zeros(B, dtype=np.int64)
        di_s = 0.0
        if self.di_enabled:
            from ..scenarios.di_device import di_update

            di0 = _time.perf_counter()
            for i in np.flatnonzero(running):
                pre[i], di_info = di_update(base[i], p, ens.di_rng[i],
                                            sample_fn=self._di_sample_fn)
                growth[i] = di_info.needs_growth
                nuc[i], cat[i] = di_info.nucleations, di_info.catastrophes
            di_s = _time.perf_counter() - di0
        lanes = [int(i) for i in np.flatnonzero(running & ~growth)]

        n_sol = None
        f64 = np.float64
        z = np.zeros(B)
        out = dict(converged=np.zeros(B, bool), iters=np.zeros(B, np.int64),
                   residual=z.copy(), residual_true=z.copy(),
                   fiber_error=z.copy(), refines=np.zeros(B, np.int64),
                   loss_of_accuracy=np.zeros(B, bool),
                   collided=np.zeros(B, bool), dt_underflow=np.zeros(B, bool),
                   dt_used=states.dt.copy(), cycles=np.zeros(B, np.int64),
                   health=np.zeros(B, np.int64), failed=np.zeros(B, bool),
                   accepted=np.zeros(B, bool),
                   guard_retries=np.zeros(B, np.int64))
        history = [[] for _ in range(B)] if p.gmres_history > 0 else None
        new_lanes = list(base)
        time_out, dt_out = states.time.copy(), states.dt.copy()
        sol_rows = {}
        if lanes:
            news, sols, infos, collided = self._trial(lanes, pre)
            for j, i in enumerate(lanes):
                info = infos[j]
                sol_rows[i] = sols[j]
                conv = bool(info.converged)
                dt64 = f64(info.dt_used)
                ferr = f64(info.fiber_error)
                if p.adaptive_timestep_flag:
                    good = conv and ferr <= p.fiber_error_tol
                    if good:
                        dt_new = (min(p.dt_max, dt64 * p.beta_up)
                                  if ferr <= 0.9 * p.fiber_error_tol
                                  else dt64)
                    else:
                        dt_new = dt64 * p.beta_down
                    coll = conv and collided[j]
                    if coll:
                        dt_new = dt64 * 0.5
                    accept = good and not coll
                    underflow = dt_new < p.dt_min
                else:
                    accept, dt_new, coll, underflow = True, dt64, False, False
                health = int(info.health) | (_verdict.DT_UNDERFLOW
                                             if underflow else 0)
                failed = _verdict.is_terminal(health) and not underflow
                advance = accept and not underflow and not failed
                reject = not accept and not underflow and not failed
                if advance:
                    new_lanes[i] = news[j]
                    time_out[i] = _in_dtype(float(states.time[i] + dt64),
                                            dtype)
                elif news[j].flight is not None:
                    # the ring advances for every lane that ran a trial:
                    # a rejected or frozen lane keeps its row
                    new_lanes[i] = new_lanes[i]._replace(
                        flight=news[j].flight)
                if advance or reject:
                    dt_out[i] = _in_dtype(float(dt_new), dtype)
                for k, v in (("converged", conv), ("iters", info.iters),
                             ("residual", info.residual),
                             ("residual_true", info.residual_true),
                             ("fiber_error", ferr),
                             ("refines", info.refines),
                             ("loss_of_accuracy", info.loss_of_accuracy),
                             ("collided", coll), ("dt_underflow", underflow),
                             ("dt_used", dt64), ("cycles", info.cycles),
                             ("health", health), ("failed", failed),
                             ("accepted", advance),
                             ("guard_retries", info.guard_retries)):
                    out[k][i] = v
                if history is not None:
                    history[i] = info.history or []
            n_sol = sol_rows[lanes[0]].shape[-1]
        merged = stack_states([s._replace(time=time_out[i], dt=dt_out[i])
                               for i, s in enumerate(new_lanes)])
        solutions = torch.zeros((B, n_sol or 0), dtype=dtype,
                                device=self.system.device)
        for i, row in sol_rows.items():
            solutions[i] = row

        di_rng = ens.di_rng
        zeros_i = np.zeros(B, dtype=np.int64)
        nucleations = catastrophes = active = zeros_i
        if self.di_enabled:
            from ..scenarios.di_device import DRAWS_PER_STEP

            di_rng = di_rng.copy()
            # every lane that drew advances its counter, rejected ones
            # included (the sequential loop does not rewind either);
            # growth-frozen lanes never drew
            di_rng[running & ~growth, 2] += DRAWS_PER_STEP
            adv = out["accepted"]
            nucleations = np.where(adv, nuc, 0)
            catastrophes = np.where(adv, cat, 0)
            active = np.array([int(s.fibers.active.sum())
                               for s in new_lanes], dtype=np.int64)
        info = EnsembleStepInfo(
            running=running, accepted=out["accepted"],
            converged=out["converged"], iters=out["iters"],
            residual=out["residual"], residual_true=out["residual_true"],
            fiber_error=out["fiber_error"], refines=out["refines"],
            loss_of_accuracy=out["loss_of_accuracy"],
            collided=out["collided"], dt_underflow=out["dt_underflow"],
            dt_used=out["dt_used"], t=merged.time.copy(),
            dt_next=merged.dt.copy(), solutions=solutions,
            cycles=out["cycles"], history=history, health=out["health"],
            failed=out["failed"], guard_retries=out["guard_retries"],
            nucleations=nucleations, catastrophes=catastrophes,
            active_fibers=active, needs_growth=running & growth, di_s=di_s)
        return EnsembleState(states=merged, t_final=ens.t_final,
                             di_rng=di_rng), info


# ---------------------------------------------------------------- the registry

def auditable_programs():
    """The ensemble layer's registry entry: one "vmap" round of B = 4
    free-fiber members (4 fibers x 8 nodes each), the batched trial and
    the per-member accept ladder, the JAX package's ``ensemble_step``."""
    from ..audit import fixtures
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice

    def retrace_probe(device=None):
        # the round on the fixture, then on the ensemble it returned
        built = build(device)
        return probe_twice(lambda: built.fn(*built.args),
                           lambda out: built.fn(out[0]))

    def build(device=None):
        from ..system import BackgroundFlow

        system = fixtures.make_system(device=device)
        runner = EnsembleRunner(system)
        dev = system.device
        states = [system.make_state(
            fibers=fixtures.make_fibers(n_fibers=4, n_nodes=8, seed=i,
                                        device=dev),
            background=BackgroundFlow.make(uniform=(1.0, 0.0, 0.0),
                                           dtype=torch.float64, device=dev))
            for i in range(4)]
        return BuiltProgram(runner.step,
                            (runner.make_ensemble(states, [1e-2] * 4),),
                            device=dev)

    return [AuditProgram(
        name="ensemble_step", layer="ensemble",
        summary="batched trial round (B=4 free-fiber members, per-member "
                "accept ladder)",
        build=build, retrace_probe=retrace_probe)]
