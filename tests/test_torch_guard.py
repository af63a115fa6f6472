"""The port's guard escalation ladder and chaos injectors against the JAX
package's.

* tests/test_guard.py's scripted stub scenarios run through both packages'
  `escalate`: the same retries, dt used and health word;
* a real small `System` under `chaos.zero_preconditioner` against JAX's
  `test_guard_ladder_on_real_system_stagnation` (two halvings, a
  stagnation verdict, dt / 4), and `chaos.poison_state` (a nonfinite
  verdict, no retry);
* a retried step equals a fresh solve at the halved dt, bit for bit, and
  leaves the input state untouched;
* the ladder in the ensemble: per-lane retries and dt used equal the JAX
  vmap runner's under the same injector, and a lane that retries alone
  leaves its siblings' bits; `poison_lane` / `nan_lane_of`: only the
  poisoned lane fails.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skellysim_tpu.guard import chaos as jchaos
from skellysim_tpu.guard import escalate as jescalate
from skellysim_tpu.guard import verdict as jverdict
from skellysim_tpu.system.system import StepInfo as JStepInfo
from skellysim_tpu_torch.ensemble import EnsembleRunner, EnsembleScheduler
from skellysim_tpu_torch.ensemble import MemberSpec, lane_state, stack_states
from skellysim_tpu_torch.guard import chaos, escalate, verdict
from skellysim_tpu_torch.system.system import StepInfo
from torch_jax_state import port_state, port_system


class _Params:
    """The knobs `escalate` reads (tests/test_guard.py's `_StubParams`)."""

    def __init__(self, **kw):
        self.guard_dt_halvings = kw.get("guard_dt_halvings", 0)
        self.guard_block_fallback = kw.get("guard_block_fallback", False)
        self.guard_f64_fallback = kw.get("guard_f64_fallback", False)
        self.gmres_block_s = kw.get("gmres_block_s", 1)
        self.adaptive_timestep_flag = kw.get("adaptive_timestep_flag", True)
        self.dt_min = kw.get("dt_min", 1e-4)
        self.gmres_tol = kw.get("gmres_tol", 1e-10)


class _State(NamedTuple):
    dt: object


class _Stub:
    """tests/test_guard.py's scripted solve, for either package: unhealthy
    until dt < ``heal_below`` or the fallback ``heal_on`` ("block" /
    "full"); ``force`` overrides the verdict of every attempt ("breakdown
    converged" / "nonfinite")."""

    def __init__(self, params, jax_side, heal_below=None, heal_on=None,
                 force=None):
        self.params = params
        self.jax_side = jax_side
        self.heal_below, self.heal_on, self.force = heal_below, heal_on, force
        self.calls = []

    def _precision_for(self, state):
        return "mixed"

    def _solve_once(self, state, pair=None, pair_anchors=None, block_s=None,
                    force_full=False):
        self.calls.append((block_s, force_full))
        fallback = ((self.heal_on == "block" and block_s == 1)
                    or (self.heal_on == "full" and force_full))
        if self.jax_side:
            # traced inside the JAX ladder's while loops: jnp selects
            healed = jnp.asarray(fallback)
            if self.heal_below is not None:
                healed = healed | (state.dt < self.heal_below)
            health = jnp.where(healed, jnp.int32(0),
                               jnp.int32(verdict.STAGNATION))
            resid = jnp.where(healed, jnp.float64(0.0), jnp.float64(1.0))
            if self.force == "breakdown converged":
                health = jnp.int32(verdict.BREAKDOWN)
                resid = jnp.float64(0.0)
            elif self.force == "nonfinite":
                health = jnp.int32(verdict.NONFINITE)
            info = JStepInfo(converged=health == 0, iters=jnp.int32(1),
                             residual=jnp.float64(0.0),
                             fiber_error=jnp.float64(0.0),
                             residual_true=resid,
                             loss_of_accuracy=jnp.asarray(False),
                             health=health, dt_used=state.dt)
            return _State(jnp.asarray(state.dt)), state.dt * 0.0, info
        healed = fallback or (self.heal_below is not None
                              and state.dt < self.heal_below)
        health = 0 if healed else verdict.STAGNATION
        resid = 0.0 if healed else 1.0
        if self.force == "breakdown converged":
            health, resid = verdict.BREAKDOWN, 0.0
        elif self.force == "nonfinite":
            health = verdict.NONFINITE
        info = StepInfo(converged=health == 0, iters=1, residual=0.0,
                        fiber_error=0.0, residual_true=resid,
                        health=health, dt_used=state.dt)
        return _State(state.dt), 0.0, info


_SCENARIOS = {
    # tests/test_guard.py :205-288, scenario by scenario
    "healthy_pays_nothing": (dict(guard_dt_halvings=3),
                             dict(heal_below=1.0)),
    "halves_until_healthy": (dict(guard_dt_halvings=4),
                             dict(heal_below=0.03)),
    "bounded_verdict_survives": (dict(guard_dt_halvings=2),
                                 dict(heal_below=0.0)),
    "dt_min_floor": (dict(guard_dt_halvings=8, dt_min=0.04),
                     dict(heal_below=0.0)),
    "block_fallback": (dict(guard_block_fallback=True, gmres_block_s=4),
                       dict(heal_on="block")),
    "full_fallback": (dict(guard_f64_fallback=True), dict(heal_on="full")),
    "every_stage": (dict(guard_dt_halvings=2, guard_block_fallback=True,
                         gmres_block_s=4, guard_f64_fallback=True),
                    dict(heal_on="full")),
    "converged_breakdown_skipped": (
        dict(guard_dt_halvings=4, guard_block_fallback=True,
             gmres_block_s=4), dict(force="breakdown converged")),
    "nonfinite_not_retried": (
        dict(guard_dt_halvings=4, guard_block_fallback=True,
             gmres_block_s=4, guard_f64_fallback=True),
        dict(force="nonfinite")),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_stub_ladders_match_jax(name):
    pkw, skw = _SCENARIOS[name]
    jsys = _Stub(_Params(**pkw), True, **skw)
    jstate = _State(jnp.asarray(0.1, dtype=jnp.float64))
    _, _, ji = jescalate.escalate(jsys, jstate, jsys._solve_once(jstate))
    tsys = _Stub(_Params(**pkw), False, **skw)
    tstate = _State(0.1)
    _, _, ti = escalate.escalate(tsys, tstate, tsys._solve_once(tstate))
    assert ti.guard_retries == int(ji.guard_retries)
    assert ti.dt_used == float(ji.dt_used)
    assert ti.health == int(ji.health)
    # the stages each override reached (the JAX ladder traces each stage
    # once; the port's calls are its runs)
    assert set(tsys.calls) <= set(jsys.calls)


def _real_pair(**overrides):
    """tests/test_guard.py's real system (`audit.fixtures`: 16 free fibers
    in a background flow) in both packages."""
    from skellysim_tpu.audit import fixtures

    jsys = fixtures.make_system(**overrides)
    jstate = fixtures.free_state(jsys)
    return jsys, jstate, port_system(jsys), port_state(jstate)


def test_ladder_on_real_system_matches_jax():
    """Zero preconditioner, two halvings armed: both packages exhaust them
    (2 retries, STAGNATION, dt / 4); a poisoned state is nonfinite with no
    retry."""
    jsys, jstate, tsys, tstate = _real_pair(guard_dt_halvings=2)
    jchaos.zero_preconditioner(jsys)
    chaos.zero_preconditioner(tsys)
    _, _, ji = jsys.step(jstate)
    _, _, ti = tsys.step(tstate)
    assert ti.guard_retries == int(ji.guard_retries) == 2
    assert ti.health & verdict.STAGNATION and int(ji.health) & \
        jverdict.STAGNATION
    assert ti.dt_used == float(ji.dt_used) == tstate.dt / 4.0
    jsys2, jstate2, tsys2, tstate2 = _real_pair(guard_dt_halvings=2)
    _, _, ji2 = jsys2.step(jchaos.poison_state(jstate2))
    _, _, ti2 = tsys2.step(chaos.poison_state(tstate2))
    assert ti2.health & verdict.NONFINITE and int(ji2.health) & \
        jverdict.NONFINITE
    assert ti2.guard_retries == int(ji2.guard_retries) == 0


def test_armed_healthy_step_is_the_unarmed_bits():
    """Every stage armed on a healthy step: no retry, and the unarmed
    step's bits."""
    _, _, tsys, tstate = _real_pair()
    _, _, armed_sys, _ = _real_pair(guard_dt_halvings=2,
                                    guard_block_fallback=True,
                                    guard_f64_fallback=True)
    n0, x0, i0 = tsys.step(tstate)
    n1, x1, i1 = armed_sys.step(tstate)
    assert i1.guard_retries == 0 and i1.health == 0
    assert torch.equal(x0, x1) and torch.equal(n0.fibers.x, n1.fibers.x)


def test_retried_step_is_a_fresh_solve_at_half_dt():
    """A step whose first attempt is declared stagnant retries at dt / 2
    from the trial's input state: its state, solution and info are a fresh
    `_solve_once` at dt / 2, bit for bit, and the input state's tensors
    are untouched."""
    _, _, tsys, tstate = _real_pair(guard_dt_halvings=1)
    x_before = tstate.fibers.x.clone()
    orig = tsys._solve_once
    calls = []

    def flaky(state, **kw):
        new, x, info = orig(state, **kw)
        calls.append(state.dt)
        if len(calls) == 1:
            info = info._replace(health=verdict.STAGNATION,
                                 residual_true=1.0)
        return new, x, info

    tsys._solve_once = flaky
    new, x, info = tsys.step(tstate)
    assert calls == [tstate.dt, tstate.dt / 2]
    assert info.guard_retries == 1 and info.dt_used == tstate.dt / 2
    fresh_new, fresh_x, fresh_info = orig(tstate._replace(dt=tstate.dt / 2))
    assert torch.equal(x, fresh_x)
    assert torch.equal(new.fibers.x, fresh_new.fibers.x)
    assert torch.equal(new.fibers.tension, fresh_new.fibers.tension)
    assert info.iters == fresh_info.iters and info.health == 0
    assert torch.equal(tstate.fibers.x, x_before)


# ------------------------------------------------------------ the ensemble

def _ensemble_pair(**overrides):
    """tests/test_ensemble.py's small free-fiber ensemble (the JAX
    `_ensemble_system`'s 1 x 8-node fiber, three members) in both
    packages, adaptive dt off so that a stagnant lane still advances."""
    import dataclasses

    from skellysim_tpu.ensemble import EnsembleRunner as JRunner

    from __graft_entry__ import _make_system

    jsys, base = _make_system(n_fibers=1, n_nodes=8, dtype=jnp.float64)
    jsys.params = dataclasses.replace(jsys.params, **overrides)
    jstates = [base._replace(fibers=base.fibers._replace(
        x=base.fibers.x + 0.01 * i)) for i in range(3)]
    tsys = port_system(jsys)
    return jsys, jstates, JRunner, tsys, [port_state(s) for s in jstates]


@pytest.mark.parametrize("impl", ["vmap", "unroll"])
def test_ensemble_ladder_matches_jax(impl):
    """Zero preconditioner with two halvings armed: each lane's retries,
    dt used, health and advanced time equal the JAX vmap runner's."""
    jsys, jstates, JRunner, tsys, tstates = _ensemble_pair(
        guard_dt_halvings=2)
    jchaos.zero_preconditioner(jsys)
    jr = JRunner(jsys, batch_impl="vmap")
    jens, jinfo = jr.step(jr.make_ensemble(jstates, [1.0] * 3))
    tr = chaos.zero_preconditioner(EnsembleRunner(tsys, batch_impl=impl))
    tens, tinfo = tr.step(tr.make_ensemble(tstates, [1.0] * 3))
    np.testing.assert_array_equal(tinfo.guard_retries,
                                  np.asarray(jinfo.guard_retries))
    np.testing.assert_array_equal(tinfo.dt_used, np.asarray(jinfo.dt_used))
    np.testing.assert_array_equal(tinfo.health, np.asarray(jinfo.health))
    assert (tinfo.guard_retries == 2).all()
    np.testing.assert_array_equal(tens.states.time,
                                  np.asarray(jens.states.time))


def test_ensemble_lane_retries_alone_siblings_keep_bits():
    """In the "vmap" plan a lane whose first attempt is declared stagnant
    re-solves alone at dt / 2: its siblings are not re-solved and keep the
    unarmed round's bits, and the retried lane's round is its lone trial
    at dt / 2."""
    _, _, _, tsys, tstates = _ensemble_pair(guard_dt_halvings=1)
    _, _, _, plain_sys, _ = _ensemble_pair()
    plain = EnsembleRunner(plain_sys, batch_impl="vmap")
    ref, ref_info = plain.step(plain.make_ensemble(tstates, [1.0] * 3))
    armed = EnsembleRunner(tsys, batch_impl="vmap")
    orig = armed._batched
    calls = []

    def flaky(st, **kw):
        new, sols, infos = orig(st, **kw)
        calls.append(len(st.time))
        if len(calls) == 1:
            infos[1] = infos[1]._replace(health=verdict.STAGNATION,
                                         residual_true=1.0)
        return new, sols, infos

    armed._batched = flaky
    out, info = armed.step(armed.make_ensemble(tstates, [1.0] * 3))
    assert calls == [3, 1]
    assert list(info.guard_retries) == [0, 1, 0]
    assert info.dt_used[1] == tstates[1].dt / 2
    for lane in (0, 2):
        assert torch.equal(out.states.fibers.x[lane],
                           ref.states.fibers.x[lane])
    lone = orig(stack_states([tstates[1]._replace(dt=tstates[1].dt / 2)]))
    assert torch.equal(out.states.fibers.x[1], lone[0].fibers.x[0])


def test_poison_lane_and_nan_lane_of_isolate_the_lane():
    """`poison_lane` on one lane of a 3-lane round: only that lane fails
    (nonfinite), its siblings keep the clean round's bits; `nan_lane_of`
    poisons the lane a scheduler runs a member on."""
    _, _, _, tsys, tstates = _ensemble_pair()
    runner = EnsembleRunner(tsys, batch_impl="vmap")
    ens = runner.make_ensemble(tstates, [1.0] * 3)
    clean, _ = runner.step(ens)
    out, info = runner.step(chaos.poison_lane(ens, 1))
    assert info.health[1] & verdict.NONFINITE and info.failed[1]
    assert not info.failed[[0, 2]].any() and not info.health[[0, 2]].any()
    for lane in (0, 2):
        assert torch.equal(out.states.fibers.x[lane],
                           clean.states.fibers.x[lane])
    sched = EnsembleScheduler(runner, [MemberSpec(f"m{i}", s, 1.0)
                                       for i, s in enumerate(tstates)], 3)
    lane = chaos.nan_lane_of(sched, "m2")
    assert lane == sched.lane_of("m2")
    assert torch.isnan(lane_state(sched.ens.states, lane).fibers.x).all()
    with pytest.raises(ValueError, match="holds no lane"):
        chaos.nan_lane_of(sched, "nobody")
