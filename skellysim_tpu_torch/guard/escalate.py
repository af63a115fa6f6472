"""The escalation ladder: retry a bad trial before failing it.

Counterpart of `skellysim_tpu.guard.escalate`. `escalate(system, state,
first)` wraps one already-computed trial solve with up to three bounded
retry stages (`Params.guard_*`):

1. **dt halvings** (``guard_dt_halvings`` > 0): re-solve at dt/2, dt/4,
   ..., floored at ``dt_min`` under the adaptive gate;
2. **block fallback** (``guard_block_fallback``, taken only with
   ``gmres_block_s > 1``): re-solve with the sequential Arnoldi cycle;
3. **f64 fallback** (``guard_f64_fallback``, taken only in "mixed"):
   re-solve with the full-precision operator (``force_full``), with the
   sequential cycle too when stage 2 is armed.

Only a retryable verdict (stagnation, breakdown: `verdict.retryable`)
whose explicit residual is above ``gmres_tol`` enters a stage: a
nonfinite state is past saving, and a breakdown bit riding a solve whose
restart still converged is not re-solved. Each retry re-solves from the
trial's INPUT state, and a retry's verdict replaces the attempt's:
``info.health`` is that of the attempt that advanced, ``info.dt_used`` its
dt and ``info.guard_retries`` the retries paid. Where the JAX package
spells each stage as a bounded `lax.while_loop` so that a vmapped batch
with no bad member takes no trip, here the ladder is a Python loop on one
host read of (health, residual) a trial; the ensemble runs it lane by lane
for the lanes that need it (`ensemble.runner`), so healthy siblings are
not re-solved.
"""

from __future__ import annotations

from . import verdict


def armed(params) -> bool:
    """Whether any stage of the ladder is enabled."""
    return bool(params.guard_dt_halvings or params.guard_block_fallback
                or params.guard_f64_fallback)


def needs_retry(params, info) -> bool:
    """Retry only what is both retryable and not actually solved (the
    explicit residual is the gate: the implicit-converged / explicit-stuck
    stall reports converged and is what the ladder exists for)."""
    return (verdict.retryable(info.health)
            and info.residual_true > params.gmres_tol)


def escalate(system, state, first, *, resolve=None, pair=None):
    """(new_state, x, info) after the enabled stages on the already
    computed ``first`` attempt. ``state`` is the trial's input state (the
    retry base). ``resolve(trial_state, **overrides)`` re-solves a trial
    (``block_s=``, ``force_full=``); by default `System._solve_once` with
    ``pair``."""
    p = system.params
    if resolve is None:
        def resolve(trial, **overrides):
            return system._solve_once(trial, pair=pair, **overrides)

    def attempt(dt, retries, **overrides):
        # dt / 2 of a value in the state's dtype is that dtype's value
        # again (a power-of-two scale): no rounding to redo
        new, x, info = resolve(state._replace(dt=dt), **overrides)
        return new, x, info._replace(dt_used=dt, guard_retries=retries)

    new, x, info = first
    out = (new, x, info._replace(dt_used=state.dt, guard_retries=0))

    # stage 1: dt halvings
    tries = 0
    while (tries < p.guard_dt_halvings and needs_retry(p, out[2])
           and (not p.adaptive_timestep_flag
                or out[2].dt_used * 0.5 >= p.dt_min)):
        out = attempt(out[2].dt_used * 0.5, out[2].guard_retries + 1)
        tries += 1

    # stage 2: s-step -> the sequential Arnoldi cycle
    if (p.guard_block_fallback and p.gmres_block_s > 1
            and needs_retry(p, out[2])):
        out = attempt(out[2].dt_used, out[2].guard_retries + 1, block_s=1)

    # stage 3: the full-precision re-solve
    if (p.guard_f64_fallback and system._precision_for(state) == "mixed"
            and needs_retry(p, out[2])):
        out = attempt(out[2].dt_used, out[2].guard_retries + 1,
                      block_s=1 if p.guard_block_fallback else None,
                      force_full=True)
    return out
