"""System orchestrator: state, coupled matvec, solve, adaptive time loop.

Counterpart of `skellysim_tpu.system.system` for free-space fiber systems
(fibers + point/background sources) on one device. The JAX package traces
each trial step into one jitted program; here the step runs eagerly on the
device with the Krylov control flow on the host (`solver.gmres`). The
structure is kept: `_prep` (caches, explicit flows, BC-applied A/RHS and
the batched LU preconditioner), GMRES over `_apply_matvec` /
`_apply_precond` (in "mixed" precision `gmres_ir` with the ``lo=`` f32 seam),
then the advance; `run` wraps it in the adaptive-dt loop with metrics lines
and frame writes.

The solution vector layout matches the reference: 4n entries per fiber,
[x | y | z | tension], buckets in order.

Features this slice does not carry raise `NotImplementedError` naming the
ROADMAP.md §1 item that will add them; none is silently ignored.
"""

from __future__ import annotations

import json
import logging
import math
import time as _time
import warnings
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..fibers import container as fc
from ..guard import verdict as _verdict
from ..params import (REFINE_PAIR_IMPLS, Params, resolve_precision,
                      resolve_refine_impl)
from ..solver import gmres, gmres_ir
from ..solver.gmres import collective_rounds
from .sources import BackgroundFlow, PointSources

logger = logging.getLogger("skellysim_tpu_torch")

#: the JAX package's runtime evaluator names
EVALUATORS = ("direct", "ring", "ewald", "tree", "spectral")


class SimState(NamedTuple):
    """Complete simulation state. ``fibers`` is one `FiberGroup` or a tuple
    of them (one bucket per resolution, solution-vector order); ``time`` and
    ``dt`` are host floats (the time loop is host-driven)."""

    time: float
    dt: float
    fibers: Optional[fc.FiberGroup]
    points: Optional[PointSources] = None
    background: Optional[BackgroundFlow] = None


fiber_buckets = fc.as_buckets


def _rewrap_fibers(fibers, new_buckets):
    """Rebuild the fibers field in its original shape (group vs tuple)."""
    if isinstance(fibers, fc.FiberGroup):
        return new_buckets[0]
    return tuple(new_buckets)


#: run-loop metrics JSONL schema: the same key set as the JAX package's
#: `METRICS_FIELDS`, so one summarizer reads both packages' metrics
METRICS_FIELDS = ("step", "t", "dt", "iters", "gmres_cycles",
                  "collective_rounds", "residual", "residual_true",
                  "fiber_error", "accepted", "refines", "loss_of_accuracy",
                  "health", "guard_retries", "nucleations", "catastrophes",
                  "active_fibers", "wall_s", "wall_ms", "gmres_history",
                  "flight")


def crossed_write_boundary(t_new: float, dt: float, dt_write: float) -> bool:
    """True when the accepted step (t_new - dt, t_new] crosses a dt_write
    frame boundary; tolerant of accumulated roundoff just below a boundary
    (see the JAX package)."""
    def idx(t: float) -> int:
        r = t / dt_write
        return math.floor(r + 1e-9 * max(abs(r), 1.0))

    return idx(t_new) > idx(t_new - dt)


class StepInfo(NamedTuple):
    converged: bool
    iters: int
    residual: float
    fiber_error: float
    residual_true: float = math.nan
    loss_of_accuracy: bool = False
    refines: int = 0
    cycles: int = 0
    history: list | None = None
    health: int = 0
    dt_used: float = 0.0
    guard_retries: int = 0


def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (the JAX package stores time/dt as 0-d
    arrays of the state dtype)."""
    return float(torch.tensor(v, dtype=dtype))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to skellysim_tpu_torch yet (ROADMAP.md §1 "
        f"item {item})")


class System:
    """Static configuration + the eager step/run functions."""

    def __init__(self, params: Params, device=None):
        p = params
        if p.pair_evaluator not in EVALUATORS:
            raise ValueError(
                f"unknown pair_evaluator {p.pair_evaluator!r}; runtime "
                f"values are {', '.join(map(repr, EVALUATORS))}")
        if p.pair_evaluator in ("ewald", "tree", "spectral") or p.periodic_box:
            raise _not_ported(f"pair_evaluator={p.pair_evaluator!r} "
                              "(and periodic boxes)", "10")
        if p.solver_precision not in ("full", "mixed", "auto"):
            raise ValueError(
                f"unknown solver_precision {p.solver_precision!r}; "
                "use 'full', 'mixed', or 'auto'")
        if p.kernel_impl in ("mxu", "df"):
            raise _not_ported(f"kernel_impl={p.kernel_impl!r}", "9")
        if p.kernel_impl not in ("exact", "pallas", "pallas_df"):
            raise ValueError(
                f"unknown kernel_impl {p.kernel_impl!r}; "
                "use 'exact', 'pallas', or 'pallas_df'")
        if p.refine_pair_impl not in REFINE_PAIR_IMPLS:
            raise ValueError(
                f"unknown refine_pair_impl {p.refine_pair_impl!r}; "
                f"use one of {REFINE_PAIR_IMPLS}")
        if p.refine_pair_impl == "df":
            raise _not_ported("refine_pair_impl='df' (XLA double-float "
                              "tiles; the port's f64-grade tile is "
                              "'pallas_df')", "9")
        if p.precond not in ("gs", "jacobi"):
            raise ValueError(
                f"unknown precond {p.precond!r}; use 'gs' or 'jacobi'")
        if p.gmres_block_s > 1:
            raise _not_ported("gmres_block_s > 1 (s-step GMRES)", "3")
        if p.dynamic_instability.n_nodes > 0:
            raise _not_ported("dynamic instability", "8")
        if p.guard_dt_halvings or p.guard_block_fallback or p.guard_f64_fallback:
            raise _not_ported("the guard escalation ladder (guard_*)", "13")
        if p.flight_window > 0:
            raise _not_ported("the flight recorder (flight_window > 0)", "13")
        self.params = params
        self.device = resolve_device(device)

    # ------------------------------------------------------------ policies

    @property
    def _refine_impl(self) -> str:
        """Pairwise tile for mixed-mode f64 residual/prep flows
        (`params.resolve_refine_impl`)."""
        return resolve_refine_impl(self.params.refine_pair_impl,
                                   self.device.type)

    def _precision_for(self, state: SimState) -> str:
        return resolve_precision(self.params.solver_precision,
                                 self._dtype(state) == torch.float64,
                                 self.device.type)

    @staticmethod
    def _dtype(state: SimState):
        return fiber_buckets(state.fibers)[0].x.dtype

    def _ring_active(self) -> bool:
        if self.params.pair_evaluator == "ring":
            # no device mesh exists in a one-card run: the same diagnostic
            # as the JAX package, then the dense direct path
            warnings.warn("pair_evaluator='ring' falls back to 'direct': "
                          "no mesh was configured")
        return False

    def _fiber_flow(self, state: SimState, caches_list, r_trg, forces_list,
                    subtract_self: bool = True, impl: str | None = None):
        """Fiber-source flow through the pair-evaluator seam; every
        resolution bucket contributes sources to ONE kernel pass."""
        if impl is None:
            impl = self.params.kernel_impl
        self._ring_active()
        return fc.flow_multi(fiber_buckets(state.fibers), caches_list, r_trg,
                             forces_list, self.params.eta,
                             subtract_self=subtract_self, evaluator="direct",
                             impl=impl)

    # ---------------------------------------------------------- state setup

    def make_state(self, fibers=None, points=None, background=None,
                   shell=None, bodies=None) -> SimState:
        if shell is not None:
            raise _not_ported("a periphery (shell)", "5")
        if bodies is not None:
            raise _not_ported("bodies", "6")
        if fibers is None:
            raise ValueError(
                "state needs at least one implicit component to solve; "
                "this slice solves fibers (point/background sources only "
                "contribute flow)")
        buckets = fiber_buckets(fibers)
        for g in buckets:
            if g.x.device != self.device:
                raise ValueError(f"fibers live on {g.x.device}, the system "
                                 f"on {self.device}")
        dtype = buckets[0].x.dtype
        return SimState(time=_in_dtype(0.0, dtype),
                        dt=_in_dtype(self.params.dt_initial, dtype),
                        fibers=fibers, points=points, background=background)

    # -------------------------------------------------------------- helpers

    def _node_positions(self, state: SimState):
        return torch.cat([fc.node_positions(g)
                          for g in fiber_buckets(state.fibers)], dim=0)

    def _external_flows(self, state: SimState, r_trg):
        """Point-source + background contributions."""
        v = torch.zeros_like(r_trg)
        if state.points is not None:
            v = v + state.points.flow(r_trg, self.params.eta, state.time)
        if state.background is not None:
            v = v + state.background.flow(r_trg, self.params.eta)
        return v

    def _split(self, state: SimState, x_flat):
        """Flat solution -> per-bucket [nf, 4n] views."""
        out, off = [], 0
        for g in fiber_buckets(state.fibers):
            size = fc.solution_size(g)
            out.append(x_flat[off:off + size].reshape(g.n_fibers,
                                                      4 * g.n_nodes))
            off += size
        return out

    @staticmethod
    def _lo_view(state: SimState, caches):
        """(state, caches) with float32 copies of exactly the leaves the
        f32 operator reads: the fiber groups (node positions, lengths) and
        each fiber's dense self-mobility; the LU factors are f32 already.
        (The JAX package casts every float leaf; the leaves not read are
        skipped here, which at 10k fibers saves several GB.)"""
        f32 = torch.float32

        def cast(g):
            return g._replace(**{k: v.to(f32) for k, v in g._asdict().items()
                                 if torch.is_tensor(v) and v.is_floating_point()})

        fibers = _rewrap_fibers(state.fibers,
                                [cast(g) for g in fiber_buckets(state.fibers)])
        lo_caches = [fc.FiberCaches(xs=None, xss=None, xsss=None, xssss=None,
                                    stokeslet=c.stokeslet.to(f32),
                                    lu=c.lu, piv=c.piv) for c in caches]
        return state._replace(fibers=fibers), lo_caches

    # ----------------------------------------------------------------- prep

    def _prep(self, state: SimState):
        """Velocities, forces, RHS/BC assembly and the LU preconditioner
        (`prep_state_for_solver`). Returns (state, fiber caches)."""
        p = self.params
        buckets = fiber_buckets(state.fibers)
        r_all = self._node_positions(state)
        precision = self._precision_for(state)
        precond_dtype = torch.float32 if precision == "mixed" else None
        # mixed mode evaluates the (f64) prep flows through the refinement
        # tile — kernel B on the card — which sets the RHS accuracy floor
        refine_prep = (precision == "mixed"
                       and self._dtype(state) == torch.float64)
        impl_flow = self._refine_impl if refine_prep else p.kernel_impl

        caches = [fc.update_cache(g, state.dt, p.eta) for g in buckets]
        # wall (steric) forces need a periphery: zero in free space
        external = [torch.zeros_like(g.x) for g in buckets]
        motor_on = state.time >= p.implicit_motor_activation_delay
        motor = [fc.generate_constant_force(g, c) if motor_on
                 else torch.zeros_like(g.x) for g, c in zip(buckets, caches)]
        v_all = self._fiber_flow(state, caches, r_all, external,
                                 impl=impl_flow)
        v_all = v_all + self._external_flows(state, r_all)

        off = 0
        new_caches = []
        for g, c, mo, ex in zip(buckets, caches, motor, external):
            nfn = g.n_fibers * g.n_nodes
            v_fib = v_all[off:off + nfn].reshape(g.n_fibers, g.n_nodes, 3)
            new_caches.append(fc.update_rhs_and_bc(
                g, c, state.dt, p.eta, v_fib, mo + ex, ex,
                precond_dtype=precond_dtype))
            off += nfn
        return state, new_caches

    # ----------------------------------------------------- operator closures

    def _apply_matvec(self, state: SimState, caches, x_flat, lo=None,
                      flow_impl: str | None = None):
        """Coupled operator A x.

        ``lo`` is an optional (state, caches) pair from `_lo_view`: when
        given, the O(N^2) pairwise flow — all the flops — is evaluated in
        f32 through it, while the stiff fiber-local ops (A_bc rows reach
        ~1e7) stay in the ``x_flat`` dtype. This is the cheap operator
        `gmres_ir` iterates with. ``flow_impl`` overrides the pairwise tile
        (the mixed solver's f64 residual passes the refinement tile).
        """
        if flow_impl is None:
            flow_impl = self.params.kernel_impl
        buckets = fiber_buckets(state.fibers)
        f_state, f_caches = (state, caches) if lo is None else lo
        hi_dtype = x_flat.dtype
        lo_dtype = hi_dtype if lo is None else torch.float32

        r_all = self._node_positions(f_state)
        x_fibs = self._split(state, x_flat)
        fws = [fc.apply_fiber_force(g, c, xf)
               for g, c, xf in zip(buckets, caches, x_fibs)]
        v_all = self._fiber_flow(f_state, f_caches, r_all,
                                 [fw.to(lo_dtype) for fw in fws],
                                 subtract_self=True, impl=flow_impl)
        res, off = [], 0
        for g, c, xf in zip(buckets, caches, x_fibs):
            nfn = g.n_fibers * g.n_nodes
            v_fib = v_all[off:off + nfn].reshape(g.n_fibers, g.n_nodes,
                                                 3).to(hi_dtype)
            vb = torch.zeros((g.n_fibers, 7), dtype=hi_dtype,
                             device=x_flat.device)
            res.append(fc.matvec(g, c, xf, v_fib, vb).reshape(-1))
            off += nfn
        return torch.cat(res)

    def _apply_precond(self, state: SimState, caches, x_flat):
        """Block preconditioner P^-1 x: the batched fiber LU solves. With
        no shell, "gs" and "jacobi" coincide (the Gauss-Seidel sweep only
        adds the shell-first coupling correction)."""
        return torch.cat([
            fc.apply_preconditioner(g, c, xf).reshape(-1)
            for g, c, xf in zip(fiber_buckets(state.fibers), caches,
                                self._split(state, x_flat))])

    # ---------------------------------------------------------------- solve

    def _solve_once(self, state: SimState):
        """prep -> GMRES -> advance; returns (new_state, solution, info)."""
        p = self.params
        state, caches = self._prep(state)
        rhs = torch.cat([c.RHS.reshape(-1) for c in caches])

        precision = self._precision_for(state)
        if precision == "mixed":
            # f64 state/assembly/refinement residuals; the Krylov loop's
            # pairwise flows evaluate through f32 copies (the lo seam) while
            # the stiff fiber-local ops stay f64
            lo = self._lo_view(state, caches)
            hi_impl = (self._refine_impl
                       if self._dtype(state) == torch.float64
                       else p.kernel_impl)
            result = gmres_ir(
                lambda v: self._apply_matvec(state, caches, v,
                                             flow_impl=hi_impl),
                lambda v: self._apply_matvec(state, caches, v, lo=lo),
                rhs,
                precond_lo=lambda v: self._apply_precond(lo[0], lo[1], v),
                tol=p.gmres_tol, inner_tol=p.inner_tol,
                restart=p.gmres_restart, maxiter=p.gmres_maxiter,
                max_refine=p.max_refine, history=p.gmres_history,
                block_s=p.gmres_block_s)
        else:
            result = gmres(
                lambda v: self._apply_matvec(state, caches, v),
                rhs,
                precond=lambda v: self._apply_precond(state, caches, v),
                tol=p.gmres_tol, restart=p.gmres_restart,
                maxiter=p.gmres_maxiter, history=p.gmres_history,
                block_s=p.gmres_block_s)

        stepped = [fc.step(g, xf) for g, xf in
                   zip(fiber_buckets(state.fibers),
                       self._split(state, result.x))]
        new_state = state._replace(fibers=_rewrap_fibers(state.fibers,
                                                         stepped))
        fiber_error = max(float(fc.fiber_error(g)) for g in stepped)
        health = result.health | _verdict.nonfinite_word(fiber_error)
        info = StepInfo(converged=bool(result.converged), iters=result.iters,
                        residual=result.residual, fiber_error=fiber_error,
                        residual_true=result.residual_true,
                        loss_of_accuracy=bool(
                            result.converged
                            and result.residual_true > 10.0 * p.gmres_tol),
                        refines=result.refines, cycles=result.cycles,
                        history=result.history, health=health,
                        dt_used=state.dt, guard_retries=0)
        return new_state, result.x, info

    def _check_collision(self, state: SimState) -> bool:
        """Fiber/shell and body collision gate: with no periphery and no
        bodies in this slice nothing can collide."""
        return False

    # ----------------------------------------------------------- public API

    def step(self, state: SimState):
        """One trial step at state.dt: (new_state, solution, info)."""
        return self._solve_once(state)

    def run(self, state: SimState, *, writer=None, max_steps: int | None = None,
            rng=None, metrics_path: str | None = None):
        """Adaptive time loop (`run`): accept/reject on fiber error and
        collision, scale dt by beta_up/beta_down, keep the previous state as
        the backup for rejected steps. ``writer(state, solution,
        rng_state=...)`` is called after each accepted step crossing a
        dt_write boundary; ``metrics_path`` appends one JSON line per trial
        step with exactly the keys of `METRICS_FIELDS`."""
        metrics_fh = open(metrics_path, "a") if metrics_path else None
        try:
            return self._run_loop(state, writer=writer, max_steps=max_steps,
                                  rng=rng, metrics_fh=metrics_fh)
        finally:
            if metrics_fh is not None:
                metrics_fh.close()

    def _run_loop(self, state: SimState, *, writer, max_steps, rng,
                  metrics_fh):
        p = self.params
        dtype = self._dtype(state)
        n_steps = 0
        while state.time < p.t_final:
            if max_steps is not None and n_steps >= max_steps:
                break
            backup = state
            t_cur, dt = state.time, state.dt
            wall0 = _time.perf_counter()
            new_state, solution, info = self.step(state)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall_s = _time.perf_counter() - wall0
            n_steps += 1
            dt = info.dt_used

            dt_new = dt
            accept = True
            if p.adaptive_timestep_flag:
                if info.converged and info.fiber_error <= p.fiber_error_tol:
                    if info.fiber_error <= 0.9 * p.fiber_error_tol:
                        dt_new = min(p.dt_max, dt * p.beta_up)
                else:
                    dt_new = dt * p.beta_down
                    accept = False
                if info.converged and self._check_collision(new_state):
                    dt_new = dt * 0.5
                    accept = False
                if dt_new < p.dt_min:
                    raise RuntimeError("Timestep smaller than dt_min")

            logger.info(
                "step t=%.6g dt=%.4g iters=%d residual=%.3e (true %.3e) "
                "fiber_error=%.3e %s (%.3fs)", t_cur, dt, info.iters,
                info.residual, info.residual_true, info.fiber_error,
                "accepted" if accept else "rejected", wall_s)
            if not info.converged and accept:
                logger.warning(
                    "GMRES did not converge: residual %.3e (true %.3e) vs "
                    "tol %.1e; step accepted (adaptive timestep off)",
                    info.residual, info.residual_true, p.gmres_tol)
            if info.loss_of_accuracy:
                logger.warning(
                    "GMRES loss of accuracy: implicit residual %.3e converged "
                    "but explicit ||b-Ax||/||b|| = %.3e (> 10x tol %.1e)",
                    info.residual, info.residual_true, p.gmres_tol)
            if info.health:
                logger.warning("solver health verdict at t=%.6g: %s "
                               "(health=%#x)", t_cur,
                               _verdict.describe(info.health), info.health)
            if metrics_fh is not None:
                metrics_fh.write(json.dumps({
                    "step": n_steps - 1, "t": t_cur, "dt": dt,
                    "iters": info.iters, "gmres_cycles": info.cycles,
                    "collective_rounds": collective_rounds(
                        info.iters, info.cycles, p.gmres_block_s,
                        restart=p.gmres_restart),
                    "residual": info.residual,
                    "residual_true": info.residual_true,
                    "fiber_error": info.fiber_error, "accepted": accept,
                    "refines": info.refines,
                    "loss_of_accuracy": info.loss_of_accuracy,
                    "health": info.health,
                    "guard_retries": info.guard_retries,
                    "nucleations": 0, "catastrophes": 0, "active_fibers": 0,
                    "wall_s": round(wall_s, 4),
                    "wall_ms": round(wall_s * 1e3, 3),
                    "gmres_history": info.history or [],
                    "flight": None}) + "\n")
                metrics_fh.flush()

            if accept:
                t_new = t_cur + dt
                state = new_state._replace(time=_in_dtype(t_new, dtype),
                                           dt=_in_dtype(dt_new, dtype))
                if writer is not None and crossed_write_boundary(
                        t_new, dt, p.dt_write):
                    if rng is not None:
                        writer(state, solution, rng_state=rng.dump_state())
                    else:
                        writer(state, solution)
            else:
                state = backup._replace(dt=_in_dtype(dt_new, dtype))
        return state
