"""System orchestrator: state, coupled matvec, solve, adaptive time loop.

Counterpart of `skellysim_tpu.system.system` on one device: fibers, a
confining periphery (shell), rigid bodies with attached fibers, and
point/background sources, in any mix; with a mesh (`parallel.make_mesh`)
the fiber and shell pair flows take the ring evaluator, sharded over the
mesh's devices (`parallel.ring`), and `System.step_spmd` runs the whole
step over a mesh of shards (`parallel.spmd`); with
``pair_evaluator="ewald"`` (the reference's "FMM"), ``"tree"`` (the
barycentric treecode) or ``"spectral"``
(the reference's "PVFMM", with a ``periodic_box``) a plan is built on the
host each trial (`_pair_args`) and the flows sum through `ops.ewald` /
`ops.treecode` / `ops.spectral`, with the JAX package's role gating (the
f64 prep flows and refinement residual of "mixed" stay dense in free
space, and shells and bodies below ``ewald_min_sources`` nodes stay on the
dense kernels). The JAX package traces each trial step into one jitted
program; here the step runs eagerly on the device with the Krylov control
flow on the host (`solver.gmres`). The structure is kept: `_prep` (caches,
explicit flows, BC-applied A/RHS and the batched LU preconditioners), GMRES
over `_apply_matvec` / `_apply_precond` (in "mixed" precision `gmres_ir`
with the ``lo=`` f32 seam), then the advance; `run` wraps it in the
adaptive-dt loop with metrics lines and frame writes.

The solution vector layout matches the reference: [fibers (4n per fiber:
x | y | z | tension, buckets in order) | shell (3 per node) | bodies (3 per
node + 6 per body, buckets in order)].

The guard escalation ladder (`guard.escalate`) wraps every trial of
`step` and `trial_step` when ``Params.guard_*`` arms it, and with
``Params.flight_window > 0`` the flight recorder (`obs.flight`) writes one
row a trial, after the ladder, into the ring on ``SimState.flight``.
`velocity_field` / `velocity_at_targets` evaluate the flow of a solved
state at any points (the listener's post-processing, `listener`).
"""

from __future__ import annotations

import json
import logging
import math
import time as _time
import warnings
from typing import NamedTuple, Optional

import torch

from ..bodies import bodies as bd
from ..device import resolve_device
from ..fibers import container as fc
from ..guard import verdict as _verdict
from ..obs.profile import phase
from ..ops.evaluator import EVALUATORS, make_pair
from ..params import (REFINE_PAIR_IMPLS, Params, resolve_precision,
                      resolve_refine_impl)
from ..periphery import periphery as peri
from ..solver import gmres, gmres_ir
from ..solver.gmres import collective_rounds
from .sources import BackgroundFlow, PointSources

logger = logging.getLogger("skellysim_tpu_torch")

#: the pair tiles ``Params.kernel_impl`` names (`ops.kernels`)
KERNEL_IMPLS = ("exact", "pallas", "pallas_df", "mxu", "df")


class SimState(NamedTuple):
    """Complete simulation state. ``fibers`` is one `FiberGroup` or a tuple
    of them (one bucket per resolution, solution-vector order), ``bodies``
    one `BodyGroup` or a tuple of buckets; ``time`` and ``dt`` are host
    floats (the time loop is host-driven)."""

    time: float
    dt: float
    fibers: Optional[fc.FiberGroup]
    points: Optional[PointSources] = None
    background: Optional[BackgroundFlow] = None
    shell: Optional[peri.PeripheryState] = None
    bodies: Optional[bd.BodyGroup] = None
    #: the flight recorder's ring (`obs.flight.FlightRecorder`: [K, 13]
    #: float32 rows and a write count on the state's device), written by
    #: every trial; None when ``Params.flight_window == 0``. Arm or strip
    #: it with `System.ensure_flight`.
    flight: Optional[tuple] = None


fiber_buckets = fc.as_buckets
body_buckets = bd.as_buckets


def _rewrap(field, new_buckets, group_type):
    """Rebuild a fibers/bodies field in its original shape (group vs
    tuple)."""
    if isinstance(field, group_type):
        return new_buckets[0]
    return tuple(new_buckets)


def _rewrap_fibers(fibers, new_buckets):
    return _rewrap(fibers, new_buckets, fc.FiberGroup)


def _cast_floats(nt, dtype):
    """NamedTuple ``nt`` with every floating tensor field cast to
    ``dtype`` (other fields pass)."""
    return nt._replace(**{k: v.to(dtype) for k, v in nt._asdict().items()
                          if torch.is_tensor(v) and v.is_floating_point()})


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


def state_placement(state: SimState):
    """(float dtype, device) of a state, from whichever implicit component
    it has (fibers, then the shell, then the bodies); (float64, None)
    without one."""
    if state.fibers is not None:
        x = fiber_buckets(state.fibers)[0].x
    elif state.shell is not None:
        x = state.shell.density
    elif state.bodies is not None:
        x = body_buckets(state.bodies)[0].solution
    else:
        return torch.float64, None
    return x.dtype, x.device


def solution_from_state(state: SimState):
    """The flat solution vector of a state's components: a fiber's [x | y |
    z | tension] (masked padding rows exact zeros), the shell density, the
    bodies' stored solutions; the inverse of the advance (the reference's
    reconstruction on resume, `trajectory_reader.cpp:227-249`)."""
    parts = []
    for g in fiber_buckets(state.fibers):
        vec = torch.cat([g.x[:, :, 0], g.x[:, :, 1], g.x[:, :, 2],
                         g.tension], dim=1)
        if g.rt_mats is not None:
            vec = torch.where(g.rt_mats.sol_mask.to(vec.device)[None, :],
                              vec, 0.0)
        parts.append(vec.reshape(-1))
    if state.shell is not None:
        parts.append(state.shell.density)
    for g in body_buckets(state.bodies):
        parts.append(g.solution.reshape(-1))
    if not parts:
        raise ValueError("state has no implicit components")
    return torch.cat(parts)


def _in_dtype(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (the JAX package stores time/dt as 0-d
    arrays of the state dtype)."""
    return float(torch.tensor(v, dtype=dtype))


def _plan_summary(plan) -> str:
    """One line of a fast plan's shape (near mode, K, grid, window,
    cells, capacity; a tree's depth, order, capacity and longest
    interaction list)."""
    if hasattr(plan, "depth"):
        from ..ops.treecode import _interaction_lists

        maxI = (_interaction_lists(plan.depth)[0].shape[1] if plan.depth
                else 0)
        return (f"depth={plan.depth} order={plan.order} "
                f"max_occ={plan.max_occ} maxI={maxI}")
    if hasattr(plan, "near_mode"):
        return (f"near {plan.near_mode} K={plan.K} M={plan.M} P={plan.P} "
                f"cells={plan.cells3} max_occ={plan.max_occ}")
    return (f"{plan.mode} M3={plan.M3} P={plan.P} cells={plan.cells3} "
            f"max_occ={plan.max_occ}")


class System:
    """Static configuration + the eager step/run functions.
    ``shell_shape`` is the periphery's collision geometry (required with a
    shell in the state). ``mesh`` (`parallel.make_mesh`) enables the ring
    pair evaluator when ``params.pair_evaluator == "ring"``; its shards
    must lie on devices of the system's device type."""

    def __init__(self, params: Params,
                 shell_shape: Optional[peri.PeripheryShape] = None,
                 device=None, mesh=None):
        p = params
        if p.pair_evaluator not in EVALUATORS:
            raise ValueError(
                f"unknown pair_evaluator {p.pair_evaluator!r}; runtime "
                f"values are {', '.join(map(repr, EVALUATORS))}")
        if p.pair_evaluator == "spectral":
            if len(p.periodic_box) not in (2, 3) or any(
                    L <= 0 for L in p.periodic_box):
                raise ValueError(
                    "pair_evaluator='spectral' needs params.periodic_box — "
                    "(Lx, Ly, Lz) for a triply periodic box or (Lx, Ly) for "
                    f"a doubly periodic slab; got {p.periodic_box!r}. "
                    "For free space use 'ewald' or 'tree'.")
        elif p.periodic_box:
            raise ValueError(
                f"params.periodic_box is set but pair_evaluator "
                f"{p.pair_evaluator!r} sums free-space kernels and would "
                "ignore the periodic images; use pair_evaluator='spectral'")
        if p.solver_precision not in ("full", "mixed", "auto"):
            raise ValueError(
                f"unknown solver_precision {p.solver_precision!r}; "
                "use 'full', 'mixed', or 'auto'")
        if p.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(
                f"unknown kernel_impl {p.kernel_impl!r}; "
                f"use one of {KERNEL_IMPLS}")
        if p.refine_pair_impl not in REFINE_PAIR_IMPLS:
            raise ValueError(
                f"unknown refine_pair_impl {p.refine_pair_impl!r}; "
                f"use one of {REFINE_PAIR_IMPLS}")
        if p.precond not in ("gs", "jacobi"):
            raise ValueError(
                f"unknown precond {p.precond!r}; use 'gs' or 'jacobi'")
        if p.gmres_block_s < 1:
            raise ValueError(
                f"gmres_block_s must be >= 1, got {p.gmres_block_s}")
        self.params = params
        self.shell_shape = shell_shape
        #: spectral FFT grid rungs (`system.buckets.BucketPolicy.grid_ladder`,
        #: set by the CLIs from `[runtime]`); () = the built-in rungs
        self.grid_ladder = ()
        self.device = resolve_device(device)
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices):
            raise ValueError(f"the mesh's shards lie on {mesh.devices}, the "
                             f"system on {self.device}")
        self.mesh = mesh

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
        """The state's float dtype (`state_placement`)."""
        return state_placement(state)[0]

    def _ring_active(self) -> bool:
        ring = self.params.pair_evaluator == "ring"
        if ring and self.mesh is None:
            # the same diagnostic as the JAX package, then the dense direct
            # path: a silent degradation would surprise a user expecting
            # O(N/D) memory a shard
            warnings.warn("pair_evaluator='ring' falls back to 'direct': "
                          "no mesh was configured")
            return False
        return ring

    def _ring_pad_targets(self, r_trg):
        """Pad the target rows to a mesh-size multiple (the shards take
        equal blocks). Pad points sit at 1e6 — far from any geometry, never
        coincident with the 1e7 source pads — and their rows are sliced
        off."""
        T = r_trg.shape[0]
        pad = (-T) % self.mesh.size
        if pad:
            far = torch.full((pad, 3), 1e6, dtype=r_trg.dtype,
                             device=r_trg.device)
            r_trg = torch.cat([r_trg, far], dim=0)
        return r_trg, T

    def _fiber_flow(self, state: SimState, caches_list, r_trg, forces_list,
                    subtract_self: bool = True, impl: str | None = None,
                    pair=None):
        """Fiber-source flow through the pair-evaluator seam; every
        resolution bucket contributes sources to ONE evaluator pass. A
        fast ``pair`` (`ops.evaluator.PairEvaluator`) sums through its
        plan; callers whose flows must stay dense (the mixed solver's f64
        residual and prep in free space, `_refine_pair`) pass none.
        The ring path pads the target rows to a mesh multiple and rotates
        the fiber-node source blocks around the mesh; shell/body target
        rows ride along in the padded target set."""
        buckets = fiber_buckets(state.fibers)
        if impl is None:
            impl = self.params.kernel_impl
        if pair is not None:
            return fc.flow_multi(buckets, caches_list, r_trg, forces_list,
                                 self.params.eta, subtract_self=subtract_self,
                                 impl=impl, pair=pair.at("fibers"))
        if not self._ring_active():
            return fc.flow_multi(buckets, caches_list, r_trg, forces_list,
                                 self.params.eta, subtract_self=subtract_self,
                                 evaluator="direct", impl=impl)
        nfn = sum(g.n_fibers * g.n_nodes for g in buckets)
        if nfn % self.mesh.size != 0:
            raise ValueError(
                f"pair_evaluator='ring' requires the total fiber node count "
                f"({nfn}) to be divisible by the mesh size ({self.mesh.size}); "
                "round the fiber batch up (inactive padding fibers are free)")
        r_pad, T = self._ring_pad_targets(r_trg)
        vel = fc.flow_multi(buckets, caches_list, r_pad, forces_list,
                            self.params.eta, subtract_self=subtract_self,
                            evaluator="ring", mesh=self.mesh, impl=impl)
        return vel[:T]

    def _shell_flow(self, state: SimState, r_trg, density,
                    impl: str | None = None, pair=None):
        """Shell -> target double-layer flow (the shell's self-interaction
        lives in its dense operator); the source padding lives in
        `peri.flow`, the target padding here. A fast ``pair`` takes the
        shell's double layer when the shell has at least
        ``params.ewald_min_sources`` nodes (below that the dense kernel is
        cheaper); callers whose flows must stay dense pass none."""
        if impl is None:
            impl = self.params.kernel_impl
        if (pair is not None
                and state.shell.n_nodes >= self.params.ewald_min_sources):
            return peri.flow(state.shell, r_trg, density, self.params.eta,
                             impl=impl, pair=pair.at("shell"))
        if not self._ring_active():
            return peri.flow(state.shell, r_trg, density, self.params.eta,
                             impl=impl)
        r_pad, T = self._ring_pad_targets(r_trg)
        return peri.flow(state.shell, r_pad, density, self.params.eta,
                         impl=impl, evaluator="ring", mesh=self.mesh)[:T]

    @staticmethod
    def _refine_pair(pair):
        """The plan for the mixed solver's f64 flows (its prep flows and
        refinement residual): none in free space ("ewald", "tree"), where
        they stay dense so that ewald_tol / tree_tol caps neither the RHS
        nor residual_true, as in the JAX package; a periodic plan is kept,
        since no dense sum holds the periodic images. (The JAX package
        keeps those flows dense under "spectral" too, and its refinement
        then converges to the free-space operator: ROADMAP.md §3.)"""
        if pair is not None and pair.evaluator == "spectral":
            return pair
        return None

    def _body_pair(self, group, pair, index: int):
        """``pair`` at body bucket ``index``'s call site for its
        double-layer flow, or None when its node count is below
        ``params.ewald_min_sources`` (dense is cheaper there)."""
        if (pair is None or group is None or group.n_bodies * group.n_nodes
                < self.params.ewald_min_sources):
            return None
        return pair.at("body", index)

    # ---------------------------------------------------------- state setup

    def make_state(self, fibers=None, points=None, background=None,
                   shell=None, bodies=None) -> SimState:
        if fibers is None and shell is None and bodies is None:
            raise ValueError(
                "state needs at least one implicit component (fibers, shell, "
                "or bodies) to solve; point/background sources only "
                "contribute flow")
        if shell is not None and self.shell_shape is None:
            raise ValueError(
                "a periphery state requires System(shell_shape="
                "PeripheryShape(...)) matching the precompute geometry; use "
                "kind='generic' explicitly for a shell with no wall physics")
        if (shell is not None and background is not None
                and background.is_active()):
            raise ValueError("background sources are incompatible with "
                             "peripheries")
        leaves = ([g.x for g in fiber_buckets(fibers)]
                  + ([shell.nodes] if shell is not None else [])
                  + [g.position for g in body_buckets(bodies)])
        for t in leaves:
            if t.device != self.device:
                raise ValueError(f"a state component lives on {t.device}, "
                                 f"the system on {self.device}")
        state = SimState(time=0.0, dt=0.0, fibers=fibers, points=points,
                         background=background, shell=shell, bodies=bodies)
        dtype = self._dtype(state)
        return self.ensure_flight(state._replace(
            time=_in_dtype(0.0, dtype),
            dt=_in_dtype(self.params.dt_initial, dtype)))

    def ensure_flight(self, state: SimState) -> SimState:
        """``state`` with its flight-recorder ring matching
        ``Params.flight_window``: a fresh ring when the window is on and
        the state has none (a state decoded from a frame: the wire never
        carries rings) or one of another size, none when the window is
        off. The run loop, `step`, `step_spmd` and the ensemble's seating
        call it."""
        from ..obs import flight as flight_mod

        window = self.params.flight_window
        if window <= 0:
            return (state if state.flight is None
                    else state._replace(flight=None))
        if state.flight is None or state.flight.rows.shape[-2] != window:
            return state._replace(flight=flight_mod.new_ring(
                window, state_placement(state)[1]))
        return state

    # -------------------------------------------------------------- helpers

    def _node_positions(self, state: SimState, body_caches=None):
        """All hydrodynamic node positions [fibers | shell | bodies].

        Pass ``body_caches`` when available so body node targets are the
        very tensor the body double layer uses as sources: a recomputed
        `place()` (or one in another precision) can leave self pairs 1 ulp
        apart instead of coincident, un-masking the kernel singularity.
        """
        parts = [fc.node_positions(g) for g in fiber_buckets(state.fibers)]
        if state.shell is not None:
            parts.append(state.shell.nodes)
        for i, g in enumerate(body_buckets(state.bodies)):
            nodes = (body_caches[i].nodes if body_caches is not None
                     else bd.place(g)[0])
            parts.append(nodes.reshape(-1, 3))
        return torch.cat(parts, dim=0)

    def _counts(self, state: SimState):
        nf = sum(g.n_fibers * g.n_nodes for g in fiber_buckets(state.fibers))
        ns = state.shell.n_nodes if state.shell is not None else 0
        nb = sum(g.n_bodies * g.n_nodes for g in body_buckets(state.bodies))
        return nf, ns, nb

    def _sizes(self, state: SimState):
        fib = sum(fc.solution_size(g) for g in fiber_buckets(state.fibers))
        shell = state.shell.solution_size if state.shell is not None else 0
        body = sum(g.solution_size for g in body_buckets(state.bodies))
        return fib, shell, body

    def _external_flows(self, state: SimState, r_trg):
        """Point-source + background contributions."""
        v = torch.zeros_like(r_trg)
        if state.points is not None:
            v = v + state.points.flow(r_trg, self.params.eta, state.time)
        if state.background is not None:
            v = v + state.background.flow(r_trg, self.params.eta)
        return v

    def _split(self, state: SimState, x_flat):
        """Flat solution -> (per-bucket [nf, 4n] fiber views, per-bucket
        [nb, 3n+6] body views)."""
        fibs, off = [], 0
        for g in fiber_buckets(state.fibers):
            size = fc.solution_size(g)
            fibs.append(x_flat[off:off + size].reshape(g.n_fibers,
                                                       4 * g.n_nodes))
            off += size
        if state.shell is not None:
            off += state.shell.solution_size
        bods = []
        for g in body_buckets(state.bodies):
            bods.append(x_flat[off:off + g.solution_size].reshape(
                g.n_bodies, 3 * g.n_nodes + 6))
            off += g.solution_size
        return fibs, bods

    @staticmethod
    def _lo_view(state: SimState, caches, body_caches):
        """(state, fiber caches, body caches) with float32 copies of the
        leaves the f32 operator reads: the fiber groups and each fiber's
        dense self-mobility; the shell (nodes, normals, the dense operator;
        M_inv is f32 already); the body groups and caches (the LU factors
        are f32 already). With a shell, each fiber's BC-applied A and
        tangents are cast too: the Gauss-Seidel correction applies the
        fiber rows in the preconditioner's precision. (The JAX package casts
        every float leaf; the leaves not read are skipped here, which at 10k
        fibers saves several GB.) Body node targets and sources stay one
        tensor (`_node_positions`)."""
        f32 = torch.float32
        has_shell = state.shell is not None
        fibers = state.fibers
        if fibers is not None:
            fibers = _rewrap_fibers(fibers, [_cast_floats(g, f32)
                                             for g in fiber_buckets(fibers)])
        lo_caches = None if caches is None else [
            fc.FiberCaches(xs=c.xs.to(f32) if has_shell else None, xss=None,
                           xsss=None, xssss=None,
                           stokeslet=c.stokeslet.to(f32),
                           A_bc=c.A_bc.to(f32) if has_shell else None,
                           lu=c.lu, piv=c.piv) for c in caches]
        shell = None if state.shell is None else _cast_floats(state.shell,
                                                              f32)
        bodies = state.bodies
        if bodies is not None:
            bodies = _rewrap(bodies, [_cast_floats(g, f32)
                                      for g in body_buckets(bodies)],
                             bd.BodyGroup)
        lo_bcaches = (None if body_caches is None
                      else [_cast_floats(c, f32) for c in body_caches])
        return (state._replace(fibers=fibers, shell=shell, bodies=bodies),
                lo_caches, lo_bcaches)

    # ------------------------------------------- fiber-periphery coupling

    def _periphery_force_fibers(self, state: SimState):
        """Steric wall force on fiber nodes, one [nf, n, 3] tensor per
        bucket (applied during every solve; zero without a shell)."""
        buckets = fiber_buckets(state.fibers)
        if state.shell is None:
            return [torch.zeros_like(g.x) for g in buckets]
        fp = self.params.fiber_periphery_interaction
        return [peri.fiber_steric_force(self.shell_shape, g.x, fp.f_0,
                                        fp.l_0, g.minus_clamped)
                for g in buckets]

    def _update_plus_pinning(self, state: SimState) -> SimState:
        """Hinge plus ends near an attachment-active periphery."""
        pb = self.params.periphery_binding
        buckets = fiber_buckets(state.fibers)
        if state.shell is None or not pb.active or not buckets:
            return state

        def pinned(g):
            x = g.x
            if g.rt_mats is None:
                tip = x[:, -1]
            else:
                # the plus end is the last LIVE node; padding rows replicate
                # node 0 and must not read as contact
                m = g.mats
                tip = torch.einsum("n,fnk->fk", m.e_last, x)
                x = torch.where(m.node_mask[None, :, None], x,
                                tip[:, None, :])
            tip = tip / torch.linalg.vector_norm(tip, dim=-1, keepdim=True)
            angle = torch.arccos(torch.clamp(tip[:, 2], -1.0, 1.0))
            in_window = ((angle >= pb.polar_angle_start)
                         & (angle <= pb.polar_angle_end))
            near = peri.check_collision(self.shell_shape, x, pb.threshold)
            return g._replace(plus_pinned=in_window & near)

        return state._replace(fibers=_rewrap_fibers(
            state.fibers, [pinned(g) for g in buckets]))

    # ----------------------------------------------------------------- prep

    def _prep(self, state: SimState, pair=None):
        """Velocities, forces, RHS/BC assembly and the LU preconditioners
        (`prep_state_for_solver`). Returns (state, fiber caches, body
        caches, shell RHS, body RHS)."""
        p = self.params
        state = self._update_plus_pinning(state)
        buckets = fiber_buckets(state.fibers)
        b_list = body_buckets(state.bodies)
        precision = self._precision_for(state)
        precond_dtype = torch.float32 if precision == "mixed" else None
        # mixed mode evaluates the (f64) prep flows through the refinement
        # tile — kernels B / D on the card — which sets the RHS accuracy floor
        refine_prep = (precision == "mixed"
                       and self._dtype(state) == torch.float64)
        impl_flow = self._refine_impl if refine_prep else p.kernel_impl
        # ... and in free space those flows stay dense (the plan withheld),
        # so ewald_tol cannot cap the RHS accuracy
        prep_pair = self._refine_pair(pair) if refine_prep else pair

        body_caches = [bd.update_cache(g, p.eta, precond_dtype=precond_dtype)
                       for g in b_list] or None
        r_all = self._node_positions(state, body_caches)
        nf_nodes, ns_nodes, _ = self._counts(state)
        v_all = torch.zeros_like(r_all)

        caches = None
        if buckets:
            caches = [fc.update_cache(g, state.dt, p.eta) for g in buckets]
            external = self._periphery_force_fibers(state)
            motor_on = state.time >= p.implicit_motor_activation_delay
            motor = [fc.generate_constant_force(g, c) if motor_on
                     else torch.zeros_like(g.x)
                     for g, c in zip(buckets, caches)]
            v_all = v_all + self._fiber_flow(state, caches, r_all, external,
                                             impl=impl_flow, pair=prep_pair)
        # external body forces/torques induce explicit flow everywhere
        for g, bc in zip(b_list, body_caches or []):
            v_all = v_all + bd.flow(g, bc, r_all, None,
                                    bd.external_forces_torques(g, state.time),
                                    p.eta, impl=impl_flow)
        v_all = v_all + self._external_flows(state, r_all)

        body_rhs, off = [], nf_nodes + ns_nodes
        for g in b_list:
            nbn = g.n_bodies * g.n_nodes
            body_rhs.append(bd.update_RHS(g, v_all[off:off + nbn].reshape(
                g.n_bodies, g.n_nodes, 3)))
            off += nbn

        if buckets:
            off = 0
            new_caches = []
            for g, c, mo, ex in zip(buckets, caches, motor, external):
                nfn = g.n_fibers * g.n_nodes
                v_fib = v_all[off:off + nfn].reshape(g.n_fibers, g.n_nodes, 3)
                new_caches.append(fc.update_rhs_and_bc(
                    g, c, state.dt, p.eta, v_fib, mo + ex, ex,
                    precond_dtype=precond_dtype))
                off += nfn
            caches = new_caches
        shell_rhs = (None if state.shell is None else
                     peri.update_RHS(v_all[nf_nodes:nf_nodes + ns_nodes],
                                     state.shell.node_mask))
        return state, caches, body_caches, shell_rhs, body_rhs

    # ----------------------------------------------------- operator closures

    def _apply_matvec(self, state: SimState, caches, body_caches, x_flat,
                      lo=None, flow_impl: str | None = None, pair=None):
        """Coupled operator A x.

        ``lo`` is an optional (state, caches, body caches) triple from
        `_lo_view`: when given, the O(N^2) pairwise flows and the
        well-scaled shell/body dense ops — all the flops — are evaluated in
        f32 through it, while the stiff fiber-local ops (A_bc rows reach
        ~1e7) and the fiber-body link conditions stay in the ``x_flat``
        dtype. This is the cheap operator `gmres_ir` iterates with.
        ``flow_impl`` overrides the pairwise tile (the mixed solver's f64
        residual passes the refinement tile). ``pair`` routes the pair
        flows through a fast plan (`_pair_args`).
        """
        p = self.params
        if flow_impl is None:
            flow_impl = p.kernel_impl
        buckets = fiber_buckets(state.fibers)
        b_list = body_buckets(state.bodies)
        fib_size, shell_size, _ = self._sizes(state)
        nf_nodes, ns_nodes, _ = self._counts(state)
        x_shell = x_flat[fib_size:fib_size + shell_size]
        f_state, f_caches, f_bcaches = ((state, caches, body_caches)
                                        if lo is None else lo)
        hi_dtype = x_flat.dtype
        lo_dtype = hi_dtype if lo is None else torch.float32

        r_all = self._node_positions(f_state, f_bcaches)
        v_all = torch.zeros_like(r_all)
        x_fibs, x_bods = self._split(state, x_flat)
        if buckets:
            fws = [fc.apply_fiber_force(g, c, xf)
                   for g, c, xf in zip(buckets, caches or [], x_fibs)]
            v_all = v_all + self._fiber_flow(f_state, f_caches, r_all,
                                             [fw.to(lo_dtype) for fw in fws],
                                             subtract_self=True,
                                             impl=flow_impl, pair=pair)
        if state.shell is not None and (buckets or b_list):
            # the shell flow is evaluated at fiber and body nodes only; its
            # self-interaction lives in the dense operator
            r_fb = torch.cat([r_all[:nf_nodes], r_all[nf_nodes + ns_nodes:]])
            v_s = self._shell_flow(f_state, r_fb, x_shell.to(lo_dtype),
                                   impl=flow_impl, pair=pair)
            v_all[:nf_nodes] += v_s[:nf_nodes]
            v_all[nf_nodes + ns_nodes:] += v_s[nf_nodes:]

        v_boundaries = [torch.zeros((g.n_fibers, 7), dtype=hi_dtype,
                                    device=x_flat.device) for g in buckets]
        if b_list:
            nbt = bd.n_total(b_list)
            body_fts = [torch.zeros((g.n_bodies, 6), dtype=hi_dtype,
                                    device=x_flat.device) for g in b_list]
            # link conditions per (fiber bucket x body bucket), in the hi
            # dtype: each fiber's GLOBAL binding id remaps to a bucket-local
            # slot, so a fiber contributes to exactly one body bucket
            for j, (gb, bc, xb) in enumerate(zip(b_list, body_caches,
                                                 x_bods)):
                for i, (gf, c, xf) in enumerate(zip(buckets, caches or [],
                                                    x_fibs)):
                    vb, ft = bd.link_conditions(
                        gb, bc, bd.local_binding(gf, gb, nbt), c, xf, xb)
                    v_boundaries[i] = v_boundaries[i] + vb
                    body_fts[j] = body_fts[j] + ft
            for j, (f_gb, f_bc, xb, ft) in enumerate(zip(
                    body_buckets(f_state.bodies), f_bcaches, x_bods,
                    body_fts)):
                b_pair = self._body_pair(f_gb, pair, j)
                v_all = v_all + bd.flow(f_gb, f_bc, r_all, xb.to(lo_dtype),
                                        ft.to(lo_dtype), p.eta,
                                        impl=flow_impl, pair=b_pair)

        res, off = [], 0
        for g, c, xf, vb in zip(buckets, caches or [], x_fibs, v_boundaries):
            nfn = g.n_fibers * g.n_nodes
            v_fib = v_all[off:off + nfn].reshape(g.n_fibers, g.n_nodes,
                                                 3).to(hi_dtype)
            res.append(fc.matvec(g, c, xf, v_fib, vb).reshape(-1))
            off += nfn
        if state.shell is not None:
            res.append(peri.matvec(f_state.shell, x_shell.to(lo_dtype),
                                   v_all[nf_nodes:nf_nodes + ns_nodes])
                       .to(hi_dtype))
        off = nf_nodes + ns_nodes
        for f_gb, f_bc, xb in zip(body_buckets(f_state.bodies),
                                  f_bcaches or [], x_bods):
            nbn = f_gb.n_bodies * f_gb.n_nodes
            v_b = v_all[off:off + nbn].reshape(f_gb.n_bodies, f_gb.n_nodes, 3)
            res.append(bd.matvec(f_gb, f_bc, xb.to(lo_dtype), v_b)
                       .to(hi_dtype).reshape(-1))
            off += nbn
        return torch.cat(res)

    def _apply_precond(self, state: SimState, caches, body_caches, x_flat,
                       pair=None):
        """Block preconditioner P^-1 x.

        "jacobi" is the reference's independent block solves (fiber LU,
        shell M_inv, body LU). "gs" (the default) is a block Gauss-Seidel
        sweep, shell block first: the shell solve's double-layer flow is
        evaluated at the fiber/body nodes (one extra stresslet launch) and
        its coupling rows are subtracted from their right-hand sides before
        the fiber/body block solves. Both coincide without a shell. In
        mixed mode ``state``/``caches`` are the `_lo_view`, and the
        corrections run in its f32 precision.

        The whole application is the phase ``precond``
        (`obs.profile.phase`), nested under whatever solver phase invoked
        it (``gmres/arnoldi/precond`` in the Krylov loop).
        """
        with phase("precond"):
            return self._apply_precond_impl(state, caches, body_caches,
                                            x_flat, pair=pair)

    def _apply_precond_impl(self, state: SimState, caches, body_caches,
                            x_flat, pair=None):
        buckets = fiber_buckets(state.fibers)
        b_list = body_buckets(state.bodies)
        fib_size, shell_size, _ = self._sizes(state)
        nf_nodes, ns_nodes, nb_nodes = self._counts(state)
        x_fibs, x_bods = self._split(state, x_flat)

        y_shell = v_corr = None
        if state.shell is not None:
            y_shell = peri.apply_preconditioner(
                state.shell, x_flat[fib_size:fib_size + shell_size])
            if self.params.precond == "gs" and nf_nodes + nb_nodes > 0:
                r_all = self._node_positions(state, body_caches)
                r_fb = torch.cat([r_all[:nf_nodes],
                                  r_all[nf_nodes + ns_nodes:]])
                v_corr = self._shell_flow(
                    state, r_fb, y_shell.to(state.shell.nodes.dtype),
                    pair=pair)

        res, off_v = [], 0
        for g, c, xf in zip(buckets, caches or [], x_fibs):
            if v_corr is not None:
                nfn = g.n_fibers * g.n_nodes
                v_fib = v_corr[off_v:off_v + nfn].reshape(g.n_fibers,
                                                          g.n_nodes, 3)
                # fiber rows of A at (0, y_shell, 0): the pure coupling term
                ld = g.x.dtype
                xf = xf - fc.matvec(
                    g, c, torch.zeros_like(xf, dtype=ld), v_fib.to(ld),
                    torch.zeros((g.n_fibers, 7), dtype=ld,
                                device=xf.device)).to(xf.dtype)
                off_v += nfn
            res.append(fc.apply_preconditioner(g, c, xf).reshape(-1))
        if y_shell is not None:
            res.append(y_shell)
        for g, bc, xb in zip(b_list, body_caches or [], x_bods):
            if v_corr is not None:
                nbn = g.n_bodies * g.n_nodes
                v_b = v_corr[off_v:off_v + nbn].reshape(g.n_bodies,
                                                        g.n_nodes, 3)
                # body rows of A at (0, y_shell, 0) = [v_nodes, 0]
                ld = bc.K.dtype
                xb = xb - bd.matvec(g, bc, torch.zeros_like(xb, dtype=ld),
                                    v_b.to(ld)).to(xb.dtype)
                off_v += nbn
            res.append(bd.apply_preconditioner(g, bc, xb).reshape(-1))
        return torch.cat(res)

    # ---------------------------------------------------------------- solve

    def _solve_impl(self, state: SimState, pair=None):
        """One trial solve, with the guard escalation ladder around it
        when any ``Params.guard_*`` stage is armed (`guard.escalate`)."""
        from ..guard import escalate

        out = self._solve_once(state, pair=pair)
        if escalate.armed(self.params):
            out = escalate.escalate(self, state, out, pair=pair)
        if self.params.flight_window > 0:
            out = self._record_flight(state, *out)
        return out

    def _record_flight(self, state: SimState, new_state: SimState, x, info):
        """(new_state with the trial's flight row appended, x, info): one
        row a trial, after the guard ladder, so it records the attempt
        that advanced (its dt and health); device operations only."""
        from ..obs import flight as flight_mod

        if new_state.flight is None:
            raise ValueError(
                "Params.flight_window > 0 but the state carries no recorder "
                "ring; arm it with System.ensure_flight (make_state arms it)")
        return new_state._replace(flight=flight_mod.record_step(
            state, new_state, x, residual_true=info.residual_true,
            health=info.health, dt_used=info.dt_used,
            shell_shape=self.shell_shape)), x, info

    def _solve_once(self, state: SimState, pair=None,
                    block_s: int | None = None, force_full: bool = False):
        """prep -> GMRES -> advance; returns (new_state, solution, info).
        ``pair``: the fast evaluator of this solve (`_pair_args`), handed
        to the flows by their role. ``block_s`` / ``force_full`` are the
        guard ladder's overrides (`guard.escalate`): re-solve with another
        Arnoldi cycle / with the full-precision operator instead of the
        configured ones (the prep stays the configured precision's, as in
        the JAX package). Nothing here writes into ``state``'s tensors, so
        a retry from the same state is a fresh solve. Its phases
        (`obs.profile.phase`) are the JAX package's: ``prep``, ``gmres``
        and ``advance``."""
        p = self.params
        bs = p.gmres_block_s if block_s is None else block_s
        with phase("prep"):
            state, caches, body_caches, shell_rhs, body_rhs = self._prep(
                state, pair=pair)
            rhs = torch.cat([c.RHS.reshape(-1) for c in caches or []]
                            + ([shell_rhs] if shell_rhs is not None else [])
                            + [br.reshape(-1) for br in body_rhs])

        precision = "full" if force_full else self._precision_for(state)
        # the f32 lo view is the Krylov solve's own setup: in the JAX
        # package XLA fuses those casts into the loop that reads them
        with phase("gmres"):
            if precision == "mixed":
                # f64 state/assembly/refinement residuals; the Krylov
                # loop's pairwise flows and shell/body dense ops evaluate
                # through f32 copies (the lo seam) while the stiff
                # fiber-local ops stay f64
                lo = self._lo_view(state, caches, body_caches)
                hi_impl = (self._refine_impl
                           if self._dtype(state) == torch.float64
                           else p.kernel_impl)
                result = gmres_ir(
                    # the f64 residual matvec (`_refine_pair`: dense in free
                    # space, so ewald_tol cannot cap residual_true)
                    lambda v: self._apply_matvec(
                        state, caches, body_caches, v, flow_impl=hi_impl,
                        pair=self._refine_pair(pair)),
                    lambda v: self._apply_matvec(state, caches, body_caches,
                                                 v, lo=lo, pair=pair),
                    rhs,
                    precond_lo=lambda v: self._apply_precond(
                        *lo, v, pair=pair),
                    tol=p.gmres_tol, inner_tol=p.inner_tol,
                    restart=p.gmres_restart, maxiter=p.gmres_maxiter,
                    max_refine=p.max_refine, history=p.gmres_history,
                    block_s=bs)
            else:
                result = gmres(
                    lambda v: self._apply_matvec(state, caches, body_caches,
                                                 v, pair=pair),
                    rhs,
                    precond=lambda v: self._apply_precond(
                        state, caches, body_caches, v, pair=pair),
                    tol=p.gmres_tol, restart=p.gmres_restart,
                    maxiter=p.gmres_maxiter, history=p.gmres_history,
                    block_s=bs)

        with phase("advance"):
            x_fibs, x_bods = self._split(state, result.x)
            new_state = state
            if state.fibers is not None:
                new_state = new_state._replace(fibers=_rewrap_fibers(
                    state.fibers,
                    [fc.step(g, xf) for g, xf in
                     zip(fiber_buckets(state.fibers), x_fibs)]))
            if state.shell is not None:
                fib_size, shell_size, _ = self._sizes(state)
                new_state = new_state._replace(shell=state.shell._replace(
                    density=result.x[fib_size:fib_size + shell_size]))
            if state.bodies is not None:
                new_b = [bd.step(g, xb, state.dt) for g, xb
                         in zip(body_buckets(state.bodies), x_bods)]
                new_state = new_state._replace(
                    bodies=_rewrap(state.bodies, new_b, bd.BodyGroup))
                if state.fibers is not None:
                    # bound fibers re-pin to their (moved) nucleation sites,
                    # one body bucket at a time (a fiber is bound to at most
                    # one)
                    nbt = bd.n_total(new_b)
                    repinned = list(fiber_buckets(new_state.fibers))
                    for gb in new_b:
                        sites = bd.place(gb)[2]
                        repinned = [g._replace(x=bd.repin_to_bodies(
                            bd.local_binding(g, gb, nbt), sites, gb).x)
                            for g in repinned]
                    new_state = new_state._replace(
                        fibers=_rewrap_fibers(new_state.fibers, repinned))
            fiber_error = max([float(fc.fiber_error(g))
                               for g in fiber_buckets(new_state.fibers)],
                              default=0.0)
            health = result.health | _verdict.nonfinite_word(fiber_error)
            info = StepInfo(
                converged=bool(result.converged), iters=result.iters,
                residual=result.residual, fiber_error=fiber_error,
                residual_true=result.residual_true,
                loss_of_accuracy=bool(
                    result.converged
                    and result.residual_true > 10.0 * p.gmres_tol),
                refines=result.refines, cycles=result.cycles,
                history=result.history, health=health, dt_used=state.dt,
                guard_retries=0)
        return new_state, result.x, info

    def _check_collision(self, state: SimState) -> bool:
        """Fiber/shell and body collision gate: body-body (spheres), body
        vs a spherical shell, and any fiber node (a clamped fiber's
        anchored first node excepted) crossing the shell. The phase
        ``collision`` (`obs.profile.phase`)."""
        with phase("collision"):
            return self._check_collision_impl(state)

    def _check_collision_impl(self, state: SimState) -> bool:
        if state.bodies is not None:
            if bd.check_collision_pairwise_multi(state.bodies, 0.0):
                return True
            if (state.shell is not None and self.shell_shape.kind == "sphere"
                    and bd.check_collision_shell_multi(
                        state.bodies, self.shell_shape.radius, 0.0)):
                return True
        if state.shell is None:
            return False
        for g in fiber_buckets(state.fibers):
            n = g.n_nodes
            # excluded rows (a clamped fiber's anchored first node, masked
            # padding rows) take the last LIVE node, interior by construction
            keep = (torch.arange(n, device=g.x.device)[None, :]
                    >= torch.where(g.minus_clamped, 1, 0)[:, None])
            if g.rt_mats is None:
                safe = g.x[:, -1:, :]
            else:
                m = g.mats
                safe = torch.einsum("n,fnk->fk", m.e_last, g.x)[:, None, :]
                keep = keep & m.node_mask[None, :]
            pts = torch.where(keep[..., None], g.x, safe)
            if bool(torch.any(peri.check_collision(self.shell_shape, pts,
                                                   0.0))):
                return True
        return False

    # ----------------------------------------------------------- public API

    def _plan_points(self, state: SimState, extra_targets=None):
        """(points, n_fill, n_src) on the host over every ACTIVE
        hydrodynamic node, the input of both planners: inactive fiber slots
        are left out of the bounding box and reserved as ``n_fill`` spread
        capacity instead; ``extra_targets`` ([n, 3]) extends the box to
        off-node evaluation points (a velocity field's). Copying the
        positions to the host synchronizes the device."""
        import numpy as np

        n_fill = 0
        n_src = 0
        parts = []
        for g in fiber_buckets(state.fibers):
            # per NODE: inactive slots and masked padding rows are both
            # reserved as spread fill capacity
            act = g.active.cpu().numpy()[:, None] & fc.node_mask_np(g)[None]
            x = g.x.cpu().numpy()[act].reshape(-1, 3)
            parts.append(x)
            n_fill += int((~act).sum())
            n_src += x.shape[0]
        if state.shell is not None:
            nodes = state.shell.nodes.cpu().numpy()
            if state.shell.node_mask is not None:
                nodes = nodes[state.shell.node_mask.cpu().numpy()]
            parts.append(nodes)
        for g in body_buckets(state.bodies):
            parts.append(bd.place(g)[0].cpu().numpy().reshape(-1, 3))
        if extra_targets is not None:
            parts.append((extra_targets.cpu().numpy()
                          if torch.is_tensor(extra_targets)
                          else np.asarray(extra_targets)).reshape(-1, 3))
        return np.concatenate(parts, axis=0), n_fill, n_src

    def make_ewald_plan(self, state: SimState, extra_targets=None):
        """Host-side Ewald plan over the `_plan_points` cloud
        (`ops.ewald.plan_ewald` at ``params.ewald_tol``), the analogue of
        the reference's per-step FMM tree rebuild."""
        from ..ops.ewald import plan_ewald

        pts, n_fill, n_src = self._plan_points(state, extra_targets)
        return plan_ewald(pts, eta=self.params.eta,
                          tol=self.params.ewald_tol, n_fill=n_fill,
                          n_src=n_src)

    def make_tree_plan(self, state: SimState, extra_targets=None):
        """Host-side treecode plan over the `_plan_points` cloud
        (`ops.treecode.plan_tree` at ``params.tree_tol``, inactive fiber
        slots reserved as fill capacity)."""
        from ..ops.treecode import plan_tree

        pts, n_fill, _ = self._plan_points(state, extra_targets)
        return plan_tree(pts, tol=self.params.tree_tol, n_fill=n_fill)

    def make_spectral_plan(self, state: SimState, extra_targets=None):
        """Host-side spectral Ewald plan over the `_plan_points` cloud for
        ``params.periodic_box`` (`ops.spectral.plan_spectral` at
        ``params.spectral_tol``, grid dims on ``self.grid_ladder``'s rungs,
        or the built-in ones)."""
        from ..ops.spectral import plan_spectral

        pts, n_fill, _ = self._plan_points(state, extra_targets)
        return plan_spectral(pts, self.params.periodic_box,
                             eta=self.params.eta,
                             tol=self.params.spectral_tol, n_fill=n_fill,
                             grid_ladder=self.grid_ladder)

    def _pair_args(self, state: SimState, extra_targets=None):
        """The `PairEvaluator` of the configured fast evaluator, its plan
        built on the host (over the nodes and ``extra_targets``) and its
        anchors on the system's device, or None for the dense and ring
        paths: the one place a plan is built a solve. A plan that cannot
        be built raises; nothing falls back to the dense sum."""
        ev = self.params.pair_evaluator
        if ev not in ("ewald", "tree", "spectral"):
            return None
        maker = {"ewald": self.make_ewald_plan, "tree": self.make_tree_plan,
                 "spectral": self.make_spectral_plan}[ev]
        return make_pair(maker(state, extra_targets=extra_targets),
                         self.device)

    def step(self, state: SimState):
        """One trial step at state.dt: (new_state, solution, info). With a
        fast evaluator the plan is built first, on the host; its seconds
        and shape are the INFO log line "... plan before t=..."."""
        state = self.ensure_flight(state)
        t0 = _time.perf_counter()
        pair = self._pair_args(state)
        if pair is not None:
            logger.info("%s plan before t=%.6g: %s, plan_s=%.4f",
                        pair.evaluator, state.time, _plan_summary(pair.plan),
                        _time.perf_counter() - t0)
        return self._solve_impl(state, pair=pair)

    def trial_step(self, state: SimState, pair=None):
        """The trial: (new_state, solution, info) of prep, GMRES and the
        advance at ``state.dt`` (with the guard ladder when armed), with
        ``pair`` (a `PairEvaluator`, or None for the dense paths) given by
        the caller. The ensemble's ``"unroll"`` plan runs each lane through
        it (the JAX package's `trial_step`, which the ensemble maps over
        members); `step` is it with the plan built first."""
        return self._solve_impl(state, pair=pair)

    def collision(self, state: SimState) -> bool:
        """The collision gate the adaptive loop rejects on (fiber nodes
        crossing the shell, body-body and body-shell)."""
        return self._check_collision(state)

    # -------------------------------------------------------- velocity field

    def velocity_field(self, state: SimState, solution, pair=None):
        """The flow of a solved state as a function of the points
        (`VelocityField`): its sources (the fiber force densities, with the
        steric wall force when ``periphery_interaction_flag`` is set, the
        bodies' densities and link forces, the shell density) built here,
        once; each call is the pair sums at its points. ``pair``: a fast
        evaluator whose plan covers the points (`_pair_args` with
        ``extra_targets``), or None for the dense and ring sums."""
        return VelocityField(self, state, solution, pair)

    def velocity_at_targets(self, state: SimState, solution, r_trg):
        """The velocity at [n, 3] points ``r_trg`` of a solved state
        (`system.cpp:330-384`): fiber, body, shell and external flows, and
        inside a rigid body its rigid motion. A configured fast evaluator
        plans over the nodes and these points."""
        r_trg = torch.as_tensor(r_trg, dtype=solution.dtype,
                                device=solution.device).reshape(-1, 3)
        pair = self._pair_args(state, extra_targets=r_trg)
        return self.velocity_field(state, solution, pair)(r_trg)

    def step_spmd(self, state, mesh, *, allow_replicated_shell: bool = False,
                  flat_solution: bool = True, donate="auto"):
        """One sharded implicit step on ``mesh`` (`parallel.spmd`): prep,
        GMRES and the advance over the mesh's shards, with the pair flows
        at resident rows around the ring, psum'd partials onto replicated
        rows and the GMRES dot products summed across shards. ``state`` is
        a `parallel.mesh.ShardedState` (`parallel.shard_state`); returns
        (new_state, solution, info) with ``new_state`` still sharded
        (`parallel.mesh.gather_state` brings it back to one device).

        ``pair_evaluator = "tree"`` composes with this path when every
        fiber slot is active: the tree plan is built on the host once a
        step over the whole state, as in `step` (on a mesh that spans
        processes, every process builds it from the all-gathered
        positions, so that every process gets the same plan), and the
        Krylov interior's fiber flows take it on every shard. With an inactive slot (the
        layout cannot spread padding nodes) the ring flows run, as they do
        for every other evaluator. Nothing is cached between calls;
        ``donate`` is accepted and ignored (`parallel.spmd
        .build_spmd_step`)."""
        from ..parallel import multihost
        from ..parallel.mesh import gather_state
        from ..parallel.spmd import build_spmd_step

        state = state._replace(shards=tuple(self.ensure_flight(st)
                                            for st in state.shards))
        pair = None
        full = self.params.pair_evaluator == "tree" and all(
            bool(g.active.all()) for st in state.shards
            for g in fiber_buckets(st.fibers))
        if self.params.pair_evaluator == "tree" and mesh.spans_processes:
            # every process takes the same branch: its shards' slots and
            # every other process's
            full = all(multihost.all_gather_object(full))
        if full:
            t0 = _time.perf_counter()
            pair = self._pair_args(gather_state(state, self.device,
                                                shell_operators=False))
            logger.info("%s plan before t=%.6g (sharded step): %s, "
                        "plan_s=%.4f", pair.evaluator, state.time,
                        _plan_summary(pair.plan), _time.perf_counter() - t0)
        fn = build_spmd_step(self, mesh, state,
                             allow_replicated_shell=allow_replicated_shell,
                             flat_solution=flat_solution, donate=donate,
                             pair=pair)
        return fn(state)

    def run(self, state: SimState, *, writer=None, max_steps: int | None = None,
            rng=None, metrics_path: str | None = None,
            profile_dir: str | None = None, trace_path: str | None = None):
        """Adaptive time loop (`run`): accept/reject on fiber error and
        collision, scale dt by beta_up/beta_down, keep the previous state as
        the backup for rejected steps. ``writer(state, solution,
        rng_state=...)`` is called after each accepted step crossing a
        dt_write boundary; ``metrics_path`` appends one JSON line per trial
        step with exactly the keys of `METRICS_FIELDS`. Passing a `SimRNG`
        enables dynamic instability when
        ``params.dynamic_instability.n_nodes > 0``: the update runs on the
        host before each trial (its seconds are the ``di_s`` log field),
        and a rejected trial restores the state from before it without
        rewinding the RNG. ``trace_path`` opens a telemetry stream
        (`obs.tracer`) for the loop: the spans ``run``,
        ``dynamic_instability``, ``step`` (a trial, to a device
        synchronise) and ``write_frame``, ``flight`` rows, ``fault``
        solver-health events and the ``compile`` events of CUDA libraries
        loaded meanwhile; with None an installed tracer
        (`obs.tracer.use`) is honoured. ``profile_dir`` wraps the loop in
        `obs.profile.profile_session` (the card's activity on when the
        system is on the card) and, once the dump is written, folds it into
        the telemetry stream as one ``device_phase`` event a phase (or one
        ``device_phase_error``)."""
        import contextlib

        from ..obs import tracer as obs_tracer

        metrics_fh = open(metrics_path, "a") if metrics_path else None
        if profile_dir is not None:
            from ..obs.profile import profile_session

            prof = profile_session(profile_dir, device=self.device)
        else:
            prof = contextlib.nullcontext()
        tracer = obs_tracer.Tracer(trace_path) if trace_path else None
        scope = (obs_tracer.use(tracer) if tracer is not None
                 else contextlib.nullcontext())
        try:
            with scope:
                with prof, obs_tracer.span("run",
                                           t_final=self.params.t_final):
                    state = self._run_loop(state, writer=writer,
                                           max_steps=max_steps, rng=rng,
                                           metrics_fh=metrics_fh)
                if profile_dir is not None:
                    from ..obs.profile import emit_device_phases

                    emit_device_phases(profile_dir, tracer)
            return state
        finally:
            if tracer is not None:
                tracer.close()
            if metrics_fh is not None:
                metrics_fh.close()

    def _run_loop(self, state: SimState, *, writer, max_steps, rng,
                  metrics_fh):
        from ..obs import flight as flight_mod
        from ..obs import tracer as obs_tracer
        from .dynamic_instability import (_count_active,
                                          apply_dynamic_instability)

        p = self.params
        state = self.ensure_flight(state)
        dtype = self._dtype(state)
        n_steps = 0
        while state.time < p.t_final:
            if max_steps is not None and n_steps >= max_steps:
                break
            backup = state
            di_stats, di_s = None, 0.0
            if rng is not None and p.dynamic_instability.n_nodes > 0:
                # a ring mesh constrains nucleation's capacity growth to
                # mesh-divisible node counts (grow_capacity invariant); a
                # rejected trial restores `backup` (taken before this
                # update) and does not rewind the RNG
                nm = self.mesh.size if self._ring_active() else 1
                di_stats = {}
                di0 = _time.perf_counter()
                with obs_tracer.span("dynamic_instability"):
                    state = apply_dynamic_instability(state, p, rng,
                                                      node_multiple=nm,
                                                      stats=di_stats)
                di_s = _time.perf_counter() - di0
            t_cur, dt = state.time, state.dt
            with obs_tracer.span("step", step=n_steps) as sp:
                wall0 = _time.perf_counter()
                new_state, solution, info = self.step(state)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                wall_s = _time.perf_counter() - wall0
                sp.note(iters=int(info.iters), residual=float(info.residual))
            n_steps += 1
            dt = info.dt_used
            # the trial's decoded flight row (one small read), for the
            # metrics column, the telemetry stream and the fault's
            # provenance
            flight_row = None
            if new_state.flight is not None and (
                    metrics_fh is not None or info.health
                    or obs_tracer.active() is not None):
                flight_row = flight_mod.read_last(new_state.flight)
                if flight_row is not None:
                    obs_tracer.emit("flight", step=n_steps - 1,
                                    **flight_row)

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
            if di_stats is not None:
                logger.info(
                    "dynamic instability before t=%.6g: %d nucleations, %d "
                    "catastrophes, fiber capacity %d, di_s=%.4f",
                    t_cur, di_stats["nucleations"], di_stats["catastrophes"],
                    sum(g.n_fibers for g in fiber_buckets(state.fibers)),
                    di_s)
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
                prov = (flight_row or {}).get("provenance")
                obs_tracer.emit(
                    "fault", kind="solver_health",
                    verdict=_verdict.describe(info.health),
                    health=info.health, t=t_cur, dt=dt,
                    retries=int(info.guard_retries),
                    **({"prov_field": prov.get("field"),
                        "prov_fiber": prov.get("fiber"),
                        "prov_node": prov.get("node")} if prov else {}))
                logger.warning("solver health verdict at t=%.6g: %s "
                               "(health=%#x, guard retries=%d)%s", t_cur,
                               _verdict.describe(info.health), info.health,
                               info.guard_retries,
                               "" if not prov else
                               f"; first offender: field={prov['field']} "
                               f"fiber={prov['fiber']} node={prov['node']}")
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
                    # events applied this trial (a rejected trial discards
                    # its update: 0 / 0) and the live count that persists
                    "nucleations": (di_stats["nucleations"]
                                    if accept and di_stats else 0),
                    "catastrophes": (di_stats["catastrophes"]
                                     if accept and di_stats else 0),
                    "active_fibers": (_count_active(
                        (new_state if accept else backup).fibers)
                        if di_stats is not None else 0),
                    "wall_s": round(wall_s, 4),
                    "wall_ms": round(wall_s * 1e3, 3),
                    "gmres_history": info.history or [],
                    "flight": flight_row}) + "\n")
                metrics_fh.flush()

            if accept:
                t_new = t_cur + dt
                state = new_state._replace(time=_in_dtype(t_new, dtype),
                                           dt=_in_dtype(dt_new, dtype))
                if writer is not None and crossed_write_boundary(
                        t_new, dt, p.dt_write):
                    with obs_tracer.span("write_frame", t=t_new):
                        if rng is not None:
                            writer(state, solution,
                                   rng_state=rng.dump_state())
                        else:
                            writer(state, solution)
            else:
                # a rejected trial rolls back the physics but keeps the
                # flight ring: its row is the evidence of the trouble
                state = backup._replace(dt=_in_dtype(dt_new, dtype),
                                        flight=new_state.flight)
        return state


class VelocityField:
    """The flow of a solved state at any points (`System.velocity_field`;
    the JAX package's `_velocity_at_targets_impl` split in two). Built once
    a frame: the fiber caches and force densities from the solution (plus
    the steric wall force when ``periphery_interaction_flag`` is set), the
    bodies' caches, densities and the forces and torques the fibers' link
    conditions put on them (only those drive the body flow here, as in the
    reference), the shell density, and the bodies' rigid motions. A call
    ``field(r_trg)`` ([n, 3] points in the solution's dtype and device) is
    then the pair sums at those points, the external flows, and the
    rigid-motion override inside sphere and ellipsoid bodies; ``calls`` and
    ``points`` count the calls and the points evaluated."""

    def __init__(self, system: System, state: SimState, solution, pair=None):
        p = system.params
        self.system, self.state, self.pair = system, state, pair
        self.dtype, self.device = solution.dtype, solution.device
        self.calls = self.points = 0
        buckets = fiber_buckets(state.fibers)
        b_list = body_buckets(state.bodies)
        fib_size, shell_size, _ = system._sizes(state)
        self.caches = [fc.update_cache(g, state.dt, p.eta) for g in buckets]
        self.body_caches = [bd.update_cache(g, p.eta) for g in b_list]
        x_fibs, x_bods = system._split(state, solution)
        self.forces = None
        if buckets:
            forces = [fc.apply_fiber_force(g, c, xf)
                      for g, c, xf in zip(buckets, self.caches, x_fibs)]
            if p.periphery_interaction_flag and state.shell is not None:
                forces = [f + w for f, w in zip(
                    forces, system._periphery_force_fibers(state))]
            self.forces = forces
        self.x_bods = x_bods
        self.body_fts = []
        nbt = bd.n_total(b_list)
        for gb, bc, xb in zip(b_list, self.body_caches, x_bods):
            ft = torch.zeros((gb.n_bodies, 6), dtype=self.dtype,
                             device=self.device)
            for g, c, xf in zip(buckets, self.caches, x_fibs):
                ft = ft + bd.link_conditions(
                    gb, bc, bd.local_binding(g, gb, nbt), c, xf, xb)[1]
            self.body_fts.append(ft)
        self.density = (None if state.shell is None
                        else solution[fib_size:fib_size + shell_size])
        self.rigid = None
        if b_list:
            from ..utils import quaternion as quat

            cat = torch.cat
            semi = cat([g.semiaxes if g.semiaxes is not None
                        else torch.zeros_like(g.position) for g in b_list])
            self.rigid = dict(
                vel6=cat([xb[:, -6:] for xb in x_bods]),
                position=cat([g.position for g in b_list]),
                radius=cat([g.radius for g in b_list]),
                sphere=cat([g.kind_sphere for g in b_list]),
                rot=quat.rotation_matrix(cat([g.orientation
                                              for g in b_list])),
                has_ax=torch.all(semi > 0.0, dim=-1),
                ax_safe=torch.where(semi > 0.0, semi, 1.0))

    def _pair(self):
        """The fast evaluator for one call: a tree keeps no geometry
        between calls (each call's points are new)."""
        pair = self.pair
        if pair is not None and pair.evaluator == "tree":
            from ..ops.evaluator import PairEvaluator

            pair = PairEvaluator(pair.plan, pair.anchors)
        return pair

    def __call__(self, r_trg):
        sys_, st, p = self.system, self.state, self.system.params
        r_trg = torch.as_tensor(r_trg, dtype=self.dtype,
                                device=self.device).reshape(-1, 3)
        self.calls += 1
        self.points += r_trg.shape[0]
        pair = self._pair()
        v = torch.zeros_like(r_trg)
        if self.forces is not None:
            v = v + sys_._fiber_flow(st, self.caches, r_trg, self.forces,
                                     subtract_self=False, pair=pair)
        for j, (gb, bc, xb, ft) in enumerate(zip(
                body_buckets(st.bodies), self.body_caches, self.x_bods,
                self.body_fts)):
            v = v + bd.flow(gb, bc, r_trg, xb, ft, p.eta,
                            impl=p.kernel_impl,
                            pair=sys_._body_pair(gb, pair, j))
        if self.density is not None:
            v = v + sys_._shell_flow(st, r_trg, self.density, pair=pair)
        v = v + sys_._external_flows(st, r_trg)
        rb = self.rigid
        if rb is not None:
            # inside a body: its rigid motion v + omega x dx (spheres by
            # radius, ellipsoids by the body-frame ellipsoid equation,
            # `system.cpp:364-381`), the first body that holds the point
            dx = r_trg[:, None, :] - rb["position"][None, :, :]
            in_sphere = ((torch.linalg.vector_norm(dx, dim=-1)
                          < rb["radius"][None, :]) & rb["sphere"][None, :])
            dx_body = torch.einsum("bji,tbj->tbi", rb["rot"], dx)
            in_ellipsoid = ((torch.sum((dx_body / rb["ax_safe"][None]) ** 2,
                                       dim=-1) < 1.0)
                            & rb["has_ax"][None, :] & ~rb["sphere"][None, :])
            inside = in_sphere | in_ellipsoid
            vel6 = rb["vel6"]
            u_rigid = vel6[None, :, :3] + torch.cross(
                vel6[None, :, 3:].expand_as(dx), dx, dim=-1)
            idx = inside.to(torch.uint8).argmax(dim=1)
            pick = u_rigid[torch.arange(r_trg.shape[0],
                                        device=r_trg.device), idx]
            v = torch.where(inside.any(dim=1)[:, None], pick, v)
        return v


# ---------------------------------------------------------------- the registry

def auditable_programs():
    """This layer's entries in the cost registry (`audit.programs`): the
    single-device implicit step (and its donating twin's name), the
    mixed-precision step and the step with the K = 32 flight recorder
    armed, the JAX package's four. Each ``build(device)`` makes the
    free-fiber fixture scene on ``device`` and runs `System.trial_step`
    (prep, GMRES, advance) on it. The retrace probes step the fixture,
    then its new state (same structure, new values)."""
    from ..audit import fixtures
    from ..audit.registry import AuditProgram, BuiltProgram, probe_twice

    def build(**overrides):
        def _build(device=None):
            system = fixtures.make_system(device=device, **overrides)
            state = fixtures.free_state(system)
            return BuiltProgram(system.trial_step, (state,),
                                device=system.device)
        return _build

    def retrace_probe(**overrides):
        def _probe(device=None):
            system = fixtures.make_system(device=device, **overrides)
            return probe_twice(
                lambda: system.trial_step(fixtures.free_state(system)),
                lambda out: system.trial_step(out[0]))
        return _probe

    return [
        AuditProgram(
            name="step_single", layer="system",
            summary="single-device implicit step (free fibers, f64)",
            build=build(), retrace_probe=retrace_probe()),
        AuditProgram(
            # eager torch keeps no program whose inputs it could alias:
            # the JAX package's donating twin is the same callable here
            name="step_single_donated", layer="system",
            summary="step_single's callable under the JAX package's "
                    "donating twin's name (the port does not donate)",
            build=build()),
        AuditProgram(
            name="step_mixed", layer="system",
            summary="mixed-precision step (f32 Krylov + f64 df refinement)",
            build=build(solver_precision="mixed", refine_pair_impl="df")),
        AuditProgram(
            name="step_flight", layer="system",
            summary="single-device implicit step with the K=32 flight "
                    "recorder armed",
            build=build(flight_window=32),
            retrace_probe=retrace_probe(flight_window=32)),
    ]
