"""System parameters.

Field-for-field mirror of `skellysim_tpu.params.Params` (same names, same
defaults), so a config or a JAX `Params` converts without renaming
(`convert.params_from_dict`). What each field means is documented there;
only the policies that differ on the card are documented here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

#: valid Params.refine_pair_impl names (same set as the JAX package)
REFINE_PAIR_IMPLS = ("auto", "exact", "df", "pallas_df")


@dataclass(frozen=True)
class DynamicInstability:
    n_nodes: int = 0
    v_growth: float = 0.0
    f_catastrophe: float = 0.0
    v_grow_collision_scale: float = 0.5
    f_catastrophe_collision_scale: float = 2.0
    nucleation_rate: float = 0.0
    min_length: float = 0.5
    radius: float = 0.025
    bending_rigidity: float = 2.5e-3
    min_separation: float = 0.1


@dataclass(frozen=True)
class PeripheryBinding:
    active: bool = False
    polar_angle_start: float = 0.0
    polar_angle_end: float = math.pi
    threshold: float = 0.75


@dataclass(frozen=True)
class FiberPeripheryInteraction:
    f_0: float = 20.0
    l_0: float = 0.05


@dataclass(frozen=True)
class Params:
    eta: float = 1.0
    dt_initial: float = 1e-2
    dt_min: float = 1e-4
    dt_max: float = 2.0
    beta_up: float = 1.2
    beta_down: float = 0.5
    adaptive_timestep_flag: bool = True
    dt_write: float = 0.25
    t_final: float = 1.0
    gmres_tol: float = 1e-10
    gmres_restart: int = 100
    gmres_maxiter: int = 1000
    gmres_block_s: int = 1
    gmres_history: int = 16
    flight_window: int = 0
    fiber_error_tol: float = 1e-1
    guard_dt_halvings: int = 0
    guard_block_fallback: bool = False
    guard_f64_fallback: bool = False
    seed: int = 1
    pair_evaluator: str = "direct"
    ewald_tol: float = 1e-6
    periodic_box: tuple = ()
    spectral_tol: float = 1e-6
    tree_tol: float = 1e-4
    #: "exact" (plain displacement form on the CPU; on the card every
    #: Stokeslet sum runs on a hand-written kernel whatever the name, see
    #: `ops.kernels.stokeslet_direct`), "pallas" (the f32 throughput tier:
    #: kernel A for f32 operands) or "pallas_df" (the f64-grade tier:
    #: kernel B), or the JAX package's plain-XLA tiles, plain torch here:
    #: "mxu" (the matmul form) and "df" (double-float f32 arithmetic,
    #: `ops.df_kernels`). The names are the JAX package's, so configs
    #: carry over.
    kernel_impl: str = "exact"
    solver_precision: str = "auto"
    inner_tol: float = 1e-5
    refine_pair_impl: str = "auto"  # one of REFINE_PAIR_IMPLS
    max_refine: int = 8
    precond: str = "gs"
    ewald_min_sources: int = 2048
    implicit_motor_activation_delay: float = 0.0
    periphery_interaction_flag: bool = False
    dynamic_instability: DynamicInstability = field(default_factory=DynamicInstability)
    periphery_binding: PeripheryBinding = field(default_factory=PeripheryBinding)
    fiber_periphery_interaction: FiberPeripheryInteraction = field(
        default_factory=FiberPeripheryInteraction)


def resolve_precision(solver_precision: str, is_f64: bool,
                      device_type: str) -> str:
    """Resolve Params.solver_precision to a concrete "full"/"mixed".

    "auto" keeps the JAX package's policy: "mixed" for f64 states on an
    accelerator (here the CUDA card), "full" otherwise. On the H100 the
    choice is not forced by the hardware as it was on the TPU (native FP64
    units, an f64-capable LU), so whether "mixed" pays there is an open
    measurement (ROADMAP §1 item 9); the policy is kept so the realistic
    configs run the same program on both packages.
    """
    if solver_precision != "auto":
        return solver_precision
    if not is_f64:
        return "full"
    return "mixed" if device_type == "cuda" else "full"


def resolve_refine_impl(refine_pair_impl: str, device_type: str) -> str:
    """Resolve Params.refine_pair_impl ("auto" -> a concrete tile).

    This differs from the JAX package on purpose: there "auto" means "df"
    (double-float arithmetic in XLA) on an accelerator, because the TPU has
    no fast f64. The port's f64-grade tile is the hand-written native-FP64
    kernel (kernel B, reached through "pallas_df"), so "auto" resolves to
    "pallas_df" on the card and to "exact" (plain f64) on the CPU.
    """
    if refine_pair_impl != "auto":
        return refine_pair_impl
    return "pallas_df" if device_type == "cuda" else "exact"
