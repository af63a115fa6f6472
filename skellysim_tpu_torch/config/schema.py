"""Typed configuration schema <-> TOML, for the tables this slice reads.

Counterpart of the part of `skellysim_tpu.config.schema` that free-space
fiber runs use: `Config` with `params`, `fibers`, `point_sources` and
`background`, with the same field names and defaults (the names ARE the
TOML contract), `Config.save` and `load_config`. A TOML written here loads
in `skellysim_tpu.builder.build_simulation` and vice versa.

Tables of later slices round-trip as plain data: ``bodies`` entries and a
``periphery`` table are kept as dicts, and the builder refuses them
(`NotImplementedError` naming the ROADMAP item).
"""

from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass, field, fields, is_dataclass
from typing import List, Optional

import numpy as np

from . import toml_io
from .. import params as runtime_params

__all__ = ["Fiber", "DynamicInstability", "PeripheryBinding", "Params",
           "Point", "BackgroundSource", "Config", "load_config",
           "config_from_data", "unpack", "to_runtime_params"]


def _vec3() -> List[float]:
    return [0.0, 0.0, 0.0]


def _ivec3() -> List[int]:
    return [0, 1, 2]


@dataclass
class Fiber:
    """One fiber (reference `Fiber`)."""
    n_nodes: int = 32
    parent_body: int = -1
    parent_site: int = -1
    force_scale: float = 0.0
    bending_rigidity: float = 2.5e-3
    radius: float = 0.0125
    length: float = 1.0
    minus_clamped: bool = False
    x: List[float] = field(default_factory=list)

    def fill_node_positions(self, x0, normal) -> None:
        """Straight fiber from x0 along `normal`, uniformly spaced."""
        x0 = np.asarray(x0, dtype=float)
        normal = np.asarray(normal, dtype=float)
        s = np.linspace(0.0, self.length, self.n_nodes)
        self.x = (x0[None, :] + s[:, None] * normal[None, :]).ravel().tolist()


@dataclass
class DynamicInstability:
    n_nodes: int = 0
    v_growth: float = 0.0
    f_catastrophe: float = 0.0
    v_grow_collision_scale: float = 0.5
    f_catastrophe_collision_scale: float = 2.0
    nucleation_rate: float = 0.0
    radius: float = 0.025
    min_length: float = 0.5
    bending_rigidity: float = 2.5e-3
    min_separation: float = 0.1


@dataclass
class PeripheryBinding:
    active: bool = False
    polar_angle_start: float = 0.0
    polar_angle_end: float = 0.5 * np.pi
    threshold: float = 0.75


@dataclass
class Params:
    """The ``[params]`` table (same keys and defaults as the JAX schema)."""
    eta: float = 1.0
    dt_initial: float = 0.025
    dt_min: float = 1e-5
    dt_max: float = 0.025
    dt_write: float = 0.1
    t_final: float = 100.0
    gmres_tol: float = 1e-8
    gmres_block_s: int = 1
    guard_dt_halvings: int = 0
    guard_block_fallback: bool = False
    guard_f64_fallback: bool = False
    flight_window: int = 0
    fiber_error_tol: float = 0.1
    seed: int = 130319
    implicit_motor_activation_delay: float = 0.0
    dynamic_instability: DynamicInstability = field(default_factory=DynamicInstability)
    periphery_binding: PeripheryBinding = field(default_factory=PeripheryBinding)
    periphery_interaction_flag: bool = False
    adaptive_timestep_flag: bool = True
    pair_evaluator: str = "TPU"
    fiber_type: str = "FiniteDifference"
    solver_precision: str = "auto"
    ewald_tol: float = 1e-6
    tree_tol: float = 1e-4
    periodic_box: list = field(default_factory=list)
    spectral_tol: float = 1e-6
    kernel_impl: str = "exact"
    refine_pair_impl: str = "auto"
    ewald_min_sources: int = 2048
    precond: str = "gs"


@dataclass
class Point:
    """Point force/torque source."""
    position: List[float] = field(default_factory=_vec3)
    force: List[float] = field(default_factory=_vec3)
    torque: List[float] = field(default_factory=_vec3)
    time_to_live: float = 0.0


@dataclass
class BackgroundSource:
    """Uniform + linear-shear background flow."""
    components: List[int] = field(default_factory=_ivec3)
    scale_factor: List[float] = field(default_factory=_vec3)
    uniform: List[float] = field(default_factory=_vec3)


@dataclass
class Config:
    """Free-space config. ``bodies`` (dicts) and ``periphery`` (a dict or
    None) are carried for round-tripping only; the builder refuses them."""
    params: Params = field(default_factory=Params)
    bodies: List[dict] = field(default_factory=list)
    fibers: List[Fiber] = field(default_factory=list)
    point_sources: List[Point] = field(default_factory=list)
    background: BackgroundSource = field(default_factory=BackgroundSource)
    periphery: Optional[dict] = None

    def validate(self) -> list[str]:
        return _validate(self)

    def save(self, filename: str = "skelly_config.toml") -> None:
        problems = self.validate()
        if problems:
            raise ValueError("invalid config:\n  " + "\n  ".join(problems))
        data = unpack(self)
        if data["periphery"] is None:
            del data["periphery"]
        toml_io.dump(data, filename)


def _validate(obj, prefix: str = "") -> list[str]:
    """Type-check every field; flag unknown attributes and numpy types."""
    problems: list[str] = []
    known = {f.name for f in fields(obj)}
    for name in vars(obj):
        if name not in known:
            problems.append(f"{prefix}{name}: unknown attribute")
    for f in fields(obj):
        v = getattr(obj, f.name)
        where = f"{prefix}{f.name}"
        if is_dataclass(v):
            problems += _validate(v, where + ".")
        elif isinstance(v, list):
            for j, item in enumerate(v):
                if is_dataclass(item):
                    problems += _validate(item, f"{where}[{j}].")
                elif isinstance(item, (np.floating, np.integer)):
                    problems.append(f"{where}[{j}]: numpy scalar; use float/int")
        elif isinstance(v, (np.floating, np.integer, np.ndarray)):
            problems.append(f"{where}: numpy type; use plain float/int/list")
        elif v is None or isinstance(v, (bool, float, int, str, dict)):
            pass
        else:
            problems.append(f"{where}: unsupported type {type(v).__name__}")
    return problems


def unpack(obj):
    """Dataclass tree -> plain dict suitable for TOML."""
    if is_dataclass(obj):
        return {f.name: unpack(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, dict):
        return {k: unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unpack(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    return obj


def _from_dict(cls, data: dict):
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    for k, v in data.items():
        if k not in known:
            continue  # forward compatibility: ignore unknown keys on load
        ann = str(known[k].type)
        if "DynamicInstability" in ann:
            v = _from_dict(DynamicInstability, v)
        elif "PeripheryBinding" in ann:
            v = _from_dict(PeripheryBinding, v)
        kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str) -> Config:
    """TOML file -> Config."""
    return config_from_data(toml_io.load(path))


def config_from_data(data: dict) -> Config:
    """Parsed TOML dict -> Config."""
    return Config(
        params=_from_dict(Params, data.get("params", {})),
        bodies=[dict(b) for b in data.get("bodies", [])],
        fibers=[_from_dict(Fiber, d) for d in data.get("fibers", [])],
        point_sources=[_from_dict(Point, d)
                       for d in data.get("point_sources", [])],
        background=_from_dict(BackgroundSource, data.get("background", {})),
        periphery=data.get("periphery"))


#: accepted pair_evaluator spellings -> runtime names (the JAX package's
#: `ops.evaluator.EVALUATOR_ALIASES`, copied): reference names CPU/GPU/TPU
#: mean dense direct, FMM the free-space fast slot, PVFMM the periodic one
EVALUATOR_ALIASES = types.MappingProxyType(
    {"cpu": "direct", "gpu": "direct", "tpu": "direct",
     "fmm": "ewald",
     "pvfmm": "spectral",
     "direct": "direct", "ring": "ring", "ewald": "ewald",
     "tree": "tree", "spectral": "spectral"})


def _runtime_evaluator(name: str) -> str:
    try:
        return EVALUATOR_ALIASES[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown pair_evaluator {name!r}; valid names: "
            + ", ".join(sorted(EVALUATOR_ALIASES))) from None


def to_runtime_params(p: Params) -> runtime_params.Params:
    """Schema-level Params -> runtime Params."""
    return runtime_params.Params(
        eta=p.eta,
        dt_initial=p.dt_initial,
        dt_min=p.dt_min,
        dt_max=p.dt_max,
        adaptive_timestep_flag=p.adaptive_timestep_flag,
        dt_write=p.dt_write,
        t_final=p.t_final,
        gmres_tol=p.gmres_tol,
        gmres_block_s=p.gmres_block_s,
        guard_dt_halvings=p.guard_dt_halvings,
        guard_block_fallback=p.guard_block_fallback,
        guard_f64_fallback=p.guard_f64_fallback,
        flight_window=p.flight_window,
        fiber_error_tol=p.fiber_error_tol,
        seed=p.seed,
        implicit_motor_activation_delay=p.implicit_motor_activation_delay,
        periphery_interaction_flag=p.periphery_interaction_flag,
        pair_evaluator=_runtime_evaluator(p.pair_evaluator),
        solver_precision=p.solver_precision,
        ewald_tol=p.ewald_tol,
        tree_tol=p.tree_tol,
        periodic_box=tuple(float(L) for L in p.periodic_box),
        spectral_tol=p.spectral_tol,
        ewald_min_sources=p.ewald_min_sources,
        kernel_impl=p.kernel_impl,
        refine_pair_impl=p.refine_pair_impl,
        precond=p.precond,
        dynamic_instability=runtime_params.DynamicInstability(
            **dataclasses.asdict(p.dynamic_instability)),
        periphery_binding=runtime_params.PeripheryBinding(
            **dataclasses.asdict(p.periphery_binding)),
    )
