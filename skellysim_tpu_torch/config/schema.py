"""Typed configuration schema <-> TOML.

Counterpart of `skellysim_tpu.config.schema` for the run config: `Config`
with `params`, `bodies`, `fibers`, `point_sources` and `background`; the
shaped subclasses `ConfigSpherical` / `ConfigEllipsoidal` /
`ConfigRevolution` with their `periphery` table; the same field names and
defaults (the names ARE the TOML contract), `Config.save` and
`load_config`, which picks the subclass by ``periphery.shape``. A TOML
written here loads in `skellysim_tpu.builder.build_simulation` and vice
versa. The placement helpers (`move_fibers_to_surface`,
`generate_nucleation_sites`) make the same numpy draws in the same order as
the JAX package's, so one `numpy.random.default_rng` seed places the same
fibers in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import List

import numpy as np
from scipy.optimize import brentq
from scipy.special import ellipe, ellipeinc

from . import param_tools, toml_io
from .. import params as runtime_params
from ..ops.evaluator import EVALUATOR_ALIASES

__all__ = ["Fiber", "DynamicInstability", "PeripheryBinding", "Params",
           "Periphery", "SphericalPeriphery", "EllipsoidalPeriphery",
           "RevolutionPeriphery", "EnvelopeConfig", "Body", "Point",
           "BackgroundSource", "Config", "ConfigSpherical",
           "ConfigEllipsoidal", "ConfigRevolution", "load_config",
           "config_from_data", "unpack", "to_runtime_params", "SweepAxis",
           "EnsembleSweep", "normalized_member_params", "RuntimeConfig",
           "load_runtime_config", "ServeConfig", "load_serve_config",
           "perturbed_fiber_positions"]


def _vec3() -> List[float]:
    return [0.0, 0.0, 0.0]


def _ivec3() -> List[int]:
    return [0, 1, 2]


def _quat_identity() -> List[float]:
    return [0.0, 0.0, 0.0, 1.0]


def _random_unit_vector(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def _random_orthogonal(normal: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    off = (np.array([1.0, 0, 0]) if (normal[1] or normal[2])
           else np.array([0, 1.0, 0]))
    b = np.cross(normal, off)
    b /= np.linalg.norm(b)
    c = np.cross(normal, b)
    c /= np.linalg.norm(c)
    theta = 2 * np.pi * rng.uniform()
    return b * np.cos(theta) + c * np.sin(theta)


def _sin_arc_length(amplitude: float, xf: float) -> float:
    """Arc length of amplitude*sin(2 pi x/xf) over one period [0, xf]."""
    a2 = (2 * np.pi * amplitude / xf) ** 2
    return xf / np.pi * (ellipe(-a2) + np.sqrt(1 + a2) * ellipe(a2 / (1 + a2)))


def _cos_arc_length(amplitude: float, xi: float, xf: float,
                    x_max: float) -> float:
    """Arc length of amplitude*cos(2 pi x/x_max) on [xi, xf]."""
    k = 2 * np.pi / x_max
    a2 = (k * amplitude) ** 2
    return (ellipeinc(k * xf, -a2) - ellipeinc(k * xi, -a2)) / k


def perturbed_fiber_positions(amplitude: float, length: float, x0, normal,
                              n_nodes: int, ortho=None,
                              rng: np.random.Generator | None = None
                              ) -> np.ndarray:
    """[n_nodes, 3] fiber nodes: straight along `normal` with a one-period
    cosine perturbation of the given amplitude, arc-length-parameterized so
    node spacing is uniform in arc length and the total equals `length`
    (the reference's `perturbed_fiber_positions`; the same draw as
    `skellysim_tpu.config.schema.perturbed_fiber_positions`)."""
    rng = rng or np.random.default_rng()
    x0 = np.asarray(x0, dtype=float)
    normal = np.asarray(normal, dtype=float)

    # axial extent x_max such that the perturbed curve has the right length
    x_max = brentq(lambda xf: _sin_arc_length(amplitude, xf) - length,
                   1e-3 * length, length)
    if ortho is None:
        ortho = _random_orthogonal(normal, rng)

    # nodes at equal arc-length increments, by inverting s(x)
    ds = length / (n_nodes - 1)
    xs = np.zeros(n_nodes)
    for i in range(1, n_nodes):
        lo = xs[i - 1]
        xs[i] = brentq(
            lambda xf: _cos_arc_length(amplitude, lo, xf, x_max) - ds,
            lo, x_max + 1e-9) if i < n_nodes - 1 else x_max
    positions = np.outer(xs, normal)
    positions += np.outer(amplitude * (np.cos(2 * np.pi * xs / x_max) - 1.0),
                          ortho)
    return positions + x0


def _min_sep_ok(x0: np.ndarray, minus_ends: list, ds_min: float) -> bool:
    if not minus_ends:
        return True
    d2 = np.sum((np.asarray(minus_ends) - x0) ** 2, axis=1)
    return bool(np.all(d2 >= ds_min * ds_min))


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
class Periphery:
    """Base periphery (use a shaped subclass)."""
    n_nodes: int = 6000
    precompute_file: str = "periphery_precompute.npz"

    def move_fibers_to_surface(self, fibers, ds_min, verbose=True,
                               rng=None) -> None:
        """Place fibers' minus ends uniformly on the surface pointing
        inward, rejecting sites closer than ds_min to prior minus ends."""
        rng = rng or np.random.default_rng()
        ends: list = []
        for i, fib in enumerate(fibers):
            x0, inward = self.find_binding_site_impl(ends, ds_min, rng)
            fib.fill_node_positions(x0, inward)
            ends.append(x0)
            if verbose:
                print(f"Inserted fiber {i} at {x0}")


@dataclass
class SphericalPeriphery(Periphery):
    shape: str = "sphere"
    radius: float = 6.0

    def find_binding_site_impl(self, minus_ends, ds_min, rng):
        while True:
            u0 = _random_unit_vector(rng)
            x0 = 0.99999999 * self.radius * u0
            if _min_sep_ok(x0, minus_ends, ds_min):
                return x0, -u0


@dataclass
class EllipsoidalPeriphery(Periphery):
    """(x/a)^2 + (y/b)^2 + (z/c)^2 = 1."""
    shape: str = "ellipsoid"
    a: float = 7.8
    b: float = 4.16
    c: float = 4.16

    def move_fibers_to_surface(self, fibers, ds_min, verbose=True, rng=None):
        rng = rng or np.random.default_rng()
        # uniform-by-area trial points slightly inside the surface
        a, b, c = self.a / 1.04, self.b / 1.04, self.c / 1.04

        def surf(t, u):
            return np.stack([a * np.cos(t) * np.sin(u),
                             b * np.sin(t) * np.sin(u),
                             c * np.cos(u)])

        n_trials = max(5 * len(fibers), 64)
        trials = param_tools.r_surface(n_trials, surf, 0, 2 * np.pi, 0, np.pi,
                                       rng=rng)[0].T
        ends: list = []
        i_trial = 0
        for i, fib in enumerate(fibers):
            while True:
                if i_trial >= n_trials:
                    raise RuntimeError(
                        "Unable to insert fibers; decrease density or ds_min")
                x0 = trials[i_trial]
                i_trial += 1
                if _min_sep_ok(x0, ends, ds_min):
                    break
            normal = np.array([x0[0] / self.a ** 2, x0[1] / self.b ** 2,
                               x0[2] / self.c ** 2])
            normal = -normal / np.linalg.norm(normal)
            fib.fill_node_positions(x0, normal)
            ends.append(x0)
            if verbose:
                print(f"Inserted fiber {i} at {x0}")


class EnvelopeConfig(dict):
    """Envelope table with attribute-style access that stays a plain dict
    for TOML round-tripping."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value


@dataclass
class RevolutionPeriphery(Periphery):
    """Surface of revolution of a height function h(x) around the x axis;
    `envelope` keys: height (an expression of x), lower_bound,
    upper_bound, n_nodes_target, plus free parameters the expression
    names."""
    shape: str = "surface_of_revolution"
    n_nodes: int = 0
    envelope: dict = field(default_factory=EnvelopeConfig)

    def __post_init__(self):
        if not isinstance(self.envelope, EnvelopeConfig):
            self.envelope = EnvelopeConfig(self.envelope)

    def move_fibers_to_surface(self, fibers, ds_min, verbose=True, rng=None):
        from ..periphery.shapes import Envelope
        rng = rng or np.random.default_rng()
        env = Envelope(self.envelope)
        lb, ub = self.envelope["lower_bound"], self.envelope["upper_bound"]

        # CDF of the area element h(x) sqrt(dx^2 + dh^2)
        xs = np.linspace(lb, ub, 1000)
        h = np.maximum(env.raw_height(xs), 0.0)
        slant = np.sqrt(np.diff(xs) ** 2 + np.diff(h) ** 2)
        dA = 0.5 * (h[1:] + h[:-1]) * slant
        cdf = np.concatenate([[0.0], np.cumsum(dA)])
        cdf /= cdf[-1]

        ends: list = []
        for i, fib in enumerate(fibers):
            while True:
                x_t = np.interp(rng.uniform(), cdf, xs)
                h_t = float(env.raw_height(x_t))
                theta = 2 * np.pi * rng.uniform()
                x0 = np.array([x_t, h_t * np.cos(theta), h_t * np.sin(theta)])
                if _min_sep_ok(x0, ends, ds_min):
                    break
            if x0[0] <= env.lower_bound:
                normal = np.array([1.0, 0.0, 0.0])
            elif x0[0] >= env.upper_bound:
                normal = np.array([-1.0, 0.0, 0.0])
            else:
                normal = np.array([float(env(x0[0]) * env.differentiate(x0[0])),
                                   -x0[1], -x0[2]])
                normal /= np.linalg.norm(normal)
            fib.fill_node_positions(x0, normal)
            ends.append(x0)
            if verbose:
                print(f"Inserted fiber {i} at {x0}")


@dataclass
class Body:
    """One rigid body (reference `Body`)."""
    n_nucleation_sites: int = 0
    position: List[float] = field(default_factory=_vec3)
    orientation: List[float] = field(default_factory=_quat_identity)
    shape: str = "sphere"
    radius: float = 1.0
    n_nodes: int = 600
    axis_length: List[float] = field(default_factory=_vec3)
    precompute_file: str = "body_precompute.npz"
    external_force_type: str = "Linear"
    external_force: List[float] = field(default_factory=_vec3)
    external_torque: List[float] = field(default_factory=_vec3)
    nucleation_sites: List[float] = field(default_factory=list)
    external_oscillation_force_amplitude: float = 0.0
    external_oscillation_force_frequency: float = 0.0
    external_oscillation_force_phase: float = 0.0

    def _require_sphere(self):
        if self.shape != "sphere":
            raise ValueError("fiber attachment only implemented for "
                             "spherical bodies")

    def generate_nucleation_sites(self, ds_min, verbose=True,
                                  rng=None) -> None:
        self._require_sphere()
        rng = rng or np.random.default_rng()
        com = np.asarray(self.position)
        sites: list = []
        for isite in range(self.n_nucleation_sites):
            while True:
                x0 = com + self.radius * _random_unit_vector(rng)
                if _min_sep_ok(x0, sites, ds_min):
                    sites.append(x0)
                    if verbose:
                        print(f"Inserting site {isite} at {x0}")
                    break
        self.nucleation_sites = np.asarray(sites).ravel().tolist()

    def move_fibers_to_surface(self, fibers, ds_min, verbose=True, rng=None):
        """Place fibers on the body surface pointing outward."""
        self._require_sphere()
        rng = rng or np.random.default_rng()
        com = np.asarray(self.position)
        ends: list = []
        for i, fib in enumerate(fibers):
            while True:
                u0 = _random_unit_vector(rng)
                x0 = com + self.radius * u0
                if _min_sep_ok(x0, ends, ds_min):
                    break
            fib.fill_node_positions(x0, u0)
            ends.append(x0)
            if verbose:
                print(f"Inserted fiber {i} at {x0}")


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
    """Free-space config (no bounding volume)."""
    params: Params = field(default_factory=Params)
    bodies: List[Body] = field(default_factory=list)
    fibers: List[Fiber] = field(default_factory=list)
    point_sources: List[Point] = field(default_factory=list)
    background: BackgroundSource = field(default_factory=BackgroundSource)

    def validate(self) -> list[str]:
        problems = _validate(self)
        problems += _validate_periodic(self)
        for j, b in enumerate(self.bodies):
            if getattr(b, "shape", None) == "deformable":
                problems.append(
                    f"bodies[{j}].shape: 'deformable' is declared but "
                    "unimplemented in the reference (the stub "
                    "skellysim_tpu_torch/bodies/deformable.py); use shape = "
                    "'sphere' or 'ellipsoid'")
        return problems

    def save(self, filename: str = "skelly_config.toml") -> None:
        problems = self.validate()
        if problems:
            raise ValueError("invalid config:\n  " + "\n  ".join(problems))
        toml_io.dump(unpack(self), filename)


@dataclass
class ConfigSpherical(Config):
    periphery: SphericalPeriphery = field(default_factory=SphericalPeriphery)


@dataclass
class ConfigEllipsoidal(Config):
    periphery: EllipsoidalPeriphery = field(
        default_factory=EllipsoidalPeriphery)


@dataclass
class ConfigRevolution(Config):
    periphery: RevolutionPeriphery = field(default_factory=RevolutionPeriphery)


def _validate_periodic(cfg) -> list[str]:
    """The periodic-box / evaluator pairing rules of the JAX schema: the
    box is [Lx, Ly, Lz] (triply periodic), [Lx, Ly] (a doubly periodic
    slab) or [] (free space); only "spectral" honors periodic images, so
    the pairing is checked both ways."""
    problems: list[str] = []
    box = cfg.params.periodic_box
    if len(box) not in (0, 2, 3):
        problems.append(
            "params.periodic_box: length must be 2 (doubly periodic slab "
            f"[Lx, Ly]) or 3 (triply periodic [Lx, Ly, Lz]), got {len(box)}")
    for j, L in enumerate(box):
        if isinstance(L, bool) or not isinstance(L, (int, float)) or L <= 0:
            problems.append(
                f"params.periodic_box[{j}]: must be a positive length, "
                f"got {L!r}")
    ev = EVALUATOR_ALIASES.get(str(cfg.params.pair_evaluator).strip().lower())
    if ev == "spectral" and not box:
        problems.append(
            "params.pair_evaluator: 'spectral' is the periodic/confined "
            "evaluator and needs params.periodic_box ([Lx, Ly, Lz] or "
            "[Lx, Ly]); for free space use 'ewald' or 'tree'")
    if ev is not None and ev != "spectral" and box:
        problems.append(
            f"params.periodic_box: set, but pair_evaluator {ev!r} sums "
            "free-space kernels and would ignore the periodic images; "
            "use pair_evaluator = 'spectral'")
    return problems


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
        elif isinstance(v, dict):
            for k, item in v.items():
                if not isinstance(item, (bool, float, int, str, list, dict,
                                         np.floating, np.integer,
                                         np.ndarray)):
                    problems.append(f"{where}[{k!r}]: unsupported type "
                                    f"{type(item).__name__}")
        elif isinstance(v, (bool, float, int, str)):
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
    """TOML file -> Config (shaped subclass chosen by periphery.shape)."""
    return config_from_data(toml_io.load(path))


def config_from_data(data: dict) -> Config:
    """Parsed TOML dict -> Config (shaped subclass chosen by
    ``periphery.shape``)."""
    peri = data.get("periphery")
    if peri is None:
        cfg = Config()
    else:
        cls, pcls = {
            "sphere": (ConfigSpherical, SphericalPeriphery),
            "ellipsoid": (ConfigEllipsoidal, EllipsoidalPeriphery),
            "surface_of_revolution": (ConfigRevolution, RevolutionPeriphery),
        }[peri.get("shape", "sphere")]
        cfg = cls()
        cfg.periphery = _from_dict(pcls, peri)
    cfg.params = _from_dict(Params, data.get("params", {}))
    cfg.fibers = [_from_dict(Fiber, d) for d in data.get("fibers", [])]
    cfg.bodies = [_from_dict(Body, d) for d in data.get("bodies", [])]
    cfg.point_sources = [_from_dict(Point, d)
                         for d in data.get("point_sources", [])]
    cfg.background = _from_dict(BackgroundSource, data.get("background", {}))
    return cfg


@dataclass
class SweepAxis:
    """One swept value of an ensemble sweep (`skellysim_tpu.config.schema
    .SweepAxis`): a dotted path into the base config (``"fibers.0.length"``,
    ``"background.uniform.0"``) and its values; members take the cartesian
    product over every axis."""
    key: str = ""
    values: List = field(default_factory=list)


@dataclass
class EnsembleSweep:
    """The `[ensemble]` table of a sweep-spec TOML (`python -m
    skellysim_tpu_torch.ensemble --sweep-file=...`): ``replicas`` copies of
    every sweep point, each member with its own RNG stream
    (`SimRNG.member(i)`)."""
    #: base run config, resolved relative to the sweep-spec file
    base_config: str = "skelly_config.toml"
    replicas: int = 1
    #: lanes of the batched step
    batch: int = 8
    #: base seed of the member streams; -1 = the base config's params.seed
    seed: int = -1
    #: member end time; -1.0 = the base config's params.t_final
    t_final: float = -1.0
    #: "vmap" (one batched trial over the lanes) or "unroll" (each lane
    #: through the unbatched step: the bits of a sequential run)
    batch_impl: str = "vmap"
    sweep: List[SweepAxis] = field(default_factory=list)


def normalized_member_params(params: "Params") -> "Params":
    """Params with the per-member knobs (seed, t_final) zeroed: members
    whose normalized params are equal can run in one ensemble."""
    return dataclasses.replace(params, seed=0, t_final=0.0)


@dataclass
class RuntimeConfig:
    """The `[runtime]` table (`skellysim_tpu.config.schema.RuntimeConfig`):
    the capacity ladders of `system.buckets.BucketPolicy`. ``jax_cache``
    names the JAX package's compilation cache; the port reads and ignores
    it, so one config serves both packages."""
    jax_cache: str = "auto"
    #: fiber-capacity rungs; [] = no padding, [-1] = the geometric ladder
    bucket_ladder: List[int] = field(default_factory=list)
    #: nodes-a-fiber rungs (valid fiber resolutions); [] = no node padding
    node_ladder: List[int] = field(default_factory=list)
    #: shell quadrature rungs; [] = off (incompatible with the fast
    #: evaluators)
    shell_ladder: List[int] = field(default_factory=list)
    #: spectral FFT grid-dimension rungs; [] = the built-in 2^a 3^b rungs
    grid_ladder: List[int] = field(default_factory=list)


def load_runtime_config(path_or_data) -> RuntimeConfig:
    """`[runtime]` table of a config TOML (a path or a parsed dict) ->
    RuntimeConfig; defaults when absent, unknown keys and malformed
    ladders rejected."""
    data = (toml_io.load(path_or_data) if isinstance(path_or_data, str)
            else (path_or_data or {}))
    table = data.get("runtime", {})
    known = {f.name for f in fields(RuntimeConfig)}
    unknown = set(table) - known
    if unknown:
        raise ValueError(f"unknown [runtime] keys {sorted(unknown)}; "
                         f"valid keys: {sorted(known)}")
    cfg = RuntimeConfig(**table)
    for name in ("bucket_ladder", "node_ladder", "shell_ladder",
                 "grid_ladder"):
        lad = getattr(cfg, name)
        if name == "bucket_ladder" and list(lad) == [-1]:
            continue  # the "geometric" spelling
        if any(int(v) < 1 for v in lad):
            raise ValueError(f"[runtime] {name} entries must be >= 1 "
                             "(or bucket_ladder = [-1] for the geometric "
                             "ladder)")
        if list(lad) != sorted(set(int(v) for v in lad)):
            raise ValueError(f"[runtime] {name} must be strictly ascending")
    return cfg


@dataclass
class ServeConfig:
    """`[serve]` table of a server config TOML (`python -m
    skellysim_tpu_torch.serve`; the JAX package's `ServeConfig`, field for
    field).

    Lives in the SERVER's run config file alongside the usual tables: the
    config's fibers/params define the warm compiled program every tenant
    must match, and `[serve]` sizes the service around it. Each capacity
    bucket is one compiled ensemble program whose lanes hold tenants with
    fiber counts up to that capacity (smaller scenes are padded with inert
    masked fibers, the ensemble's masked lanes applied to admission).
    """
    #: bind address for the TCP service
    host: str = "127.0.0.1"
    #: listen port; 0 = ephemeral (pair with the CLI's --port-file)
    port: int = 0
    #: padded fiber capacities, one warm compiled program (bucket) each;
    #: empty = derived from the bucket policy (`[runtime] bucket_ladder`
    #: rungs starting at the base config's fiber count, `bucket_count`
    #: rungs) — this list remains the manual override
    bucket_capacities: List[int] = field(default_factory=list)
    #: number of policy-ladder rungs to derive buckets from when
    #: `bucket_capacities` is empty (starting at the base scene's rung);
    #: 1 = a single bucket at the base scene's own rung (the default)
    bucket_count: int = 1
    #: concurrent tenant slots (compiled ensemble lanes) per bucket
    max_lanes: int = 4
    #: admission-queue bound per bucket; a submit beyond it is REJECTED
    #: (admission control: shed load instead of growing an unbounded queue)
    queue_depth: int = 16
    #: batched execution plan for the lanes: "vmap" (throughput) or
    #: "unroll" (bit-reproducible lanes)
    batch_impl: str = "vmap"
    #: per-send socket timeout: a client that stops reading its responses
    #: is dropped (and its tenants evicted) instead of freezing the
    #: single-threaded event loop on a full TCP window
    send_timeout_s: float = 30.0
    #: terminal tenant-record retention (seconds): finished / evicted /
    #: cancelled records (and their final-state snapshots) expire this long
    #: after retirement, bounding server memory under sustained traffic.
    #: 0 disables expiry (the pre-TTL behavior: records live until
    #: shutdown). An expired tenant answers "unknown tenant" — clients
    #: must fetch snapshots/frames within the TTL.
    record_ttl_s: float = 0.0
    #: crash-safe write-ahead tenant journal (`serve.journal`):
    #: append-only trajectory-v1 snapshots on
    #: admit / evict / every `journal_every` rounds. A restarted server
    #: pointed at the same path re-admits every live tenant from the
    #: journal with at most `journal_every` rounds of replay. Empty =
    #: journaling off (the pre-guard behavior: a killed server loses its
    #: tenants).
    journal_path: str = ""
    #: checkpoint cadence (batched rounds) for live lanes when journaling;
    #: the bound on replay after a crash. Must be >= 1 when journaling.
    journal_every: int = 8
    #: allow `chaos` requests (`guard.chaos` fault injection: the chaos
    #: smoke and the fault-injection tests). NEVER enable in production:
    #: a chaos request deliberately poisons tenant state.
    chaos_enabled: bool = False
    #: per-connection frame-size bound (bytes): a header claiming more
    #: answers a structured error and the connection survives
    #: (protocol.FrameDecoder skip mode); the default matches
    #: protocol.MAX_FRAME_BYTES
    max_frame_bytes: int = 1 << 31


def load_serve_config(path: str) -> ServeConfig:
    """`[serve]` table of a config TOML -> ServeConfig (defaults when the
    table is absent; unknown keys rejected — a typo'd knob silently running
    defaults would mis-size a production service)."""
    table = toml_io.load(path).get("serve", {})
    known = {f.name for f in dataclasses.fields(ServeConfig)}
    unknown = set(table) - known
    if unknown:
        raise ValueError(f"{path}: unknown [serve] keys {sorted(unknown)}; "
                         f"valid keys: {sorted(known)}")
    cfg = ServeConfig(**table)
    if cfg.max_lanes < 1:
        raise ValueError(f"{path}: [serve] max_lanes must be >= 1")
    if cfg.queue_depth < 0:
        raise ValueError(f"{path}: [serve] queue_depth must be >= 0")
    if cfg.batch_impl not in ("vmap", "unroll"):
        raise ValueError(f"{path}: unknown [serve] batch_impl "
                         f"{cfg.batch_impl!r}; use 'vmap' or 'unroll'")
    if any(c < 1 for c in cfg.bucket_capacities):
        raise ValueError(f"{path}: [serve] bucket_capacities must be >= 1")
    if cfg.bucket_count < 1:
        raise ValueError(f"{path}: [serve] bucket_count must be >= 1")
    if cfg.send_timeout_s <= 0:
        raise ValueError(f"{path}: [serve] send_timeout_s must be > 0")
    if cfg.journal_path and cfg.journal_every < 1:
        raise ValueError(f"{path}: [serve] journal_every must be >= 1 "
                         "when journal_path is set")
    if cfg.max_frame_bytes < 1 << 16:
        raise ValueError(f"{path}: [serve] max_frame_bytes must be >= 64 KiB "
                         "(a single status response must fit)")
    return cfg


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
