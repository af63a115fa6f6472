"""Sweep-spec TOML -> expanded member plans (the ensemble's work queue).

Counterpart of `skellysim_tpu.config.sweep`: `load_sweep` reads the
`[ensemble]` table (and its `[[ensemble.sweep]]` axes) into
`schema.EnsembleSweep`; `expand_members` takes the cartesian product of the
axes times ``replicas`` and yields one `MemberPlan` a member (id, dotted
config overrides, seed, t_final); `apply_overrides` builds a member's
Config from the base.

Overrides are restricted to values that land in the simulation state
(fiber geometry and stiffness, body positions and forces, background flow,
point sources): the members of one ensemble share the runtime `Params`, so
a key that would change them is refused, with the two exceptions the
scheduler handles per member (`params.t_final`, `params.seed`).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import os
from typing import List

from . import toml_io
from .schema import Config, EnsembleSweep, SweepAxis, load_config


@dataclasses.dataclass
class MemberPlan:
    """One expanded member: overrides to apply to the base config + the
    per-member knobs the scheduler handles (seed, t_final)."""

    member_id: str
    index: int               # global member index (RNG stream selector)
    overrides: dict          # dotted key -> value for this sweep point
    seed: int
    t_final: float           # <= 0 means "use base params.t_final"


def load_sweep(path: str) -> EnsembleSweep:
    """Sweep-spec TOML file -> EnsembleSweep (unknown keys rejected: a
    mistyped key would run the base config N times)."""
    data = toml_io.load(path)
    table = data.get("ensemble")
    if table is None:
        raise ValueError(f"{path}: missing [ensemble] table")
    known = {f.name for f in dataclasses.fields(EnsembleSweep)}
    unknown = set(table) - known
    if unknown:
        raise ValueError(
            f"{path}: unknown [ensemble] keys {sorted(unknown)}; "
            f"valid keys: {sorted(known)}")
    axes = [SweepAxis(**ax) for ax in table.get("sweep", [])]
    kwargs = {k: v for k, v in table.items() if k != "sweep"}
    spec = EnsembleSweep(sweep=axes, **kwargs)
    if spec.replicas < 1:
        raise ValueError(f"{path}: replicas must be >= 1, got {spec.replicas}")
    if spec.batch < 1:
        raise ValueError(f"{path}: batch must be >= 1, got {spec.batch}")
    if spec.batch_impl not in ("vmap", "unroll"):
        raise ValueError(
            f"{path}: unknown batch_impl {spec.batch_impl!r}; "
            "use 'vmap' or 'unroll'")
    for ax in spec.sweep:
        if not ax.key:
            raise ValueError(f"{path}: sweep axis without a key")
        if not ax.values:
            raise ValueError(f"{path}: sweep axis {ax.key!r} has no values")
        _check_sweepable(ax.key)
    return spec


#: params.* keys members may differ in (the scheduler handles them per
#: member)
_PARAMS_SWEEPABLE = ("params.t_final", "params.seed")


def _check_sweepable(key: str):
    if key.startswith("params.") and key not in _PARAMS_SWEEPABLE:
        raise ValueError(
            f"sweep key {key!r} changes the static runtime Params: all "
            "ensemble members share them, so only state "
            f"values are sweepable (params exceptions: "
            f"{', '.join(_PARAMS_SWEEPABLE)}). Run separate ensembles for "
            "different solver/physics parameters.")


def expand_members(spec: EnsembleSweep, base: Config) -> List[MemberPlan]:
    """Cartesian product of sweep axes x replicas -> member plans.

    Member ids are ``m<index:05d>``; the id order (axes outer, replicas
    inner) is the queue order, and ``index`` selects `SimRNG.member(index)`,
    so a sweep is reproducible whatever the lanes' packing.
    """
    base_seed = spec.seed if spec.seed >= 0 else base.params.seed
    base_t_final = (spec.t_final if spec.t_final > 0.0
                    else base.params.t_final)
    points = (itertools.product(*[[(ax.key, v) for v in ax.values]
                                  for ax in spec.sweep])
              if spec.sweep else [()])
    plans = []
    for point in points:
        for _ in range(spec.replicas):
            idx = len(plans)
            overrides = dict(point)
            seed = int(overrides.pop("params.seed", base_seed))
            t_final = float(overrides.pop("params.t_final", base_t_final))
            if t_final <= 0.0:
                # "<= 0 means base" holds for swept values too
                t_final = float(base_t_final)
            plans.append(MemberPlan(member_id=f"m{idx:05d}", index=idx,
                                    overrides=overrides, seed=seed,
                                    t_final=t_final))
    return plans


def apply_overrides(base: Config, overrides: dict) -> Config:
    """Deep-copied base config with dotted-path overrides applied.

    Paths address attributes and list indices: ``fibers.0.length``,
    ``background.uniform``, ``bodies.1.external_force.2``. A path that does
    not resolve raises (never a silent no-op)."""
    cfg = copy.deepcopy(base)
    for key, value in overrides.items():
        _check_sweepable(key)
        parts = key.split(".")
        obj = cfg
        for part in parts[:-1]:
            obj = _descend(obj, part, key)
        _assign(obj, parts[-1], value, key)
    return cfg


def _descend(obj, part: str, key: str):
    if part.isdigit():
        try:
            return obj[int(part)]
        except (IndexError, TypeError) as e:
            raise ValueError(f"override {key!r}: index {part} out of range "
                             f"({e})") from None
    if not hasattr(obj, part):
        raise ValueError(f"override {key!r}: {type(obj).__name__} has no "
                         f"field {part!r}")
    return getattr(obj, part)


def _assign(obj, part: str, value, key: str):
    if part.isdigit():
        try:
            obj[int(part)] = value
        except (IndexError, TypeError) as e:
            raise ValueError(f"override {key!r}: index {part} out of range "
                             f"({e})") from None
        return
    if not hasattr(obj, part):
        raise ValueError(f"override {key!r}: {type(obj).__name__} has no "
                         f"field {part!r}")
    setattr(obj, part, value)


def resolve_base_config(spec: EnsembleSweep, sweep_path: str) -> str:
    """Base-config path, resolved relative to the sweep-spec file."""
    if os.path.isabs(spec.base_config):
        return spec.base_config
    return os.path.join(os.path.dirname(os.path.abspath(sweep_path)),
                        spec.base_config)


def load_members(sweep_path: str):
    """(spec, base_config_path, base Config, [MemberPlan]) from a sweep-spec
    TOML: the front half of `python -m skellysim_tpu_torch.ensemble`."""
    spec = load_sweep(sweep_path)
    base_path = resolve_base_config(spec, sweep_path)
    base = load_config(base_path)
    return spec, base_path, base, expand_members(spec, base)
