"""Carry state and parameters across from the JAX package.

The two packages share no objects: a caller (the tests, a migration script)
turns the JAX package's state into numpy arrays and plain values, and these
functions build the port's counterparts on a given device. Field names are
the JAX package's (`FiberGroup`, `PeripheryState`, `BodyGroup`, `Params`),
so ``group._asdict()`` and ``dataclasses.asdict(params)`` pass through
unchanged once their leaves are numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import params as P
from .bodies.bodies import BodyGroup
from .device import resolve_device
from .fibers.container import FiberGroup
from .fibers.matrices import FibMatsRT
from .obs.flight import FlightRecorder
from .periphery.periphery import PeripheryState
from .system import BackgroundFlow, PointSources, SimState

_INT_FIELDS = {"binding_body", "binding_site", "config_rank",
               "ext_force_type"}
_BOOL_FIELDS = {"minus_clamped", "plus_pinned", "active", "kind_sphere",
                "node_mask", "row_mask", "sol_mask"}


def params_from_dict(d: Mapping) -> P.Params:
    """`Params` from a mapping of the JAX `Params` fields (nested tables as
    mappings); unknown keys are rejected so a renamed field cannot vanish."""
    known = {f.name for f in dataclasses.fields(P.Params)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown Params fields {sorted(unknown)}")
    kw = dict(d)
    for name, cls in (("dynamic_instability", P.DynamicInstability),
                      ("periphery_binding", P.PeripheryBinding),
                      ("fiber_periphery_interaction",
                       P.FiberPeripheryInteraction)):
        if isinstance(kw.get(name), Mapping):
            kw[name] = cls(**kw[name])
    if "periodic_box" in kw:
        kw["periodic_box"] = tuple(kw["periodic_box"])
    return P.Params(**kw)


def _tuple_from_numpy(cls, leaves: Mapping, device, dtype, keep=()):
    """``cls`` (a NamedTuple of tensors) from numpy leaves: int/bool fields
    keep their kind, the ``keep`` fields keep their own float dtype, every
    other float field becomes ``dtype``."""
    kw = {}
    for name in cls._fields:
        v = leaves.get(name)
        if v is None:
            kw[name] = None
            continue
        a = np.array(v)
        t = (torch.int32 if name in _INT_FIELDS
             else torch.bool if name in _BOOL_FIELDS
             else torch.as_tensor(a).dtype if name in keep else dtype)
        kw[name] = torch.as_tensor(a, dtype=t, device=device)
    return cls(**kw)


def group_from_numpy(leaves: Mapping, *, device, dtype=torch.float64) -> FiberGroup:
    """`FiberGroup` from a mapping of numpy leaves named like the JAX
    `FiberGroup` fields; ``rt_mats`` (runtime node-padded matrices) is
    None or a mapping of the JAX `FibMatsRT` fields (``rt._asdict()``)."""
    rt = leaves.get("rt_mats")
    if rt is not None:
        if not isinstance(rt, Mapping):
            rt = rt._asdict()
        rt = _tuple_from_numpy(FibMatsRT, rt, device, dtype)
    leaves = {k: v for k, v in leaves.items() if k != "rt_mats"}
    return _tuple_from_numpy(FiberGroup, leaves, device, dtype)._replace(
        rt_mats=rt)


def shell_from_numpy(leaves: Mapping, *, device, dtype=torch.float64) -> PeripheryState:
    """`PeripheryState` from numpy leaves named like the JAX
    `PeripheryState` fields; M_inv keeps its own dtype (f32 in mixed mode),
    ``node_mask`` (a node-masked shell's live rows) stays bool."""
    return _tuple_from_numpy(PeripheryState, leaves, device, dtype,
                             keep=("M_inv",))


def bodies_from_numpy(leaves, *, device, dtype=torch.float64):
    """`BodyGroup` (one mapping of JAX `BodyGroup` fields) or a tuple of
    buckets (a sequence of mappings)."""
    if isinstance(leaves, Mapping):
        return _tuple_from_numpy(BodyGroup, leaves, device, dtype)
    return tuple(_tuple_from_numpy(BodyGroup, g, device, dtype)
                 for g in leaves)


def state_from_numpy(fibers, *, time: float, dt: float, points=None,
                     background=None, shell=None, bodies=None, flight=None,
                     device=None, dtype=torch.float64) -> SimState:
    """`SimState` from numpy-leaf mappings: ``fibers`` is one mapping of
    `FiberGroup` fields, a sequence of them (resolution buckets) or None;
    ``points`` maps the `PointSources` fields, ``background`` the
    `BackgroundFlow` fields, ``shell`` the `PeripheryState` fields,
    ``bodies`` the `BodyGroup` fields (or a sequence of buckets) and
    ``flight`` the flight ring's (``rows``, ``count``; `obs.flight`)."""
    device = resolve_device(device)
    if fibers is None:
        fib = None
    elif isinstance(fibers, Mapping):
        fib = group_from_numpy(fibers, device=device, dtype=dtype)
    else:
        fib = tuple(group_from_numpy(g, device=device, dtype=dtype)
                    for g in fibers)
    pts = bg = None
    if points is not None:
        points = {k: np.array(v) for k, v in points.items()}
        pts = PointSources.make(points["position"], points["force"],
                                points["torque"], points["time_to_live"],
                                dtype=dtype, device=device)
    if background is not None:
        background = {k: np.array(v) for k, v in background.items()}
        bg = BackgroundFlow.make(background["uniform"],
                                 background["components"],
                                 background["scale"], dtype=dtype,
                                 device=device)
    return SimState(
        time=float(time), dt=float(dt), fibers=fib, points=pts, background=bg,
        shell=(None if shell is None
               else shell_from_numpy(shell, device=device, dtype=dtype)),
        bodies=(None if bodies is None
                else bodies_from_numpy(bodies, device=device, dtype=dtype)),
        flight=(None if flight is None else FlightRecorder(
            rows=torch.as_tensor(np.asarray(flight["rows"]),
                                 dtype=torch.float32, device=device),
            count=torch.as_tensor(np.asarray(flight["count"]),
                                  dtype=torch.int32, device=device))))
