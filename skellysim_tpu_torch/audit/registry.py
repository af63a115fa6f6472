"""The auditable-program registration seam.

Counterpart of `skellysim_tpu.audit.registry`. Each layer that owns an
entry point (`system.system`, `solver.gmres`, `ops.treecode`,
`ops.spectral`, `parallel.spmd`, `ensemble.runner`,
`scenarios.di_device`) exposes a small ``auditable_programs()`` returning
`AuditProgram`s; `audit.programs.all_programs` aggregates them. The layer
declares what to run (it knows its own entry points and their fixtures);
`obs.cost` owns how the run is counted.

The JAX package's ``build()`` traces and lowers a jitted function; the
port has no trace, so ``build(device)`` assembles the fixture scene on
``device`` and returns the callable with its arguments, which `obs.cost`
runs under its counter. There is no ``retrace_probe``: nothing retraces.
Layer modules import this module inside their ``auditable_programs()``,
so the registry never becomes an import-time dependency of the
simulation stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class BuiltProgram:
    """One registered entry point, ready to run: ``fn(*args, **kwargs)``
    on ``device``, the scene's tensors already there."""

    fn: Callable
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    device: object = None


@dataclass
class AuditProgram:
    """One registered entry point. ``build(device)`` assembles its fixture
    scene on ``device`` (None: the card) and returns a `BuiltProgram`;
    it is called lazily, so a single-program run never pays for the rest
    of the registry."""

    name: str
    layer: str          # system | solver | ops | parallel | ensemble | scenarios
    summary: str
    build: Callable[..., BuiltProgram]
