"""The auditable-program and auditable-kernel registration seams.

Counterpart of `skellysim_tpu.audit.registry`. Each layer that owns an
entry point (`system.system`, `solver.gmres`, `ops.treecode`,
`ops.spectral`, `parallel.spmd`, `ensemble.runner`,
`scenarios.di_device`) exposes a small ``auditable_programs()`` returning
`AuditProgram`s; `audit.programs.all_programs` aggregates them. The
modules that own hand-written kernels (`ops.cuda_kernels` for A-D,
`parallel.ring` for E / F, `ops.treecode` for G / H) expose
``auditable_kernels()`` returning `AuditKernel`s, aggregated by
`audit.kernels.all_kernels`. The layer declares what to run (it knows its
own entry points and their fixtures); `obs.cost` and the audit checks own
how the run is counted and checked.

The JAX package's ``build()`` traces and lowers a jitted function; the
port has no trace, so ``build(device)`` assembles the fixture scene on
``device`` and returns the callable with its arguments, which the cost
counter and the audit's `observe.Observer` run. The JAX package's
``retrace_probe`` counts traces of a jitted entry point over two
same-structure calls; the port's counts what eager torch rebuilds instead
(`rebuild_counts`): a second call of the same structure, with drifted
values, must build nothing the first call built.

Layer modules import this module inside their ``auditable_programs()``,
so the registry never becomes an import-time dependency of the
simulation stack.
"""

from __future__ import annotations

import sys
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
    of the registry. ``retrace_probe(device)``, when given, runs the entry
    point twice with same-structure, different-value arguments and
    returns ``1 + `` what the second call rebuilt (`rebuilds_during`):
    the ``retrace-budget`` check holds it against ``[retrace]
    max_traces``."""

    name: str
    layer: str   # system | solver | ops | parallel | ensemble | scenarios
    summary: str
    build: Callable[..., BuiltProgram]
    retrace_probe: Callable[..., int] | None = None


@dataclass
class KernelCase:
    """One hand-written kernel at one shape: ``wrapper(*args)`` launches it
    (on a CUDA tensor), ``plain(*args)`` is its plain PyTorch version, and
    the two agree within ``rtol`` of the plain result's largest entry.
    ``entries`` are the regular expressions of its compiled functions'
    names in the source's ``-Xptxas -v`` report; ``dynamic_smem`` the
    dynamic shared bytes a block it launches with."""

    label: str
    wrapper: Callable
    plain: Callable
    args: tuple
    rtol: float
    entries: tuple
    dynamic_smem: int = 0


@dataclass
class BuiltKernel:
    """What the ``dma`` check consumes for one registered kernel family:
    its CUDA source (``csrc/<source>.cu``) and its cases (`KernelCase`),
    each at a ragged shape on ``device``."""

    source: str
    cases: list
    device: object = None


@dataclass
class AuditKernel:
    """One registered hand-written kernel family (the ``auditable_kernels()``
    seam: `AuditProgram`'s shape, but ``build(device)`` returns the
    `BuiltKernel` the ``dma`` check launches). Its contract keeps the JAX
    package's name where the JAX package has one (A / B are
    ``stokeslet_pallas_tiles``)."""

    name: str
    layer: str
    summary: str
    kernels: str            # the port's letters, e.g. "A / B"
    build: Callable[..., BuiltKernel]


# ------------------------------------------------------------- rebuilds

def _cache_misses() -> int:
    """Misses of every module-level ``functools.lru_cache`` of the port's
    modules (plan tables, device tables, fiber matrices)."""
    total = 0
    for name, mod in list(sys.modules.items()):
        if not name.startswith("skellysim_tpu_torch.") or mod is None:
            continue
        for v in list(vars(mod).values()):
            info = getattr(v, "cache_info", None)
            if callable(info) and getattr(v, "__module__", None) == name:
                total += info().misses
    return total


def rebuild_counts() -> dict:
    """What the process has built so far: CUDA libraries loaded
    (``ops.cuda_kernels._libs``, each load a ``compile`` event),
    ``lru_cache`` misses of the port's modules, the treecode's device
    tables (``ops.treecode._geometry``) and the host plans and kept-geometry
    misses the fast evaluators count (``ops.spectral.REBUILDS``,
    ``ops.treecode.REBUILDS``)."""
    from ..ops import cuda_kernels, spectral, treecode

    out = {"libraries": len(cuda_kernels._libs),
           "cache_misses": _cache_misses(),
           "device_tables": len(treecode._geometry)}
    out.update(spectral.REBUILDS)
    out.update(treecode.REBUILDS)
    return out


def rebuilds_during(fn, *args, **kwargs) -> tuple:
    """(result, {what: count}) of ``fn(*args, **kwargs)``: the
    `rebuild_counts` it added (only the kinds that moved)."""
    before = rebuild_counts()
    out = fn(*args, **kwargs)
    after = rebuild_counts()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


def probe_twice(first, second) -> int:
    """The port's retrace probe: ``first()`` warms (its builds are
    allowed), ``second(first_result)`` is the same-structure call with new
    values; returns 1 + what the second call rebuilt."""
    out = first()
    _, rebuilt = rebuilds_during(second, out)
    return 1 + sum(rebuilt.values())
