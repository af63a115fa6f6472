"""Aggregate the auditable-program registry from every layer's seam
(counterpart of `skellysim_tpu.audit.programs`)."""

from __future__ import annotations


def all_programs():
    """Every registered `AuditProgram`, in layer order (system → solver →
    ops → parallel → ensemble → scenarios). Each layer is imported here,
    not when this module is: registration must not pull the simulation
    stack in before the CLI decides what to build."""
    # import the module path directly: package __init__s re-export
    # same-named FUNCTIONS (`solver.gmres`), which would shadow
    # `from ..solver import gmres`-style module lookups
    from ..ensemble.runner import auditable_programs as ensemble_programs
    from ..ops.spectral import auditable_programs as spectral_programs
    from ..ops.treecode import auditable_programs as ops_programs
    from ..parallel.spmd import auditable_programs as parallel_programs
    from ..scenarios.di_device import auditable_programs as scenario_programs
    from ..solver.gmres import auditable_programs as solver_programs
    from ..system.system import auditable_programs as system_programs

    progs = []
    for layer in (system_programs, solver_programs, ops_programs,
                  spectral_programs, parallel_programs, ensemble_programs,
                  scenario_programs):
        progs.extend(layer())
    names = [p.name for p in progs]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate auditable program name(s): "
                         f"{', '.join(sorted(dupes))}")
    return progs


def get_program(name: str):
    for p in all_programs():
        if p.name == name:
            return p
    raise KeyError(
        f"no auditable program named {name!r} "
        f"(registered: {', '.join(p.name for p in all_programs())})")
