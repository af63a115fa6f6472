"""Deformable body: declared interface, deliberately unimplemented.

The port's copy of `skellysim_tpu.bodies.deformable`, the parity marker for
the reference's `DeformableBody` stub (`include/body_deformable.hpp:17-47`,
`src/core/body_deformable.cpp:13-41`): the reference declares a
4-unknowns-per-node deformable surface, but every method is an empty body
and `flow_deformable` throws (`body_container.cpp:449-463`). A config that
selects it fails at build time (`builder.build_bodies`) rather than running
as a rigid body.
"""

from __future__ import annotations


class DeformableBodyNotImplemented(NotImplementedError):
    pass


SOLUTION_PER_NODE = 4  # `body_deformable.hpp:35`: get_solution_size = 4 * n


def make_group(*args, **kwargs):
    raise DeformableBodyNotImplemented(
        "deformable bodies are declared but not implemented (matching the "
        "reference stub: `body_deformable.cpp:13-41`, flow_deformable throws "
        "at `body_container.cpp:449-463`)")
