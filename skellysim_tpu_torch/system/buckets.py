"""Capacity padding (`skellysim_tpu.system.buckets`).

Only the mesh padding of the ring evaluator is ported; the bucket policy,
`bucketize` and the capacity ladders belong to ROADMAP.md §1 item 11.
"""

from __future__ import annotations

from ..fibers import container as fc


def pad_for_mesh(fibers, mesh_size: int):
    """Round each fiber group up to a mesh-divisible node count with inert
    padding slots (`fibers.container.grow_capacity`): the ring evaluator's
    divisibility invariant, which `System._fiber_flow` checks."""
    if fibers is None or mesh_size <= 1:
        return fibers
    if isinstance(fibers, fc.FiberGroup):
        return fc.grow_capacity(fibers, fibers.n_fibers,
                                node_multiple=mesh_size)
    return tuple(fc.grow_capacity(g, g.n_fibers, node_multiple=mesh_size)
                 for g in fibers)
