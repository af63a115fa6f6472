"""Capacity padding (`skellysim_tpu.system.buckets`).

The mesh padding of the ring evaluator and dynamic instability's geometric
fiber-capacity rungs (the default policy). The bucket policy, `bucketize`
and the `[runtime]` ladders belong to ROADMAP.md §1 item 11.
"""

from __future__ import annotations

from ..fibers import container as fc

#: the geometric fiber-capacity ladder (x2 from 2, doubling past the last
#: rung): the rungs dynamic instability's capacity growth lands on
GEOMETRIC_FIBER_LADDER = (2, 4, 8, 16, 32, 64, 128, 256, 512,
                          1024, 2048, 4096, 8192, 16384)


def _rung(ladder, n: int) -> int:
    """Smallest ladder rung >= n; doubles past the last rung."""
    for r in ladder:
        if r >= n:
            return r
    r = ladder[-1] if ladder else 1
    while r < n:
        r *= 2
    return r


def next_fiber_capacity(n_needed: int) -> int:
    """Dynamic instability's growth target: the geometric rung that holds
    ``n_needed`` fibers (the JAX package's default policy)."""
    return _rung(GEOMETRIC_FIBER_LADDER, max(n_needed, 1))


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
