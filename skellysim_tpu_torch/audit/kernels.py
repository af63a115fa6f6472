"""Aggregate the auditable-kernel registry from every module that owns a
hand-written kernel (counterpart of `skellysim_tpu.audit.kernels`).

`ops.cuda_kernels` registers A-D, `parallel.ring` E / F and
`ops.treecode` G / H, each through an ``auditable_kernels()`` returning
`registry.AuditKernel`s; the ``dma`` check (`audit.dmaflow`) runs each on
the card.
"""

from __future__ import annotations


def all_kernels():
    """Every registered `AuditKernel`, ops before parallel. The modules are
    imported here, not when this module is."""
    from ..ops.cuda_kernels import auditable_kernels as pair_kernels
    from ..ops.treecode import auditable_kernels as tree_kernels
    from ..parallel.ring import auditable_kernels as ring_kernels

    kerns = []
    for layer in (pair_kernels, tree_kernels, ring_kernels):
        kerns.extend(layer())
    names = [k.name for k in kerns]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate auditable kernel name(s): "
                         f"{', '.join(sorted(dupes))}")
    return kerns



def get_kernel(name: str):
    """The registered `AuditKernel` named ``name``; KeyError naming the
    registered ones otherwise."""
    for k in all_kernels():
        if k.name == name:
            return k
    raise KeyError(
        f"no auditable kernel named {name!r} "
        f"(registered: {', '.join(k.name for k in all_kernels())})")
