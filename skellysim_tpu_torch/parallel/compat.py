"""The fused-ring selection seam (`skellysim_tpu.parallel.compat
.fused_ring_mode`).

The JAX package's other compatibility shims (`shard_map`, `use_mesh`)
bridge jax versions and have no counterpart here.
"""

from __future__ import annotations

import logging
import os

import torch

logger = logging.getLogger("skellysim_tpu_torch")

#: layouts whose refusal of the fused ring was logged (once each)
_logged: set = set()


def fused_ring_mode(impl: str, device: torch.device, mesh=None) -> str:
    """``"fused"`` (one ring kernel a card, kernels E / F) or
    ``"ppermute"`` (the hop-by-hop ring accumulation,
    `parallel.ring._ring_accumulate`).

    The fused kernel serves ``impl="pallas"`` on CUDA tensors.
    ``SKELLY_FUSED_RING=0`` (also "off" / "ppermute") is the JAX package's
    explicit opt-out and gives the hop-by-hop ring. CPU tensors take the
    plain hop-by-hop ring. There is no environmental fallback on the card:
    where the kernel cannot build or launch, the call raises. (The JAX
    package's "interpret" override and its VMEM budget gate do not carry
    over: the card's ring slots live in device memory and serve every
    shape.)

    The layout rule, the counterpart of that gate: the fused ring needs
    every card of the ``mesh`` driven by one process (one process for all
    the shards of a card; on several cards one process a card, or one for
    them all). E / F's blocks spin on counters that the neighbours'
    launches signal, and two processes on one card have two contexts whose
    kernels take turns on it, never running at once, so such a ring could
    only time out. A mesh whose processes share a card takes
    ``"ppermute"``; the first such call for a mesh logs why and emits a
    ``fault`` event (kind ``fused_ring_fallback``, leg ``layout``) to the
    active tracer, as the JAX package does for its environmental
    fallbacks.
    """
    override = os.environ.get("SKELLY_FUSED_RING", "").strip().lower()
    if override in ("0", "off", "ppermute"):
        return "ppermute"
    if impl != "pallas" or torch.device(device).type != "cuda":
        return "ppermute"
    shared = mesh.shared_cards() if mesh is not None else []
    if shared:
        if mesh not in _logged:
            _logged.add(mesh)
            logger.info(
                "fused ring refused: processes %s share card(s) %s, whose "
                "contexts take turns on the card; the ring runs hop by hop "
                "(\"ppermute\")", sorted(set(mesh.processes)), shared)
            from ..obs import tracer as obs_tracer

            obs_tracer.emit("fault", kind="fused_ring_fallback",
                            reason=f"shared-cards-{shared}", leg="layout")
        return "ppermute"
    return "fused"
