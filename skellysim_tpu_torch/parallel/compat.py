"""The fused-ring selection seam (`skellysim_tpu.parallel.compat
.fused_ring_mode`).

The JAX package's other compatibility shims (`shard_map`, `use_mesh`)
bridge jax versions and have no counterpart here.
"""

from __future__ import annotations

import os

import torch


def fused_ring_mode(impl: str, device: torch.device) -> str:
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
    """
    override = os.environ.get("SKELLY_FUSED_RING", "").strip().lower()
    if override in ("0", "off", "ppermute"):
        return "ppermute"
    if impl != "pallas" or torch.device(device).type != "cuda":
        return "ppermute"
    return "fused"
