"""Device mesh for the ring pair evaluator.

Counterpart of `skellysim_tpu.parallel.mesh` (`FIBER_AXIS`, `make_mesh`).
The port keeps the JAX package's single-controller model: a mesh is an
ordered tuple of shard devices in one process. On several cards each card
holds one shard; on one card (or on the CPU, as the tests run it) one device
holds several shards, the analogue of the JAX tests' forced host devices.
The ring kernels run the same device code in both layouts (`ops.cuda_kernels`
`ring_stokeslet_f32` / `ring_stresslet_f32`).

`shard_state`, `make_member_mesh` and `make_2d_mesh` belong to the SPMD and
ensemble slices (ROADMAP.md §1 items 11 and 12) and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device

FIBER_AXIS = "fib"


@dataclass(frozen=True)
class Mesh:
    """A 1-D ring of shards along `FIBER_AXIS`: ``devices[k]`` holds shard
    k."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """A ring of ``n_devices`` shards.

    With ``device`` (e.g. ``"cpu"``, ``"cuda"`` or ``"cuda:1"``) all
    ``n_devices`` shards (default 1) live on that one device. Without it
    each shard gets its own card, the first ``n_devices`` visible ones
    (default: all), and every card is given access to its two ring
    neighbours' memory; asking for more cards than exist, or for cards that
    cannot reach their neighbours, raises.
    """
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if device is not None:
        dev = resolve_device(device)
        return Mesh((dev,) * (1 if n_devices is None else int(n_devices)))
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh() places one shard on each CUDA card and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for shards on the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if n > count:
        raise ValueError(f"a mesh of {n} cards was asked for and {count} "
                         "are visible; pass device=... to place several "
                         "shards on one card")
    devices = tuple(torch.device("cuda", i) for i in range(n))
    if n > 1:
        from ..ops.cuda_kernels import enable_ring_peer_access

        enable_ring_peer_access(devices)
    return Mesh(devices)
