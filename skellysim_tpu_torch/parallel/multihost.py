"""Several processes under one mesh: `torch.distributed`.

Counterpart of `skellysim_tpu.parallel.multihost`. The reference scales
across nodes with MPI ranks (`skelly_sim.cpp:14`); the JAX package with
`jax.distributed`, every host running the same program over a global
mesh. Here every process runs the same program too: `initialize` joins
the processes, `parallel.mesh.make_mesh` then gives the mesh of every
process's shards in process order, each process holds and steps only its
own shards (`shard_state`), and the step's collectives
(`parallel.spmd.Collectives`) and the ring (`parallel.ring`) reach the
other processes through the few functions below.

Typical launch (one process a card, the same command everywhere):

    SKELLY_COORDINATOR=host0:1234 SKELLY_NUM_PROCS=4 SKELLY_PROC_ID=$RANK \\
        python my_driver.py

The process group is `gloo` (objects, barriers, and every tensor where
processes share a card or lie on the CPU); where every process has a card
of its own, tensors on the cards go through an `nccl` group instead. NCCL
refuses two processes on one card, and gloo does not take every CUDA
tensor, so on the `gloo` route a CUDA tensor is staged through host
memory here, and the bytes are counted (`staged_bytes`).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch

logger = logging.getLogger("skellysim_tpu_torch")

#: seconds a collective waits for the other processes before it raises
TIMEOUT_S = 600


class _Runtime:
    """The joined processes: this one's index and device, the count, every
    process's card, and the tensor group (None: the default `gloo`
    group)."""

    def __init__(self, rank, world, device, cards, group):
        self.rank, self.world, self.device = rank, world, device
        self.cards, self.group = cards, group
        self.backend = "gloo" if group is None else "nccl"
        self.staged_bytes = 0


_runtime: _Runtime | None = None


def card_id(device: torch.device) -> str:
    """What names ``device`` alike in every process of a host: a card's
    UUID (any process numbering of the cards), or this process's CPU."""
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        if uuid is not None:
            return f"cuda:{uuid}"
        return f"{socket.gethostname()}:cuda:{device.index}"
    return f"{socket.gethostname()}:cpu:{os.getpid()}"


def _process_device(device, process_id: int) -> torch.device:
    """The process's device: ``device`` (default "cuda"; an unnumbered
    "cuda" is the process's card, ``cuda:<process_id % device_count>``
    among the cards it sees). The CPU only where asked for; a missing card
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA card "
                               "(torch.cuda.is_available() is False); pass "
                               "device='cpu' to join on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> bool:
    """Join the other processes; a no-op that returns False for a run of
    one process with no coordinator.

    The arguments default from SKELLY_COORDINATOR (``host:port`` of
    process 0), SKELLY_NUM_PROCS and SKELLY_PROC_ID. ``device`` is the
    process's device, made the current card: by default its card,
    ``cuda:<process_id % device_count>`` of the cards it sees, so that
    every process sees every card; a missing card raises, and the CPU is
    taken only as ``device="cpu"``. The group is `gloo` over
    ``tcp://<coordinator>``; where the processes' cards are all distinct,
    CUDA tensors take an `nccl` group. Logs the backend and the card;
    returns True."""
    global _runtime
    coordinator_address = coordinator_address or os.environ.get(
        "SKELLY_COORDINATOR")
    if num_processes is None and "SKELLY_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SKELLY_NUM_PROCS"])
    if process_id is None and "SKELLY_PROC_ID" in os.environ:
        process_id = int(os.environ["SKELLY_PROC_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if _runtime is not None:
        raise RuntimeError("initialize: this process has already joined")
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            "initialize needs the coordinator address, the process count and "
            "this process's index (SKELLY_COORDINATOR, SKELLY_NUM_PROCS, "
            f"SKELLY_PROC_ID); got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    import torch.distributed as dist

    dev = _process_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    cards = [None] * num_processes
    dist.all_gather_object(cards, card_id(dev))
    group = None
    if dev.type == "cuda" and len(set(cards)) == num_processes:
        group = dist.new_group(backend="nccl")
    _runtime = _Runtime(process_id, num_processes, dev, tuple(cards), group)
    logger.info("process %d of %d on %s (%s), tensors over %s",
                process_id, num_processes, dev, cards[process_id],
                _runtime.backend)
    return True


def runtime() -> _Runtime | None:
    """The joined processes, or None in a run of one process."""
    return _runtime


def _require() -> _Runtime:
    if _runtime is None:
        raise RuntimeError("no process group: call parallel.multihost"
                           ".initialize first")
    return _runtime


def process_info() -> dict:
    """{process_index, process_count, local/global device counts}: the
    analogue of the reference's rank / size echo (`system.cpp:30-45`). One
    process counts every card it sees (the CPU where there is none);
    joined processes drive one device each."""
    if _runtime is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return {"process_index": 0, "process_count": 1,
                "local_device_count": n, "global_device_count": n}
    return {"process_index": _runtime.rank,
            "process_count": _runtime.world, "local_device_count": 1,
            "global_device_count": _runtime.world}


def all_gather_object(obj) -> list:
    """Every process's picklable ``obj``, in process order."""
    import torch.distributed as dist

    out = [None] * _require().world
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait until every process gets here (host side only)."""
    import torch.distributed as dist

    _require()
    dist.barrier()


def _nccl(rt, tensors) -> bool:
    return rt.group is not None and all(t.is_cuda for t in tensors)


def _to_host(rt, t):
    """``t`` as the gloo group takes it: contiguous, on the CPU (a CUDA
    tensor staged, its bytes counted), bool as uint8."""
    t = t.contiguous()
    if t.is_cuda:
        rt.staged_bytes += t.numel() * t.element_size()
        t = t.cpu()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _from_host(rt, t, like):
    """A received host tensor back as ``like``'s dtype and device."""
    if like.dtype == torch.bool:
        t = t.view(torch.bool)
    if like.is_cuda:
        rt.staged_bytes += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def all_gather(t: torch.Tensor) -> list:
    """Every process's ``t`` (the same shape and dtype everywhere), in
    process order, each on ``t``'s device."""
    import torch.distributed as dist

    rt = _require()
    if _nccl(rt, [t]):
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(rt.world)]
        dist.all_gather(out, t, group=rt.group)
        return out
    host = _to_host(rt, t)
    out = [torch.empty_like(host) for _ in range(rt.world)]
    dist.all_gather(out, host)
    return [_from_host(rt, o, t) for o in out]


def exchange(sends, to: int, recv_like, frm: int):
    """Post the sends of ``sends`` to process ``to`` and the receives of
    tensors shaped like ``recv_like`` from process ``frm``, all at once
    (`torch.distributed.batch_isend_irecv`); returns a function that waits
    for them and returns the received tensors on ``recv_like``'s devices.
    On the `gloo` route CUDA tensors are staged through the host."""
    import torch.distributed as dist

    rt = _require()
    nccl = _nccl(rt, list(sends) + list(recv_like))
    if nccl:
        out = [t.contiguous() for t in sends]
        bufs = [torch.empty_like(r) for r in recv_like]
    else:
        out = [_to_host(rt, t) for t in sends]
        bufs = [torch.empty(r.shape, dtype=torch.uint8 if r.dtype == torch.bool
                            else r.dtype) for r in recv_like]
    group = rt.group if nccl else None
    ops = ([dist.P2POp(dist.isend, t, to, group=group, tag=i)
            for i, t in enumerate(out)]
           + [dist.P2POp(dist.irecv, b, frm, group=group, tag=i)
              for i, b in enumerate(bufs)])
    works = dist.batch_isend_irecv(ops)

    def wait():
        for w in works:
            w.wait()
        out.clear()  # the send buffers are held until the sends are done
        if nccl:
            return bufs
        return [_from_host(rt, b, r) for b, r in zip(bufs, recv_like)]

    return wait
