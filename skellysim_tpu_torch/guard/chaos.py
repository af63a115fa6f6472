"""Fault injectors: deliberately break what the guard must survive.

Counterpart of `skellysim_tpu.guard.chaos`: `poison_state` /
`poison_lane` flip NaNs into a (lane's) state between rounds,
`zero_preconditioner` forces GMRES stagnation on a live `System`,
`nan_lane_of` poisons the lane a scheduler runs a member on (the serve
``chaos`` request, which stays off unless ``[serve] chaos_enabled``), and
`garble_frame` / `truncate_frame` / `oversized_header` corrupt client
frames of the serve protocol. SIGKILL is
`serve.client.SpawnedServer.kill`. No production path imports this
module.
"""

from __future__ import annotations

import torch


def poison_state(state, *, value=float("nan")):
    """``state`` with every fiber position set to ``value`` (the canonical
    poisoned-member injection; shapes and dtypes unchanged)."""
    from ..fibers import container as fc

    buckets = tuple(g._replace(x=torch.full_like(g.x, value))
                    for g in fc.as_buckets(state.fibers))
    fibers = (buckets[0] if isinstance(state.fibers, fc.FiberGroup)
              else buckets)
    return state._replace(fibers=fibers)


def poison_lane(ens, lane: int, *, value=float("nan")):
    """An `EnsembleState` with lane ``lane``'s member state poisoned; the
    other lanes' tensors are copied unchanged (`ensemble.runner
    .set_lane`)."""
    from ..ensemble.runner import lane_state, set_lane

    poisoned = poison_state(lane_state(ens.states, lane), value=value)
    return ens._replace(states=set_lane(ens.states, lane, poisoned))


def _zeroed(fn):
    def zeroed(*args, **kw):
        return torch.zeros_like(fn(*args, **kw))
    return zeroed


def zero_preconditioner(target):
    """Patch ``target`` (in place; returns it) so that every
    preconditioner application is zero: GMRES's Krylov updates become
    A 0 = 0, the implicit residual collapses while x never moves, and the
    solve exits through the stall path with a STAGNATION verdict.
    ``target`` is a `System`, or an `ensemble.EnsembleRunner` once built:
    the runner's batched trial and its member mesh's twin systems apply
    preconditioners of their own, and the runner's patch zeroes them all
    (its system's, the batched trial's, and each twin's as it is made)."""
    from ..ensemble.runner import EnsembleRunner

    if not isinstance(target, EnsembleRunner):
        target._apply_precond = _zeroed(target._apply_precond)
        return target
    zero_preconditioner(target.system)
    batched = getattr(target, "_batched", None)
    if batched is not None:
        batched._precond = _zeroed(batched._precond)
    runner_on, patched = target._runner_on, set()

    def on_device(device):
        run = runner_on(device)
        if run is not target and id(run) not in patched:
            patched.add(id(run))
            zero_preconditioner(run)
        return run

    target._runner_on = on_device
    return target


def nan_lane_of(scheduler, member_id: str, *, value=float("nan")) -> int:
    """Poison the lane currently running ``member_id`` on a live
    scheduler; returns the lane index."""
    lane = scheduler.lane_of(member_id)
    if lane is None:
        raise ValueError(f"member {member_id!r} holds no lane")
    scheduler.ens = poison_lane(scheduler.ens, lane, value=value)
    return lane


# ------------------------------------------------------------ wire chaos

def garble_frame(payload: bytes, *, seed: int = 0, flips: int = 16) -> bytes:
    """``payload`` with ``flips`` deterministic byte flips: still a
    well-framed message, no longer valid msgpack (the server must answer
    a structured error, not die)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    buf = bytearray(payload)
    for _ in range(max(1, flips)):
        i = int(rng.integers(0, len(buf)))
        buf[i] ^= 0xFF
    return bytes(buf)


def truncate_frame(framed: bytes, keep: int) -> bytes:
    """The first ``keep`` bytes of a framed (header + payload) message: a
    mid-frame disconnect or partial delivery."""
    return framed[:keep]


def oversized_header(size: int) -> bytes:
    """A frame header claiming ``size`` bytes (no body): the hostile or
    corrupt header the decoder must survive in skip mode."""
    from ..serve import protocol

    return protocol.HEADER.pack(size)
