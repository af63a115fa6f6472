"""Dynamic-instability rate math (`skellysim_tpu.system.di_rates`).

The catastrophe / growth / nucleation arithmetic of the reference
(`dynamic_instability.cpp:76-91,115-116`), written once for two callers:
the host update (`system.dynamic_instability.apply_dynamic_instability`)
passes ``xp=numpy``, the ensemble's device update
(`scenarios.di_device.di_update`) passes ``xp=torch`` with float64 tensors
on the card. Constants enter the torch path as float64 tensors, so both
paths compute in float64.
"""

from __future__ import annotations

import numpy as np


def _const(xp, v, like):
    """``v`` as the namespace's float64 constant beside ``like`` (numpy:
    the plain float)."""
    if xp is np:
        return v
    return xp.as_tensor(v, dtype=xp.float64, device=like.device)


def effective_rates(di, plus_pinned, xp=np):
    """(v_growth, f_catastrophe) per fiber with the plus-pinned rescaling
    (`dynamic_instability.cpp:76-79`): a fiber whose plus end is pinned to
    the periphery grows slower and dies faster by the collision scales."""
    def c(v):
        return _const(xp, v, plus_pinned)

    v_growth = xp.where(plus_pinned,
                        c(di.v_growth * di.v_grow_collision_scale),
                        c(di.v_growth))
    f_cat = xp.where(plus_pinned,
                     c(di.f_catastrophe * di.f_catastrophe_collision_scale),
                     c(di.f_catastrophe))
    return v_growth, f_cat


def catastrophe_mask(active, u, dt, f_cat, xp=np):
    """Fibers dying this step: P(die) = 1 - exp(-dt * f_cat) per active
    fiber against one uniform draw (`dynamic_instability.cpp:83-84`).
    ``u`` in [0, 1): a fiber dies when its draw exceeds the survival
    probability, so ``u = 0`` never kills and ``u -> 1`` always does —
    the injection convention the parity tests rely on."""
    return active & (u > xp.exp(-dt * f_cat))


def grown_length(length, survive, dt, v_growth, xp=np):
    """Survivor target lengths: L + dt * v_growth; dead fibers keep their
    final length (`dynamic_instability.cpp:89-91`)."""
    return xp.where(survive, length + dt * v_growth, length)


def nucleation_mean(dt, rate, n_inactive):
    """Poisson mean for this step's nucleation count: dt * rate * (number
    of sites not bound at step entry) (`dynamic_instability.cpp:115`)."""
    return dt * rate * n_inactive


def nucleation_count(n_raw, n_free, xp=np):
    """Poisson draw capped by the free-site count
    (`dynamic_instability.cpp:116`)."""
    return xp.minimum(n_raw, n_free)


def nucleated_nodes(origin, com, min_length, n_nodes, xp=np):
    """[n_nodes, 3] node positions of one nucleated fiber: minus end on its
    site, pointing radially out of the body COM, length ``min_length``
    (`dynamic_instability.cpp:118-126,178-186`). ``origin``/``com`` may
    carry leading batch axes; nodes fill a new second-to-last axis."""
    u_dir = origin - com
    u_dir = u_dir / xp.sqrt((u_dir * u_dir).sum(axis=-1, keepdims=True))
    s = (np.linspace(0.0, min_length, n_nodes) if xp is np else
         xp.linspace(0.0, min_length, n_nodes, dtype=origin.dtype,
                     device=origin.device))
    shape = origin.shape[:-1] + (n_nodes, 3)
    return (origin[..., None, :]
            + s.reshape((1,) * (len(shape) - 2) + (n_nodes, 1))
            * u_dir[..., None, :]).reshape(shape)
