"""Batched adaptive streamline and vortex-line integration.

Counterpart of `skellysim_tpu.postprocess.streamline` (the reference's
per-line Boost.odeint Cash-Karp 5(4) loops,
`src/core/streamline.cpp:67-165`): the K seeds of a batch
advance together, so each integrator stage is one velocity evaluation over
K points (one launch of each pair kernel), and a line that is done (its
``t_final`` reached, its buffer full, or its speed past the singularity
bailout ``|v| > 1e3``, `streamline.cpp:51-53`) rides a done-mask. Where the
JAX package runs the steps in a ``lax.while_loop``, here they are a Python
loop with one host read a step (the all-done test), never one a line.

Error control is Boost's `controlled_runge_kutta` with its
`default_error_checker` (a_x = a_dxdt = 1): per component the tolerance
abs_err + rel_err (|x| + dt |dx/dt|), acceptance at a max-norm error <= 1,
a step shrink of 0.9 err^(-1/3) floored at 0.2, and growth of 0.9
err^(-1/5) capped at 5 below err 0.5.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

# Cash-Karp 5(4) tableau
_A = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (3 / 10, -9 / 10, 6 / 5),
    (-11 / 54, 5 / 2, -70 / 27, 35 / 27),
    (1631 / 55296, 175 / 512, 575 / 13824, 44275 / 110592, 253 / 4096),
)
_B5 = (37 / 378, 0.0, 250 / 621, 125 / 594, 0.0, 512 / 1771)
_B4 = (2825 / 27648, 0.0, 18575 / 48384, 13525 / 55296, 277 / 14336, 1 / 4)

_SINGULAR_SPEED = 1e3  # `streamline.cpp:51`


class _LineBatch(NamedTuple):
    """Padded integration output of K lines."""

    x: torch.Tensor      # [K, S, 3]
    time: torch.Tensor   # [K, S]
    count: torch.Tensor  # [K] samples written a line
    steps: int           # integrator steps taken


def _integrate_batch(field_fn: Callable, speed_fn: Callable | None, x0,
                     dt_init, t_final, abs_err, rel_err, sign,
                     max_steps: int) -> _LineBatch:
    """Integrate dx/ds = sign field(x) for s in [0, t_final],
    every line at once. ``speed_fn`` (the bailout's field) None means
    ``field_fn``, whose first stage is then reused. Recorded times are
    sign s, as the reference's backward leg from 0 to -t_final
    (`streamline.cpp:84`)."""
    K = x0.shape[0]
    S = max_steps
    dtype, dev = x0.dtype, x0.device
    ks = torch.arange(K, device=dev)

    buf_x = torch.zeros((K, S, 3), dtype=dtype, device=dev)
    buf_x[:, 0] = x0
    buf_t = torch.zeros((K, S), dtype=dtype, device=dev)
    count = torch.ones(K, dtype=torch.int64, device=dev)
    t = torch.zeros(K, dtype=dtype, device=dev)
    dt = torch.full((K,), float(dt_init), dtype=dtype, device=dev)
    done = torch.full((K,), bool(t_final <= 0.0), device=dev)
    eps_t = 1e-14 * max(1.0, abs(float(t_final)))
    x = x0
    it = 0

    def f(xx):
        return sign * field_fn(xx)

    while it < 8 * S and bool((~done).any()):
        dt_use = torch.clamp_max(dt, t_final - t)
        h = dt_use[:, None]
        k1 = f(x)
        # singularity bailout: the previous point was recorded; a line whose
        # speed there explodes ends (for streamlines |k1| is the speed)
        if speed_fn is None:
            speed = torch.linalg.vector_norm(k1, dim=-1)
        else:
            speed = torch.linalg.vector_norm(speed_fn(x), dim=-1)
        done = done | (speed > _SINGULAR_SPEED)
        k2 = f(x + h * (_A[0][0] * k1))
        k3 = f(x + h * (_A[1][0] * k1 + _A[1][1] * k2))
        k4 = f(x + h * (_A[2][0] * k1 + _A[2][1] * k2 + _A[2][2] * k3))
        k5 = f(x + h * (_A[3][0] * k1 + _A[3][1] * k2 + _A[3][2] * k3
                        + _A[3][3] * k4))
        k6 = f(x + h * (_A[4][0] * k1 + _A[4][1] * k2 + _A[4][2] * k3
                        + _A[4][3] * k4 + _A[4][4] * k5))
        stages = (k1, k2, k3, k4, k5, k6)
        dx5 = sum(b * k for b, k in zip(_B5, stages))
        dx4 = sum(b * k for b, k in zip(_B4, stages))
        x5 = x + h * dx5

        tol = abs_err + rel_err * (torch.abs(x) + h * torch.abs(k1))
        err = torch.amax(h * torch.abs(dx5 - dx4) / tol, dim=-1)
        err = torch.clamp_min(err, 1e-30)

        accept = (err <= 1.0) & ~done
        new_x = torch.where(accept[:, None], x5, x)
        new_t = torch.where(accept, t + dt_use, t)

        write = accept & (count < S)
        idx = torch.clamp(count, 0, S - 1)
        buf_x[ks, idx] = torch.where(write[:, None], new_x, buf_x[ks, idx])
        buf_t[ks, idx] = torch.where(write, sign * new_t, buf_t[ks, idx])
        count = count + write.to(count.dtype)

        fac_dec = torch.clamp_min(0.9 * err ** (-1 / 3), 0.2)
        fac_inc = torch.clamp_max(0.9 * err ** (-1 / 5), 5.0)
        dt = torch.where(err > 1.0, dt_use * fac_dec,
                         torch.where(err < 0.5, dt_use * fac_inc, dt_use))
        done = done | (new_t >= t_final - eps_t) | (count >= S)
        x, t = new_x, new_t
        it += 1
    return _LineBatch(x=buf_x, time=buf_t, count=count, steps=it)


def make_vorticity_fn(vel_fn: Callable, eps: float | None = None) -> Callable:
    """The curl of ``vel_fn`` by 6-point central differences
    (`get_vorticity_at_point`, `streamline.cpp:16-35`): one velocity
    evaluation over 6K points a call.
    ``eps`` defaults to 1e-7 in float64 and 1e-3 in float32."""

    def vort(x):
        x = torch.atleast_2d(x)
        e = eps if eps is not None else (1e-7 if x.dtype == torch.float64
                                         else 1e-3)
        K = x.shape[0]
        offs = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                             [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                            dtype=x.dtype, device=x.device) * e
        pts = (x[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        v = vel_fn(pts).reshape(K, 6, 3)
        return (0.5 / e) * torch.stack([
            (v[:, 2, 2] - v[:, 3, 2]) - (v[:, 4, 1] - v[:, 5, 1]),
            (v[:, 4, 0] - v[:, 5, 0]) - (v[:, 0, 2] - v[:, 1, 2]),
            (v[:, 0, 1] - v[:, 1, 1]) - (v[:, 2, 0] - v[:, 3, 0]),
        ], dim=-1)

    return vort


def _seeds(x0, device):
    if torch.is_tensor(x0):
        x0 = x0.to(device) if device is not None else x0
    else:
        x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64),
                             device=device)
    return torch.atleast_2d(x0)


def _assemble(field_fn, speed_fn, x0, dt_init, t_final, abs_err, rel_err,
              back_integrate, max_steps, val_fn, device=None, stats=None):
    """The forward (and backward) legs, joined line by line on the host."""
    x0 = _seeds(x0, device)
    if x0.numel() == 0:
        return []

    def run(sign):
        batch = _integrate_batch(field_fn, speed_fn, x0, dt_init, t_final,
                                 abs_err, rel_err, sign, max_steps=max_steps)
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + batch.steps
        count = batch.count.cpu().numpy()
        # val over the recorded extent only (a multiple of 64, as in the
        # JAX package), not the padded buffer
        used = min(-(-max(int(count.max()), 1) // 64) * 64, max_steps)
        x_used = batch.x[:, :used]
        val = val_fn(x_used.reshape(-1, 3)).reshape(x_used.shape)
        return (x_used.cpu().numpy(), batch.time[:, :used].cpu().numpy(),
                val.cpu().numpy(), count)

    parts = [run(1.0)]
    if back_integrate:
        parts.insert(0, run(-1.0))

    lines = []
    for i in range(x0.shape[0]):
        if back_integrate:
            (bx, bt, bv, bc), (fx, ft, fv, fc) = parts
            nb, nf = int(bc[i]), int(fc[i])
            # the backward leg reversed without its seed, then the forward
            # leg (`join_back_and_forward`, `streamline.cpp:56-65`)
            x = np.concatenate([bx[i, :nb][::-1][:-1], fx[i, :nf]])
            tm = np.concatenate([bt[i, :nb][::-1][:-1], ft[i, :nf]])
            val = np.concatenate([bv[i, :nb][::-1][:-1], fv[i, :nf]])
        else:
            fx, ft, fv, fc = parts[0]
            nf = int(fc[i])
            x, tm, val = fx[i, :nf], ft[i, :nf], fv[i, :nf]
        lines.append({"x": x, "val": val, "time": tm})
    return lines


def streamlines(vel_fn: Callable, x0, *, dt_init: float = 0.1,
                t_final: float = 1.0, abs_err: float = 1e-10,
                rel_err: float = 1e-6, back_integrate: bool = True,
                max_steps: int = 512, device=None, stats=None):
    """Streamlines of ``vel_fn(pts)`` ([n, 3] tensors in, [n, 3] out) from [K, 3] seeds ``x0`` (placed on ``device``); a list of
    {x: [n, 3], val: [n, 3], time: [n]} numpy dicts, one a line, the
    reference's `StreamLine` wire fields (`streamline.hpp:29`). ``stats``
    (a dict) gains the integrator steps taken under ``"steps"``."""
    return _assemble(vel_fn, None, x0, dt_init, t_final, abs_err, rel_err,
                     back_integrate, max_steps, val_fn=vel_fn, device=device,
                     stats=stats)


def vortex_lines(vel_fn: Callable, x0, *, dt_init: float = 0.1,
                 t_final: float = 1.0, abs_err: float = 1e-10,
                 rel_err: float = 1e-6, back_integrate: bool = True,
                 max_steps: int = 512, eps: float | None = None,
                 device=None, stats=None):
    """Vorticity field lines; ``val`` holds the vorticity along each line
    (`VortexLine::compute`, `streamline.cpp:115-165`). The bailout tests the
    velocity, as the reference's shared observer does."""
    vort_fn = make_vorticity_fn(vel_fn, eps)
    return _assemble(vort_fn, vel_fn, x0, dt_init, t_final, abs_err, rel_err,
                     back_integrate, max_steps, val_fn=vort_fn, device=device,
                     stats=stats)
