"""Wrappers of the hand-written Stokeslet kernels, with their plain versions.

Kernel A, `stokeslet_f32`: the float32 Stokeslet sum, replacing the Pallas
tile `skellysim_tpu/ops/pallas_kernels.py::_stokeslet_kernel` (reached
through `stokeslet_pallas`). It carries every f32 Krylov matvec of the
mixed-precision solve.

Kernel B, `stokeslet_f64`: the f64-grade Stokeslet sum (f32 or f64 in, f64
out), replacing the double-float Pallas tile
`skellysim_tpu/ops/pallas_df.py::_stokeslet_df_kernel` (reached through
`stokeslet_pallas_df`). It carries the f64 prep flows and every refinement
residual. On the H100 it is native FP64, not double-float emulation.

Both live in ``csrc/stokeslet.cu`` (the source note there says what bounds
them on the card and what the design does about it) and are built with nvcc
and loaded with ctypes at first launch (`ops.cuda_build`).

One routing rule in each wrapper: a CPU tensor takes the plain version
(`stokeslet_f32_plain` / `stokeslet_f64_plain`, the blocked displacement form
of `ops.kernels.stokeslet_block`); a CUDA tensor launches the kernel. There
is no fallback: a build or launch failure raises. Each wrapper counts its
launches in a plain int attribute (``stokeslet_f32.launches``), incremented
where the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .kernels import _pair_sum, stokeslet_block

_FACTOR = 1.0 / (8.0 * math.pi)

_lib = None  # the loaded ctypes library (process-wide, built on first use)


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("stokeslet")
        ptr = ctypes.c_void_p
        lib.stokeslet_f32_launch.argtypes = [ptr, ptr, ptr, ptr,
                                             ctypes.c_longlong,
                                             ctypes.c_longlong,
                                             ctypes.c_float, ptr]
        lib.stokeslet_f32_launch.restype = ctypes.c_int
        lib.stokeslet_f64_launch.argtypes = [ptr, ptr, ptr, ptr,
                                             ctypes.c_longlong,
                                             ctypes.c_longlong,
                                             ctypes.c_double, ptr]
        lib.stokeslet_f64_launch.restype = ctypes.c_int
        lib.stokeslet_error_string.argtypes = [ctypes.c_int]
        lib.stokeslet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _scale(eta) -> float:
    """1/(8 pi eta), or 1 for the unscaled entry (``eta=None``)."""
    return 1.0 if eta is None else _FACTOR / float(eta)


def _check_points(name, a, dtype, device):
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{name} must be [n, 3], got {tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    return a.to(dtype).contiguous()


def _launch(fn_name, dtype, r_src, r_trg, f_src, scale):
    """Validate, allocate the output and launch one kernel; raises if the
    launch was refused (cudaGetLastError() != 0 right after it)."""
    device = r_trg.device
    trg = _check_points("r_trg", r_trg, dtype, device)
    src = _check_points("r_src", r_src, dtype, device)
    f = _check_points("f_src", f_src, dtype, device)
    if src.shape[0] != f.shape[0]:
        raise ValueError(f"r_src has {src.shape[0]} rows, f_src "
                         f"{f.shape[0]}")
    out = torch.zeros((trg.shape[0], 3), dtype=dtype, device=device)
    if trg.shape[0] == 0 or src.shape[0] == 0:
        return out, False
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(trg.data_ptr(), src.data_ptr(),
                                   f.data_ptr(), out.data_ptr(),
                                   trg.shape[0], src.shape[0], scale, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc} "
                           f"({lib.stokeslet_error_string(rc).decode()})")
    return out, True


def stokeslet_f32_plain(r_src, r_trg, f_src, eta=None):
    """Plain float32 Stokeslet sum (the version kernel A is held against)."""
    u = _pair_sum(stokeslet_block, r_trg.to(torch.float32),
                  (r_src.to(torch.float32), f_src.to(torch.float32)))
    return u if eta is None else u * (_FACTOR / eta)


def stokeslet_f64_plain(r_src, r_trg, f_src, eta=None):
    """Plain float64 Stokeslet sum (the version kernel B is held against)."""
    u = _pair_sum(stokeslet_block, r_trg.to(torch.float64),
                  (r_src.to(torch.float64), f_src.to(torch.float64)))
    return u if eta is None else u / (8.0 * math.pi) / eta


def stokeslet_f32(r_src, r_trg, f_src, eta=None):
    """Kernel A: float32 Stokeslet sum [n_trg, 3]; ``eta=None`` returns the
    unscaled sum (the block entry the ring evaluator will use)."""
    if r_trg.device.type == "cpu":
        return stokeslet_f32_plain(r_src, r_trg, f_src, eta)
    out, launched = _launch("stokeslet_f32_launch", torch.float32, r_src,
                            r_trg, f_src, _scale(eta))
    stokeslet_f32.launches += int(launched)
    return out


def stokeslet_f64(r_src, r_trg, f_src, eta=None):
    """Kernel B: f64-grade Stokeslet sum [n_trg, 3] in float64 from f32 or
    f64 inputs; ``eta=None`` returns the unscaled sum."""
    if r_trg.device.type == "cpu":
        return stokeslet_f64_plain(r_src, r_trg, f_src, eta)
    out, launched = _launch("stokeslet_f64_launch", torch.float64, r_src,
                            r_trg, f_src, _scale(eta))
    stokeslet_f64.launches += int(launched)
    return out


stokeslet_f32.launches = 0
stokeslet_f64.launches = 0

#: every kernel wrapper of this module (chip_smoke resets and reads these)
KERNEL_WRAPPERS = (stokeslet_f32, stokeslet_f64)
