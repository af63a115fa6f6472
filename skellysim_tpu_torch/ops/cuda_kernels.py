"""Wrappers of the hand-written pair-sum kernels, with their plain versions.

Kernel A, `stokeslet_f32`: the float32 Stokeslet sum, replacing the Pallas
tile `skellysim_tpu/ops/pallas_kernels.py::_stokeslet_kernel` (reached
through `stokeslet_pallas`). It carries every f32 Krylov matvec of the
mixed-precision solve.

Kernel B, `stokeslet_f64`: the f64-grade Stokeslet sum (f32 or f64 in, f64
out), replacing the double-float Pallas tile
`skellysim_tpu/ops/pallas_df.py::_stokeslet_df_kernel` (reached through
`stokeslet_pallas_df`). It carries the f64 prep flows and every refinement
residual. On the H100 it is native FP64, not double-float emulation.

Kernel C, `stresslet_f32`: the float32 stresslet (double-layer) sum,
replacing `skellysim_tpu/ops/pallas_kernels.py::_stresslet_kernel` (reached
through `stresslet_pallas`). It carries the shell->fiber/body and body->all
flows of every f32 matvec and Gauss-Seidel preconditioner application.

Kernel D, `stresslet_f64`: the f64-grade stresslet sum, replacing
`skellysim_tpu/ops/pallas_df.py::_stresslet_df_kernel` (reached through
`stresslet_pallas_df`). It carries the shell and body double layers of every
refinement residual. Native FP64, like kernel B.

All four are instances of one tiled kernel in ``csrc/pair_sums.cu`` (the
source note there says what bounds them on the card and what the design
does about it), built with nvcc and loaded with ctypes at the first launch
(`ops.cuda_build`).

One routing rule in each wrapper: a CPU tensor takes the plain version (the
blocked displacement forms of `ops.kernels.stokeslet_block` /
`stresslet_block`); a CUDA tensor launches the kernel. There is no
fallback: a build or launch failure raises. Each wrapper counts its
launches in a plain int attribute (``stokeslet_f32.launches``), incremented
where the kernel is launched and nowhere else. ``eta=None`` returns the
unscaled sum (the block entry the ring evaluator will use; the stresslet's
-3 is part of the sum, as in `stresslet_pallas_block`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .kernels import _pair_sum, stokeslet_block, stresslet_block

_FACTOR = 1.0 / (8.0 * math.pi)

#: the one kernel source, ``csrc/pair_sums.cu``
SOURCE = "pair_sums"
#: per family: the plain block form and the payload's columns per source
#: (forces; the 9 row-major stresslet components)
_FAMILIES = {"stokeslet": (stokeslet_block, 3),
             "stresslet": (stresslet_block, 9)}
_DTYPES = {"f32": torch.float32, "f64": torch.float64}

#: the loaded ctypes library (built on first use)
_libs: dict = {}


def _library():
    lib = _libs.get(SOURCE)
    if lib is None:
        lib = cuda_build.load(SOURCE)
        ptr = ctypes.c_void_p
        for family in _FAMILIES:
            for prec, scalar in (("f32", ctypes.c_float),
                                 ("f64", ctypes.c_double)):
                fn = getattr(lib, f"{family}_{prec}_launch")
                fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong,
                               ctypes.c_longlong, scalar, ptr]
                fn.restype = ctypes.c_int
        lib.pair_sums_error_string.argtypes = [ctypes.c_int]
        lib.pair_sums_error_string.restype = ctypes.c_char_p
        _libs[SOURCE] = lib
    return lib


def _scale(eta) -> float:
    """1/(8 pi eta), or 1 for the unscaled entry (``eta=None``)."""
    return 1.0 if eta is None else _FACTOR / float(eta)


def _check_rows(name, a, cols, dtype, device):
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"{name} must be [n, {cols}], got {tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    return a.to(dtype).contiguous()


def _launch(name, family, dtype, r_src, r_trg, payload, scale):
    """Validate, allocate the output and launch kernel ``name`` (e.g.
    "stresslet_f32"); ``payload`` is [n_src, 3] forces or [n_src, 9]
    stresslet components. Raises if the launch was refused
    (cudaGetLastError() != 0 right after it)."""
    device = r_trg.device
    trg = _check_rows("r_trg", r_trg, 3, dtype, device)
    src = _check_rows("r_src", r_src, 3, dtype, device)
    pay = _check_rows("payload", payload, _FAMILIES[family][1], dtype, device)
    if src.shape[0] != pay.shape[0]:
        raise ValueError(f"r_src has {src.shape[0]} rows, the payload "
                         f"{pay.shape[0]}")
    out = torch.zeros((trg.shape[0], 3), dtype=dtype, device=device)
    if trg.shape[0] == 0 or src.shape[0] == 0:
        return out, False
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            trg.data_ptr(), src.data_ptr(), pay.data_ptr(), out.data_ptr(),
            trg.shape[0], src.shape[0], scale, stream)
    if rc != 0:
        err = lib.pair_sums_error_string(rc).decode()
        raise RuntimeError(f"{name}_launch failed: CUDA error {rc} ({err})")
    return out, True


def _make_wrapper(family: str, prec: str):
    """(kernel wrapper, plain version) of one family and precision. The
    payload is [n_src, 3] forces (Stokeslet) or [n_src, 3, 3] / [n_src, 9]
    row-major S (stresslet); the output is [n_trg, 3] in ``prec``, from f32
    or f64 inputs."""
    block, cols = _FAMILIES[family]
    dtype = _DTYPES[prec]
    name = f"{family}_{prec}"

    def plain(r_src, r_trg, payload, eta=None):
        pay = payload.reshape(payload.shape[0], cols).to(dtype)
        if cols == 9:
            pay = pay.reshape(-1, 3, 3)
        u = _pair_sum(block, r_trg.to(dtype), (r_src.to(dtype), pay))
        return u if eta is None else u * (_FACTOR / eta)

    def wrapper(r_src, r_trg, payload, eta=None):
        if r_trg.device.type == "cpu":
            return plain(r_src, r_trg, payload, eta)
        out, launched = _launch(name, family, dtype, r_src, r_trg,
                                payload.reshape(payload.shape[0], cols),
                                _scale(eta))
        wrapper.launches += int(launched)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = f"{name}_plain"
    wrapper.__doc__ = (f"The {prec} {family} sum on its CUDA kernel (CPU "
                       f"tensors: `{name}_plain`).")
    plain.__doc__ = f"Plain {prec} {family} sum (the version `{name}` is " \
                    "held against)."
    wrapper.launches = 0
    return wrapper, plain


stokeslet_f32, stokeslet_f32_plain = _make_wrapper("stokeslet", "f32")  # A
stokeslet_f64, stokeslet_f64_plain = _make_wrapper("stokeslet", "f64")  # B
stresslet_f32, stresslet_f32_plain = _make_wrapper("stresslet", "f32")  # C
stresslet_f64, stresslet_f64_plain = _make_wrapper("stresslet", "f64")  # D

#: every kernel wrapper of this module (chip_smoke resets and reads these)
KERNEL_WRAPPERS = (stokeslet_f32, stokeslet_f64, stresslet_f32, stresslet_f64)
