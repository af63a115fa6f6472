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

A and B are ``csrc/stokeslet_sums.cu``, C and D ``csrc/stresslet_sums.cu``,
each designed for the card (the source notes say what bounds them and what
the design does about it): R targets a thread, sources staged by
``cp.async`` into a double-buffered tile, and a split over sources whose
partial sums a second pass reduces in order. `pair_plan` picks R, the chunks
and the grid of all four. Their pair code is ``csrc/pair_terms.cuh``, which
E and F include too. Each also takes a member axis (the ensemble's lanes):
`stokeslet_f32_batched` and its siblings sum B members of one shape in one
launch of the same kernel (member ``blockIdx.z``), the lone wrappers being
its B = 1 case; their plain twins sum member by member through the lone
plain versions.
``csrc/pair_sums.cu`` keeps the first design of A-D (one target a thread) as
their yardstick: `stokeslet_f32_tiled`, `stokeslet_f64_tiled`,
`stresslet_f32_tiled` and `stresslet_f64_tiled`, which only the GPU tests and
chip_smoke.py's kernel phases call. Every source is built with nvcc and
loaded with ctypes at the first launch (`ops.cuda_build`).

Kernel E, `ring_stokeslet_f32`, and kernel F, `ring_stresslet_f32`: the
float32 Stokeslet and stresslet sums of a ring evaluator, every shard's
resident targets against every shard's source block, with the blocks
rotating around the ring inside one kernel. They replace
`skellysim_tpu/parallel/ring_fused.py::_ring_kernel` (kind "stokeslet" and
"stresslet", reached through `fused_ring_block_sum`) and carry every f32
fiber and shell flow of a ring run. Both are ``csrc/ring_sums.cu``; they
take per-shard lists (shard k on its mesh device) and return the unscaled
per-shard sums. Inside every ring step they are kernel A's design (R
targets a thread, ``cp.async`` staging of a tile-major slot, a source split
whose partial sums a second launch reduces in order; `ring_plan` picks the
split). Their first design (one target a thread) stays as their yardstick,
`ring_stokeslet_f32_v1` / `ring_stresslet_f32_v1`. Their plain version is
the ring accumulation (`parallel.ring._ring_accumulate`) over kernel A's /
C's plain block.

Kernel G, `tree_stokeslet_f32` / `tree_stokeslet_f64`, and kernel H,
`tree_stresslet_f32` / `tree_stresslet_f64`: the treecode's near and far
pair sums (``csrc/tree_sums.cu``), with no Pallas counterpart (the JAX
package sums them in plain XLA, `skellysim_tpu/ops/treecode.py
_tree_eval`). They take leaf-sorted targets and lists of source segments
(`ops.treecode._segment_lists`): one block an item of at most
`TREE_ITEM_TARGETS` targets of one leaf, a warp T targets (two a lane) x
32 / T source slices, the leaf's segments split over the warps and staged
by ``cp.async``. Their first design (one target a lane, items of at most
`TREE_V1_ITEM_TARGETS`) stays as their yardstick, `tree_stokeslet_f32_v1`
and its siblings, which no path launches. Their plain twin expands the
same lists into pairs, whichever design's items they hold.

One routing rule in each wrapper: a CPU tensor takes the plain version (the
blocked displacement forms of `ops.kernels.stokeslet_block` /
`stresslet_block`); a CUDA tensor launches the kernel. There is no
fallback: a build or launch failure raises. Each wrapper counts its
launches in a plain int attribute (``stokeslet_f32.launches``), incremented
where the kernel is launched and nowhere else. Each wrapper is also a pair
seam of `obs.cost`: under a counter it counts its sum once, from the
shapes (the treecode's from its lists), whether the kernel or the plain
version computes it (`obs.cost.seamed`; ``wrapper.uncounted`` is the call
without the seam). ``eta=None`` returns the unscaled sum (the block entry
the ring evaluator will use; the stresslet's
-3 is part of the sum, as in `stresslet_pallas_block`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..obs import cost as _cost
from . import cuda_build
from .kernels import _pair_sum, stokeslet_block, stresslet_block

_FACTOR = 1.0 / (8.0 * math.pi)

#: the Stokeslet sums' source, ``csrc/stokeslet_sums.cu`` (kernels A and B)
STOKESLET_SOURCE = "stokeslet_sums"
#: the stresslet sums' source, ``csrc/stresslet_sums.cu`` (kernels C and D)
STRESSLET_SOURCE = "stresslet_sums"
#: the tiled pair sums' source, ``csrc/pair_sums.cu`` (the first design of
#: A-D, their yardstick)
SOURCE = "pair_sums"
#: the fused ring sums' source, ``csrc/ring_sums.cu`` (kernels E and F)
RING_SOURCE = "ring_sums"
#: the treecode's pair sums' source, ``csrc/tree_sums.cu`` (kernels G and H)
TREE_SOURCE = "tree_sums"
#: every kernel source (chip_smoke builds them in parallel)
SOURCES = (STOKESLET_SOURCE, STRESSLET_SOURCE, SOURCE, RING_SOURCE,
           TREE_SOURCE)
#: per family: the plain block form and the payload's columns per source
#: (forces; the 9 row-major stresslet components)
_FAMILIES = {"stokeslet": (stokeslet_block, 3),
             "stresslet": (stresslet_block, 9)}
_DTYPES = {"f32": torch.float32, "f64": torch.float64}

#: the loaded ctypes library (built on first use)
_libs: dict = {}


def _library(source: str = SOURCE):
    lib = _libs.get(source)
    if lib is not None:
        return lib
    lib = cuda_build.load(source)
    ptr, cint, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scalars = {"f32": ctypes.c_float, "f64": ctypes.c_double}
    if source in (STOKESLET_SOURCE, STRESSLET_SOURCE):
        family = source.split("_")[0]
        for prec, scalar in scalars.items():
            fn = getattr(lib, f"{family}_{prec}_launch")
            fn.argtypes = [cint, ptr, ptr, ptr, ptr, ptr, cll, cll, cll, cll,
                           cint, cint, scalar, ptr]
            fn.restype = cint
        fn = getattr(lib, f"{family}_blocks_per_sm")
        fn.argtypes = [cint, ctypes.POINTER(cint)]
        fn.restype = cint
        if family == "stokeslet":
            lib.rsqrt_f64_probe_launch.argtypes = [ptr, ptr, ptr, cll, ptr]
            lib.rsqrt_f64_probe_launch.restype = cint
    elif source == SOURCE:
        for prec, scalar in scalars.items():
            for family in _FAMILIES:
                fn = getattr(lib, f"{family}_{prec}_tiled_launch")
                fn.argtypes = [ptr, ptr, ptr, ptr, cll, cll, scalar, ptr]
                fn.restype = cint
    elif source == TREE_SOURCE:
        for prec, scalar in scalars.items():
            for family in _FAMILIES:
                for v in ("", "_v1"):
                    fn = getattr(lib, f"tree_{family}_{prec}{v}_launch")
                    fn.argtypes = [ptr] * 6 + [cll, scalar, ptr]
                    fn.restype = cint
        lib.tree_shared_bytes.argtypes = [cint, cint]
        lib.tree_shared_bytes.restype = cint
        for fn, want in ((lib.tree_item_targets, TREE_ITEM_TARGETS),
                         (lib.tree_v1_item_targets, TREE_V1_ITEM_TARGETS)):
            got = fn()
            if got != want:
                raise RuntimeError(f"tree_sums.cu's {fn.__name__}() is {got}, "
                                   f"the lists use {want}")
    else:
        for name in _RING_RECORD_WORDS:
            plan_args = [] if name.endswith("_v1") else [cint] * 5
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = [ptr, cint, cll, cll, cint, cint, cint,
                           ctypes.c_ulonglong, *plan_args, ptr]
            fn.restype = cint
            fn = getattr(lib, f"{name}_blocks_per_sm")
            fn.argtypes = [cint, ctypes.POINTER(cint)]
            fn.restype = cint
        lib.ring_enable_peer_access.argtypes = [cint, cint]
        lib.ring_enable_peer_access.restype = cint
        ull_p = ctypes.POINTER(ctypes.c_ulonglong)
        lib.ring_ipc_alloc.argtypes = [cint, ctypes.c_ulonglong,
                                       ctypes.c_ulonglong, ull_p, ptr]
        lib.ring_ipc_alloc.restype = cint
        lib.ring_ipc_open.argtypes = [cint, ptr, ull_p]
        lib.ring_ipc_open.restype = cint
        lib.ring_ipc_handle_bytes.argtypes = []
        lib.ring_ipc_handle_bytes.restype = cint
        for i, (name, words) in enumerate(_RING_RECORD_WORDS.items()):
            got = lib.ring_record_words(i)
            if got != words:
                raise RuntimeError(f"ring_sums.cu's {name} slot takes {got} "
                                   f"words a source, the wrapper sizes slots "
                                   f"for {words}")
        got = lib.ring_targets_a_thread()
        if got != RING_R:
            raise RuntimeError(f"ring_sums.cu builds E and F with R = {got}, "
                               f"the plan uses {RING_R}")
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [cint]
    err.restype = ctypes.c_char_p
    _libs[source] = lib
    return lib


def _cuda_error(source: str, rc: int) -> str:
    return getattr(_library(source), f"{source}_error_string")(rc).decode()


def _scale(eta) -> float:
    """1/(8 pi eta), or 1 for the unscaled entry (``eta=None``)."""
    return 1.0 if eta is None else _FACTOR / float(eta)


def _check_rows(name, a, cols, dtype, device):
    if a.ndim != 2 or a.shape[1] != cols:
        raise ValueError(f"{name} must be [n, {cols}], got {tuple(a.shape)}")
    if a.device != device:
        raise ValueError(f"{name} is on {a.device}, expected {device}")
    return a.to(dtype).contiguous()


def _operands(family, dtype, r_src, r_trg, payload):
    """The validated, contiguous (targets, sources, payload) of one sum;
    ``payload`` is [n_src, 3] forces or [n_src, 9] stresslet components."""
    device = r_trg.device
    trg = _check_rows("r_trg", r_trg, 3, dtype, device)
    src = _check_rows("r_src", r_src, 3, dtype, device)
    pay = _check_rows("payload", payload, _FAMILIES[family][1], dtype, device)
    if src.shape[0] != pay.shape[0]:
        raise ValueError(f"r_src has {src.shape[0]} rows, the payload "
                         f"{pay.shape[0]}")
    return trg, src, pay


def _raise_on(source, name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {rc} "
                           f"({_cuda_error(source, rc)})")


def _tiled_launch(name, family, dtype, r_src, r_trg, payload, scale):
    """Validate, allocate the output and launch ``csrc/pair_sums.cu``'s
    tiled kernel ``name`` (e.g. "stresslet_f32_tiled"). Returns (output,
    launched); raises if the launch was refused (cudaGetLastError() != 0
    right after it)."""
    trg, src, pay = _operands(family, dtype, r_src, r_trg, payload)
    device = trg.device
    out = torch.zeros((trg.shape[0], 3), dtype=dtype, device=device)
    if trg.shape[0] == 0 or src.shape[0] == 0:
        return out, False
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            trg.data_ptr(), src.data_ptr(), pay.data_ptr(), out.data_ptr(),
            trg.shape[0], src.shape[0], scale, stream)
    _raise_on(SOURCE, name, rc)
    return out, True


# --------------------------------------------- kernels A-D: the plan

#: threads a block and sources a staged tile of kernels A and B
#: (``csrc/stokeslet_sums.cu``, kThreads and kTile)
STOKESLET_THREADS = 128
STOKESLET_TILE = 128
#: targets a thread of each precision's one instance, tuned on the card
#: (PERF.md; the source's kR, which refuses a launch with another R)
STOKESLET_R = {"f32": 8, "f64": 2}
#: the same of kernels C and D (``csrc/stresslet_sums.cu``)
STRESSLET_THREADS = 128
STRESSLET_TILE = 128
STRESSLET_R = {"f32": 4, "f64": 2}
#: per family: the source, threads a block, sources a tile, R a precision
_PAIR_KERNELS = {
    "stokeslet": (STOKESLET_SOURCE, STOKESLET_THREADS, STOKESLET_TILE,
                  STOKESLET_R),
    "stresslet": (STRESSLET_SOURCE, STRESSLET_THREADS, STRESSLET_TILE,
                  STRESSLET_R)}
#: the plan takes the fewest source chunks whose blocks keep at least this
#: share of the card's resident block slots busy over the launch
_BUSY_TARGET = 0.95
#: the most source chunks a plan takes (bounds the partial-sum scratch)
_MAX_CHUNKS = 64
#: the most partial-sum values a plan's scratch holds ([members, chunks,
#: n_trg, 3]); a batch of many members takes fewer chunks. No lone sum the
#: port runs reaches it (640k targets x 64 chunks x 3 is 123M)
_MAX_SCRATCH = 1 << 28
#: the most members one launch serves (gridDim.z)
MAX_MEMBERS = 65535


@dataclass(frozen=True)
class PairPlan:
    """How one launch of kernel A, B (``family`` "stokeslet"), C or D
    ("stresslet") covers the pairs: target block b holds targets [b R T,
    (b + 1) R T) (T threads, R a thread), source chunk c holds sources
    [c L, min(n_src, (c + 1) L)) (L = ``chunk_len``, a tile multiple), and
    the grid is every (target block, chunk). ``busy`` is the share of the
    card's block slots (SMs x resident blocks an SM) the launch keeps busy
    when every block of a chunk takes the same time."""
    family: str
    n_trg: int
    n_src: int
    r: int
    threads: int
    tile: int
    target_blocks: int
    chunks: int
    chunk_len: int
    slots: int
    busy: float
    #: independent sums of this shape one launch serves (blockIdx.z)
    members: int = 1

    @property
    def grid(self) -> tuple:
        if self.members == 1:
            return (self.target_blocks, self.chunks)
        return (self.target_blocks, self.chunks, self.members)

    @property
    def tiles(self) -> int:
        return -(-self.n_src // self.tile)

    @property
    def scratch_shape(self) -> tuple:
        """The partial sums, [chunks, n_trg, 3] ([members, chunks, n_trg,
        3] for a batch), that the reduction pass adds in chunk order."""
        if self.members == 1:
            return (self.chunks, self.n_trg, 3)
        return (self.members, self.chunks, self.n_trg, 3)

    def target_ranges(self) -> list:
        per = self.r * self.threads
        return [(b * per, min(self.n_trg, (b + 1) * per))
                for b in range(self.target_blocks)]

    def source_ranges(self) -> list:
        return [(c * self.chunk_len, min(self.n_src, (c + 1) * self.chunk_len))
                for c in range(self.chunks)]


def pair_plan(family: str, n_trg: int, n_src: int, sm_count: int,
              blocks_per_sm: int, prec: str = "f32", members: int = 1,
              chunks: int | None = None) -> PairPlan:
    """The launch plan of kernel A / B (``family`` "stokeslet", ``prec``
    "f32" / "f64") or C / D ("stresslet") for ``members`` sums (one launch,
    B = 1 the lone sum) of ``n_trg`` targets and ``n_src`` sources each
    (both >= 1) on a card of ``sm_count`` SMs with ``blocks_per_sm``
    resident blocks of the kernel each. Targets fill ceil(n_trg / (R T))
    blocks a member; the sources are split into the fewest equal
    tile-multiple chunks (at most ``_MAX_CHUNKS``, at most one a tile, the
    scratch within ``_MAX_SCRATCH`` values) that keep ``_BUSY_TARGET`` of
    the slots busy over the members' blocks, or the busiest split when none
    does: a grid of fewer blocks than slots, or whose last wave is mostly
    empty, leaves SMs idle. ``chunks`` forces the split a lone plan of
    that many chunks takes (the same ``chunk_len``), so each member sums in
    the lone launch's order."""
    if family not in _PAIR_KERNELS:
        raise ValueError(f"no pair kernel family {family!r}; built: "
                         f"{tuple(_PAIR_KERNELS)}")
    _, threads, tile, rs = _PAIR_KERNELS[family]
    if prec not in rs:
        raise ValueError(f"no {family.capitalize()} kernel is built for "
                         f"{prec!r}; built: {tuple(rs)}")
    r = rs[prec]
    if n_trg < 1 or n_src < 1 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError("a plan needs n_trg, n_src, sm_count and "
                         "blocks_per_sm >= 1, got "
                         f"{(n_trg, n_src, sm_count, blocks_per_sm)}")
    if not 1 <= members <= MAX_MEMBERS:
        raise ValueError(f"a launch serves 1 to {MAX_MEMBERS} members "
                         f"(gridDim.z), got {members}")
    target_blocks = -(-n_trg // (r * threads))
    tiles = -(-n_src // tile)
    slots = sm_count * blocks_per_sm
    blocks = target_blocks * members
    most = max(1, min(tiles, _MAX_CHUNKS,
                      _MAX_SCRATCH // (3 * n_trg * members)))
    if chunks is not None:
        if chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {chunks}")
        want_range = [min(chunks, tiles)]
    else:
        want_range = range(1, most + 1)
    best = None
    for want in want_range:
        chunk_tiles = -(-tiles // want)
        n_chunks = -(-tiles // chunk_tiles)
        waves = -(-blocks * n_chunks // slots)
        busy = blocks * tiles / (waves * slots * chunk_tiles)
        if best is None or busy > best[0]:
            best = (busy, n_chunks, chunk_tiles)
        if busy >= _BUSY_TARGET:
            break
    busy, n_chunks, chunk_tiles = best
    return PairPlan(family=family, n_trg=n_trg, n_src=n_src, r=r,
                    threads=threads, tile=tile, target_blocks=target_blocks,
                    chunks=n_chunks, chunk_len=chunk_tiles * tile,
                    slots=slots, busy=busy, members=members)


def stokeslet_plan(n_trg: int, n_src: int, sm_count: int, blocks_per_sm: int,
                   prec: str = "f32") -> PairPlan:
    """`pair_plan` of kernel A (``prec`` "f32") or B ("f64")."""
    return pair_plan("stokeslet", n_trg, n_src, sm_count, blocks_per_sm, prec)


#: SM count by device, and resident blocks an SM by (device, family, prec)
_sm_counts: dict = {}
_blocks_per_sm: dict = {}


def pair_card_plan(family, device, prec, n_trg, n_src, members: int = 1,
                   chunks: int | None = None) -> PairPlan:
    """`pair_plan` on ``device`` (a CUDA device), with its SM count and the
    kernel's resident blocks an SM as the card reports them."""
    source = _PAIR_KERNELS[family][0]
    lib = _library(source)
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    key = (device, family, prec)
    if key not in _blocks_per_sm:
        got = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(lib, f"{family}_blocks_per_sm")(int(prec == "f64"),
                                                         ctypes.byref(got))
        _raise_on(source, f"{family}_blocks_per_sm", rc)
        if got.value < 1:
            raise RuntimeError(f"{family}_{prec} cannot be resident on "
                               f"{device}")
        _blocks_per_sm[key] = got.value
    return pair_plan(family, n_trg, n_src, _sm_counts[device],
                     _blocks_per_sm[key], prec, members=members,
                     chunks=chunks)


def _aligned(a):
    """``a`` if its data is 16-byte aligned (the kernel stages full tiles
    with 16-byte copies), else an aligned copy."""
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _member_operands(family, dtype, r_src, r_trg, payload):
    """`_operands` of a member batch: targets [B, n_trg, 3], sources [B,
    n_src, 3] and payload [B, n_src, cols], one device, one B."""
    device = r_trg.device
    cols = _FAMILIES[family][1]
    for name, a, c in (("r_trg", r_trg, 3), ("r_src", r_src, 3),
                       ("payload", payload, cols)):
        if a.ndim != 3 or a.shape[2] != c:
            raise ValueError(f"{name} must be [B, n, {c}], got "
                             f"{tuple(a.shape)}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, expected {device}")
    if not r_trg.shape[0] == r_src.shape[0] == payload.shape[0]:
        raise ValueError("targets, sources and payload hold "
                         f"{r_trg.shape[0]}, {r_src.shape[0]} and "
                         f"{payload.shape[0]} members")
    if r_src.shape[1] != payload.shape[1]:
        raise ValueError(f"r_src has {r_src.shape[1]} rows a member, the "
                         f"payload {payload.shape[1]}")
    return (r_trg.to(dtype).contiguous(), r_src.to(dtype),
            payload.to(dtype))


def _member_rows(a, stride):
    """[B, n, c] as a contiguous 16-byte aligned [B, stride, c] (the extra
    rows zero): every member's first row then stays 16-byte aligned."""
    if a.shape[1] == stride and a.is_contiguous() and a.data_ptr() % 16 == 0:
        return a
    out = a.new_zeros((a.shape[0], stride, a.shape[2]))
    out[:, :a.shape[1]] = a
    return out


def _pair_launch(family, prec, r_src, r_trg, payload, scale,
                 chunks: int | None = None):
    """Validate, plan, allocate the output and the partial-sum scratch, and
    launch kernel A / B (``family`` "stokeslet") or C / D ("stresslet"):
    the chunk pass and the reduction pass. Lone operands are [n, c]; a
    member batch ([B, n, c] each, `_member_operands`) takes one launch over
    the B members, its source rows padded to a multiple of 4 a member so
    each member's first source stays 16-byte aligned. ``chunks`` forces the
    source split (`pair_plan`). Returns (output, launched); raises if a
    launch was refused."""
    dtype = _DTYPES[prec]
    batched = r_trg.ndim == 3
    if batched:
        trg, src, pay = _member_operands(family, dtype, r_src, r_trg,
                                         payload)
        members = trg.shape[0]
    else:
        trg, src, pay = _operands(family, dtype, r_src, r_trg, payload)
        members = 1
    device = trg.device
    n_trg, n_src = trg.shape[-2], src.shape[-2]
    out = torch.empty(trg.shape, dtype=dtype, device=device)
    if n_trg == 0 or n_src == 0 or members == 0:
        return out.zero_(), False
    source = _PAIR_KERNELS[family][0]
    lib = _library(source)
    plan = pair_card_plan(family, device, prec, n_trg, n_src, members,
                          chunks)
    if batched:
        stride = -(-n_src // 4) * 4
        src, pay = _member_rows(src, stride), _member_rows(pay, stride)
    else:
        stride = n_src
        src, pay = _aligned(src), _aligned(pay)
    part = torch.empty(plan.scratch_shape, dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{family}_{prec}_launch")(
            plan.r, trg.data_ptr(), src.data_ptr(), pay.data_ptr(),
            part.data_ptr(), out.data_ptr(), n_trg, n_src, stride,
            plan.chunk_len, plan.chunks, members, scale, stream)
    _raise_on(source, f"{family}_{prec}", rc)
    return out, True


def rsqrt_f64_probe(x):
    """Kernel B's reciprocal square root on a CUDA float64 tensor: (the
    ``rsqrt.approx.ftz.f64`` seed, the corrected result), to measure both
    errors on the card."""
    x = x.to(torch.float64).contiguous()
    seed, y = torch.empty_like(x), torch.empty_like(x)
    lib = _library(STOKESLET_SOURCE)
    with torch.cuda.device(x.device):
        rc = lib.rsqrt_f64_probe_launch(
            x.data_ptr(), seed.data_ptr(), y.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(STOKESLET_SOURCE, "rsqrt_f64_probe", rc)
    return seed, y


# ------------------------------------------------------------ the wrappers

def _make_wrapper(family: str, prec: str, name: str, launch):
    """(kernel wrapper, plain version) of one family and precision;
    ``launch(r_src, r_trg, payload, scale) -> (out, launched)`` runs the
    kernel. The payload is [n_src, 3] forces (Stokeslet) or [n_src, 3, 3] /
    [n_src, 9] row-major S (stresslet); the output is [n_trg, 3] in
    ``prec``, from f32 or f64 inputs."""
    block, cols = _FAMILIES[family]
    dtype = _DTYPES[prec]

    def plain(r_src, r_trg, payload, eta=None):
        pay = payload.reshape(payload.shape[0], cols).to(dtype)
        if cols == 9:
            pay = pay.reshape(-1, 3, 3)
        u = _pair_sum(block, r_trg.to(dtype), (r_src.to(dtype), pay))
        return u if eta is None else u * (_FACTOR / eta)

    @_cost.seamed(family, _cost.dense_work)
    def wrapper(r_src, r_trg, payload, eta=None):
        if r_trg.device.type == "cpu":
            return plain(r_src, r_trg, payload, eta)
        out, launched = launch(r_src, r_trg,
                               payload.reshape(payload.shape[0], cols),
                               _scale(eta))
        wrapper.launches += int(launched)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = f"{family}_{prec}_plain"
    wrapper.__doc__ = (f"The {prec} {family} sum on its CUDA kernel (CPU "
                       f"tensors: `{plain.__name__}`).")
    plain.__doc__ = f"Plain {prec} {family} sum (the version `{name}` is " \
                    "held against)."
    wrapper.launches = 0
    return wrapper, plain


def _pair_wrapper(family, prec):
    return _make_wrapper(
        family, prec, f"{family}_{prec}",
        lambda s, t, p, scale: _pair_launch(family, prec, s, t, p, scale))


def _batched_wrapper(family: str, prec: str, lone_plain):
    """(kernel wrapper, plain version) of one family and precision over a
    member axis: sources [B, n_src, 3], targets [B, n_trg, 3] and payload
    [B, n_src, 3] / [B, n_src, 3, 3] / [B, n_src, 9] -> [B, n_trg, 3] in
    ``prec``. On the card one launch serves every member (`_pair_launch`);
    ``chunks`` forces the source split (the lone plan's, to compare bits
    with a lone launch). The plain version sums member by member through
    the lone plain version, so it gives its bits."""
    cols = _FAMILIES[family][1]
    name = f"{family}_{prec}_batched"

    def plain(r_src, r_trg, payload, eta=None):
        return torch.stack([lone_plain(s, t, p, eta)
                            for s, t, p in zip(r_src, r_trg, payload)])

    @_cost.seamed(family, _cost.dense_work)
    def wrapper(r_src, r_trg, payload, eta=None, *, chunks=None):
        if r_trg.device.type == "cpu":
            return plain(r_src, r_trg, payload, eta)
        out, launched = _pair_launch(
            family, prec, r_src, r_trg,
            payload.reshape(payload.shape[0], payload.shape[1], cols),
            _scale(eta), chunks=chunks)
        wrapper.launches += int(launched)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = f"{name}_plain"
    wrapper.__doc__ = (f"The {prec} {family} sums of a member batch in one "
                       f"launch of its CUDA kernel (CPU tensors: "
                       f"`{plain.__name__}`).")
    plain.__doc__ = (f"Plain {prec} {family} sums of a member batch, member "
                     f"by member (the version `{name}` is held against).")
    wrapper.launches = 0
    return wrapper, plain


def _tiled_wrapper(family, prec):
    name = f"{family}_{prec}_tiled"
    return _make_wrapper(
        family, prec, name,
        lambda s, t, p, scale: _tiled_launch(name, family, _DTYPES[prec], s,
                                             t, p, scale))[0]


stokeslet_f32, stokeslet_f32_plain = _pair_wrapper("stokeslet", "f32")  # A
stokeslet_f64, stokeslet_f64_plain = _pair_wrapper("stokeslet", "f64")  # B
stresslet_f32, stresslet_f32_plain = _pair_wrapper("stresslet", "f32")  # C
stresslet_f64, stresslet_f64_plain = _pair_wrapper("stresslet", "f64")  # D
#: A-D over a member axis (the ensemble's lanes): one launch a family
stokeslet_f32_batched, stokeslet_f32_batched_plain = _batched_wrapper(
    "stokeslet", "f32", stokeslet_f32_plain)
stokeslet_f64_batched, stokeslet_f64_batched_plain = _batched_wrapper(
    "stokeslet", "f64", stokeslet_f64_plain)
stresslet_f32_batched, stresslet_f32_batched_plain = _batched_wrapper(
    "stresslet", "f32", stresslet_f32_plain)
stresslet_f64_batched, stresslet_f64_batched_plain = _batched_wrapper(
    "stresslet", "f64", stresslet_f64_plain)
#: the first design of A-D (one target a thread), kept as their yardstick:
#: only the GPU tests and chip_smoke.py's kernel phases call these
stokeslet_f32_tiled = _tiled_wrapper("stokeslet", "f32")
stokeslet_f64_tiled = _tiled_wrapper("stokeslet", "f64")
stresslet_f32_tiled = _tiled_wrapper("stresslet", "f32")
stresslet_f64_tiled = _tiled_wrapper("stresslet", "f64")


# ---------------------------------------------------------------- ring sums

#: threads a block and sources a staged tile of kernels E and F
#: (``csrc/ring_sums.cu``, kThreads and kTile)
RING_THREADS = 128
RING_TILE = 128
#: targets a thread of E's and F's instances, tuned on the card (PERF.md;
#: the source's kR, checked when the library loads, which refuses a launch
#: with another R)
RING_R = 4
#: the position of a slot's pad sources (the source's kPadPosition, the JAX
#: package's _PAD_SENTINEL); their payload is zero
RING_PAD_POSITION = 1e18
#: floats a source takes in a slot, by instance: the redesign's tile-major
#: layout (position + payload) and the first design's 16-byte records;
#: checked against the source when the library loads
_RING_RECORD_WORDS = {"ring_stokeslet_f32": 6, "ring_stresslet_f32": 12,
                      "ring_stokeslet_f32_v1": 8, "ring_stresslet_f32_v1": 12}
#: shards one ring call serves at most (the kernel's table size)
_RING_MAX_SHARDS = 16


@dataclass(frozen=True)
class RingPlan:
    """How one call of kernel E or F covers the pairs of each ring step.
    A slot holds ``tiles`` full tiles (the last padded). A work item is
    (target block b: targets [b R T, (b + 1) R T), T threads, R a thread;
    chunk c: tiles [c C, (c + 1) C) of the step's slot, C =
    ``chunk_tiles``), item index i = b chunks + c; ``grid`` blocks a shard
    stride over a step's items, block g taking those whose running index
    step x items + i is g mod grid. ``busy`` is the share of a step's
    block slots (grid x rounds of items x C tiles) the items fill."""
    n_trg: int
    n_src: int
    n_shards: int
    r: int
    tiles: int
    target_blocks: int
    chunks: int
    chunk_tiles: int
    grid: int
    busy: float

    @property
    def items(self) -> int:
        return self.target_blocks * self.chunks

    @property
    def scratch_shape(self) -> tuple:
        """A shard's partial sums, [n steps, chunks, n_trg, 3], that the
        reduction adds step-major then chunk."""
        return (self.n_shards, self.chunks, self.n_trg, 3)

    def item_ranges(self, i: int) -> tuple:
        """(target range, source range) of item ``i``; the source range
        stops at n_src (the slot's pads past it add nothing)."""
        b, c = divmod(i, self.chunks)
        per, per_chunk = self.r * RING_THREADS, self.chunk_tiles * RING_TILE
        return ((b * per, min(self.n_trg, (b + 1) * per)),
                (c * per_chunk, min(self.n_src, (c + 1) * per_chunk)))

    def block_items(self, block: int, step: int) -> range:
        """The items block ``block`` sums at ring step ``step``."""
        return range((block - step * self.items) % self.grid, self.items,
                     self.grid)


def ring_plan(n_trg: int, n_src: int, n_shards: int, shards_per_launch: int,
              sms: int, blocks_per_sm: int, family: str) -> RingPlan:
    """The plan of kernel E (``family`` "stokeslet") or F ("stresslet") for
    ``n_trg`` targets and ``n_src`` sources a shard on a ring of
    ``n_shards``, each launch serving ``shards_per_launch`` of them on a
    card of ``sms`` SMs with ``blocks_per_sm`` resident blocks of the
    kernel: the persistent grid is sms x blocks_per_sm / shards_per_launch
    blocks a shard. The sources of a step are split into the fewest chunks
    of whole tiles that keep ``_BUSY_TARGET`` of a step's block slots busy
    on the whole card's grid (one shard a card), or the busiest split there
    when none does (one chunk a tile at the most). The split sets the order
    of the f32 sums, so it does not depend on ``shards_per_launch``: the
    same shards give the same bits on one card as on one card each. A
    launch serving s shards gives each the card's grid / s, which the same
    items fill at least as well where s divides the card's grid; ``busy``
    is the share on the launch's own grid."""
    if family not in _FAMILIES:
        raise ValueError(f"no ring kernel is built for {family!r}; built: "
                         f"{tuple(_FAMILIES)}")
    if min(n_trg, n_src, n_shards, shards_per_launch, sms,
           blocks_per_sm) < 1:
        raise ValueError("a ring plan needs counts >= 1, got "
                         f"{(n_trg, n_src, n_shards, shards_per_launch)} "
                         f"on {sms} SMs x {blocks_per_sm} blocks")
    if n_shards > _RING_MAX_SHARDS or shards_per_launch > n_shards:
        raise ValueError(f"a ring has 1..{_RING_MAX_SHARDS} shards and a "
                         f"launch serves at most all of them, got {n_shards}, "
                         f"{shards_per_launch}")
    grid = sms * blocks_per_sm // shards_per_launch
    if grid < 1:
        raise ValueError(f"{shards_per_launch} shards a launch leave a grid "
                         f"of 0 on {sms} SMs x {blocks_per_sm} blocks")
    target_blocks = -(-n_trg // (RING_R * RING_THREADS))
    tiles = -(-n_src // RING_TILE)

    def busy_on(width, chunk_tiles):
        rounds = -(-target_blocks * -(-tiles // chunk_tiles) // width)
        return target_blocks * tiles / (rounds * width * chunk_tiles)

    best, seen = None, set()
    for want in range(1, tiles + 1):
        chunk_tiles = -(-tiles // want)
        if chunk_tiles in seen:
            continue
        seen.add(chunk_tiles)
        busy = busy_on(sms * blocks_per_sm, chunk_tiles)
        if best is None or busy > best[0]:
            best = (busy, chunk_tiles)
        if busy >= _BUSY_TARGET:
            break
    chunk_tiles = best[1]
    return RingPlan(n_trg=n_trg, n_src=n_src, n_shards=n_shards, r=RING_R,
                    tiles=tiles, target_blocks=target_blocks,
                    chunks=-(-tiles // chunk_tiles), chunk_tiles=chunk_tiles,
                    grid=grid, busy=busy_on(grid, chunk_tiles))


def ring_slot_plain(family: str, src, payload):
    """The plain form of one slot of kernel E / F, as the kernel packs it:
    per tile of RING_TILE sources, the tile's positions (row-major x, y,
    z), then its payload (row-major), the last tile padded with sources at
    RING_PAD_POSITION carrying zero payload. Returns [tiles, RING_TILE
    (3 + cols)] float32."""
    cols = _FAMILIES[family][1]
    n = src.shape[0]
    tiles = -(-n // RING_TILE)
    pos = torch.full((tiles * RING_TILE, 3), RING_PAD_POSITION,
                     dtype=torch.float32, device=src.device)
    pay = torch.zeros((tiles * RING_TILE, cols), dtype=torch.float32,
                      device=src.device)
    pos[:n] = src
    pay[:n] = payload.reshape(n, cols)
    return torch.cat([pos.reshape(tiles, -1), pay.reshape(tiles, -1)], dim=1)


class _RingComm:
    """One ring's persistent device state: each shard's n write-once slots
    (``slot_words`` floats each) and its n + 2 monotone counters (arrival
    per slot, entry, exit), on the shard's device, the number of calls
    served (the epoch the kernel waits for) and the grid width every launch
    of the ring takes (each counter counts one signal a block; the width
    follows from the ring's devices, so it never changes). The
    counters are zeroed once here and never again: a reset between calls
    would race with a slow neighbour. Each zero fill runs on its card's
    current stream, which nothing orders before a neighbour card's first
    signal into these counters, so every card of the ring is synchronized
    before the ring is used (once a ring)."""

    def __init__(self, devices, slot_words, grid):
        n = len(devices)
        self.grid = grid
        self.slots = [torch.empty(n * slot_words, dtype=torch.float32,
                                  device=d) for d in devices]
        self.flags = [torch.zeros(n + 2, dtype=torch.int64, device=d)
                      for d in devices]
        for d in set(devices):
            torch.cuda.synchronize(d)
        self.epoch = 0

    def pointers(self, k: int):
        """(slots, counters) of shard ``k``."""
        return self.slots[k].data_ptr(), self.flags[k].data_ptr()


def _every_error(error: str | None) -> str | None:
    """Every process's ``error`` joined (None where none met one): a
    gather, so also a barrier, after which every process decides alike."""
    from ..parallel import multihost

    errors = [e for e in multihost.all_gather_object(error) if e]
    return "; ".join(errors) or None


class _IpcRing:
    """One ring's state where its shards lie in several processes (one
    process a card): `_RingComm`'s slots and counters, each of this
    process's shards in one plain `cudaMalloc` of the library
    (``csrc/ring_sums.cu`` `ring_ipc_alloc`: counters zeroed, then the
    slots), exported as a CUDA IPC handle. The handles are exchanged once
    (`multihost.all_gather_object`), and each neighbour that another
    process holds is mapped (`ring_ipc_open`): a launch reads and writes no
    other memory of another process's shards. Nothing here is ever freed
    or unmapped: a neighbour process may write it as long as it runs. The
    ring is used only after every process has zeroed its counters (the
    gathers that follow are barriers, and an explicit barrier ends the
    set-up). The epoch is numbered alike in every process: they make the
    same ring calls in the same order."""

    def __init__(self, lib, mesh, slot_words: int, grid: int):
        from ..parallel import multihost

        n = mesh.size
        self.grid, self.epoch = grid, 0
        flag_bytes = -(-(n + 2) * 8 // 256) * 256
        total = flag_bytes + n * slot_words * 4
        hb = lib.ring_ipc_handle_bytes()
        base, handles, error = {}, {}, None
        for k in mesh.local:
            ptr, h = ctypes.c_ulonglong(0), (ctypes.c_ubyte * hb)()
            rc = lib.ring_ipc_alloc(mesh.devices[k].index, total, flag_bytes,
                                    ctypes.byref(ptr), h)
            if rc != 0:
                error = (f"process {mesh.process}: ring_ipc_alloc for shard "
                         f"{k} on {mesh.devices[k]} failed: CUDA error {rc} "
                         f"({_cuda_error(RING_SOURCE, rc)})")
                break
            base[k], handles[k] = ptr.value, bytes(h)
        every = {}
        for err, part in multihost.all_gather_object((error, handles)):
            error = error or err
            every.update(part)
        if error:
            raise RuntimeError(error)
        for k in mesh.local:
            for j in ((k - 1) % n, (k + 1) % n):
                if j in base:
                    continue
                ptr = ctypes.c_ulonglong(0)
                h = (ctypes.c_ubyte * hb).from_buffer_copy(every[j])
                rc = lib.ring_ipc_open(mesh.devices[k].index, h,
                                       ctypes.byref(ptr))
                if rc != 0:
                    error = (f"process {mesh.process}: mapping shard {j}'s "
                             f"ring state on {mesh.devices[k]} failed: CUDA "
                             f"error {rc} ({_cuda_error(RING_SOURCE, rc)})")
                    break
                base[j] = ptr.value
            if error:
                break
        error = _every_error(error)
        if error:
            raise RuntimeError(error)
        multihost.barrier()
        self.base, self.flag_bytes = base, flag_bytes

    def pointers(self, k: int):
        """(slots, counters) of shard ``k``: this process's or a mapped
        neighbour's."""
        return self.base[k] + self.flag_bytes, self.base[k]


#: ring state by (family, shard devices, sources a shard) for the redesign
#: and (family + "_v1", ...) for the first design; process-wide because the
#: counters must outlive every call of the ring (a fresh, zeroed buffer a
#: call could reuse memory a neighbour card still writes)
_ring_comms: dict = {}
#: rings no call may use again (a call failed part-way): a neighbour card's
#: launch of an earlier call may still write their slots and counters, so
#: they are never freed
_failed_rings: list = []
#: resident blocks an SM by (instance name, device)
_ring_blocks: dict = {}
#: `ring_card_plan`'s plans by (instance name, devices, targets, sources)
_ring_plans: dict = {}


def _ring_blocks_per_sm(lib, name, device) -> int:
    """Resident blocks an SM of instance ``name`` on ``device`` (its
    cooperative grid is this x the SM count, among the shards a launch
    serves); raises where the card cannot launch it cooperatively."""
    key = (name, device)
    if key not in _ring_blocks:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(lib, f"{name}_blocks_per_sm")(device.index,
                                                       ctypes.byref(out))
        if rc != 0 or out.value < 1:
            raise RuntimeError(f"{name} has no cooperative grid on {device}: "
                               f"CUDA error {rc} "
                               f"({_cuda_error(RING_SOURCE, rc)}), "
                               f"{out.value} blocks an SM")
        _ring_blocks[key] = out.value
    return _ring_blocks[key]


def _launch_groups(devices, first: int = 0):
    """(device, first shard, shard count) of each launch: one per run of
    consecutive shards on one device (one per card on a card mesh, one for
    every shard of a mesh on one card); ``devices`` are the shards from
    ``first`` on (a process's own, on a mesh that spans processes)."""
    groups = []
    for k, d in enumerate(devices, first):
        if groups and groups[-1][0] == d:
            groups[-1][2] += 1
        else:
            groups.append([d, k, 1])
    return [tuple(g) for g in groups]


def ring_card_plan(family, devices, n_trg, n_src, name=None, mesh=None):
    """`ring_plan` for a ring whose shard k lies on ``devices[k]``, with
    each card's SM count and the instance's resident blocks an SM as the
    cards report them; every launch of a ring takes the narrowest card's
    grid. ``name`` is the instance (default: the family's kernel). On a
    ``mesh`` that spans processes ``devices`` are this process's shards'
    and every process reports its launches' grids (a gather), so that
    every process gets the one plan. Plans are kept for the life of the
    process: a ring's shapes and cards are those of its run."""
    name = name or f"ring_{family}_f32"
    key = (name, tuple(devices) if mesh is None else mesh, n_trg, n_src)
    if key in _ring_plans:
        return _ring_plans[key]
    lib = _library(RING_SOURCE)
    grids = []
    for d, _, count in _launch_groups(devices):
        if d not in _sm_counts:
            _sm_counts[d] = torch.cuda.get_device_properties(
                d).multi_processor_count
        grids.append((_sm_counts[d], _ring_blocks_per_sm(lib, name, d),
                      count))
    n_shards = len(devices)
    if mesh is not None:
        from ..parallel import multihost

        grids = [g for part in multihost.all_gather_object(grids)
                 for g in part]
        n_shards = mesh.size
    sms, per_sm, count = min(grids, key=lambda g: g[0] * g[1] // g[2])
    plan = _ring_plans[key] = ring_plan(n_trg, n_src, n_shards, count,
                                        sms, per_sm, family)
    return plan


def _ring_launch(name, family, r_trg, src, payload, mesh=None):
    """Validate the per-shard lists, allocate the outputs, the partial sums
    and the ring state, and issue every launch of one ring call of instance
    ``name`` (all of them before anything that blocks); returns (per-shard
    outputs, launches). On a ``mesh`` that spans processes the lists hold
    this process's shards (``mesh.local``) and the ring state is an
    `_IpcRing`. A launch that fails raises in its own process at once; no
    call waits on the others to learn it (that would cost a host gather a
    call): their launches wait on the missing signals until the kernel's
    trap, and the step's once-a-step agreement or their next collective
    fails them."""
    n_loc = len(r_trg)
    n = n_loc if mesh is None else mesh.size
    first = 0 if mesh is None else mesh.local.start
    if (not 1 <= n <= _RING_MAX_SHARDS or len(src) != n_loc
            or len(payload) != n_loc
            or (mesh is not None and n_loc != len(mesh.local))):
        raise ValueError(f"a ring call takes 1..{_RING_MAX_SHARDS} shards and "
                         "one source block and payload per target block; got "
                         f"{n_loc}, {len(src)}, {len(payload)} of {n}")
    devices = [t.device for t in r_trg]
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"ring kernel shards must all lie on CUDA devices, "
                         f"got {devices}")
    cols = _FAMILIES[family][1]
    f32 = torch.float32
    trg = [_check_rows("r_trg", t, 3, f32, d) for t, d in zip(r_trg, devices)]
    srcs = [_check_rows("r_src", s, 3, f32, d) for s, d in zip(src, devices)]
    pays = [_check_rows("payload", p.reshape(p.shape[0], cols), cols, f32, d)
            for p, d in zip(payload, devices)]
    nt, ns = trg[0].shape[0], srcs[0].shape[0]
    if (any(t.shape[0] != nt for t in trg)
            or any(a.shape[0] != ns for a in srcs + pays)):
        raise ValueError("every shard needs the same target and source "
                         f"counts; got {[t.shape[0] for t in trg]} targets, "
                         f"{[a.shape[0] for a in srcs]} sources, "
                         f"{[a.shape[0] for a in pays]} payload rows")
    if nt == 0 or ns == 0:
        return [torch.zeros((nt, 3), dtype=f32, device=d)
                for d in devices], 0
    lib = _library(RING_SOURCE)
    v1 = name.endswith("_v1")
    plan = ring_card_plan(family, devices, nt, ns, name, mesh=mesh)
    out = [torch.empty((nt, 3), dtype=f32, device=d) for d in devices]
    part = out if v1 else [torch.empty(plan.scratch_shape, dtype=f32,
                                       device=d) for d in devices]
    slot_words = _RING_RECORD_WORDS[name] * (
        ns if v1 else plan.tiles * RING_TILE)
    key = (family + ("_v1" if v1 else ""),
           tuple(devices) if mesh is None else mesh, ns)
    comm = _ring_comms.get(key)
    if comm is None:
        comm = _ring_comms[key] = (
            _RingComm(devices, slot_words, plan.grid) if mesh is None
            else _IpcRing(lib, mesh, slot_words, plan.grid))
    elif comm.grid != plan.grid:
        raise RuntimeError(f"{name}: the ring on {devices} counts signals of "
                           f"{comm.grid} blocks a shard, the plan asks for "
                           f"{plan.grid}; a ring's grid never changes")
    ptrs = [0] * (7 * n)
    for i, k in enumerate(range(first, first + n_loc)):
        ptrs[7 * k:7 * k + 7] = (
            trg[i].data_ptr(), srcs[i].data_ptr(), pays[i].data_ptr(),
            out[i].data_ptr(), *comm.pointers(k), part[i].data_ptr())
    if mesh is not None:
        for j in {(first - 1) % n, (first + n_loc) % n} - set(mesh.local):
            ptrs[7 * j + 4:7 * j + 6] = comm.pointers(j)
    table = (ctypes.c_ulonglong * (7 * n))(*ptrs)
    comm.epoch += 1
    launch = getattr(lib, f"{name}_launch")
    groups = _launch_groups(devices, first)
    error = None
    for d, start, count in groups:
        with torch.cuda.device(d):
            stream = torch.cuda.current_stream(d).cuda_stream
            plan_args = () if v1 else (plan.r, plan.tiles, plan.chunk_tiles,
                                       plan.chunks, plan.target_blocks)
            rc = launch(table, n, nt, ns, start, count, plan.grid, comm.epoch,
                        *plan_args, stream)
        if rc != 0:
            error = (f"{name}_launch failed on {d}: CUDA error {rc} "
                     f"({_cuda_error(RING_SOURCE, rc)})")
            break
    if error:
        # the ring's counters no longer match its epoch, and the
        # launches already issued (other cards or processes) may still
        # write its buffers: keep them alive, and give the next call a
        # fresh ring
        _failed_rings.append(_ring_comms.pop(key))
        raise RuntimeError(error)
    return out, len(groups)


def _make_ring_wrapper(family: str, name: str):
    """(kernel wrapper, plain version) of one ring instance. Both take
    lists with one entry a shard: targets [nt, 3], sources [ns, 3] and
    payload [ns, 3] forces or [ns, 3, 3] / [ns, 9] stresslet components,
    shard k on its own device; both return the unscaled float32 sums [nt,
    3] a shard, each on its shard's device."""
    block_plain = {"stokeslet": stokeslet_f32_plain,
                   "stresslet": stresslet_f32_plain}[family]

    def plain(r_trg, src, payload, mesh=None):
        from ..parallel.ring import _ring_accumulate

        u0 = [torch.zeros((t.shape[0], 3), dtype=torch.float32,
                          device=t.device) for t in r_trg]
        return _ring_accumulate(
            lambda k, s, p: block_plain(s, r_trg[k], p),
            [t.device for t in r_trg], u0, list(src), list(payload),
            mesh=mesh)

    @_cost.seamed(family, _cost.ring_lists_work)
    def wrapper(r_trg, src, payload, mesh=None):
        if all(t.device.type == "cpu" for t in r_trg):
            return plain(r_trg, src, payload, mesh)
        out, launched = _ring_launch(name, family, r_trg, src, payload, mesh)
        wrapper.launches += launched
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = f"{name}_plain"
    wrapper.__doc__ = (f"The f32 {family} ring sum on its fused CUDA kernel "
                       f"(CPU tensors: `{name}_plain`); one launch a card. "
                       "On a ``mesh`` that spans processes the lists hold "
                       "this process's shards.")
    plain.__doc__ = (f"Plain f32 {family} ring sum: the ring accumulation "
                     "over the plain block (the version the kernel is held "
                     "against).")
    wrapper.launches = 0
    return wrapper, plain


ring_stokeslet_f32, ring_stokeslet_f32_plain = \
    _make_ring_wrapper("stokeslet", "ring_stokeslet_f32")  # E
ring_stresslet_f32, ring_stresslet_f32_plain = \
    _make_ring_wrapper("stresslet", "ring_stresslet_f32")  # F
#: E's and F's first design (one target a thread, 16-byte records),
#: kept as their yardstick: only the GPU tests and chip_smoke.py's ring
#: kernel phases call these
ring_stokeslet_f32_v1 = _make_ring_wrapper("stokeslet",
                                           "ring_stokeslet_f32_v1")[0]
ring_stresslet_f32_v1 = _make_ring_wrapper("stresslet",
                                           "ring_stresslet_f32_v1")[0]


def enable_ring_peer_access(devices) -> None:
    """Let every card of a ring reach its two neighbours' memory (their
    slots and counters); raises where a pair of neighbours cannot."""
    lib = _library(RING_SOURCE)
    n = len(devices)
    for k, d in enumerate(devices):
        for nb in {devices[(k + 1) % n], devices[(k - 1) % n]} - {d}:
            rc = lib.ring_enable_peer_access(d.index, nb.index)
            if rc == -1:
                raise RuntimeError(f"{d} cannot reach its ring neighbour {nb} "
                                   "(cudaDeviceCanAccessPeer is 0)")
            if rc != 0:
                raise RuntimeError(f"enabling peer access {d} -> {nb} failed: "
                                   f"CUDA error {rc} "
                                   f"({_cuda_error(RING_SOURCE, rc)})")


# ---------------------------------------------------------------- tree sums

#: targets an item of kernels G and H at most (``csrc/tree_sums.cu``'s
#: kItemTargets: 32 lanes, R = 2 targets a lane; checked when the library
#: loads), and of their first design (`tree_*_v1`, one target a lane)
TREE_ITEM_TARGETS = 64
TREE_V1_ITEM_TARGETS = 32
#: target lanes a warp of G / H at least (the source's kMinLanes): a warp
#: serves T target lanes x 32 / T source slices
TREE_MIN_LANES = 4
#: pairs of one chunk of the plain twin (its [pairs, 3] temporaries)
_TREE_PLAIN_BUDGET = 1 << 22


def tree_item_lanes(n):
    """The target lanes T a warp of kernel G / H gives an item of ``n``
    targets (int64 tensor): the smallest power of two, at least
    `TREE_MIN_LANES`, with 2 T >= n; the source's `item_lanes`."""
    lanes = torch.full_like(n, TREE_MIN_LANES)
    for _ in range(3):  # the source's loop: 4 -> 8 -> 16 -> 32
        lanes = torch.where((lanes < 32) & (2 * lanes < n), 2 * lanes, lanes)
    return lanes


def tree_item_slots(items, v1: bool = False):
    """Target slots an item's warps compute (the lane pairs of a source):
    2 T for the redesigned G / H, 32 for their first design."""
    if v1:
        return torch.full_like(items[:, 1], TREE_V1_ITEM_TARGETS)
    return 2 * tree_item_lanes(items[:, 1])


def tree_shared_bytes(family: str, prec: str) -> int:
    """Dynamic shared bytes of one block of kernel G / H (the card's
    build)."""
    return _library(TREE_SOURCE).tree_shared_bytes(_FAMILIES[family][1],
                                                   int(prec == "f64"))


def _tree_check(family, dtype, trg, src, pay, items, segs):
    """The validated, contiguous operands of one tree sum."""
    trg, src, pay = _operands(family, dtype, src, trg, pay)
    return (trg, src, pay,
            _check_rows("items", items, 4, torch.int64, trg.device),
            _check_rows("segments", segs, 2, torch.int64, trg.device))


def _tree_pair_terms(family, d, q):
    """The unscaled pair terms [n, 3] of displacements ``d`` [n, 3] and
    payload rows ``q`` [n, 3] / [n, 9] (the plain pair of
    `stokeslet_block` / `stresslet_block`, the -3 included)."""
    r2 = torch.sum(d * d, dim=-1)
    mask = r2 > 0.0
    rinv = torch.where(mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)
    if family == "stokeslet":
        df = torch.sum(d * q, dim=-1)
        return rinv[:, None] * q + (df * rinv ** 3)[:, None] * d
    dSd = torch.einsum("ni,nij,nj->n", d, q.reshape(-1, 3, 3), d)
    return (-3.0 * dSd * rinv ** 5)[:, None] * d


def _tree_plain_sum(terms, trg, src, pay, items, segs):
    """The plain twin's unscaled sum: every (target, source) pair of every
    item expanded, its terms ``terms(d, q)`` [pairs, 3] (`_tree_pair_terms`
    for G and H) added with `index_add_`, items in chunks of at most
    `_TREE_PLAIN_BUDGET` pairs."""
    dev = trg.device
    out = torch.zeros((trg.shape[0], 3), dtype=trg.dtype, device=dev)
    seg_len = segs[:, 1]
    cum = torch.cat([seg_len.new_zeros(1), torch.cumsum(seg_len, 0)])
    item_pairs = items[:, 1] * (cum[items[:, 2] + items[:, 3]]
                                - cum[items[:, 2]])
    bounds, acc = [0], 0
    for i, n in enumerate(item_pairs.tolist()):
        if acc and acc + n > _TREE_PLAIN_BUDGET:
            bounds.append(i)
            acc = 0
        acc += n
    bounds.append(len(item_pairs))

    def ranges(first, count):
        """Concatenated aranges [first_k, first_k + count_k)."""
        rep = torch.repeat_interleave(torch.arange(len(count), device=dev),
                                      count)
        local = torch.arange(rep.shape[0], device=dev) - (
            torch.cumsum(count, 0) - count)[rep]
        return rep, first[rep] + local

    for i0, i1 in zip(bounds[:-1], bounds[1:]):
        it = items[i0:i1]
        seg_item, seg_id = ranges(it[:, 2], it[:, 3])
        ent_seg, ent_src = ranges(segs[seg_id, 0], segs[seg_id, 1])
        ent_item = seg_item[ent_seg]
        pair_ent, pair_t = ranges(it[ent_item, 0], it[ent_item, 1])
        q = pay[ent_src[pair_ent]]
        d = trg[pair_t] - src[ent_src[pair_ent]]
        out.index_add_(0, pair_t, terms(d, q))
    return out


def _tree_launch(name, family, prec, trg, src, pay, items, segs, scale):
    """Validate, allocate the output and launch ``name`` (``tree_{family}
    _{prec}`` or its ``_v1``), kernel G (``family`` "stokeslet") or H
    ("stresslet"). Returns (output, launched); raises if the launch was
    refused."""
    trg, src, pay, items, segs = _tree_check(family, _DTYPES[prec], trg, src,
                                             pay, items, segs)
    device = trg.device
    out = torch.empty((trg.shape[0], 3), dtype=trg.dtype, device=device)
    if items.shape[0] == 0:
        return out, False
    lib = _library(TREE_SOURCE)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            trg.data_ptr(), src.data_ptr(), pay.data_ptr(), items.data_ptr(),
            segs.data_ptr(), out.data_ptr(), items.shape[0], scale, stream)
    _raise_on(TREE_SOURCE, name, rc)
    return out, True


def _tree_wrapper(family: str, prec: str, v1: bool = False):
    """(kernel wrapper, plain twin) of kernel G (Stokeslet) or H
    (stresslet) in one precision, or (``v1``) of their first design. Both
    take the leaf-sorted targets [n_trg, 3], the source array [n_src, 3]
    and its payload [n_src, 3] / [n_src, 9] (bucketed sources, then
    proxies), and `ops.treecode._segment_lists`' items [n_items, 4] (at
    most `TREE_ITEM_TARGETS` targets an item; `TREE_V1_ITEM_TARGETS` for
    ``v1``) and segments [n_seg, 2] (int64); both return the sum at
    viscosity ``eta`` [n_trg, 3] in ``prec``, in the targets' order."""
    name = f"tree_{family}_{prec}" + ("_v1" if v1 else "")
    terms = functools.partial(_tree_pair_terms, family)

    def plain(r_trg, src, payload, items, segs, eta):
        trg, src, pay, items, segs = _tree_check(
            family, _DTYPES[prec], r_trg, src, payload, items, segs)
        return _tree_plain_sum(terms, trg, src, pay, items, segs) \
            * (_FACTOR / eta)

    @_cost.seamed(family, _cost.tree_work)
    def wrapper(r_trg, src, payload, items, segs, eta):
        if r_trg.device.type == "cpu":
            return plain(r_trg, src, payload, items, segs, eta)
        out, launched = _tree_launch(name, family, prec, r_trg, src, payload,
                                     items, segs, _scale(eta))
        wrapper.launches += int(launched)
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    plain.__name__ = plain.__qualname__ = f"tree_{family}_{prec}_plain"
    wrapper.__doc__ = (f"The {prec} treecode {family} sum over segment lists "
                       f"on its CUDA kernel (CPU tensors: `{plain.__name__}`"
                       ").")
    plain.__doc__ = (f"Plain {prec} treecode {family} sum over segment lists "
                     f"(the version `{name}` is held against).")
    wrapper.launches = 0
    return wrapper, plain


tree_stokeslet_f32, tree_stokeslet_f32_plain = _tree_wrapper("stokeslet",
                                                             "f32")  # G
tree_stokeslet_f64, tree_stokeslet_f64_plain = _tree_wrapper("stokeslet",
                                                             "f64")  # G
tree_stresslet_f32, tree_stresslet_f32_plain = _tree_wrapper("stresslet",
                                                             "f32")  # H
tree_stresslet_f64, tree_stresslet_f64_plain = _tree_wrapper("stresslet",
                                                             "f64")  # H
#: G's and H's first design, their yardstick (over items of at most
#: TREE_V1_ITEM_TARGETS targets); the plain twin is the same sum
tree_stokeslet_f32_v1 = _tree_wrapper("stokeslet", "f32", v1=True)[0]
tree_stokeslet_f64_v1 = _tree_wrapper("stokeslet", "f64", v1=True)[0]
tree_stresslet_f32_v1 = _tree_wrapper("stresslet", "f32", v1=True)[0]
tree_stresslet_f64_v1 = _tree_wrapper("stresslet", "f64", v1=True)[0]


#: every kernel wrapper of the port's paths (chip_smoke resets and reads
#: these)
KERNEL_WRAPPERS = (stokeslet_f32, stokeslet_f64, stresslet_f32, stresslet_f64,
                   ring_stokeslet_f32, ring_stresslet_f32, tree_stokeslet_f32,
                   tree_stokeslet_f64, tree_stresslet_f32, tree_stresslet_f64)
#: A-D over the member axis: the same launchers as their lone wrappers,
#: counted apart (chip_smoke resets and reads these too)
MEMBER_WRAPPERS = (stokeslet_f32_batched, stokeslet_f64_batched,
                   stresslet_f32_batched, stresslet_f64_batched)
#: the yardstick wrappers, which no path may launch
YARDSTICK_WRAPPERS = (stokeslet_f32_tiled, stokeslet_f64_tiled,
                      stresslet_f32_tiled, stresslet_f64_tiled,
                      ring_stokeslet_f32_v1, ring_stresslet_f32_v1,
                      tree_stokeslet_f32_v1, tree_stokeslet_f64_v1,
                      tree_stresslet_f32_v1, tree_stresslet_f64_v1)


# ---------------------------------------------------------------- the registry

def _ragged_cloud(seed, n, cols=3, dtype=torch.float64, device=None):
    import numpy as np

    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, cols)), dtype=dtype, device=device)


def auditable_kernels():
    """This module's entries in the kernel registry (`audit.kernels`): A /
    B under the JAX package's ``stokeslet_pallas_tiles`` and C / D under
    its ``stresslet_pallas_tiles``, each at a ragged shape (1,237 targets,
    2,011 sources: no multiple of a tile, a chunk or a warp)."""
    from ..audit.registry import AuditKernel, BuiltKernel, KernelCase

    def build(family, letters):
        def _build(device=None):
            from ..device import resolve_device

            dev = resolve_device(device)
            cols = _FAMILIES[family][1]
            cases = []
            for letter, prec, rtol in zip(letters, ("f32", "f64"),
                                          (1e-4, 1e-12)):
                dtype = _DTYPES[prec]
                mangled = "f" if prec == "f32" else "d"   # float / double
                args = (_ragged_cloud(1, 2011, dtype=dtype, device=dev),
                        _ragged_cloud(2, 1237, dtype=dtype, device=dev),
                        _ragged_cloud(3, 2011, cols, dtype, dev), 1.0)
                cases.append(KernelCase(
                    label=f"{letter} {family}_{prec}",
                    wrapper=globals()[f"{family}_{prec}"],
                    plain=globals()[f"{family}_{prec}_plain"], args=args,
                    rtol=rtol,
                    entries=(rf"{family}_chunk_kernelI{mangled}",
                             rf"{family}_reduce_kernelI{mangled}")))
            return BuiltKernel(source=f"{family}_sums", cases=cases,
                               device=dev)
        return _build

    return [
        AuditKernel(name="stokeslet_pallas_tiles", layer="ops",
                    summary="Stokeslet pair sums A (f32) / B (f64), "
                            "csrc/stokeslet_sums.cu",
                    kernels="A / B", build=build("stokeslet", "AB")),
        AuditKernel(name="stresslet_pallas_tiles", layer="ops",
                    summary="stresslet pair sums C (f32) / D (f64), "
                            "csrc/stresslet_sums.cu",
                    kernels="C / D", build=build("stresslet", "CD")),
    ]
