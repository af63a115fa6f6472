"""skellysim_tpu_torch: the PyTorch/CUDA port of skellysim_tpu.

The JAX package (`skellysim_tpu`) is the reference; this package mirrors its
module layout and names so each counterpart is found at the same path. It
imports torch, numpy and scipy only — never jax, never `skellysim_tpu` —
and keeps its own copies of the small host-side modules it needs.

Slices covered so far: the single-card implicit timestep of fibers, a
confining periphery and rigid bodies with attached fibers, with point and
background sources, and its precompute, with the direct pair evaluator or
the ring evaluator over a device mesh (`parallel`); the pairwise Stokeslet
and stresslet sums run on hand-written Hopper kernels (`ops.cuda_kernels`).
Entry points run on the CUDA card unless the caller asks for the CPU
(`--device=cpu`, ``device="cpu"``); a missing card raises.
"""

import torch as _torch

__version__ = "0.1.0"

TRAJECTORY_VERSION = 1

# TF32 off, stated explicitly rather than left to the library defaults: the
# fiber block matvecs and LU factors carry rows up to ~1e7 (the stiff
# fourth-derivative blocks) and the GMRES Gram products are accuracy-gated to
# gmres_tol; TF32 keeps ~3 decimal digits, which would put the f32 Krylov
# interior's noise floor far above what the f64 refinement can contract.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
