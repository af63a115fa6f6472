"""Post-processing: streamlines and vortex lines of a velocity field.

Counterpart of `skellysim_tpu.postprocess` (the reference's listener-mode
analysis, `src/core/streamline.cpp`): every line seed
advances together, each integrator stage one batched velocity evaluation
over the seeds.
"""

from .streamline import make_vorticity_fn, streamlines, vortex_lines

__all__ = ["streamlines", "vortex_lines", "make_vorticity_fn"]
