"""The ring pair evaluator over a device mesh (`skellysim_tpu.parallel`)."""

from .mesh import FIBER_AXIS, Mesh, make_mesh  # noqa: F401
from .ring import (ring_stokeslet, ring_stokeslet_df,  # noqa: F401
                   ring_stresslet, ring_stresslet_df)
