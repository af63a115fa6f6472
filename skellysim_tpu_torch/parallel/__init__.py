"""The device mesh, the ring pair evaluator and the sharded step
(`skellysim_tpu.parallel`)."""

from .mesh import (FIBER_AXIS, SHELL_ROW_SHARDED_FIELDS,  # noqa: F401
                   Mesh, ShardedState, gather_state, make_mesh, shard_state)
from .ring import (ring_oseen_contract, ring_stokeslet,  # noqa: F401
                   ring_stokeslet_df, ring_stresslet, ring_stresslet_df)
from .spmd import (Collectives, ShardVec, SpmdSolution,  # noqa: F401
                   build_spmd_step, spmd_shell_mode, spmd_step)
