"""The device mesh, the ring pair evaluator, the sharded step and several
processes under one mesh (`skellysim_tpu.parallel`)."""

from .mesh import (FIBER_AXIS, MEMBER_AXIS,  # noqa: F401
                   SHELL_ROW_SHARDED_FIELDS, Mesh, ShardedEnsemble,
                   ShardedState, gather_ensemble, gather_state, make_2d_mesh,
                   make_member_mesh, make_mesh, shard_ensemble, shard_state)
from .multihost import initialize as initialize_multihost  # noqa: F401
from .multihost import process_info  # noqa: F401
from .ring import (ring_oseen_contract, ring_stokeslet,  # noqa: F401
                   ring_stokeslet_df, ring_stresslet, ring_stresslet_df)
from .spmd import (Collectives, ShardVec, SpmdSolution,  # noqa: F401
                   build_spmd_step, spmd_shell_mode, spmd_step)
