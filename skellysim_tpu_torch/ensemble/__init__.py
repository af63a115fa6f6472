"""Batched execution of independent simulations (counterpart of
`skellysim_tpu.ensemble`): B members of one bucket step as one batched
round (`runner`: the ``"vmap"`` plan of `batched.BatchedTrial`, or the
bit-reproducible ``"unroll"`` plan), a continuous-batching `scheduler`
keeps the lanes full from a queue, and `cli` (`python -m
skellysim_tpu_torch.ensemble --sweep-file=...`) turns a sweep spec into
per-member trajectories and one metrics JSONL."""

from .runner import (EnsembleRunner, EnsembleState,  # noqa: F401
                     EnsembleStepInfo, lane_state, rng_carry, set_lane,
                     stack_states)
from .scheduler import (EnsembleScheduler, MemberSpec,  # noqa: F401
                        run_ensemble)
