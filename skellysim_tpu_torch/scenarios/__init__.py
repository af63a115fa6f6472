"""Device-side dynamic instability and the scenario sweep front-end
(counterpart of `skellysim_tpu.scenarios`): `di_device`, the nucleation /
catastrophe update as mask flips over a member's fixed fiber capacity, and
`sweep`, which drains DI members through one ensemble scheduler a capacity
rung and reseats a member whose rung fills."""

from .di_device import DIDraws, DIInfo, di_update, sample_draws  # noqa: F401
from .sweep import ScenarioEnsemble, ensure_di_capacity  # noqa: F401
