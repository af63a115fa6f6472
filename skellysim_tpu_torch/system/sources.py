"""Point force/torque sources and background flow.

Counterpart of `skellysim_tpu.system.sources` (the reference's
`PointSourceContainer` and `BackgroundSource`), as NamedTuples of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernels


class PointSources(NamedTuple):
    """Batched point sources; time_to_live == 0 means always alive."""

    position: torch.Tensor      # [np, 3]
    force: torch.Tensor         # [np, 3]
    torque: torch.Tensor        # [np, 3]
    time_to_live: torch.Tensor  # [np]

    @staticmethod
    def make(position, force=None, torque=None, time_to_live=0.0,
             dtype=torch.float64, device="cpu"):
        position = torch.as_tensor(position, dtype=dtype,
                                   device=device).reshape(-1, 3)
        n = position.shape[0]
        z = torch.zeros((n, 3), dtype=dtype, device=device)

        def vec3(v):
            return z if v is None else torch.as_tensor(
                v, dtype=dtype, device=device).reshape(-1, 3)

        return PointSources(
            position=position, force=vec3(force), torque=vec3(torque),
            time_to_live=torch.as_tensor(time_to_live, dtype=dtype,
                                         device=device).broadcast_to(
                                             (n,)).clone())

    def flow(self, r_trg, eta, time):
        """Oseen + rotlet flow at targets; expired sources are masked out."""
        alive = (self.time_to_live == 0.0) | (time < self.time_to_live)
        f = torch.where(alive[:, None], self.force, 0.0)
        t = torch.where(alive[:, None], self.torque, 0.0)
        u = kernels.oseen_contract(self.position, r_trg, f, eta)
        return u + kernels.rotlet(self.position, r_trg, t, eta)


class BackgroundFlow(NamedTuple):
    """v_j = uniform_j + r[components_j] * scale_j."""

    uniform: torch.Tensor     # [3]
    components: torch.Tensor  # [3] int
    scale: torch.Tensor       # [3]

    @staticmethod
    def make(uniform=(0.0, 0.0, 0.0), components=(0, 1, 2),
             scale=(0.0, 0.0, 0.0), dtype=torch.float64, device="cpu"):
        return BackgroundFlow(
            uniform=torch.as_tensor(uniform, dtype=dtype, device=device),
            components=torch.as_tensor(components, dtype=torch.int64,
                                       device=device),
            scale=torch.as_tensor(scale, dtype=dtype, device=device))

    def flow(self, r_trg, eta):
        return self.uniform[None, :] + r_trg[:, self.components] * self.scale[None, :]

    def is_active(self):
        return bool(torch.any(self.uniform != 0.0) | torch.any(self.scale != 0.0))
