"""Quaternion helpers, (w, x, y, z) convention, on [..., 4] tensors.

Counterpart of `skellysim_tpu.utils.quaternion` (body orientation and
stepping).
"""

from __future__ import annotations

import numpy as np
import torch

#: host-side constant; callers make a tensor of their own dtype and device
IDENTITY = np.asarray([1.0, 0.0, 0.0, 0.0])


def multiply(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def rotation_matrix(q):
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x**2 + y**2)], dim=-1),
    ], dim=-2)


def from_rotation_vector(phi):
    """Rotation vector [..., 3] -> quaternion; safe at |phi| = 0."""
    norm = torch.linalg.vector_norm(phi, dim=-1, keepdim=True)
    safe = torch.where(norm > 0, norm, 1.0)
    half = 0.5 * norm
    xyz = torch.where(norm > 0, torch.sin(half) * phi / safe, 0.0)
    return torch.cat([torch.cos(half), xyz], dim=-1)


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
