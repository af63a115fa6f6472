"""Deterministic fixture scenes for the auditable-program registry.

Counterpart of `skellysim_tpu.audit.fixtures`, built with the port's own
builders: the same scenes (16 fibers x 16 nodes from seed 5; the coupled
scene's 56-node shell, node-aligned on the 2 / 4 / 8 meshes, with one
forced 50-node body) on the same `BASE_PARAMS`, on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

#: parameters shared by every registered entry point (adaptive gate off:
#: the registered program is the pure trial step). ``solver_precision`` is
#: pinned to what "auto" is on the CPU, where the JAX package's baselines
#: are compiled: on the card "auto" would take "mixed", another program
#: than the one the baselines describe.
BASE_PARAMS = dict(eta=1.0, dt_initial=1e-3, t_final=1e-2, gmres_tol=1e-10,
                   adaptive_timestep_flag=False, solver_precision="full")

#: shell node count for the coupled scene — divides 2/4/8 node-aligned
SHELL_NODES = 56
BODY_NODES = 50


def make_fibers(n_fibers=16, n_nodes=16, seed=5, box=4.0,
                dtype=torch.float64, device="cpu"):
    from ..fibers import container as fc

    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n_nodes)
    origins = rng.uniform(-box, box, size=(n_fibers, 3))
    dirs = rng.normal(size=(n_fibers, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = origins[:, None, :] + t[None, :, None] * dirs[:, None, :]
    return fc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                         radius=0.0125, dtype=dtype, device=device)


def make_system(shell: bool = False, device=None, **param_overrides):
    """A `System` on ``device`` (None: the card), optionally with the
    spherical periphery, on the baseline parameters."""
    from ..params import Params
    from ..periphery.periphery import PeripheryShape
    from ..system import System

    shape = PeripheryShape(kind="sphere", radius=6.0) if shell else None
    return System(Params(**dict(BASE_PARAMS, **param_overrides)),
                  shell_shape=shape, device=device)


def free_state(system, seed=5):
    """16 free fibers in a uniform background flow (divides the 2/4/8
    meshes) on the system's device."""
    from ..system import BackgroundFlow

    dev = system.device
    return system.make_state(
        fibers=make_fibers(seed=seed, device=dev),
        background=BackgroundFlow.make(uniform=(1.0, 0.0, 0.0),
                                       dtype=torch.float64, device=dev))


def coupled_state(system, seed=7):
    """16 fibers + the 56-node shell + one externally forced body on the
    system's device."""
    from ..testing import make_coupled_parts

    dev = system.device
    shell, _, bodies = make_coupled_parts(SHELL_NODES, BODY_NODES,
                                          torch.float64, device=dev)
    return system.make_state(fibers=make_fibers(seed=seed, box=2.0,
                                                device=dev),
                             shell=shell, bodies=bodies)
