"""Config -> runnable simulation.

Counterpart of `skellysim_tpu.builder` for free-space fiber configs: reads
the TOML config and assembles `System`, the initial `SimState` and the
`SimRNG` on the requested device (the card unless ``device="cpu"``).
Periphery and body tables raise `NotImplementedError` (ROADMAP.md §1 items
5 and 6).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .config import schema
from .device import resolve_device
from .fibers import container as fc
from .system import BackgroundFlow, PointSources, System
from .utils.rng import SimRNG


def build_fibers(cfg_fibers: list, dtype, device):
    """FiberGroup (one resolution) or tuple of per-resolution buckets in
    first-appearance order; each fiber's config position is its
    `config_rank` (trajectory wire order)."""
    if not cfg_fibers:
        return None
    by_n: dict = {}
    for rank, f in enumerate(cfg_fibers):
        by_n.setdefault(int(f.n_nodes), []).append((rank, f))

    def one_bucket(items):
        ranks = [r for r, _ in items]
        fibs = [f for _, f in items]
        n = fibs[0].n_nodes
        x = np.stack([np.asarray(f.x, dtype=float).reshape(n, 3) for f in fibs])
        return fc.make_group(
            x,
            lengths=np.array([f.length for f in fibs]),
            bending_rigidity=np.array([f.bending_rigidity for f in fibs]),
            radius=np.array([f.radius for f in fibs]),
            force_scale=np.array([f.force_scale for f in fibs]),
            minus_clamped=np.array([f.minus_clamped or f.parent_body >= 0
                                    for f in fibs]),
            binding_body=np.array([f.parent_body for f in fibs], dtype=np.int32),
            binding_site=np.array([f.parent_site for f in fibs], dtype=np.int32),
            config_rank=np.array(ranks, dtype=np.int32),
            dtype=dtype, device=device)

    groups = [one_bucket(items) for items in by_n.values()]
    return groups[0] if len(groups) == 1 else tuple(groups)


def build_point_sources(cfg_points: list, dtype, device):
    if not cfg_points:
        return None
    return PointSources.make(
        position=np.stack([p.position for p in cfg_points]),
        force=np.stack([p.force for p in cfg_points]),
        torque=np.stack([p.torque for p in cfg_points]),
        time_to_live=np.array([p.time_to_live for p in cfg_points]),
        dtype=dtype, device=device)


def build_background(cfg_bg, dtype, device):
    if cfg_bg is None:
        return None
    if not any(cfg_bg.uniform) and not any(cfg_bg.scale_factor):
        return None
    return BackgroundFlow.make(uniform=cfg_bg.uniform,
                               components=cfg_bg.components,
                               scale=cfg_bg.scale_factor, dtype=dtype,
                               device=device)


def build_simulation(config, dtype=torch.float64, device=None):
    """Config (object or TOML path) -> (System, SimState, SimRNG)."""
    if isinstance(config, (str, os.PathLike)):
        config = schema.load_config(str(config))
    if config.periphery is not None:
        raise NotImplementedError(
            "configs with a periphery are not ported to skellysim_tpu_torch "
            "yet (ROADMAP.md §1 item 5)")
    if config.bodies:
        raise NotImplementedError(
            "configs with bodies are not ported to skellysim_tpu_torch yet "
            "(ROADMAP.md §1 item 6)")
    device = resolve_device(device)
    params = schema.to_runtime_params(config.params)
    if params.pair_evaluator == "ring":
        warnings.warn("config selects pair_evaluator='ring' but a one-card "
                      "run has no mesh; using the direct evaluator")
    system = System(params, device=device)
    state = system.make_state(
        fibers=build_fibers(config.fibers, dtype, device),
        points=build_point_sources(config.point_sources, dtype, device),
        background=build_background(config.background, dtype, device))
    return system, state, SimRNG(seed=config.params.seed)
