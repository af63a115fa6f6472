"""Shared small coupled scenes for the tests and `chip_smoke.py`.

Counterpart of `skellysim_tpu.testing.make_coupled_parts` (a spherical
periphery with uniform quadrature weights plus one externally forced sphere
body; the same arrays as the JAX package's for the same arguments), and
`make_coupled_scene`, which adds fibers bound to the body's nucleation
sites and a few free fibers: every coupling of the confined, body-carrying
step (shell flow, body flow, link conditions, repinning) in a scene small
enough for the CPU. `free_port` and `run_all` start and watch the
processes of a run that spans processes (the multi-process tests and
`chip_smoke.py`).
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from .bodies import bodies as bd
from .fibers import container as fc
from .periphery import periphery as peri
from .periphery.precompute import precompute_body
from .periphery.shapes import sphere_shape


def make_coupled_parts(shell_n: int, body_n: int, dtype=torch.float64, *,
                       device="cpu", radius: float = 6.0,
                       body_position=(0.0, 0.0, -2.0),
                       body_force=(0.0, 0.0, 0.5), nucleation_sites=None,
                       precond_dtype=None):
    """(shell_state, shell_shape, body_group): a sphere shell of ``shell_n``
    nodes (host float64 operator and inverse) and one sphere body of radius
    0.5 with ``body_n`` nodes; ``nucleation_sites`` ([ns, 3], body frame)
    are optional attachment sites."""
    spec = sphere_shape(shell_n, radius=radius * 1.04)
    normals = -spec.node_normals  # periphery normals point inward
    weights = np.full(shell_n, 4 * np.pi * (radius * 1.04) ** 2 / shell_n)
    op, M_inv = peri.build_shell_operator(spec.nodes, normals, weights)
    shell = peri.make_state(spec.nodes, normals, weights, op, M_inv,
                            dtype=dtype, precond_dtype=precond_dtype,
                            device=device)
    shape = peri.PeripheryShape(kind="sphere", radius=radius)
    pre = precompute_body("sphere", body_n, radius=0.5)
    bodies = bd.make_group(
        pre["node_positions_ref"], pre["node_normals_ref"],
        pre["node_weights"], position=np.asarray([body_position], dtype=float),
        external_force=np.asarray([body_force], dtype=float),
        nucleation_sites_ref=nucleation_sites, radius=np.array([0.5]),
        kind="sphere", dtype=dtype, device=device)
    return shell, shape, bodies


def make_coupled_scene(shell_n: int = 200, body_n: int = 100,
                       n_bound: int = 8, n_free: int = 4, device="cpu",
                       precond_dtype=None):
    """(shell, shape, bodies, fibers): `make_coupled_parts` with a shell of
    radius 3 around a body at (0, 0, -1) carrying ``n_bound`` nucleation
    sites, one clamped 16-node fiber of length 0.6 bound to each and
    pointing outward, plus ``n_free`` free 16-node fibers of length 0.8
    inside the shell. Sites and free fibers are drawn from
    ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((n_bound, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sites = 0.5 * u
    body_pos = np.array([0.0, 0.0, -1.0])
    shell, shape, bodies = make_coupled_parts(
        shell_n, body_n, device=device, radius=3.0,
        body_position=body_pos, nucleation_sites=sites,
        precond_dtype=precond_dtype)
    t = np.linspace(0.0, 1.0, 16)
    bound = (body_pos + sites)[:, None, :] + 0.6 * t[None, :, None] * u[:, None]
    d = rng.standard_normal((n_free, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    free = (rng.uniform(-0.6, 0.6, (n_free, 3))[:, None, :] + [0.0, 0.0, 0.8]
            + 0.8 * t[None, :, None] * d[:, None])
    nf = n_bound + n_free
    fibers = fc.make_group(
        np.concatenate([bound, free]),
        lengths=np.r_[np.full(n_bound, 0.6), np.full(n_free, 0.8)],
        bending_rigidity=0.01, radius=0.0125, force_scale=-0.05,
        minus_clamped=np.arange(nf) < n_bound,
        binding_body=np.where(np.arange(nf) < n_bound, 0, -1),
        binding_site=np.where(np.arange(nf) < n_bound, np.arange(nf), -1),
        device=device)
    return shell, shape, bodies, fibers


def free_port() -> int:
    """A TCP port of localhost that is free now (bound to 0)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_all(cmds, log_dir, tag, deadline_s):
    """Start every (argv, env, cwd) of ``cmds`` at once, each writing its
    output to ``log_dir/<tag>_<i>.log``, and wait until all exit 0; a
    process that fails, or the deadline, kills the others at once and
    raises RuntimeError with every output's tail. Returns the outputs."""
    logs = [os.path.join(str(log_dir), f"{tag}_{i}.log")
            for i in range(len(cmds))]
    procs = []
    try:
        for (argv, env, cwd), log in zip(cmds, logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    argv, stdout=fh, stderr=subprocess.STDOUT, env=env,
                    cwd=cwd))
        end = time.monotonic() + deadline_s
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs)
                           if p.returncode not in (None, 0)), None)
            if time.monotonic() > end:
                failed = "deadline"
            time.sleep(0.05)
        if failed is None:
            failed = next((i for i, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        with open(log) as fh:
            outs.append(fh.read())
    if failed is not None:
        raise RuntimeError(f"{tag}: process {failed} failed (of {len(procs)}, "
                           f"exit codes {[p.returncode for p in procs]}; "
                           f"deadline {deadline_s} s):\n"
                           + "\n---\n".join(o[-3000:] for o in outs))
    return outs
