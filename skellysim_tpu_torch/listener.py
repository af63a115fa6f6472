"""Listener mode: the post-processing server over stdin / stdout.

Counterpart of `skellysim_tpu.listener` and of the reference's
`listener::run` (`src/core/listener.cpp:86-136`): framed
msgpack requests {frame_no, evaluator, streamlines, vortexlines,
velocity_field} arrive on stdin (`serve.protocol`); the trajectory frame
is loaded and re-landed on the config's ``[runtime]`` bucket, and the
answer {time, i_frame, n_frames, streamlines, vortexlines, velocity_field}
goes to stdout. A zero-length request ends the server; an invalid frame
number, or an evaluator name it does not know, is answered with a
zero-length frame, and the server goes on.

``evaluator`` switches the pair evaluator for the whole request (the
reference's `System::set_evaluator`, `system.cpp:389-393`), through the
alias table of `ops.evaluator` (case-insensitive): "CPU" / "GPU" ->
"direct" (the dense kernels, on the card the process runs on), "FMM" ->
"ewald", "PVFMM" -> "spectral", and the native names. A fast evaluator
plans once a request over the frame's nodes, the seeds and an EXTENDED box
(the bounding box grown by half its diagonal a side), so that the lines can
roam before they leave the planned region.

A request's work on the card: the frame's sources once
(`System.velocity_field`), then each integrator stage one batched
velocity evaluation over the request's line seeds (`postprocess`), and the
velocity slice one evaluation over its points. Each request logs one INFO
line to stderr, ``listener request {...}``, with its wall seconds,
integrator steps, velocity evaluations and points, and the kernel launches
it made.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time

import numpy as np
import torch

from .builder import build_simulation
from .io import eigen
from .io.trajectory import TrajectoryReader, frame_to_state
from .ops.evaluator import EVALUATOR_ALIASES
from .postprocess import streamlines as compute_streamlines
from .postprocess import vortex_lines as compute_vortex_lines
from .serve import protocol
from .system.system import solution_from_state

logger = logging.getLogger("skellysim_tpu_torch")

_LINE_DEFAULTS = dict(dt_init=0.1, t_final=1.0, abs_err=1e-10, rel_err=1e-6,
                      back_integrate=True)

#: reference evaluator names -> runtime pair evaluators (the alias table
#: the config schema reads too)
EVALUATOR_MAP = EVALUATOR_ALIASES


def switch_evaluator(system, evaluator: str | None):
    """(system, switched) for a request's evaluator name: an absent name
    keeps the system; an unknown one raises ValueError (the request is
    refused, as a typo in a config is); another known one builds a System
    with it. Switching to "ring" makes a mesh over the system's card when
    the system has none (without one the ring would run direct)."""
    if not evaluator:
        return system, False
    ev = EVALUATOR_MAP.get(str(evaluator).lower())
    if ev is None:
        raise ValueError(
            f"unknown evaluator {evaluator!r} in listener request; valid "
            "names: " + ", ".join(sorted(EVALUATOR_MAP)))
    if ev == system.params.pair_evaluator:
        return system, False
    from .system import System

    mesh = system.mesh
    if ev == "ring" and mesh is None:
        from .parallel import make_mesh

        mesh = make_mesh(1, device=system.device)
    # a periodic config serves only "spectral" and the reverse: System
    # raises on a mismatched switch, and that one request is refused
    new = System(dataclasses.replace(system.params, pair_evaluator=ev),
                 shell_shape=system.shell_shape, device=system.device,
                 mesh=mesh)
    new.grid_ladder = system.grid_ladder
    return new, True


def _line_kwargs(req: dict) -> dict:
    kw = dict(_LINE_DEFAULTS)
    for k in kw:
        if req and k in req:
            kw[k] = req[k]
    return kw


def _seeds(req: dict) -> np.ndarray:
    x0 = req.get("x0") if req else None
    if x0 is None:
        return np.zeros((0, 3))
    return np.atleast_2d(np.asarray(x0, dtype=np.float64)).reshape(-1, 3)


def _pack_lines(lines: list) -> list:
    return [{"x": eigen.pack_matrix(ln["x"]),
             "val": eigen.pack_matrix(ln["val"]),
             "time": eigen.pack_matrix(ln["time"])} for ln in lines]


def _extended_corners(state, system, seeds: np.ndarray) -> np.ndarray:
    """The 8 corners of the node and seed bounding box grown by half its
    diagonal (at least 0.5) a side: extra plan targets that keep the lines
    inside the planned region."""
    pts = [system._node_positions(state).cpu().numpy()]
    if seeds.size:
        pts.append(seeds)
    pts = np.vstack(pts)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    margin = 0.5 * max(float(np.linalg.norm(hi - lo)), 1.0)
    lo, hi = lo - margin, hi + margin
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


def _launches() -> dict:
    """The kernel wrappers' launch counts (`ops.cuda_kernels`)."""
    from .ops import cuda_kernels as ck

    return {w.__name__: w.launches
            for w in ck.KERNEL_WRAPPERS + ck.MEMBER_WRAPPERS}


def process_request(system, template_state, reader: TrajectoryReader,
                    cmd: dict, policy=None, stats: dict | None = None
                    ) -> dict | None:
    """One request -> its answer, or None for an invalid frame number.
    ``policy`` (a `system.buckets.BucketPolicy`) re-lands the decoded frame
    on the server's capacity bucket. ``stats`` (a dict) gains the request's
    integrator steps (``"steps"``) and velocity evaluations (``"calls"``,
    ``"points"``)."""
    frame_no = int(cmd.get("frame_no", 0))
    if frame_no < 0 or frame_no >= len(reader):
        return None
    frame = reader.load_frame(frame_no)
    state = frame_to_state(frame, template_state)
    if policy is not None:
        from .system import buckets as bucket_mod

        state, _ = bucket_mod.bucketize(
            state, policy, pair_evaluator=system.params.pair_evaluator)
    solution = solution_from_state(state)
    stats = {} if stats is None else stats

    sl_req = cmd.get("streamlines") or {}
    vl_req = cmd.get("vortexlines") or {}
    vf_req = cmd.get("velocity_field") or {}
    seeds_sl = _seeds(sl_req)
    seeds_vl = _seeds(vl_req)
    fast = system.params.pair_evaluator in ("ewald", "tree", "spectral")

    fields = []
    field = None
    if seeds_sl.size or seeds_vl.size:
        pair = None
        if fast:
            # one plan for the request's lines, over the extended box
            corners = _extended_corners(state, system,
                                        np.vstack([seeds_sl, seeds_vl]))
            pair = system._pair_args(state, extra_targets=corners)
        field = system.velocity_field(state, solution, pair)
        fields.append(field)
    sl = compute_streamlines(field, seeds_sl, **_line_kwargs(sl_req),
                             device=system.device, stats=stats)
    vl = compute_vortex_lines(field, seeds_vl, **_line_kwargs(vl_req),
                              device=system.device, stats=stats)

    vf_x = vf_req.get("x")
    if vf_x is not None and np.asarray(vf_x).size:
        pts = torch.as_tensor(np.atleast_2d(np.asarray(vf_x, np.float64)),
                              dtype=solution.dtype,
                              device=solution.device).reshape(-1, 3)
        if fast or field is None:
            # a fast evaluator plans over the nodes and these points, as
            # `System.velocity_at_targets` does
            pair = (system._pair_args(state, extra_targets=pts) if fast
                    else None)
            field = system.velocity_field(state, solution, pair)
            fields.append(field)
        vf = field(pts).cpu().numpy()
    else:
        vf = np.zeros((0, 3))
    stats["calls"] = stats.get("calls", 0) + sum(f.calls for f in fields)
    stats["points"] = stats.get("points", 0) + sum(f.points for f in fields)

    return {
        "time": frame["time"],
        "i_frame": frame_no,
        "n_frames": len(reader),
        "streamlines": _pack_lines(sl),
        "vortexlines": _pack_lines(vl),
        "velocity_field": eigen.pack_matrix(vf),
    }


def serve(config_file: str = "skelly_config.toml",
          trajectory_file: str | None = None, stdin=None, stdout=None,
          device=None) -> None:
    """Serve requests on ``stdin`` / ``stdout`` (binary streams; default
    the process's) over the trajectory beside ``config_file`` (or
    ``trajectory_file``), on ``device`` (default: the card)."""
    import os

    from .config.schema import load_runtime_config
    from .system import buckets as bucket_mod

    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    traj = trajectory_file or os.path.join(
        os.path.dirname(os.path.abspath(config_file)) or ".", "skelly_sim.out")

    system, template_state, _ = build_simulation(config_file, device=device)
    # the template, and every decoded frame (process_request), on the
    # config's capacity bucket
    policy = bucket_mod.BucketPolicy.from_runtime(
        load_runtime_config(config_file))
    system.grid_ladder = policy.grid_ladder
    template_state, _ = bucket_mod.bucketize(
        template_state, policy, pair_evaluator=system.params.pair_evaluator)
    reader = TrajectoryReader(traj)
    print(f"Entering listener mode ({len(reader)} frames)", file=sys.stderr,
          flush=True)

    while True:
        payload = protocol.read_frame(stdin)
        if payload is None:
            return
        if payload == b"":
            print("Terminate message received. Exiting listener mode",
                  file=sys.stderr, flush=True)
            return
        cmd = protocol.unpack_message(payload)
        try:
            system, _ = switch_evaluator(system, cmd.get("evaluator"))
        except ValueError as e:
            # refuse the request (a zero-length answer) and keep serving
            print(f"listener: {e}", file=sys.stderr, flush=True)
            protocol.write_empty(stdout)
            continue
        t0 = time.perf_counter()
        before = _launches()
        stats: dict = {}
        response = process_request(system, template_state, reader, cmd,
                                   policy=policy, stats=stats)
        if system.device.type == "cuda":
            torch.cuda.synchronize(system.device)
        after = _launches()
        logger.info("listener request %s", json.dumps({
            "frame_no": cmd.get("frame_no", 0),
            "evaluator": system.params.pair_evaluator,
            "valid": response is not None,
            "wall_s": time.perf_counter() - t0,
            "integrator_steps": stats.get("steps", 0),
            "velocity_calls": stats.get("calls", 0),
            "velocity_points": stats.get("points", 0),
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}))
        if response is None:
            protocol.write_empty(stdout)
            continue
        protocol.write_message(stdout, response)
