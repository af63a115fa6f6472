"""Command-line entry point: run or resume a TOML config.

Counterpart of `skellysim_tpu.cli`: flag parsing, trajectory-existence
guards, the initial frame and config snapshot (or, with ``--resume``, the
last frame of the trajectory, its RNG state, an appending writer and a
resume marker in the metrics file), then the time loop.

Usage: python -m skellysim_tpu_torch [--config-file=...] [--resume]
       [--overwrite] [--metrics-file=...] [--trace-file=...]
       [--profile=DIR] [--listen] [--device=cuda|cpu]

``--trace-file`` appends the run's telemetry (`obs.tracer`: spans, flight
rows, faults, compile events) as JSON lines; `obs.summarize` renders it.
``--profile DIR`` runs the loop under `torch.profiler`
(`obs.profile.profile_session`), writes Kineto's trace into DIR and
appends the device time by phase to the trace file as ``device_phase``
events; ``python -m skellysim_tpu_torch.obs profile DIR`` prints the
table, ``... timeline TRACE --profile DIR -o OUT`` the merged timeline.

Runs on the CUDA card unless ``--device=cpu`` is given; a missing card
raises. ``--listen`` serves the post-processing protocol over stdin and
stdout on the config's trajectory instead of running (`listener`; drive it
with `io.Listener`).

With SKELLY_COORDINATOR / SKELLY_NUM_PROCS / SKELLY_PROC_ID set, every
process joins the others first (`parallel.multihost.initialize`, before
any use of the card: each process on its own card by default) and logs
its rank. As in the JAX package the CLI builds no mesh: every process runs
the whole config, and writes the trajectory beside its own config file.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys

from .builder import build_simulation
from .config.schema import load_runtime_config
from .io.trajectory import TrajectoryWriter, resume_state
from .system import buckets
from .utils.rng import SimRNG

TRAJECTORY_FILE = "skelly_sim.out"


def _snapshot_path(traj: str, suffix: str) -> str:
    """'skelly_sim.out' -> 'skelly_sim.<suffix>' (a path without '.out'
    gets the suffix appended, never substituted)."""
    base, ext = os.path.splitext(traj)
    return (base if ext == ".out" else traj) + "." + suffix


def run(config_file: str, resume: bool = False, overwrite: bool = False,
        trajectory_path: str | None = None, metrics_path: str | None = None,
        device=None, trace_path: str | None = None,
        profile_dir: str | None = None) -> None:
    traj = trajectory_path or os.path.join(
        os.path.dirname(os.path.abspath(config_file)) or ".", TRAJECTORY_FILE)
    if os.path.exists(traj) and not (resume or overwrite):
        sys.exit(f"Trajectory '{traj}' already exists and neither --resume "
                 "nor --overwrite was given; refusing to clobber it")
    if resume and not os.path.exists(traj):
        sys.exit(f"--resume given but trajectory '{traj}' does not exist")
    system, state, rng = build_simulation(config_file, device=device)
    # the scene lands on its `[runtime]` capacity bucket (the identity
    # without ladders); the spectral grid rungs ride the System
    policy = buckets.BucketPolicy.from_runtime(
        load_runtime_config(config_file))
    system.grid_ladder = policy.grid_ladder
    state, key = buckets.bucketize(
        state, policy, pair_evaluator=system.params.pair_evaluator)
    log = logging.getLogger("skellysim_tpu_torch")
    log.info("device %s: %d fiber, %d shell and %d body nodes; scene "
             "bucket: %s", system.device, *system._counts(state),
             key.describe())
    if resume:
        state, rng_state, reader = resume_state(traj, state)
        reader.close()
        # the frame holds live rows only: land on the same bucket again
        state, _ = buckets.bucketize(
            state, policy, pair_evaluator=system.params.pair_evaluator)
        if rng_state:
            rng = SimRNG.from_state(rng_state)
        writer = TrajectoryWriter(traj, append=True)
        if metrics_path and os.path.exists(metrics_path):
            # step indices restart at 0 per run: the marker segments an
            # appended metrics file
            with open(metrics_path, "a") as fh:
                fh.write(json.dumps({"resume": True,
                                     "t": float(state.time)}) + "\n")
        print(f"Resuming from t={state.time:.6g}")
    else:
        writer = TrajectoryWriter(traj)
        shutil.copyfile(config_file, _snapshot_path(traj, "initial_config"))
        writer.write_frame(state, rng_state=rng.dump_state())
    with writer:
        final = system.run(state, writer=writer.write_frame, rng=rng,
                           metrics_path=metrics_path, trace_path=trace_path,
                           profile_dir=profile_dir)
    shutil.copyfile(config_file, _snapshot_path(traj, "final_config"))
    print(f"Finished at t={final.time:.6g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="skellysim-tpu-torch",
        description="cytoskeletal hydrodynamics simulator (PyTorch/CUDA port)")
    ap.add_argument("--config-file", default="skelly_config.toml")
    ap.add_argument("--resume", action="store_true",
                    help="continue an existing trajectory from its last frame")
    ap.add_argument("--overwrite", action="store_true",
                    help="overwrite an existing trajectory")
    ap.add_argument("--listen", action="store_true",
                    help="serve post-processing requests (streamlines, "
                         "vortex lines, velocity fields) on the config's "
                         "trajectory over stdin/stdout")
    ap.add_argument("--metrics-file", default=None,
                    help="append one JSON line of step metrics per trial step")
    ap.add_argument("--trace-file", default=None,
                    help="telemetry JSONL (span, flight, fault and compile "
                         "events; render with skellysim_tpu_torch.obs"
                         ".summarize)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler capture of the whole loop "
                         "(obs.profile.profile_session); the dump is "
                         "parsed afterwards and device_phase events are "
                         "appended to --trace-file. Render with `python -m "
                         "skellysim_tpu_torch.obs profile DIR` / `obs "
                         "timeline`")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the CUDA card; raises when "
                         "there is none)")
    ap.add_argument("--log-level",
                    default=os.environ.get("SKELLYSIM_LOG", "INFO"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="[%(asctime)s] [%(levelname)s] %(message)s",
                        stream=sys.stderr)
    # several processes (a no-op for one; the analogue of the reference's
    # MPI_Init, `skelly_sim.cpp:14`): before anything touches the card
    from .parallel import initialize_multihost, process_info

    if initialize_multihost(device=args.device):
        logging.getLogger("skellysim_tpu_torch").info(
            "multi-process runtime: %s", process_info())
    if args.listen:
        from .listener import serve

        serve(args.config_file, device=args.device)
        return
    run(args.config_file, resume=args.resume, overwrite=args.overwrite,
        metrics_path=args.metrics_file, device=args.device,
        trace_path=args.trace_file, profile_dir=args.profile)


if __name__ == "__main__":
    main()
