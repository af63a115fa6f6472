"""Process driver: run a TOML config.

Counterpart of `skellysim_tpu.cli`: flag parsing, trajectory-existence
guards, the initial frame and config snapshot, then the time loop.

Usage: python -m skellysim_tpu_torch [--config-file=...] [--overwrite]
       [--metrics-file=...] [--device=cuda|cpu]

Runs on the CUDA card unless ``--device=cpu`` is given; a missing card
raises. ``--resume`` and ``--listen`` are not ported yet (ROADMAP.md §1
items 7 and 13).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

from .builder import build_simulation
from .io.trajectory import TrajectoryWriter

TRAJECTORY_FILE = "skelly_sim.out"


def _snapshot_path(traj: str, suffix: str) -> str:
    """'skelly_sim.out' -> 'skelly_sim.<suffix>' (a path without '.out'
    gets the suffix appended, never substituted)."""
    base, ext = os.path.splitext(traj)
    return (base if ext == ".out" else traj) + "." + suffix


def run(config_file: str, overwrite: bool = False,
        trajectory_path: str | None = None, metrics_path: str | None = None,
        device=None) -> None:
    traj = trajectory_path or os.path.join(
        os.path.dirname(os.path.abspath(config_file)) or ".", TRAJECTORY_FILE)
    if os.path.exists(traj) and not overwrite:
        sys.exit(f"Trajectory '{traj}' already exists and --overwrite was "
                 "not given; refusing to clobber it")

    system, state, rng = build_simulation(config_file, device=device)
    logging.getLogger("skellysim_tpu_torch").info(
        "device %s: %d fiber, %d shell and %d body nodes", system.device,
        *system._counts(state))
    with TrajectoryWriter(traj) as writer:
        shutil.copyfile(config_file, _snapshot_path(traj, "initial_config"))
        writer.write_frame(state, rng_state=rng.dump_state())
        final = system.run(state, writer=writer.write_frame, rng=rng,
                           metrics_path=metrics_path)
    shutil.copyfile(config_file, _snapshot_path(traj, "final_config"))
    print(f"Finished at t={final.time:.6g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="skellysim-tpu-torch",
        description="cytoskeletal hydrodynamics simulator (PyTorch/CUDA port)")
    ap.add_argument("--config-file", default="skelly_config.toml")
    ap.add_argument("--overwrite", action="store_true",
                    help="overwrite an existing trajectory")
    ap.add_argument("--resume", action="store_true",
                    help="not ported yet (ROADMAP.md §1 item 7)")
    ap.add_argument("--listen", action="store_true",
                    help="not ported yet (ROADMAP.md §1 item 13)")
    ap.add_argument("--metrics-file", default=None,
                    help="append one JSON line of step metrics per trial step")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the CUDA card; raises when "
                         "there is none)")
    ap.add_argument("--log-level",
                    default=os.environ.get("SKELLYSIM_LOG", "INFO"))
    args = ap.parse_args(argv)
    if args.resume:
        raise NotImplementedError("--resume is not ported to "
                                  "skellysim_tpu_torch yet (ROADMAP.md §1 "
                                  "item 7)")
    if args.listen:
        raise NotImplementedError("--listen is not ported to "
                                  "skellysim_tpu_torch yet (ROADMAP.md §1 "
                                  "item 13)")
    logging.basicConfig(level=args.log_level.upper(),
                        format="[%(asctime)s] [%(levelname)s] %(message)s",
                        stream=sys.stderr)
    run(args.config_file, overwrite=args.overwrite,
        metrics_path=args.metrics_file, device=args.device)


if __name__ == "__main__":
    main()
