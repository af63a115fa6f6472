"""The centrosome scene of `chip_smoke.py` phase 10, cut to run on the CPU,
through both packages' CLIs: does the port's GMRES iteration count per step
match the JAX package's, and grow the same way, where the nucleated fibers
crowd the body?

The scene keeps what crowds: one 600-node sphere of radius 0.5 with
``--sites`` nucleation sites placed 0.04 apart (the same placement and seed
as phase 10), dynamic instability at 64 nodes with phase 10's rates, so
~200 fibers nucleate a step onto the sphere. It cuts the rest: ``--fibers``
clamped ellipsoid fibers (phase 10: 2,000) in a ``--shell-nodes`` shell
(phase 10: 8,000), and the solver's default f64 tiers (phase 10 runs the
card's f32 tiers with f64 refinement). Each package runs ``--steps``
steps from the same config and precompute (written by the JAX package).

    JAX_PLATFORMS=cpu python tests/torch_di_crowding.py [--fibers 16]
        [--shell-nodes 1000] [--sites 1000] [--steps 2] [--threads 4]

Both runs go at once, each with ``--threads`` threads: ~36 min on 8
cores at the defaults, most of it the port's second step at 512 fiber
slots. Prints one line a
step (each package's iterations, events, active fibers and wall) and one
JSON line; exits 1 if the packages' per-step counts differ.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DT = 8e-3


def write_config(path, n_fibers, n_shell, n_sites, steps):
    from skellysim_tpu.config import Body, ConfigEllipsoidal, Fiber

    config = ConfigEllipsoidal()
    config.params.dt_initial = config.params.dt_max = DT
    config.params.dt_write = DT
    config.params.t_final = steps * DT
    di = config.params.dynamic_instability
    di.n_nodes, di.v_growth, di.f_catastrophe = 64, 0.2, 0.5
    di.nucleation_rate, di.min_length = 25.0, 0.5
    config.fibers = [
        Fiber(length=1.0, bending_rigidity=2.5e-3, parent_body=-1,
              force_scale=-0.05, minus_clamped=True, n_nodes=64)
        for _ in range(n_fibers)]
    config.periphery.n_nodes = n_shell
    config.periphery.move_fibers_to_surface(
        config.fibers, ds_min=0.1, rng=np.random.default_rng(100),
        verbose=False)
    body = Body(position=[0.0, 0.0, 0.0], shape="sphere", radius=0.5,
                n_nodes=600, n_nucleation_sites=n_sites,
                precompute_file="body_precompute.npz")
    body.generate_nucleation_sites(ds_min=0.04, verbose=False,
                                   rng=np.random.default_rng(7))
    config.bodies = [body]
    config.save(path)


def start(package, run_dir, threads):
    """One CLI run of ``package`` in ``run_dir``, started in the
    background."""
    cmd = [sys.executable, "-m", package, "--config-file",
           os.path.join(run_dir, "skelly_config.toml"), "--metrics-file",
           os.path.join(run_dir, "metrics.jsonl")]
    cmd += ["--no-jax-cache"] if package == "skellysim_tpu" else [
        "--device=cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(threads),
               XLA_FLAGS=f"--xla_cpu_multi_thread_eigen=true "
                         f"intra_op_parallelism_threads={threads}",
               PYTHONPATH=REPO)
    with open(os.path.join(run_dir, f"{package}.log"), "a") as log:
        return subprocess.Popen(cmd, cwd=run_dir, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fibers", type=int, default=16)
    ap.add_argument("--shell-nodes", type=int, default=1000)
    ap.add_argument("--sites", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    from skellysim_tpu import precompute

    work = tempfile.mkdtemp(prefix="di_crowding_")
    try:
        base = os.path.join(work, "base")
        os.makedirs(base)
        cfg = os.path.join(base, "skelly_config.toml")
        write_config(cfg, args.fibers, args.shell_nodes, args.sites,
                     args.steps)
        precompute.precompute_from_config(cfg, verbose=False)
        dirs = {}
        for package in ("skellysim_tpu", "skellysim_tpu_torch"):
            dirs[package] = os.path.join(work, package)
            shutil.copytree(base, dirs[package])
        t0 = time.perf_counter()
        procs = {p: start(p, d, args.threads) for p, d in dirs.items()}
        for package, proc in procs.items():
            if proc.wait():
                with open(os.path.join(dirs[package],
                                       f"{package}.log")) as fh:
                    sys.stderr.write(fh.read()[-4000:])
                raise SystemExit(f"{package} exited {proc.returncode}")
        wall = time.perf_counter() - t0
        steps = {}
        for package, d in dirs.items():
            with open(os.path.join(d, "metrics.jsonl")) as fh:
                steps[package] = [m for m in map(json.loads, fh)
                                  if "step" in m]
    finally:
        shutil.rmtree(work)

    keys = ("iters", "nucleations", "catastrophes", "active_fibers",
            "accepted")
    jax_steps, port_steps = steps["skellysim_tpu"], steps["skellysim_tpu_torch"]
    same = len(jax_steps) == len(port_steps) == args.steps
    for i, (a, b) in enumerate(zip(jax_steps, port_steps)):
        same = same and all(a[k] == b[k] for k in keys)
        print(f"step {i} t={a['t']:.4g}: iterations JAX {a['iters']} / port "
              f"{b['iters']}; +{a['nucleations']} / +{b['nucleations']} "
              f"nucleated, -{a['catastrophes']} / -{b['catastrophes']} "
              f"catastrophes, active {a['active_fibers']} / "
              f"{b['active_fibers']}; wall {a['wall_s']:.1f} / "
              f"{b['wall_s']:.1f} s")
    print(json.dumps({"scene": vars(args), "same_counts": same,
                      "wall_s": wall,
                      "jax": [{k: m[k] for k in keys} for m in jax_steps],
                      "port": [{k: m[k] for k in keys} for m in port_steps]}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
