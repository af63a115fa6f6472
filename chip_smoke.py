#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card and check it.

    python3 chip_smoke.py                      # on a machine with one H100

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — nvcc builds the hand-written kernels from the sources in this
             checkout (skellysim_tpu_torch/csrc); prints seconds and the
             `-Xptxas -v` report (registers, spills).
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shape (the 640,000 fiber nodes of the
             10k-fiber config as sources and as targets, as in every
             matvec): error, kernel time (CUDA events after warm-up),
             plain time, and the bound.
4. run     — writes the repo's 10k-fiber x 64-node free-space config
             (examples/free_fibers_10k/gen_config.py's recipe, with
             refine_pair_impl="pallas_df", dt_write = dt so every step
             writes a frame, t_final = 0.01: two steps) with the port's own
             Config, sets every launch count to 0, runs
             `python -m skellysim_tpu_torch` on it in this process, reads the
             counts, the per-step metrics and the peak device memory, and
             decodes the trajectory with the port's own msgpack reader.
5. check   — a small scene stepped on the card (kernels) and on the CPU
             (plain versions) agrees to 1e-8.

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA card the script exits 2
before printing any result.

``--device=cpu --fibers=N`` rehearses the same phases on the
CPU at a small size with the plain versions (no build, no launch counts, no
result line).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import runpy
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet peaks (dense, 700 W): 67 TFLOP/s FP32 outside
#: the tensor cores, 34 TFLOP/s FP64 outside the tensor cores, 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
#: flops per pair, the Pallas tile's own cost estimate
#: (skellysim_tpu/ops/pallas_kernels.py `stokeslet_pallas` CostEstimate)
FLOPS_PER_PAIR = 22
#: two steps of dt = 5e-3
T_FINAL = 0.01


def log(*a):
    print(*a, flush=True)


def bound_ms(n, itemsize, peak):
    """Least time for the same work on ``n`` points that are both sources
    and targets: max(operations / peak, bytes / HBM rate); bytes = each
    input read once (3 position + 3 force words a point) and the output
    written once (3 words a point)."""
    ops = FLOPS_PER_PAIR * n * n
    nbytes = itemsize * 9 * n
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def timed(torch, fn, device, reps):
    """Mean ms of ``fn()`` over ``reps`` runs: CUDA events on the card,
    the host clock on the CPU (rehearsal only)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return 1e3 * (time.perf_counter() - t0) / reps, out


def make_config(path, n_fibers, t_final):
    """The 10k free-fiber config (examples/free_fibers_10k/gen_config.py)
    written with the port's own schema."""
    import numpy as np

    from skellysim_tpu_torch.config import Config, Fiber

    rng = np.random.default_rng(100)
    box = 20.0
    config = Config()
    config.params.dt_write = 5e-3
    config.params.dt_initial = 5e-3
    config.params.dt_max = 5e-3
    config.params.t_final = t_final
    config.params.gmres_tol = 1e-8
    config.params.pair_evaluator = "ring"
    config.params.kernel_impl = "pallas"
    config.params.solver_precision = "auto"
    config.params.refine_pair_impl = "pallas_df"
    for _ in range(n_fibers):
        fib = Fiber(length=1.0, bending_rigidity=2.5e-3, force_scale=-0.05,
                    n_nodes=64)
        origin = rng.uniform(-box / 2, box / 2, 3)
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        fib.fill_node_positions(origin, direction)
        config.fibers.append(fib)
    config.save(path)
    return config


def phase_kernels(torch, ck, device, nodes, card):
    """Each kernel against its plain version at the main path's shape
    (every fiber node a source and a target, as in every matvec); returns
    the JSON entries (launches filled in after the run)."""
    import numpy as np

    rng = np.random.default_rng(7)
    n_src = nodes.shape[0]
    # forces of a matvec's size: quadrature-weighted O(1) densities
    f = rng.standard_normal((n_src, 3)) / 63.0
    eta = 1.0
    # both kernels get the same values: rounded to f32 once, then widened
    # for kernel B. With f64 inputs, kernel A's f32 rounding of the
    # positions alone moves u by 5.7e-4 of max|u| here: two nodes of
    # different fibers lie 2.6e-4 apart.
    src64 = torch.as_tensor(nodes, dtype=torch.float32,
                            device=device).double()
    f64 = torch.as_tensor(f, dtype=torch.float32, device=device).double()
    # the reference of both kernels: the plain version in f64 (also kernel
    # B's plain time, since it is kernel B's own plain version)
    ref_ms, ref = timed(torch, lambda: ck.stokeslet_f64_plain(
        src64, src64, f64, eta), device, 1)
    out = []
    specs = [
        ("stokeslet_f32", ck.stokeslet_f32, torch.float32,
         ck.stokeslet_f32_plain, PEAK_FP32, 1e-4,
         "skellysim_tpu/ops/pallas_kernels.py:110 (_stokeslet_kernel)"),
        ("stokeslet_f64", ck.stokeslet_f64, torch.float64,
         None, PEAK_FP64, 1e-12,
         "skellysim_tpu/ops/pallas_df.py:158 (_stokeslet_df_kernel)"),
    ]
    for name, kern, dt, plain, peak, tol, replaces in specs:
        src = src64.to(dt)
        force = f64.to(dt)
        timed(torch, lambda: kern(src, src, force, eta), device, 1)  # warm-up
        ms, got = timed(torch, lambda: kern(src, src, force, eta), device, 3)
        if plain is None:
            plain_ms = ref_ms
        else:
            plain_ms, _ = timed(torch, lambda: plain(src, src, force, eta),
                                device, 1)
        err = (got.double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        finite = bool(torch.isfinite(got).all())
        b_ms, b_by = bound_ms(n_src, got.element_size(), peak)
        log(f"[kernels] {name}: {n_src} x {n_src} pairs, max abs err "
            f"{err:.3e}, max rel err {rel:.3e} (tolerance {tol:g} of max|u|; "
            f"reference: plain f64), kernel {ms:.3f} ms, plain {plain_ms:.1f} "
            f"ms, bound {b_ms:.3f} ms ({b_by}, {FLOPS_PER_PAIR} flops a pair "
            f"at {peak / 1e12:g} TFLOP/s, the data sheet's rate at 700 W; "
            f"this card: {card})")
        if not finite or not rel <= tol:
            raise SystemExit(f"{name} disagrees with its plain version: "
                             f"rel err {rel:.3e} > {tol:g} (finite={finite})")
        out.append({"name": name, "route": "cuda",
                    "source": "skellysim_tpu_torch/csrc/stokeslet.cu",
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None,
                    "shape": [int(n_src), int(n_src)]})
        del src, force, got
    del src64, f64, ref
    log("[kernels] no single PyTorch call computes the singular Stokeslet "
        "sum (it is not a convolution, attention or sparse product): "
        "library_ms is null")
    return out


def phase_run(torch, ck, device, cfg_path, run_dir):
    """`python -m skellysim_tpu_torch` on the config, in this process."""
    metrics = os.path.join(run_dir, "metrics.jsonl")
    for w in ck.KERNEL_WRAPPERS:
        w.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    argv = sys.argv
    sys.argv = ["skellysim_tpu_torch", f"--config-file={cfg_path}",
                f"--metrics-file={metrics}", f"--device={device.type}",
                "--log-level=WARNING"]
    t0 = time.perf_counter()
    try:
        runpy.run_module("skellysim_tpu_torch", run_name="__main__",
                         alter_sys=True)
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in ck.KERNEL_WRAPPERS}
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    steps = [json.loads(line) for line in open(metrics)]
    return wall, counts, peak, steps


def phase_check_small(torch, device):
    """One mixed step of a small scene on ``device`` and on the CPU."""
    import numpy as np

    from skellysim_tpu_torch.fibers import container as fc
    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System

    rng = np.random.default_rng(3)
    t = np.linspace(0, 1, 16)
    d = rng.normal(size=(8, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x = rng.uniform(-1, 1, (8, 1, 3)) + t[None, :, None] * d[:, None, :]
    res = {}
    for dev in sorted({device.type, "cpu"}):
        p = Params(dt_initial=0.01, gmres_tol=1e-12, solver_precision="mixed",
                   kernel_impl="pallas", refine_pair_impl="pallas_df")
        system = System(p, device=dev)
        g = fc.make_group(x, lengths=1.0, bending_rigidity=0.01,
                          radius=0.0125, force_scale=-0.05, device=dev)
        new, _, info = system.step(system.make_state(fibers=g))
        if not info.converged:
            raise SystemExit(f"small scene did not converge on {dev}")
        res[dev] = new.fibers.x.cpu().numpy()
    err = float(np.abs(res[device.type] - res["cpu"]).max())
    log(f"[check] small scene (8 fibers x 16 nodes, mixed): card vs CPU "
        f"max |dx| = {err:.3e} (tolerance 1e-8)")
    if not err <= 1e-8:
        raise SystemExit("card and CPU disagree on the small scene")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fibers", type=int, default=10_000)
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the card and has nothing to run here",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader
    from skellysim_tpu_torch.ops import cuda_build
    from skellysim_tpu_torch.ops import cuda_kernels as ck

    device = torch.device(args.device)
    t_start = time.perf_counter()

    # 1. device
    smi = None
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"[device] nvidia-smi: {smi}")
        log(f"[device] torch: {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
            f", CUDA {torch.version.cuda}")

    # 2. build
    if device.type == "cuda":
        info = cuda_build.build("stokeslet")
        log(f"[build] stokeslet.cu: {info['seconds']:.1f} s "
            f"(cached={info['cached']}) -> {os.path.relpath(info['path'], REPO)}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] ptxas: {line.strip()}")

    # 4's config first: its node positions are phase 3's inputs
    run_dir = os.path.join(REPO, ".smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    config = make_config(cfg_path, args.fibers, T_FINAL)
    log(f"[run] wrote {args.fibers} x 64-node config in "
        f"{time.perf_counter() - t0:.1f} s")
    import numpy as np

    nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                            for f in config.fibers])
    del config

    # 3. kernels vs plain
    entries = phase_kernels(torch, ck, device, nodes, smi)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the main path
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    for s in steps:
        log(f"[run] step {s['step']}: t={s['t']:.4g} dt={s['dt']:.3g} wall "
            f"{s['wall_s']:.3f} s, GMRES iterations {s['iters']}, refinement "
            f"sweeps {s['refines']}, true residual {s['residual_true']:.3e}, "
            f"fiber error {s['fiber_error']:.3e}, accepted {s['accepted']}")
    log(f"[run] whole CLI run {wall:.1f} s (build of the state, {len(steps)} "
        f"steps, frame writes); launches {counts}; peak device memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if len(steps) < 2 or not all(s["accepted"] for s in steps):
        raise SystemExit("the run did not take its two accepted steps")
    for s in steps:
        if not (s["residual_true"] <= 1e-8 and math.isfinite(s["fiber_error"])
                and s["health"] == 0):
            raise SystemExit(f"step {s['step']} is not converged/healthy: {s}")
    if device.type == "cuda" and not all(counts.values()):
        raise SystemExit(f"a kernel of the main path never launched: {counts}")
    for e in entries:
        e["launches"] = counts[e["name"]]

    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    last = reader.load_frame(len(reader) - 1)
    fibers = last["fibers"][1]
    xs = np.stack([m["x_"] for m in fibers])
    log(f"[run] trajectory: {len(reader)} frames, times {reader.times}, "
        f"last frame {len(fibers)} fibers, x {xs.shape}")
    if (len(reader) != len(steps) + 1 or abs(last["time"] - T_FINAL) > 1e-9
            or xs.shape != (args.fibers, 64, 3) or not np.isfinite(xs).all()):
        raise SystemExit("the trajectory does not hold the expected frames")

    # 5. small reference check
    phase_check_small(torch, device)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    if device.type != "cuda":
        log("rehearsal on the CPU passed (no result line: nothing was "
            "measured on a card)")
        return 0
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
