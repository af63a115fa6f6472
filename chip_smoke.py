#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one card and check them.

    python3 chip_smoke.py                      # on a machine with one H100

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device    — the card's name and power limit (nvidia-smi) and torch's name.
2. build     — nvcc builds the hand-written kernels from the sources in this
               checkout (skellysim_tpu_torch/csrc/*.cu, one nvcc per source,
               started together); prints seconds and the `-Xptxas -v` report
               (registers, spills).
3. kernels   — kernels A and B (Stokeslet) against their plain PyTorch
               versions on the card at the free-space path's shape (the
               640,000 fiber nodes of the 10k-fiber config as sources and as
               targets): error, kernel time (CUDA events after warm-up),
               plain time, and the bound.
4. run       — the repo's 10k-fiber x 64-node free-space config
               (examples/free_fibers_10k/gen_config.py's recipe, with
               refine_pair_impl="pallas_df", a frame every step) written with
               the port's own Config; every launch count set to 0, then
               `python -m skellysim_tpu_torch` in this process; the counts,
               per-step metrics and peak device memory are read and the
               trajectory is decoded with the port's own reader.
5. check     — a small coupled scene (a ~200-node spherical shell holding
               one sphere body with 8 bound fibers, plus free fibers) takes
               one mixed step on the card (kernels) and on the CPU (plain
               versions); the two agree to 1e-8.
6. confined  — the repo's ellipsoid config (examples/ellipsoid/gen_config.py:
               2,000 clamped fibers x 64 nodes inside an 8,000-node
               ellipsoidal shell, three steps of dt = 8e-3) written with the
               port's schema in a temporary directory outside the checkout;
               `python -m skellysim_tpu_torch.precompute` on the card (seconds of quadrature / assembly / inverse and
               ||M M_inv - I|| on 8 columns); kernels C and D (stresslet)
               against their plain versions with the shell's nodes as
               sources and the fiber nodes as targets; then the run, as in 4,
               gated on every step accepted with true residual <= gmres_tol
               and health 0, on all four kernels launching, and on frames
               that carry a finite shell density of 3 x 8,000 values.
7. bodies    — examples/stokes_tests/body_const_force (one 600-node sphere,
               force (0, 0, 1), three steps of dt = 0.1) precomputed and run
               the same way; the body's velocity must meet the reference's
               Stokes-drag gate |1 - v / (F / 6 pi eta r_eff)| < 1e-6, and
               kernels C and D must launch.

Then one JSON line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA card the script exits 2
before printing any result. Every file a phase writes (configs, the ~6.9 GB
shell precompute, trajectories) lives in one temporary directory outside
the checkout, removed at the end whether the run passed or failed.

``--device=cpu`` with small ``--fibers``, ``--ellipsoid-fibers`` and
``--shell-nodes`` rehearses the same phases on the CPU with the plain
versions (no build, no launch counts, no result line).
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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data sheet peaks (dense, 700 W): 67 TFLOP/s FP32 outside
#: the tensor cores, 34 TFLOP/s FP64 outside the tensor cores, 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
#: flops per pair, the Pallas tiles' own cost estimates
#: (skellysim_tpu/ops/pallas_kernels.py `stokeslet_pallas` / `stresslet_pallas`)
FLOPS_PER_PAIR = {"stokeslet": 22, "stresslet": 40}
#: words a source carries: position + force (Stokeslet), position + the 9
#: stresslet components
SOURCE_WORDS = {"stokeslet": 6, "stresslet": 12}
#: two steps of dt = 5e-3 on the free-space path
T_FINAL = 0.01
#: the ellipsoid config's dt, three steps
ELLIPSOID_DT = 8e-3
ELLIPSOID_STEPS = 3
#: the body scene's dt, three steps
BODY_DT = 0.1
BODY_STEPS = 3


def log(*a):
    print(*a, flush=True)


def bound_ms(family, n_src, n_trg, itemsize, peak, same_points=False):
    """Least time for the same work: max(operations / peak, bytes / HBM
    rate); bytes = each input read once (the sources' words, the target
    positions unless they are the sources themselves) and the [n_trg, 3]
    output written once."""
    ops = FLOPS_PER_PAIR[family] * n_src * n_trg
    words = SOURCE_WORDS[family] * n_src + (0 if same_points else 3) * n_trg
    nbytes = itemsize * (words + 3 * n_trg)
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


def make_ellipsoid_config(path, n_fibers, n_shell):
    """examples/ellipsoid/gen_config.py's config written with the port's
    schema, three steps with a frame each and the card's tiers."""
    import numpy as np

    from skellysim_tpu_torch.config import ConfigEllipsoidal, Fiber

    rng = np.random.default_rng(100)
    config = ConfigEllipsoidal()
    config.params.dt_initial = ELLIPSOID_DT
    config.params.dt_max = ELLIPSOID_DT
    config.params.dt_write = ELLIPSOID_DT
    config.params.t_final = ELLIPSOID_STEPS * ELLIPSOID_DT
    config.params.kernel_impl = "pallas"
    config.params.solver_precision = "auto"
    config.params.refine_pair_impl = "pallas_df"
    config.fibers = [
        Fiber(length=1.0, bending_rigidity=2.5e-3, parent_body=-1,
              force_scale=-0.05, minus_clamped=True, n_nodes=64)
        for _ in range(n_fibers)]
    config.periphery.n_nodes = n_shell
    config.periphery.move_fibers_to_surface(config.fibers, ds_min=0.1,
                                            rng=rng, verbose=False)
    config.save(path)
    return config


def make_body_config(path):
    """examples/stokes_tests/body_const_force/gen_config.py's config with
    the port's schema, cut to three steps."""
    from skellysim_tpu_torch.config import Body, Config

    config = Config()
    config.params.eta = 1.0
    config.params.dt_initial = BODY_DT
    config.params.dt_write = BODY_DT
    config.params.t_final = BODY_STEPS * BODY_DT
    config.params.adaptive_timestep_flag = False
    config.bodies = [Body(position=[0.0, 0.0, 0.0], shape="sphere",
                          radius=0.5, n_nodes=600,
                          external_force=[0.0, 0.0, 1.0])]
    config.save(path)
    return config


def phase_kernels(torch, ck, device, specs, card):
    """Each kernel against its plain version on the same (f32-rounded)
    inputs; returns the JSON entries (launches filled in after the runs).

    ``specs``: (family, src [n, 3], trg [m, 3], payload [n, 3 or 9],
    same_points, [(name, kernel, dtype, plain or None, peak, tol,
    replaces)]). Both kernels of a family get the same values, rounded to
    f32 once and widened for the f64 kernel: with f64 inputs, the f32
    kernel's rounding of the positions alone would dominate its error."""
    out = []
    for family, src, trg, pay, same, kernels in specs:
        f64_plain = getattr(ck, f"{family}_f64_plain")
        src64, trg64, pay64 = (torch.as_tensor(a, dtype=torch.float32,
                                               device=device).double()
                               for a in (src, trg, pay))
        eta = 1.0
        # the reference of both kernels: the plain version in f64 (also the
        # f64 kernel's plain time, since it is that kernel's plain version)
        ref_ms, ref = timed(torch, lambda: f64_plain(src64, trg64, pay64,
                                                     eta), device, 1)
        n_src, n_trg = src64.shape[0], trg64.shape[0]
        for name, kern, dt, plain, peak, tol, replaces in kernels:
            s, t, f = src64.to(dt), trg64.to(dt), pay64.to(dt)
            timed(torch, lambda: kern(s, t, f, eta), device, 1)  # warm-up
            ms, got = timed(torch, lambda: kern(s, t, f, eta), device, 3)
            plain_ms = ref_ms if plain is None else timed(
                torch, lambda: plain(s, t, f, eta), device, 1)[0]
            err = (got.double() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            finite = bool(torch.isfinite(got).all())
            b_ms, b_by = bound_ms(family, n_src, n_trg, got.element_size(),
                                  peak, same_points=same)
            log(f"[kernels] {name}: {n_src} sources x {n_trg} targets, max "
                f"abs err {err:.3e}, max rel err {rel:.3e} (tolerance "
                f"{tol:g} of max|u|; reference: plain f64), kernel {ms:.3f} "
                f"ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}, "
                f"{FLOPS_PER_PAIR[family]} flops a pair at "
                f"{peak / 1e12:g} TFLOP/s, the data sheet's rate at 700 W; "
                f"this card: {card})")
            if not finite or not rel <= tol:
                raise SystemExit(f"{name} disagrees with its plain version: "
                                 f"rel err {rel:.3e} > {tol:g} "
                                 f"(finite={finite})")
            out.append({"name": name, "route": "cuda",
                        "source": f"skellysim_tpu_torch/csrc/{ck.SOURCE}.cu",
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "max_rel_err": rel,
                        "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None,
                        "shape": [int(n_src), int(n_trg)]})
            del s, t, f, got
        del src64, trg64, pay64, ref
        log(f"[kernels] no single PyTorch call computes the singular "
            f"{family} sum (it is not a convolution, attention or sparse "
            "product): library_ms is null")
    return out


def phase_run(torch, ck, device, cfg_path, run_dir):
    """`python -m skellysim_tpu_torch` on the config, in this process, with
    every launch count set to 0 just before and read just after."""
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


def report_run(tag, wall, counts, peak, steps, n_steps, tol, device, needed):
    """Print a run's per-step metrics and gate it: ``n_steps`` accepted
    steps, each with true residual <= ``tol``, finite fiber error and
    health 0, and every kernel in ``needed`` launched (on the card)."""
    for s in steps:
        log(f"[{tag}] step {s['step']}: t={s['t']:.4g} dt={s['dt']:.3g} wall "
            f"{s['wall_s']:.3f} s, GMRES iterations {s['iters']}, refinement "
            f"sweeps {s['refines']}, true residual {s['residual_true']:.3e}, "
            f"fiber error {s['fiber_error']:.3e}, accepted {s['accepted']}")
    log(f"[{tag}] whole CLI run {wall:.1f} s (build of the state, "
        f"{len(steps)} steps, frame writes); launches {counts}; peak device "
        f"memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    if len(steps) != n_steps or not all(s["accepted"] for s in steps):
        raise SystemExit(f"{tag}: the run did not take its {n_steps} "
                         "accepted steps")
    for s in steps:
        if not (s["residual_true"] <= tol and math.isfinite(s["fiber_error"])
                and s["health"] == 0):
            raise SystemExit(f"{tag}: step {s['step']} is not "
                             f"converged/healthy: {s}")
    if device.type == "cuda" and not all(counts[k] > 0 for k in needed):
        raise SystemExit(f"{tag}: a kernel of the path never launched: "
                         f"{counts}")


def phase_check_small(torch, device):
    """One mixed step of the small coupled scene on ``device`` and on the
    CPU (`skellysim_tpu_torch.testing.make_coupled_scene`)."""
    import numpy as np

    from skellysim_tpu_torch.params import Params
    from skellysim_tpu_torch.system import System
    from skellysim_tpu_torch.testing import make_coupled_scene

    res = {}
    for dev in sorted({device.type, "cpu"}):
        p = Params(dt_initial=0.02, gmres_tol=1e-12, solver_precision="mixed",
                   kernel_impl="pallas", refine_pair_impl="pallas_df")
        shell, shape, bodies, fibers = make_coupled_scene(
            shell_n=200, body_n=100, device=dev, precond_dtype=torch.float32)
        system = System(p, shell_shape=shape, device=dev)
        new, sol, info = system.step(system.make_state(
            fibers=fibers, shell=shell, bodies=bodies))
        if not info.converged:
            raise SystemExit(f"small scene did not converge on {dev}")
        res[dev] = (sol.cpu().numpy(), new.fibers.x.cpu().numpy(),
                    new.bodies.position.cpu().numpy())
    a, b = res[device.type], res["cpu"]
    err_sol = float(np.abs(a[0] - b[0]).max() / np.abs(b[0]).max())
    err_x = float(np.abs(a[1] - b[1]).max())
    err_pos = float(np.abs(a[2] - b[2]).max())
    log(f"[check] small coupled scene (200-node shell, 100-node body with 8 "
        f"bound fibers, 4 free fibers x 16 nodes, mixed): card vs CPU max "
        f"rel |d solution| = {err_sol:.3e}, max |dx| = {err_x:.3e}, max "
        f"|d body position| = {err_pos:.3e} (tolerance 1e-8)")
    if not max(err_sol, err_x, err_pos) <= 1e-8:
        raise SystemExit("card and CPU disagree on the small scene")


def phase_confined(torch, ck, device, work, args, card):
    """Ellipsoid config: precompute on the device, kernels C and D at its
    shape, then the run."""
    import numpy as np

    from skellysim_tpu_torch import precompute
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    run_dir = os.path.join(work, "ellipsoid")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    config = make_ellipsoid_config(cfg_path, args.ellipsoid_fibers,
                                   args.shell_nodes)
    log(f"[confined] wrote {args.ellipsoid_fibers} x 64-node fibers in a "
        f"{args.shell_nodes}-node ellipsoid in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stats = precompute.main([cfg_path, f"--device={device.type}"])
    log(f"[confined] precompute {time.perf_counter() - t0:.1f} s in all "
        f"(with the npz write): quadrature {stats['quadrature_s']:.2f} s, "
        f"assembly {stats['assembly_s']:.2f} s, inverse "
        f"{stats['inverse_s']:.2f} s, max ||M M_inv e_j - e_j|| over 8 "
        f"columns {stats['inverse_residual']:.3e}")

    with np.load(os.path.join(run_dir, config.periphery.precompute_file)) as z:
        shell_nodes, shell_normals = z["nodes"], z["normals"]
    fiber_nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                                  for f in config.fibers])
    del config
    rho = np.random.default_rng(11).standard_normal(shell_nodes.shape)
    f_dl = 2.0 * shell_normals[:, :, None] * rho[:, None, :]   # eta = 1
    entries = phase_kernels(torch, ck, device, [(
        "stresslet", shell_nodes, fiber_nodes, f_dl.reshape(-1, 9), False, [
            ("stresslet_f32", ck.stresslet_f32, torch.float32,
             ck.stresslet_f32_plain, PEAK_FP32, 1e-4,
             "skellysim_tpu/ops/pallas_kernels.py:204 (_stresslet_kernel)"),
            ("stresslet_f64", ck.stresslet_f64, torch.float64, None,
             PEAK_FP64, 1e-12,
             "skellysim_tpu/ops/pallas_df.py:195 (_stresslet_df_kernel)")])],
        card)
    shape_times(torch, ck, device, fiber_nodes, shell_nodes)
    del fiber_nodes, shell_nodes, shell_normals, f_dl
    if device.type == "cuda":
        torch.cuda.empty_cache()

    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run("confined", wall, counts, peak, steps, ELLIPSOID_STEPS, 1e-8,
               device, [w.__name__ for w in ck.KERNEL_WRAPPERS])
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    ok = len(reader) == ELLIPSOID_STEPS + 1
    for i in range(len(reader)):
        dens = np.asarray(reader.load_frame(i)["shell"]["solution_vec_"])
        ok = ok and dens.shape == (3 * args.shell_nodes,)
        ok = ok and bool(np.isfinite(dens).all())
        ok = ok and (i == 0 or bool(np.abs(dens).max() > 0))
    log(f"[confined] trajectory: {len(reader)} frames, times {reader.times}, "
        f"shell density {dens.shape}, max |density| {np.abs(dens).max():.4g}")
    if not ok:
        raise SystemExit("the confined trajectory does not hold finite shell "
                         "densities of the expected length in every frame")
    return entries, counts


def shape_times(torch, ck, device, fiber_nodes, shell_nodes):
    """Per-launch time of what the confined step repeats, at its own
    shapes, for the launches x time breakdown: kernels A and B with the
    fiber nodes as sources and every node as targets (the matvec's and the
    prep's fiber flow), and the dense [3N, 3N] shell products (operator in
    f32 and f64, the f32 inverse) as the step runs them."""
    import numpy as np

    rng = np.random.default_rng(13)
    every = np.concatenate([fiber_nodes, shell_nodes])
    force = rng.standard_normal(fiber_nodes.shape) / 63.0
    parts = []
    for name, kern, dt in (("stokeslet_f32", ck.stokeslet_f32, torch.float32),
                           ("stokeslet_f64", ck.stokeslet_f64,
                            torch.float64)):
        s, t, f = (torch.as_tensor(a, dtype=dt, device=device)
                   for a in (fiber_nodes, every, force))
        timed(torch, lambda: kern(s, t, f, 1.0), device, 1)
        ms = timed(torch, lambda: kern(s, t, f, 1.0), device, 3)[0]
        parts.append(f"{name} {ms:.3f} ms ({s.shape[0]} x {t.shape[0]})")
    n3 = 3 * shell_nodes.shape[0]
    for dt in (torch.float32, torch.float64):
        M = torch.randn((n3, n3), dtype=dt, device=device)
        x = torch.randn(n3, dtype=dt, device=device)
        timed(torch, lambda: M @ x, device, 1)
        ms = timed(torch, lambda: M @ x, device, 5)[0]
        parts.append(f"dense [{n3}, {n3}] {str(dt)[6:]} matvec {ms:.3f} ms")
        del M, x
    log("[confined] per-launch times at this path's shapes: "
        + "; ".join(parts))


def phase_bodies(torch, ck, device, work):
    """The 600-node sphere under a constant force, through the CLIs."""
    import numpy as np

    from skellysim_tpu_torch import precompute
    from skellysim_tpu_torch.io.trajectory import TrajectoryReader

    run_dir = os.path.join(work, "body_const_force")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    config = make_body_config(cfg_path)
    precompute.main([cfg_path, f"--device={device.type}"])
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run("bodies", wall, counts, peak, steps, BODY_STEPS,
               config.params.gmres_tol, device,
               ["stresslet_f32", "stresslet_f64"])
    with np.load(os.path.join(run_dir, config.bodies[0].precompute_file)) as z:
        r_eff = float(np.linalg.norm(z["node_positions_ref"][0]))
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    first, last = reader.load_frame(0), reader.load_frame(len(reader) - 1)
    z0 = float(first["bodies"][0][0]["position_"][2])
    z1 = float(last["bodies"][0][0]["position_"][2])
    v = (z1 - z0) / (last["time"] - first["time"])
    force, eta = config.bodies[0].external_force[2], config.params.eta
    v_theory = force / (6 * math.pi * eta * r_eff)
    err = abs(1 - v / v_theory)
    log(f"[bodies] sphere radius 0.5 (quadrature radius r_eff = {r_eff:.6g}), "
        f"{len(reader)} frames: v = {v:.12g}, F / (6 pi eta r_eff) = "
        f"{v_theory:.12g}, |1 - v / v_theory| = {err:.3e} (gate 1e-6)")
    if not err < 1e-6:
        raise SystemExit("the body misses the Stokes-drag gate")
    return counts, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--fibers", type=int, default=10_000,
                    help="fibers of the free-space path")
    ap.add_argument("--ellipsoid-fibers", type=int, default=2000)
    ap.add_argument("--shell-nodes", type=int, default=8000)
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
    work = tempfile.mkdtemp(prefix="skelly_smoke_")
    try:
        entries, launches, smi = run_phases(torch, ck, cuda_build,
                                            TrajectoryReader, device, args,
                                            work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    if device.type != "cuda":
        log("rehearsal on the CPU passed (no result line: nothing was "
            "measured on a card)")
        return 0
    for e in entries:
        e["launches_by_path"] = {path: c[e["name"]]
                                 for path, c in launches.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


def run_phases(torch, ck, cuda_build, TrajectoryReader, device, args, work):
    """Phases 1-7; returns (kernel entries, launch counts by path, the
    nvidia-smi line)."""
    import numpy as np

    # 1. device
    smi = None
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        log(f"[device] nvidia-smi: {smi}")
        log(f"[device] torch: {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s) visible, this run uses "
            f"one; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    if device.type == "cuda":
        names = (ck.SOURCE,)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as pool:
            infos = list(pool.map(cuda_build.build, names))
        log(f"[build] {len(names)} source(s) in parallel: "
            f"{time.perf_counter() - t0:.1f} s")
        for name, info in zip(names, infos):
            log(f"[build] {name}.cu: {info['seconds']:.1f} s "
                f"(cached={info['cached']}) -> "
                f"{os.path.relpath(info['path'], REPO)}")
            for line in info["ptxas"].splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling" in line or "warning" in line):
                    log(f"[build] ptxas: {line.strip()}")

    # 4's config first: its node positions are phase 3's inputs
    run_dir = os.path.join(work, "free_fibers_10k")
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "skelly_config.toml")
    t0 = time.perf_counter()
    config = make_config(cfg_path, args.fibers, T_FINAL)
    log(f"[run] wrote {args.fibers} x 64-node config in "
        f"{time.perf_counter() - t0:.1f} s")
    nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                            for f in config.fibers])
    del config

    # 3. kernels A and B vs plain
    f = np.random.default_rng(7).standard_normal(nodes.shape) / 63.0
    entries = phase_kernels(torch, ck, device, [(
        "stokeslet", nodes, nodes, f, True, [
            ("stokeslet_f32", ck.stokeslet_f32, torch.float32,
             ck.stokeslet_f32_plain, PEAK_FP32, 1e-4,
             "skellysim_tpu/ops/pallas_kernels.py:110 (_stokeslet_kernel)"),
            ("stokeslet_f64", ck.stokeslet_f64, torch.float64, None,
             PEAK_FP64, 1e-12,
             "skellysim_tpu/ops/pallas_df.py:158 (_stokeslet_df_kernel)")])],
        smi)
    del nodes, f
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 4. the free-space path
    launches = {}
    wall, counts, peak, steps = phase_run(torch, ck, device, cfg_path,
                                          run_dir)
    report_run("run", wall, counts, peak, steps, round(T_FINAL / 5e-3), 1e-8,
               device, ["stokeslet_f32", "stokeslet_f64"])
    launches["free_fibers_10k"] = counts
    reader = TrajectoryReader(os.path.join(run_dir, "skelly_sim.out"))
    last = reader.load_frame(len(reader) - 1)
    fibers = last["fibers"][1]
    xs = np.stack([m["x_"] for m in fibers])
    log(f"[run] trajectory: {len(reader)} frames, times {reader.times}, "
        f"last frame {len(fibers)} fibers, x {xs.shape}")
    if (len(reader) != len(steps) + 1 or abs(last["time"] - T_FINAL) > 1e-9
            or xs.shape != (args.fibers, 64, 3) or not np.isfinite(xs).all()):
        raise SystemExit("the trajectory does not hold the expected frames")
    shutil.rmtree(run_dir)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 5. small reference check
    phase_check_small(torch, device)

    # 6. the confined full-width path
    more, launches["ellipsoid"] = phase_confined(torch, ck, device, work,
                                                 args, smi)
    entries += more
    shutil.rmtree(os.path.join(work, "ellipsoid"))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # 7. the body scene at its published size
    launches["body_const_force"] = phase_bodies(torch, ck, device, work)[0]

    # each kernel's launches: those of the path its slice ported it for
    path_of = {"stokeslet_f32": "free_fibers_10k",
               "stokeslet_f64": "free_fibers_10k",
               "stresslet_f32": "ellipsoid", "stresslet_f64": "ellipsoid"}
    for e in entries:
        e["launches"] = launches[path_of[e["name"]]][e["name"]]
    return entries, launches, smi


if __name__ == "__main__":
    sys.exit(main())
