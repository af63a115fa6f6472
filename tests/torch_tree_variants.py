"""Kernels G / H (``csrc/tree_sums.cu``) against edited builds of their own
source, on the card, in turns in one process: the stage length (64 or 128
sources in both precisions, against the shipped 128 f32 / 64 f64) and the
group loop unrolled twice. Not collected by pytest.

    python tests/torch_tree_variants.py        # on a machine with a card

Inputs: phase 3's 640,000-node cloud of chip_smoke.py (``make_config``)
for G; for H, 8,000 nodes on a sphere of radius 6 onto them and the first
128,000 of the cloud's nodes scaled by 0.5 (a stand-in for phase 6's
ellipsoid shell, which needs the shell precompute). Both at tol 1e-4,
f32 and f64. Each build is compiled with ``cuda_build.NVCC_FLAGS`` into a
temporary directory and loaded with ctypes; each time is the mean of 3
launches after a warm-up, the builds timed in order and then in reverse.
Prints per (family, precision) every build's ms and its largest
difference from the shipped build, the first design's ms, and each
build's registers, spills and hot-loop SASS instructions a pair
(chip_smoke.py's phase 12 times the shipped build by target-lane class).
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from skellysim_tpu_torch.ops import cuda_build  # noqa: E402
from skellysim_tpu_torch.ops import evaluator as ev  # noqa: E402
from skellysim_tpu_torch.ops import treecode as ttc  # noqa: E402

STAGE = "constexpr int kStage = 512 / sizeof(T);"
LOOP = "#pragma unroll 1\n  for (int g = s; g < groups; g += S) {"
#: edits of the shipped source, by name
VARIANTS = {
    "shipped": {},
    "stage64": {STAGE: "constexpr int kStage = 64;"},
    "stage128": {STAGE: "constexpr int kStage = 128;"},
    "unroll2": {LOOP: LOOP.replace("unroll 1", "unroll 2")},
}


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build(work):
    """{name: (ctypes library, path, ptxas report)} of every variant, the
    nvcc runs started together."""
    text = (cuda_build.CSRC_DIR / "tree_sums.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for a, b in edits.items():
            if a not in src:
                raise SystemExit(f"variant {name}: {a!r} not in the source")
            src = src.replace(a, b)
        cu = os.path.join(work, f"tree_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(work, f"libtree_{name}.so")
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
               str(cuda_build.CSRC_DIR), "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{report}")
        libs[name] = (ctypes.CDLL(so), so, report)
    return libs


def launcher(lib, name, prec, device):
    fn = getattr(lib, f"{name}_launch")
    scalar = ctypes.c_float if prec == "f32" else ctypes.c_double
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, scalar,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(trg, src, pay, items, segs):
        out = torch.empty((trg.shape[0], 3), dtype=trg.dtype, device=device)
        rc = fn(trg.data_ptr(), src.data_ptr(), pay.data_ptr(),
                items.data_ptr(), segs.data_ptr(), out.data_ptr(),
                items.shape[0], 1.0,
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise SystemExit(f"{name}: launch failed, CUDA error {rc}")
        return out
    return run


def mean_ms(fn, device, reps=3):
    """(mean ms of ``reps`` launches after a warm-up, the last output)."""
    cs.timed(torch, fn, device, 1)
    return cs.timed(torch, fn, device, reps)


def main():
    if not torch.cuda.is_available():
        print("torch_tree_variants: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(f"[variants] {smi()}", flush=True)
    work = tempfile.mkdtemp(prefix="tree_variants_")
    try:
        return run_variants(device, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_variants(device, work):
    libs = build(work)
    for name, (_, so, report) in libs.items():
        sass = cs.sass_functions(cuda_build, so)
        for family, cols in (("G", 3), ("H", 9)):
            for c in ("f", "d"):
                pat = rf"tree_kernelI{c}Li{cols}E"
                per, fp64, _ = cs._sass_loop(sass, pat)
                regs, _ = cs.ptxas_usage(report, pat)
                print(f"[variants] {name} {family} "
                      f"{'f32' if c == 'f' else 'f64'}: {regs} registers, "
                      f"{cs.ptxas_spills(report, pat)} bytes spilled, SASS "
                      f"{per:.3f} a pair ({fp64:.3f} FP64)", flush=True)

    cfg = os.path.join(work, "cloud.toml")
    config = cs.make_config(cfg, 10_000, cs.T_FINAL)
    nodes = np.concatenate([np.asarray(f.x).reshape(-1, 3)
                            for f in config.fibers])
    f = np.random.default_rng(7).standard_normal(nodes.shape) / 63.0
    shell = np.random.default_rng(3).normal(size=(8000, 3))
    shell *= 6.0 / np.linalg.norm(shell, axis=1, keepdims=True)
    S = np.random.default_rng(4).standard_normal((8000, 9))
    cases = (("stokeslet", nodes, f, nodes),
             ("stresslet", shell, S,
              np.vstack([0.5 * nodes[:128_000], shell])))
    for family, src_np, pay_np, trg_np in cases:
        plan = ttc.plan_tree(np.vstack([src_np, trg_np]), tol=1e-4)
        for prec, dt in (("f32", torch.float32), ("f64", torch.float64)):
            src, pay, trg = (torch.as_tensor(a, dtype=dt, device=device)
                             for a in (src_np, pay_np, trg_np))
            anchors = ev.make_pair(plan, device).anchors
            geom = ttc.tree_geometry(plan, anchors, src, trg)
            ops = (geom.trg, geom.src, ttc.tree_payload(geom, pay))
            leaf = ttc._leaf_ids(plan, anchors[0].to(dt), geom.trg)
            items_v1, _ = ttc._segment_lists(plan, geom.counts, geom.cell_n,
                                             leaf, v1=True)
            kname = f"tree_{family}_{prec}"
            ms, ref = {}, None
            for name in list(VARIANTS) + list(VARIANTS)[::-1]:
                run = launcher(libs[name][0], kname, prec, device)
                t, out = mean_ms(lambda: run(*ops, geom.items, geom.segs),
                                 device)
                ms.setdefault(name, []).append(t)
                if ref is None:
                    ref = out
                diff = float((out.double() - ref.double()).abs().max()
                             / ref.double().abs().max())
                ms[name + " diff"] = diff
            v1 = launcher(libs["shipped"][0], f"{kname}_v1", prec, device)
            v1_ms, _ = mean_ms(lambda: v1(*ops, items_v1, geom.segs),
                               device)
            print(f"[variants] {kname} ({trg.shape[0]} targets, "
                  f"{src.shape[0]} sources; {geom.items.shape[0]} items): "
                  + "; ".join(f"{n} {np.mean(ms[n]):.3f} ms ("
                              + ", ".join(f"{x:.3f}" for x in ms[n])
                              + f"; max diff {ms[n + ' diff']:.1e})"
                              for n in VARIANTS)
                  + f"; first design {v1_ms:.3f} ms; {smi()}", flush=True)
            del geom, ops, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
