"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each source under ``skellysim_tpu_torch/csrc`` has a plain C interface and is
compiled by ``nvcc`` into a shared library under ``skellysim_tpu_torch/_build``
(git-ignored) at first use, then loaded with `ctypes`. No PyTorch header is
included, so a build takes seconds. Libraries are named by a hash of the
source, the shared headers and the flags, so an edited source never loads a
stale build, and a
finished build is reused by later processes. Nothing here runs at import.

Every library `load` builds or loads emits one ``compile`` event to the
active tracer (`obs.tracer`): the port's counterpart of the JAX package's
`observed_jit` compile events, with ``name`` ("cuda:<source>"),
``wall_s`` (build and load) and ``persistent_cache`` (True when the
library was already built). The service counts such events after its
warm-up (`serve.metrics`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: sm_90a: Hopper with its architecture-specific features (the `a` keeps
#: wgmma/setmaxnreg available to later kernels; plain sm_90 refuses them)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install prefix. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    """Build path of ``csrc/<name>.cu``'s library, keyed by the source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists already.

    Returns {"path", "seconds", "cached", "ptxas"} — ``ptxas`` holds the
    `-Xptxas -v` report (registers, shared memory, spills per kernel), kept
    beside the library so a cached build reports it too; a library with no
    report beside it is built again. A failed build raises with the
    compiler's output.
    """
    out = library_path(name)
    report = out.with_name(f"{out.name}.ptxas.txt")
    if out.exists() and report.exists():
        return {"path": str(out), "seconds": 0.0, "cached": True,
                "ptxas": report.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stdout}\n{proc.stderr}")
    ptxas = (proc.stdout + proc.stderr).strip()
    tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
    tmp_report.write_text(ptxas)
    os.replace(tmp_report, report)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return {"path": str(out), "seconds": seconds, "cached": False,
            "ptxas": ptxas}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library; one
    ``compile`` event to the active tracer."""
    from ..obs import tracer as obs_tracer

    t0 = time.perf_counter()
    info = build(name)
    lib = ctypes.CDLL(info["path"])
    obs_tracer.emit("compile", name=f"cuda:{name}",
                    wall_s=round(time.perf_counter() - t0, 6),
                    persistent_cache=info["cached"])
    return lib
