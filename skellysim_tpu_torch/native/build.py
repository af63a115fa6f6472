"""Compile-on-first-use loader for the native trajectory helpers.

Each helper is one ``native/<name>.cpp`` with a plain C interface, compiled
by ``g++ -O3 -shared -fPIC -std=c++17`` into ``skellysim_tpu_torch/_build/``
(git-ignored; named by a hash of the source and the flags, so an edited
source never loads a stale build) and loaded with `ctypes`. A build goes to
a per-process temporary name and is renamed into place, so processes that
build at once (test workers) never load a half-written file.

Where no ``g++`` is on ``PATH``, `load_library` logs one warning and
returns None, and the callers take their numpy path. Any other failure (a
compile error, a library that does not load) raises: an error in the
repo's own C++ never passes as a slower run.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_CACHE: dict = {}
_WARNED = []


def library_path(name: str) -> Path:
    """Build path of ``native/<name>.cpp``'s library, keyed by the source
    and the flags."""
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists already;
    returns the library's path. A failed compile raises with g++'s
    output."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"native/{name}.cpp:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str):
    """``native/<name>.cpp`` built and loaded (a `ctypes.CDLL`, cached per
    process), or None when there is no ``g++`` on ``PATH``."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        if shutil.which("g++") is None:
            if not _WARNED:
                _WARNED.append(True)
                logging.getLogger("skellysim_tpu_torch").warning(
                    "no g++ on PATH: the native trajectory encoder and "
                    "scanner are not built; taking the numpy paths")
            return None
        lib = ctypes.CDLL(str(build(name)))
        _CACHE[name] = lib
        return lib
