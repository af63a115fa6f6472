"""The port's trajectory encoder, scanner and their native builds against
the JAX package's.

* `state_to_frame` packed (by the port's `msgpack_lite` and by the `msgpack`
  package) equals `frame_bytes`, and both equal the JAX package's
  `frame_bytes` / `state_to_frame` of the same state: one bucket, two
  resolutions with bodies and a shell, a bucket with no active fiber, no
  fibers;
* the native encoder (`native/frameenc.cpp`) equals the numpy path, and
  both equal the JAX bytes; `frame_bytes` takes it where the JAX package
  does (one bucket in config order);
* `build_index` with the native scanner equals the Python scan and the JAX
  package's offsets and times (a truncated last frame too), and the JAX
  reader takes the port's `.cindex` without a rebuild;
* the loader (`native/build.py`): two processes building at once both load
  a whole library; a compile error raises; no `g++` gives None, one
  warning, and the numpy bytes.

The native cases skip only where there is no `g++` on PATH.
"""

import logging
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

from skellysim_tpu.io import trajectory as jtraj
from skellysim_tpu.params import Params as JParams
from skellysim_tpu.system import SimState as JSimState
from skellysim_tpu.system import System as JSystem
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.io import msgpack_lite
from skellysim_tpu_torch.io import trajectory as ttraj
from skellysim_tpu_torch.native import build as nbuild
from tests.test_torch_resume import _jax_fibers, _leaves, _mixed_scene

REPO = Path(__file__).resolve().parent.parent
NATIVE = pytest.mark.skipif(shutil.which("g++") is None,
                            reason="no g++ on PATH: the port takes its "
                            "numpy paths")
RNG_STATE = [1, "abc", [["shared", "1:0:3"]]]


def _single_scene(nf=300, n=16, all_inactive=False):
    """One bucket: random active slots, bindings, clamps and tension."""
    rng = np.random.default_rng(13)
    g = _jax_fibers(nf, n, seed=13)
    active = (np.zeros(nf, bool) if all_inactive
              else rng.random(nf) > 0.1)
    g = g._replace(
        active=jnp.asarray(active),
        binding_body=jnp.asarray(rng.integers(-1, 300, nf), jnp.int32),
        binding_site=jnp.asarray(rng.integers(-1, 70000, nf), jnp.int32),
        penalty=jnp.asarray(rng.uniform(10, 1000, nf)))
    jstate = JSystem(JParams()).make_state(fibers=g)._replace(
        time=jnp.float64(1.25), dt=jnp.float64(0.05))
    tstate = convert.state_from_numpy(_leaves(g), time=1.25, dt=0.05,
                                      device="cpu")
    return jstate, tstate


def _scene(name):
    if name == "single":
        return _single_scene()
    if name == "none_active":
        return _single_scene(nf=5, all_inactive=True)
    if name == "mixed":
        return _mixed_scene()
    jstate = JSimState(time=jnp.float64(0.5), dt=jnp.float64(0.01),
                       fibers=None, points=None, background=None)
    return jstate, convert.state_from_numpy(None, time=0.5, dt=0.01,
                                            device="cpu")


@pytest.mark.parametrize("scene", ["single", "mixed", "none_active",
                                   "no_fibers"])
def test_state_to_frame_packs_to_frame_bytes_and_the_jax_frame(scene):
    jstate, tstate = _scene(scene)
    raw = ttraj.frame_bytes(tstate, rng_state=RNG_STATE)
    frame = ttraj.state_to_frame(tstate, rng_state=RNG_STATE)
    assert msgpack_lite.packb(frame) == raw
    assert msgpack.packb(frame) == raw
    assert raw == jtraj.frame_bytes(jstate, rng_state=RNG_STATE)
    assert raw == msgpack.packb(jtraj.state_to_frame(jstate,
                                                     rng_state=RNG_STATE))
    assert msgpack.unpackb(raw, raw=False) == jtraj.state_to_frame(
        jstate, rng_state=RNG_STATE)


@NATIVE
def test_native_encoder_matches_numpy_and_jax(monkeypatch):
    jstate, tstate = _single_scene()
    native = ttraj._fiber_array_bytes_native(tstate.fibers)
    assert native is not None
    assert native == ttraj._fiber_array_bytes_py(tstate.fibers)
    assert native == jtraj._fiber_array_bytes_py(jstate.fibers)
    # frame_bytes through the native encoder (one bucket in config order)
    # and with it taken away: the same bytes, the JAX package's
    calls = []
    real = ttraj._fiber_array_bytes_native
    monkeypatch.setattr(ttraj, "_fiber_array_bytes_native",
                        lambda g: calls.append(1) or real(g))
    with_native = ttraj.frame_bytes(tstate)
    assert calls == [1]
    monkeypatch.setattr(ttraj, "load_library", lambda name: None)
    assert ttraj.frame_bytes(tstate) == with_native
    assert with_native == jtraj.frame_bytes(jstate)


def _write_trajectory(path, truncated):
    _, tstate = _single_scene(nf=40)
    with ttraj.TrajectoryWriter(path) as tw:
        for k in range(5):
            tw.write_frame(tstate._replace(time=0.125 * k),
                           rng_state=[["shared", f"1:0:{k}"]])
    if truncated:
        # a write cut short: half of one more frame
        raw = ttraj.frame_bytes(tstate._replace(time=9.0))
        with open(path, "ab") as fh:
            fh.write(raw[:len(raw) // 2])


@NATIVE
@pytest.mark.parametrize("truncated", [False, True])
def test_native_index_matches_python_and_jax(tmp_path, monkeypatch,
                                             truncated):
    path = str(tmp_path / "skelly_sim.out")
    _write_trajectory(path, truncated)
    py = ttraj.build_index(path, use_native=False)
    jx = jtraj.build_index(path, use_native=False)
    nat = ttraj.build_index(path, use_native=True)
    assert nat == py == (list(jx[0]), list(jx[1]))
    assert nat[1] == [0.0, 0.125, 0.25, 0.375, 0.5]
    # the port's .cindex (written last) is taken by the JAX reader as it is
    monkeypatch.setattr(jtraj, "build_index", _refuse)
    jr = jtraj.TrajectoryReader(path)
    assert (jr._fpos, jr.times) == nat
    jr.close()
    with ttraj.TrajectoryReader(path) as tr:
        assert (tr._offsets, tr.times) == nat


def _refuse(*a, **k):
    raise AssertionError("the index was rebuilt")


_BUILDER = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from skellysim_tpu_torch.native import build
    build.BUILD_DIR = Path({build_dir!r})
    go = Path({go!r})
    while not go.exists():
        time.sleep(0.005)
    lib = build.load_library("trajscan")
    # the whole library: its scanner finds the one frame of a small buffer
    import ctypes
    buf = bytes([0x81, 0xa4]) + b"time" + bytes([0xcb, 0x3f, 0xf8]) + bytes(6)
    offs = ctypes.POINTER(ctypes.c_uint64)()
    times = ctypes.POINTER(ctypes.c_double)()
    lib.trajscan_buffer.restype = ctypes.c_int64
    n = lib.trajscan_buffer(buf, len(buf), ctypes.byref(offs),
                            ctypes.byref(times))
    assert (n, offs[0], times[0]) == (1, 0, 1.5), (n, times[0])
    print(build.library_path("trajscan"))
""")


@NATIVE
def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    build_dir, go = tmp_path / "_build", tmp_path / "go"
    code = _BUILDER.format(repo=str(REPO), build_dir=str(build_dir),
                           go=str(go))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.parent == build_dir and lib.exists()
    # no temporary file is left behind
    assert sorted(p.name for p in build_dir.iterdir()) == [lib.name]


@NATIVE
def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "frameenc.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(nbuild, "SRC_DIR", tmp_path / "src")
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nbuild, "_CACHE", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nbuild.load_library("frameenc")
    assert not list((tmp_path / "_build").iterdir())


def test_no_compiler_takes_the_numpy_path_with_one_warning(monkeypatch,
                                                           caplog):
    jstate, tstate = _single_scene(nf=30)
    monkeypatch.setattr(nbuild, "_CACHE", {})
    monkeypatch.setattr(nbuild, "_WARNED", [])
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING, logger="skellysim_tpu_torch"):
        assert nbuild.load_library("frameenc") is None
        assert ttraj._fiber_array_bytes_native(tstate.fibers) is None
        raw = ttraj.frame_bytes(tstate)
    assert sum("no g++" in r.getMessage() for r in caplog.records) == 1
    assert raw == jtraj.frame_bytes(jstate)


@NATIVE
def test_libraries_build_into_the_build_directory():
    for name in ("frameenc", "trajscan"):
        lib = nbuild.library_path(name)
        assert nbuild.load_library(name) is not None
        assert lib.parent == REPO / "skellysim_tpu_torch" / "_build"
        assert lib.exists() and not os.path.exists(
            REPO / "skellysim_tpu_torch" / "native" / f"_{name}.so")
