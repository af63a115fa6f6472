"""Trajectory writer/reader (reference trajectory format v1).

Counterpart of `skellysim_tpu.io.trajectory`: a header map, then one
msgpack map per frame {time, dt, rng_state, fibers, bodies, shell}. Fibers
are written in config order (`config_rank`), active slots only; bodies as
[spheres, deformables, ellipsoids], each kind in config order; the shell as
its density. So the wire matches the JAX package's and decodes with
`skellysim_tpu.io.trajectory` and the reference tools. `state_to_frame`
gives the frame as an object map; `frame_bytes` gives its bytes directly,
through the native C++ encoder (`native/frameenc.cpp`) where the fibers are
one bucket in config order, as in the JAX package, else through the numpy
field-vectorized encoder. `FieldWriter` writes velocity-field frames
(``skelly_sim.vf``) for `paraview_utils/field_reader.py`.

The trajectory doubles as the checkpoint: `resume_state` rebuilds a
`SimState` from the last frame (`--resume`). The reader seeks through a
``<path>.cindex`` side file {mtime, size, offsets, times}, the JAX package's
and the reference's index format, built by `build_index` (the native
scanner, `native/trajscan.cpp`, or a Python scan) when missing or stale;
frames are decoded from a memory map, so reading one frame of a large
trajectory touches only that frame's bytes.

The native helpers are built with ``g++`` at first use; with no ``g++`` on
``PATH`` the numpy paths run (one warning), and any other failure of the
native build raises (`native.build`).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import platform
import time as _time

import numpy as np

from .. import TRAJECTORY_VERSION, __version__
from ..native import load_library
from . import eigen
from .msgpack_lite import OutOfData, packb, unpack_at

FIBER_TYPE_NONE = 0
FIBER_TYPE_FINITE_DIFFERENCE = 1

_FIBER_KEYS = ["n_nodes_", "radius_", "length_", "length_prev_",
               "bending_rigidity_", "penalty_param_", "force_scale_",
               "beta_tstep_", "binding_site_", "tension_", "x_",
               "minus_clamped_"]
_FIBER_KEY_BYTES = [packb(k) for k in _FIBER_KEYS]
_SCALAR_FIELDS = ("radius", "length", "length_prev", "bending_rigidity",
                  "penalty", "force_scale", "beta_tstep")


def _np(t, dtype=None):
    a = t.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _bucket_list(fibers) -> list:
    """SimState.fibers as a list of buckets, masked node padding stripped:
    a bucketized run writes an unpadded run's frames."""
    from ..fibers.container import as_buckets, strip_node_padding

    return [strip_node_padding(g) for g in as_buckets(fibers)]


def _active_ranks(group) -> np.ndarray:
    """Config-order ranks of the active slots (slot order)."""
    active = _np(group.active)
    if group.config_rank is None:
        return np.flatnonzero(active)
    return _np(group.config_rank)[active]


def _fiber_maps(group) -> list:
    """Per-active-fiber msgpack maps (the reference's field set), one host
    transfer per field."""
    x = _np(group.x, np.float64)
    tension = _np(group.tension, np.float64)
    n_nodes = int(x.shape[1])
    scalars = [_np(getattr(group, f), np.float64).tolist()
               for f in _SCALAR_FIELDS]
    binding = np.stack([_np(group.binding_body), _np(group.binding_site)],
                       axis=1).tolist()
    minus_clamped = _np(group.minus_clamped).tolist()
    return [{
        "n_nodes_": n_nodes,
        **{k: scalars[j][i] for j, k in enumerate(_FIBER_KEYS[1:8])},
        "binding_site_": binding[i],
        "tension_": eigen.pack_matrix(tension[i]),
        "x_": eigen.pack_matrix(x[i]),
        "minus_clamped_": minus_clamped[i],
    } for i in np.nonzero(_np(group.active))[0]]


def _body_maps(bodies):
    """Bodies as [spherical, deformable, ellipsoidal] lists of maps, each
    kind in config order (`config_rank`) across buckets."""
    from ..bodies.bodies import as_buckets

    entries = []                       # (rank, is_sphere, map)
    for g in as_buckets(bodies):
        pos = _np(g.position, np.float64)
        orient = _np(g.orientation, np.float64)
        sol = _np(g.solution, np.float64)
        radius = _np(g.radius, np.float64).tolist()
        kind_sphere = _np(g.kind_sphere).tolist()
        ranks = _np(g.config_rank).tolist()
        for i in range(pos.shape[0]):
            entries.append((ranks[i], kind_sphere[i], {
                "radius_": radius[i],
                "position_": eigen.pack_matrix(pos[i]),
                "orientation_": eigen.pack_quat(orient[i]),
                "solution_vec_": eigen.pack_matrix(sol[i]),
            }))
    entries.sort(key=lambda t: t[0])
    return [[m for _, s, m in entries if s], [],
            [m for _, s, m in entries if not s]]


def _shell_wire_density(state) -> np.ndarray:
    """The shell density as the wire carries it: live quadrature rows
    only (a padded shell's masked rows hold exact zeros)."""
    if state.shell is None:
        return np.zeros(0)
    density = _np(state.shell.density, np.float64)
    if state.shell.node_mask is not None:
        density = density[:3 * int(state.shell.node_mask.sum())]
    return density


def state_to_frame(state, rng_state=None) -> dict:
    """A SimState as a trajectory-v1 frame map; fibers of several buckets
    merge back into config order. ``packb(state_to_frame(s))`` equals
    ``frame_bytes(s)``."""
    buckets = _bucket_list(state.fibers)
    if buckets:
        entries = []
        for g in buckets:
            entries.extend(zip(_active_ranks(g).tolist(), _fiber_maps(g)))
        entries.sort(key=lambda t: t[0])
        fibers_field = [FIBER_TYPE_FINITE_DIFFERENCE, [m for _, m in entries]]
    else:
        fibers_field = [FIBER_TYPE_NONE, []]
    return {
        "time": float(state.time),
        "dt": float(state.dt),
        "rng_state": rng_state if rng_state is not None else [],
        "fibers": fibers_field,
        "bodies": _body_maps(state.bodies),
        "shell": {"solution_vec_": eigen.pack_matrix(
            _shell_wire_density(state))},
    }


def _fiber_chunk_bytes(group) -> list:
    """(config rank, msgpack map bytes) per active fiber, field-vectorized:
    one host transfer per field, one vectorized double encode per field."""
    x = _np(group.x, np.float64)
    tension = _np(group.tension, np.float64)
    active = np.nonzero(_np(group.active))[0]
    ranks = (_np(group.config_rank) if group.config_rank is not None
             else np.arange(x.shape[0]))
    nf, n = x.shape[0], int(x.shape[1])
    scalars = [eigen.mp_doubles(_np(getattr(group, f), np.float64))
               for f in _SCALAR_FIELDS]
    binding = np.stack([_np(group.binding_body), _np(group.binding_site)],
                       axis=1).tolist()
    minus_clamped = _np(group.minus_clamped)
    tension_rows = eigen.mp_doubles(tension).reshape(nf, n * 9)
    x_rows = eigen.mp_doubles(x).reshape(nf, 3 * n * 9)
    tension_head = (eigen.mp_array_header(3 + n) + eigen.EIGEN_TAG
                    + packb(n) + packb(1))
    x_head = (eigen.mp_array_header(3 + 3 * n) + eigen.EIGEN_TAG
              + packb(3) + packb(n))
    kb = _FIBER_KEY_BYTES
    map_head = eigen.mp_map_header(len(_FIBER_KEYS))
    n_nodes_b = packb(n)
    out = []
    for i in active:
        out.append((int(ranks[i]), b"".join([
            map_head,
            kb[0], n_nodes_b,
            *[b for j in range(7)
              for b in (kb[1 + j], scalars[j][i].tobytes())],
            kb[8], packb([int(v) for v in binding[i]]),
            kb[9], tension_head, tension_rows[i].tobytes(),
            kb[10], x_head, x_rows[i].tobytes(),
            kb[11], packb(bool(minus_clamped[i])),
        ])))
    return out


def _fiber_array_bytes_py(group) -> bytes:
    """msgpack bytes of the active-fiber map array (slot order), numpy
    field-vectorized."""
    chunks = _fiber_chunk_bytes(group)
    return (eigen.mp_array_header(len(chunks))
            + b"".join(c for _, c in chunks))


def _fiber_array_bytes_native(group):
    """The same bytes from the C++ encoder (`native/frameenc.cpp`); None
    when there is no ``g++``."""
    lib = load_library("frameenc")
    if lib is None:
        return None
    dbl = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.frameenc_fibers.restype = ctypes.c_int64
    lib.frameenc_fibers.argtypes = [dbl] * 9 + [
        ctypes.POINTER(ctypes.c_int32), u8, u8, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(u8), ctypes.POINTER(ctypes.c_uint64)]
    lib.frameenc_free.restype = None
    lib.frameenc_free.argtypes = [u8]

    def host(t, dtype):
        return np.ascontiguousarray(_np(t, dtype))

    x = host(group.x, np.float64)
    nf, n = x.shape[0], x.shape[1]
    doubles = [x, host(group.tension, np.float64)] + [
        host(getattr(group, f), np.float64) for f in _SCALAR_FIELDS]
    binding = np.ascontiguousarray(np.stack(
        [_np(group.binding_body), _np(group.binding_site)],
        axis=1).astype(np.int32))
    active = host(group.active, np.uint8)
    mclamp = host(group.minus_clamped, np.uint8)
    out_p = u8()
    out_len = ctypes.c_uint64()
    rc = lib.frameenc_fibers(
        *[a.ctypes.data_as(dbl) for a in doubles],
        binding.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        active.ctypes.data_as(u8), mclamp.ctypes.data_as(u8),
        nf, n, ctypes.byref(out_p), ctypes.byref(out_len))
    if rc < 0:
        raise RuntimeError(f"frameenc_fibers failed ({rc}) on {nf} fibers "
                           f"x {n} nodes")
    try:
        return ctypes.string_at(out_p, out_len.value)
    finally:
        lib.frameenc_free(out_p)


def _fiber_array_bytes(group) -> bytes:
    """msgpack bytes of the active-fiber map array: the native encoder,
    or the numpy one where there is no ``g++``."""
    native = _fiber_array_bytes_native(group)
    return native if native is not None else _fiber_array_bytes_py(group)


def frame_bytes(state, rng_state=None) -> bytes:
    """Raw msgpack bytes of a trajectory-v1 frame, equal to
    ``packb(state_to_frame(state, rng_state))``."""
    buckets = _bucket_list(state.fibers)
    if len(buckets) == 1 and np.all(np.diff(_active_ranks(buckets[0])) > 0):
        # one bucket in config order: the native encoder's case
        fibers_b = (eigen.mp_array_header(2)
                    + packb(FIBER_TYPE_FINITE_DIFFERENCE)
                    + _fiber_array_bytes(buckets[0]))
    elif buckets:
        # several resolutions (or permuted ranks): per-fiber chunks merged
        # back into config order
        entries = []
        for g in buckets:
            entries.extend(_fiber_chunk_bytes(g))
        entries.sort(key=lambda t: t[0])
        fibers_b = (eigen.mp_array_header(2)
                    + packb(FIBER_TYPE_FINITE_DIFFERENCE)
                    + eigen.mp_array_header(len(entries))
                    + b"".join(c for _, c in entries))
    else:
        fibers_b = packb([FIBER_TYPE_NONE, []])
    return b"".join([
        eigen.mp_map_header(6),
        packb("time"), packb(float(state.time)),
        packb("dt"), packb(float(state.dt)),
        packb("rng_state"), packb(rng_state if rng_state is not None else []),
        packb("fibers"), fibers_b,
        packb("bodies"), packb(_body_maps(state.bodies)),
        packb("shell"),
        eigen.mp_map_header(1) + packb("solution_vec_")
        + eigen.pack_matrix_bytes(_shell_wire_density(state)),
    ])


class TrajectoryWriter:
    """Appends header + frames to a trajectory file."""

    def __init__(self, path: str, *, append: bool = False,
                 fiber_type: int = FIBER_TYPE_FINITE_DIFFERENCE):
        self.path = path
        self._fh = open(path, "ab" if append else "wb")
        if not append:
            self._fh.write(packb({
                "trajversion": TRAJECTORY_VERSION,
                "number_mpi_ranks": 1,
                "fiber_type": fiber_type,
                "skellysim_version": __version__,
                "skellysim_commit": "skellysim_tpu_torch",
                "simdate": _time.strftime("%Y-%m-%d %H:%M:%S"),
                "hostname": platform.node(),
            }))
            self._fh.flush()

    def write_frame(self, state, solution=None, *, rng_state=None):
        """Append one frame; ``solution`` is accepted and ignored so this
        can be passed as ``System.run(..., writer=tw.write_frame)``."""
        self._fh.write(frame_bytes(state, rng_state))
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FieldWriter:
    """Appends velocity-field frames {time, dt, x_grid, v_grid} in the
    reference's ``skelly_sim.vf`` layout (point clouds in the 3 x n
    ``__eigen__`` encoding), read by `paraview_utils/field_reader.py`.
    ``positions`` / ``velocities`` may be card tensors: a frame takes one
    copy to the host and no other sync."""

    def __init__(self, path: str = "skelly_sim.vf", *, append: bool = False):
        self.path = path
        self._fh = open(path, "ab" if append else "wb")

    def write_frame(self, time: float, positions, velocities, dt: float = 0.0):
        import torch

        def host(a):
            a = _np(a) if torch.is_tensor(a) else np.asarray(a)
            return a.astype(np.float64).reshape(-1, 3)

        if torch.is_tensor(positions) and torch.is_tensor(velocities):
            n = positions.reshape(-1, 3).shape[0]
            both = host(torch.cat([positions.reshape(-1, 3),
                                   velocities.reshape(-1, 3)]))
            x, v = both[:n], both[n:]
        else:
            x, v = host(positions), host(velocities)
        self._fh.write(b"".join([
            eigen.mp_map_header(4),
            packb("time"), packb(float(time)),
            packb("dt"), packb(float(dt)),
            packb("x_grid"), eigen.pack_matrix_bytes(x),
            packb("v_grid"), eigen.pack_matrix_bytes(v),
        ]))
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _scan(data):
    """(offsets, times) of every frame map in a trajectory buffer, each
    top-level object decoded in turn; a truncated last object (a write cut
    short) ends the scan."""
    offsets, times = [], []
    pos = 0
    while pos < len(data):
        try:
            obj, end = unpack_at(data, pos)
        except OutOfData:
            break
        if isinstance(obj, dict) and "time" in obj:
            offsets.append(pos)
            times.append(obj["time"])
        pos = end
    return offsets, times


def _scan_native(mm):
    """`_scan` by the C++ scanner (`native/trajscan.cpp`), which skips
    payloads undecoded; None when there is no ``g++``."""
    lib = load_library("trajscan")
    if lib is None:
        return None
    lib.trajscan_buffer.restype = ctypes.c_int64
    lib.trajscan_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.trajscan_free.restype = None
    lib.trajscan_free.argtypes = [ctypes.c_void_p]
    offsets_p = ctypes.POINTER(ctypes.c_uint64)()
    times_p = ctypes.POINTER(ctypes.c_double)()
    buf = np.frombuffer(mm, dtype=np.uint8)
    try:
        n = lib.trajscan_buffer(buf.ctypes.data, buf.size,
                                ctypes.byref(offsets_p), ctypes.byref(times_p))
    finally:
        del buf                        # the map closes only once unexported
    try:
        if n < 0:
            raise RuntimeError(f"trajscan_buffer failed ({n})")
        offsets = np.ctypeslib.as_array(offsets_p, shape=(max(n, 1),))[:n]
        times = np.ctypeslib.as_array(times_p, shape=(max(n, 1),))[:n]
        return offsets.tolist(), times.tolist()
    finally:
        lib.trajscan_free(offsets_p)
        lib.trajscan_free(times_p)


def _map(path: str):
    with open(path, "rb") as fh:
        return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)


def build_index(path: str, use_native: bool = True):
    """Frame (offsets, times), written to ``<path>.cindex`` in the JAX
    package's format ({mtime: int, size, offsets, times}), which its reader
    and the reference's take without a rebuild. ``use_native`` scans with
    the C++ scanner where there is a ``g++``, else in Python. The file is
    stat'ed before the scan, so a frame appended meanwhile invalidates the
    index."""
    st = os.stat(path)
    if st.st_size == 0:
        offsets, times = [], []
    else:
        mm = _map(path)
        try:
            res = _scan_native(mm) if use_native else None
            offsets, times = res if res is not None else _scan(mm)
        finally:
            mm.close()
    with open(path + ".cindex", "wb") as fh:
        fh.write(packb({"mtime": int(st.st_mtime), "size": st.st_size,
                        "offsets": offsets, "times": times}))
    return offsets, times


class TrajectoryReader:
    """Random-access frame reader: ``header``, ``times``, ``len()`` and
    `load_frame` (decoded with `eigen.decode_tree`). Frame offsets come
    from ``<path>.cindex`` when its mtime and size match the file, else
    from `build_index`."""

    def __init__(self, path: str = "skelly_sim.out"):
        self.path = path
        self._mm = _map(path)
        self.header = unpack_at(self._mm, 0)[0]
        if not (isinstance(self.header, dict)
                and "trajversion" in self.header):
            self._mm.close()
            raise ValueError(f"{path}: missing trajectory header")
        st = os.stat(path)
        offsets = times = None
        if os.path.exists(path + ".cindex"):
            with open(path + ".cindex", "rb") as fh:
                index = unpack_at(fh.read(), 0)[0]
            if (index.get("mtime") == int(st.st_mtime)
                    and index.get("size", st.st_size) == st.st_size):
                offsets, times = index["offsets"], index["times"]
        if offsets is None:
            offsets, times = build_index(path)
        self._offsets = offsets
        self.times = times

    def __len__(self):
        return len(self._offsets)

    def load_frame(self, i: int) -> dict:
        i = int(i)
        if i < 0:
            i += len(self)
        return eigen.decode_tree(unpack_at(self._mm, self._offsets[i])[0])

    def close(self):
        self._mm.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -------------------------------------------------------------------- resume

def frame_to_state(frame: dict, template_state, dtype=None):
    """Rebuild a SimState from a decoded frame
    (`skellysim_tpu.io.trajectory.frame_to_state`).

    Fibers are rebuilt from the frame (their parameters are serialized),
    regrouped by resolution in first-appearance order, with the frame
    position as ``config_rank`` so a re-written trajectory keeps the wire
    order; bodies and the shell keep their geometry and operators from
    ``template_state`` and take position / orientation / solution (bodies,
    mapped back through kind and ``config_rank``) and the density (shell)
    from the frame.
    """
    import torch

    from ..bodies.bodies import BodyGroup, as_buckets
    from ..fibers import container as fc
    from ..system.system import state_placement

    t_dtype, device = state_placement(template_state)
    dtype = t_dtype if dtype is None else dtype
    state = template_state

    fiber_maps = frame["fibers"][1] if frame["fibers"][0] else []
    if fiber_maps:
        by_n: dict = {}
        for rank, f in enumerate(fiber_maps):
            by_n.setdefault(int(f["n_nodes_"]), []).append((rank, f))

        def one_bucket(items):
            maps = [f for _, f in items]
            g = fc.make_group(
                np.stack([np.asarray(f["x_"]).reshape(-1, 3) for f in maps]),
                lengths=np.array([f["length_"] for f in maps]),
                bending_rigidity=np.array([f["bending_rigidity_"]
                                           for f in maps]),
                radius=np.array([f["radius_"] for f in maps]),
                penalty=np.array([f["penalty_param_"] for f in maps]),
                beta_tstep=np.array([f["beta_tstep_"] for f in maps]),
                force_scale=np.array([f["force_scale_"] for f in maps]),
                minus_clamped=np.array([f["minus_clamped_"] for f in maps]),
                binding_body=np.array([f["binding_site_"][0] for f in maps]),
                binding_site=np.array([f["binding_site_"][1] for f in maps]),
                config_rank=np.array([r for r, _ in items], dtype=np.int32),
                dtype=dtype, device=device)
            return g._replace(
                tension=torch.as_tensor(
                    np.stack([np.asarray(f["tension_"]) for f in maps]),
                    dtype=dtype, device=device),
                length_prev=torch.as_tensor(
                    [f["length_prev_"] for f in maps], dtype=dtype,
                    device=device))

        groups = [one_bucket(items) for items in by_n.values()]
        state = state._replace(
            fibers=groups[0] if len(groups) == 1 else tuple(groups))
    elif template_state.fibers is not None:
        state = state._replace(fibers=None)

    bodies_wire = [b for sub in frame["bodies"] for b in sub]
    if bodies_wire:
        b_list = list(as_buckets(state.bodies))
        if not b_list or sum(g.n_bodies for g in b_list) != len(bodies_wire):
            raise ValueError("trajectory bodies do not match the configured "
                             "state")
        # the wire holds [spheres..., ellipsoids...], each in config order:
        # map wire slots back to (bucket, slot) by kind and config_rank
        entries = []                   # (is_ellipsoid, rank, bucket, slot)
        for bi, g in enumerate(b_list):
            ks = g.kind_sphere.cpu().numpy()
            ranks = (g.config_rank.cpu().numpy()
                     if g.config_rank is not None else np.arange(g.n_bodies))
            for slot in range(g.n_bodies):
                entries.append((not bool(ks[slot]), int(ranks[slot]), bi,
                                slot))
        entries.sort()
        pos = [g.position.cpu().numpy().copy() for g in b_list]
        orient = [g.orientation.cpu().numpy().copy() for g in b_list]
        sol = [g.solution.cpu().numpy().copy() for g in b_list]
        for wire_slot, (_, _, bi, slot) in enumerate(entries):
            m = bodies_wire[wire_slot]
            pos[bi][slot] = m["position_"]
            orient[bi][slot] = m["orientation_"]
            sol[bi][slot] = m["solution_vec_"]
        new_b = tuple(
            g._replace(
                position=torch.as_tensor(pos[bi], dtype=dtype, device=device),
                orientation=torch.as_tensor(orient[bi], dtype=dtype,
                                            device=device),
                solution=torch.as_tensor(sol[bi], dtype=dtype, device=device))
            for bi, g in enumerate(b_list))
        state = state._replace(
            bodies=new_b[0] if isinstance(state.bodies, BodyGroup) else new_b)

    shell_sol = np.asarray(frame["shell"]["solution_vec_"])
    if (state.shell is not None
            and shell_sol.size == state.shell.density.shape[0]):
        state = state._replace(shell=state.shell._replace(
            density=torch.as_tensor(shell_sol.reshape(-1), dtype=dtype,
                                    device=device)))
    elif (state.shell is not None and state.shell.node_mask is not None
          and shell_sol.size == 3 * int(state.shell.node_mask.sum())):
        # live-rows wire density over a padded template: the padded rows
        # stay exact zero
        full = np.zeros(state.shell.density.shape[0])
        full[:shell_sol.size] = shell_sol.reshape(-1)
        state = state._replace(shell=state.shell._replace(
            density=torch.as_tensor(full, dtype=dtype, device=device)))
    # the wire carries no flight ring: `System.ensure_flight` arms a fresh
    # one where the window is on
    return state._replace(time=float(frame["time"]), dt=float(frame["dt"]),
                          flight=None)


def resume_state(path: str, template_state):
    """(state, rng_state, reader) from the last frame (`--resume`)."""
    reader = TrajectoryReader(path)
    if len(reader) == 0:
        reader.close()
        raise ValueError(f"{path}: no frames to resume from")
    frame = reader.load_frame(len(reader) - 1)
    return (frame_to_state(frame, template_state),
            frame.get("rng_state", []), reader)
