"""Trajectory writer/reader (reference trajectory format v1).

Counterpart of `skellysim_tpu.io.trajectory` through its pure-Python
field-vectorized encoder: a header map, then one msgpack map per frame
{time, dt, rng_state, fibers, bodies, shell}. Fibers are written in config
order (`config_rank`), active slots only; bodies as [spheres, deformables,
ellipsoids], each kind in config order; the shell as its density. So the
wire matches the JAX package's and decodes with `skellysim_tpu.io.trajectory`
and the reference tools.

The trajectory doubles as the checkpoint: `resume_state` rebuilds a
`SimState` from the last frame (`--resume`). The reader seeks through a
``<path>.cindex`` side file {mtime, size, offsets, times}, the JAX package's
and the reference's index format, built by `build_index` when missing or
stale; frames are decoded from a memory map, so reading one frame of a
large trajectory touches only that frame's bytes.
"""

from __future__ import annotations

import mmap
import os
import platform
import time as _time

import numpy as np

from .. import TRAJECTORY_VERSION, __version__
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
                "orientation_": ["__quat__"] + orient[i].tolist(),
                "solution_vec_": eigen.pack_matrix(sol[i]),
            }))
    entries.sort(key=lambda t: t[0])
    return [[m for _, s, m in entries if s], [],
            [m for _, s, m in entries if not s]]


def frame_bytes(state, rng_state=None) -> bytes:
    """Raw msgpack bytes of a trajectory-v1 frame."""
    from ..fibers.container import as_buckets, strip_node_padding

    entries = []
    for g in as_buckets(state.fibers):
        # masked node padding never reaches the wire: a bucketized run
        # writes an unpadded run's frames
        entries.extend(_fiber_chunk_bytes(strip_node_padding(g)))
    if entries:
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


def _shell_wire_density(state) -> np.ndarray:
    """The shell density as the wire carries it: live quadrature rows
    only (a padded shell's masked rows hold exact zeros)."""
    if state.shell is None:
        return np.zeros(0)
    density = _np(state.shell.density, np.float64)
    if state.shell.node_mask is not None:
        density = density[:3 * int(state.shell.node_mask.sum())]
    return density


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


def _map(path: str):
    with open(path, "rb") as fh:
        return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)


def build_index(path: str):
    """Frame (offsets, times), written to ``<path>.cindex`` in the JAX
    package's format ({mtime: int, size, offsets, times}), which its reader
    and the reference's take without a rebuild. The file is stat'ed before
    the scan, so a frame appended meanwhile invalidates the index."""
    st = os.stat(path)
    mm = _map(path)
    try:
        offsets, times = _scan(mm)
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
