"""Trajectory writer/reader (reference trajectory format v1).

Counterpart of `skellysim_tpu.io.trajectory` through its pure-Python
field-vectorized encoder: a header map, then one msgpack map per frame
{time, dt, rng_state, fibers, bodies, shell}. Fibers are written in config
order (`config_rank`), active slots only; bodies as [spheres, deformables,
ellipsoids], each kind in config order; the shell as its density. So the
wire matches the JAX package's and decodes with `skellysim_tpu.io.trajectory`
and the reference tools. Resuming from a frame (`--resume`) is not ported yet (ROADMAP.md §1
item 7).
"""

from __future__ import annotations

import platform
import time as _time

import numpy as np

from .. import TRAJECTORY_VERSION, __version__
from . import eigen
from .msgpack_lite import iter_unpack, packb

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
    from ..fibers.container import as_buckets

    entries = []
    for g in as_buckets(state.fibers):
        entries.extend(_fiber_chunk_bytes(g))
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
        + eigen.pack_matrix_bytes(np.zeros(0) if state.shell is None
                                  else _np(state.shell.density, np.float64)),
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


class TrajectoryReader:
    """Reads a whole trajectory with the port's own msgpack decoder:
    ``header``, ``times``, ``len()`` and `load_frame` (decoded with
    `eigen.decode_tree`)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        objs = list(iter_unpack(data))
        if not objs or not (isinstance(objs[0][1], dict)
                            and "trajversion" in objs[0][1]):
            raise ValueError(f"{path}: missing trajectory header")
        self.header = objs[0][1]
        self._frames = [o for _, o in objs[1:]
                        if isinstance(o, dict) and "time" in o]
        self.times = [f["time"] for f in self._frames]

    def __len__(self):
        return len(self._frames)

    def load_frame(self, i: int) -> dict:
        return eigen.decode_tree(self._frames[int(i)])
