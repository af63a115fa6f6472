"""Standalone trajectory frame indexing/loading for the ParaView readers.

Counterpart of the reference `paraview_utils/trajectory_utility.py` (the
port's copy of the JAX package's): no package imports, so ParaView's Python
can exec it next to the reader scripts. Handles both single-file
trajectories (`python -m skellysim_tpu_torch` writes `skelly_sim.out`,
`io.trajectory.FieldWriter` writes `skelly_sim.vf`) and the reference's
per-rank multi-file layout (`skelly_sim.out.0`, `.1`, ...).
"""

import msgpack


class DesyncError(Exception):
    pass


def get_frame_info(filenames):
    """(file handles, per-file frame offsets, times) for a set of trajectory
    files; skips each file's header frame."""
    if not filenames:
        return [], [], []

    fhs, fpos_all, times = [], [], []
    for filename in filenames:
        f = open(filename, "rb")
        fhs.append(f)
        unpacker = msgpack.Unpacker(f, raw=False)
        fpos = []
        ftimes = []
        while True:
            try:
                pos = unpacker.tell()
                obj = unpacker.unpack()
            except msgpack.exceptions.OutOfData:
                break
            if isinstance(obj, dict) and "time" in obj:
                fpos.append(pos)
                ftimes.append(obj["time"])
        fpos_all.append(fpos)
        if not times:
            times = ftimes
        elif times != ftimes:
            raise DesyncError("trajectory files disagree on frame times")
    return fhs, fpos_all, times


def load_frame(fhs, fpos, index):
    """Merge the index-th frame across files; fibers concatenate, bodies and
    shell come from the first file (rank 0 in the reference layout)."""
    data = []
    for i in range(len(fhs)):
        fhs[i].seek(fpos[i][index])
        data.append(msgpack.Unpacker(fhs[i], raw=False).unpack())

    time, dt = data[0]["time"], data[0]["dt"]
    fibers = []
    for el in data:
        if el["time"] != time or el["dt"] != dt:
            raise DesyncError
        fibers.extend(el["fibers"][1])
        el.pop("fibers")

    frame = data[0]
    frame["fibers"] = fibers
    # flatten [spherical, deformable, ellipsoidal] sublists
    frame["bodies"] = [b for sub in frame["bodies"] for b in sub]
    return frame


def load_field_frame(fhs, fpos, index):
    """Raw per-file frames of a velocity-field dump (no merging)."""
    data = []
    for i in range(len(fhs)):
        fhs[i].seek(fpos[i][index])
        data.append(msgpack.Unpacker(fhs[i], raw=False).unpack())
    return data


def eigen_points(field):
    """['__eigen__', rows, cols, ...] -> list of [x, y, z] points."""
    rows, cols = field[1], field[2]
    flat = field[3:]
    if rows == 3:
        return [flat[3 * i:3 * i + 3] for i in range(cols)]
    if cols == 1 or rows == 1:
        n = len(flat) // 3
        return [flat[3 * i:3 * i + 3] for i in range(n)]
    raise ValueError(f"cannot interpret eigen field {rows}x{cols} as points")
