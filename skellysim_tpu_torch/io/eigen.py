"""Wire-format helpers for the reference trajectory encoding.

Counterpart of `skellysim_tpu.io.eigen`: Eigen matrices travel as msgpack
arrays ``['__eigen__', rows, cols, <column-major data>]`` and quaternions as
``['__quat__', w, x, y, z]``, so frames written here decode with the JAX
package's and the reference's readers. Encoding goes through the port's own
`msgpack_lite`.
"""

from __future__ import annotations

import numpy as np

from .msgpack_lite import array_header, map_header, packb

__all__ = ["mp_array_header", "mp_map_header", "mp_doubles", "pack_matrix",
           "pack_matrix_bytes", "unpack_matrix", "pack_quat", "decode_tree"]

EIGEN_TAG = packb("__eigen__")


def mp_array_header(n: int) -> bytes:
    """Raw msgpack array header (fixarray / array16 / array32)."""
    return array_header(n)


def mp_map_header(n: int) -> bytes:
    """Raw msgpack map header (fixmap / map16 / map32)."""
    return map_header(n)


def mp_doubles(a: np.ndarray) -> np.ndarray:
    """[n, 9] uint8 rows: each double as msgpack float64 (0xcb + big-endian
    payload) — the vectorized payload encoder."""
    flat = np.ascontiguousarray(a, dtype=np.float64).reshape(-1)
    out = np.empty((flat.size, 9), dtype=np.uint8)
    out[:, 0] = 0xCB
    out[:, 1:] = flat.astype(">f8").view(np.uint8).reshape(flat.size, 8)
    return out


def pack_matrix_bytes(a: np.ndarray) -> bytes:
    """Raw msgpack bytes of an ``__eigen__`` list: a [n, 3] point cloud is
    the reference's 3 x n column-major matrix (rows=3, cols=n, row-major
    ravel), a vector is n x 1."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
        rows, cols, flat = a.shape[0], 1, a
    elif a.ndim == 2 and a.shape[1] == 3:
        rows, cols, flat = 3, a.shape[0], a.ravel()
    elif a.ndim == 2:
        rows, cols, flat = a.shape[0], a.shape[1], a.ravel(order="F")
    else:
        raise ValueError(f"cannot encode array of shape {a.shape}")
    return (mp_array_header(3 + flat.size) + EIGEN_TAG
            + packb(int(rows)) + packb(int(cols))
            + mp_doubles(flat).tobytes())


def pack_matrix(a: np.ndarray) -> list:
    """An ``__eigen__`` list (the form `packb` encodes; see
    `pack_matrix_bytes` for the layout)."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
        return ["__eigen__", a.shape[0], 1] + a.tolist()
    if a.ndim == 2 and a.shape[1] == 3:
        return ["__eigen__", 3, a.shape[0]] + a.ravel().tolist()
    if a.ndim == 2:
        return ["__eigen__", a.shape[0], a.shape[1]] + a.ravel(
            order="F").tolist()
    raise ValueError(f"cannot encode array of shape {a.shape}")


def unpack_matrix(d: list) -> np.ndarray:
    """Decode an ``__eigen__`` list."""
    rows, cols = d[1], d[2]
    data = np.asarray(d[3:], dtype=np.float64)
    if rows == 1 or cols == 1:
        return data
    if rows == 3:
        return data.reshape(cols, rows)
    return data.reshape(cols, rows).T


def pack_quat(q) -> list:
    """Encode a (w, x, y, z) quaternion as a ``__quat__`` list."""
    q = np.asarray(q, dtype=np.float64)
    return ["__quat__"] + q.tolist()


def decode_tree(d):
    """Recursively convert ``__eigen__``/``__quat__`` lists to numpy arrays."""
    if isinstance(d, list):
        if d and d[0] == "__eigen__":
            return unpack_matrix(d)
        if d and d[0] == "__quat__":
            return np.asarray(d[1:], dtype=np.float64)
        return [decode_tree(v) for v in d]
    if isinstance(d, dict):
        return {k: decode_tree(v) for k, v in d.items()}
    return d
