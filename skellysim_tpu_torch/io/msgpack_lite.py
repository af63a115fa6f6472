"""A small pure-Python msgpack encoder/decoder for the trajectory format.

The port does not depend on the `msgpack` package (the card's machine need
not have it). This covers the types the trajectory-v1 format and the
listener's messages use: nil, bool, int, float (32/64), str, bin, array
and map (numpy scalars pack as their Python values; anything else goes to
``packb``'s ``default=`` hook, as with the `msgpack` package). Long runs of
float64 elements (the ``__eigen__`` payloads) are decoded vectorized with
numpy, so a 10k-fiber frame (~2.5M doubles) decodes in well under a
second.
"""

from __future__ import annotations

import struct

import numpy as np


def _pack_into(out: list, obj, default=None) -> None:
    if isinstance(obj, np.generic):
        obj = obj.item()
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif 0 <= obj < 1 << 8:
            out.append(b"\xcc" + struct.pack(">B", obj))
        elif 0 <= obj < 1 << 16:
            out.append(b"\xcd" + struct.pack(">H", obj))
        elif 0 <= obj < 1 << 32:
            out.append(b"\xce" + struct.pack(">I", obj))
        elif 0 <= obj < 1 << 64:
            out.append(b"\xcf" + struct.pack(">Q", obj))
        elif -(1 << 7) <= obj:
            out.append(b"\xd0" + struct.pack(">b", obj))
        elif -(1 << 15) <= obj:
            out.append(b"\xd1" + struct.pack(">h", obj))
        elif -(1 << 31) <= obj:
            out.append(b"\xd2" + struct.pack(">i", obj))
        else:
            out.append(b"\xd3" + struct.pack(">q", obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for v in obj:
            _pack_into(out, v, default)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _pack_into(out, k, default)
            _pack_into(out, v, default)
    elif default is not None:
        new = default(obj)
        if new is obj:
            raise TypeError(f"cannot msgpack-encode {type(obj)!r}")
        _pack_into(out, new, default)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj)!r}")


def packb(obj, default=None) -> bytes:
    """msgpack bytes of ``obj``; ``default(o)`` turns an object of another
    type into one that packs (the `msgpack` package's hook)."""
    out: list = []
    _pack_into(out, obj, default)
    return b"".join(out)


def array_header(n: int) -> bytes:
    """Raw msgpack array header (fixarray / array16 / array32)."""
    if n < 16:
        return bytes([0x90 | n])
    if n < 65536:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


def map_header(n: int) -> bytes:
    """Raw msgpack map header (fixmap / map16 / map32)."""
    if n < 16:
        return bytes([0x80 | n])
    if n < 65536:
        return b"\xde" + n.to_bytes(2, "big")
    return b"\xdf" + n.to_bytes(4, "big")


class OutOfData(Exception):
    """The buffer ended inside an object."""


def _need(data, pos, n):
    if pos + n > len(data):
        raise OutOfData(f"need {n} bytes at offset {pos}, have "
                        f"{len(data) - pos}")


def _decode(data: bytes, pos: int):
    """Decode one object at ``pos``; returns (object, next position)."""
    _need(data, pos, 1)
    b = data[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if 0x80 <= b <= 0x8F:
        return _decode_map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _decode_array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        _need(data, pos, n)
        return data[pos:pos + n].decode("utf-8"), pos + n
    if b >= 0xE0:
        return b - 0x100, pos
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
        return fixed[b], pos
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        fmt = scalars[b]
        size = struct.calcsize(fmt)
        _need(data, pos, size)
        return struct.unpack_from(fmt, data, pos)[0], pos + size
    lengths = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
               0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
               0xDC: (">H", "array"), 0xDD: (">I", "array"),
               0xDE: (">H", "map"), 0xDF: (">I", "map")}
    if b in lengths:
        fmt, kind = lengths[b]
        size = struct.calcsize(fmt)
        _need(data, pos, size)
        n = struct.unpack_from(fmt, data, pos)[0]
        pos += size
        if kind == "array":
            return _decode_array(data, pos, n)
        if kind == "map":
            return _decode_map(data, pos, n)
        _need(data, pos, n)
        raw = data[pos:pos + n]
        return (raw.decode("utf-8") if kind == "str" else bytes(raw)), pos + n
    raise ValueError(f"unsupported msgpack type byte {b:#x} at {pos - 1}")


def _decode_array(data, pos, n):
    out = []
    while len(out) < n:
        if data[pos:pos + 1] == b"\xcb" and n - len(out) >= 8:
            # vectorized run of float64 elements (9 bytes each)
            avail = min(n - len(out), (len(data) - pos) // 9)
            buf = np.frombuffer(data, dtype=np.uint8, count=9 * avail,
                                offset=pos).reshape(avail, 9)
            tags = buf[:, 0] == 0xCB
            run = avail if tags.all() else int(np.argmin(tags))
            out.extend(np.ascontiguousarray(buf[:run, 1:]).view(">f8")
                       .ravel().tolist())
            pos += 9 * run
            continue
        v, pos = _decode(data, pos)
        out.append(v)
    return out, pos


def _decode_map(data, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _decode(data, pos)
        v, pos = _decode(data, pos)
        out[k] = v
    return out, pos


def unpack_at(data, pos: int):
    """Decode the object at ``pos`` of ``data`` (bytes, or any buffer such
    as an mmap): (object, next position)."""
    return _decode(data, pos)



def unpackb(data):
    """The one object that ``data`` (bytes) encodes; raises when bytes are
    left over or missing."""
    obj, pos = _decode(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes after the msgpack object")
    return obj
