"""Minimal TOML emitter + tomllib-based loader (a copy of
`skellysim_tpu.config.toml_io`; the port imports nothing of the JAX package).

The runtime config contract is a TOML file (reference: the Python toolkit dumps
`toml.dump(_unpack(config))`, the reference `src/skelly_sim/skelly_config.py:958-973`,
and the C++ side parses it with toml11, `src/core/params.cpp:3-80`). Python ships
`tomllib` (read-only), so writing needs a small emitter. Supported value types:
bool/int/float/str, flat lists, nested dicts (tables), lists of dicts (arrays of
tables) — exactly the shapes the config schema produces.
"""

from __future__ import annotations

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:
    # API-compatible backport: on 3.10 boxes a bare `import tomllib` killed
    # every config-dependent test module at collection
    import tomli as tomllib
from typing import Any


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        s = repr(v)
        # TOML floats need a '.' or exponent; repr(inf/nan) needs mapping
        if s in ("inf", "-inf"):
            return s
        if s == "nan":
            return "nan"
        if "." not in s and "e" not in s and "E" not in s:
            s += ".0"
        return s
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{escaped}"'
    raise TypeError(f"unsupported TOML scalar: {type(v)!r}")


def _format_value(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_format_value(x) for x in v) + "]"
    return _format_scalar(v)


def _format_key(k: str) -> str:
    """Bare keys are [A-Za-z0-9_-]+ in TOML; anything else (the audit
    contracts' "float32->float64" promotion edges) must be quoted."""
    if k and all(c.isascii() and (c.isalnum() or c in "_-") for c in k):
        return k
    return _format_scalar(str(k))


def _is_table(v: Any) -> bool:
    return isinstance(v, dict)


def _is_table_array(v: Any) -> bool:
    return isinstance(v, (list, tuple)) and len(v) > 0 and all(
        isinstance(x, dict) for x in v)


def _emit_table(out: list[str], table: dict, prefix: str) -> None:
    scalars = {k: v for k, v in table.items()
               if not _is_table(v) and not _is_table_array(v)}
    for k, v in scalars.items():
        out.append(f"{_format_key(k)} = {_format_value(v)}")
    for k, v in table.items():
        if _is_table(v):
            name = f"{prefix}{_format_key(k)}"
            out.append("")
            out.append(f"[{name}]")
            _emit_table(out, v, name + ".")
    for k, v in table.items():
        if _is_table_array(v):
            name = f"{prefix}{_format_key(k)}"
            for item in v:
                out.append("")
                out.append(f"[[{name}]]")
                _emit_table(out, item, name + ".")


def dumps(data: dict) -> str:
    """Serialize a nested dict to a TOML string."""
    out: list[str] = []
    _emit_table(out, data, "")
    return "\n".join(out).lstrip("\n") + "\n"


def dump(data: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def loads(s: str) -> dict:
    return tomllib.loads(s)
