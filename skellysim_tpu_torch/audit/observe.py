"""What one run of a program does, seen from the inside: the runtime
counterpart of the JAX package's jaxpr extractors (`walk_eqns`,
`dtype_flow`, `callback_inventory`, `fft_inventory`,
`collective_inventory` in `skellysim_tpu.audit.checks`).

Eager torch has no lowered program to read, so `Observer` watches a run:
a `TorchDispatchMode` sees every aten op, a `TorchFunctionMode` the
Python-level reads that dispatch no op, and the `parallel.spmd.Collectives`
seam reports each collective. Every event is keyed by its **site**: the
innermost frame inside ``skellysim_tpu_torch/`` (outside this package and
the cost counter), as ``file:line`` relative to the package. Counting
sites, not events, makes a pin independent of the iteration count, as the
JAX contracts' static counts are; the events are counted too.

What is recorded:

* **dtype edges**: every ``_to_copy`` / ``copy_`` between two float (or
  two complex) dtypes, keyed ``"float32->float64"`` (widening and
  narrowing alike), and every other op whose floating tensor inputs mix
  float32 and float64 (``mixed``).
* **host syncs**, by kind: ``item`` (``_local_scalar_dense``: ``.item()``,
  ``bool()``, ``float()``, ``int()`` of a tensor), ``d2h`` (a blocking
  copy from the card to the host: ``.cpu()``, ``.tolist()``,
  ``.to("cpu")``), ``numpy`` / ``tolist`` (a CPU tensor's values read into
  Python on a CPU run, which dispatches no op), ``sync-op`` (an op that
  must wait for the card to size its output: `SYNC_OPS`, and indexing
  with a boolean mask), ``upload`` (a blocking copy from the host to the
  card: ``torch.as_tensor(array, device=...)``, ``torch.tensor(list,
  ...)``, a host index tensor) and ``synchronize`` (a stream's
  ``synchronize``). Only tensors on the program's device count: a CPU
  table read on a card run moves nothing, and neither does reading back a
  tensor made from host data with no device (host scratch) on either
  backend. On the card these are the
  events, one for one, that ``torch.cuda.set_sync_debug_mode`` warns
  about (which counts neither ``torch.cuda.synchronize`` nor an event's
  wait). A read of a program
  tensor is ``item`` or ``numpy`` / ``tolist`` on the CPU and ``item`` or
  ``d2h`` on the card, at the same site (``x.cpu().numpy()`` is one event
  either way); uploads and explicit waits exist on the card only.
* **FFT sites**: aten ``_fft_r2c`` / ``_fft_c2r`` / ``_fft_c2c``.
* **writes to the arguments**: every op that writes into the storage of a
  program argument (its schema's mutable arguments and ``out=``).
* **collectives**: kind (``all_reduce`` for psum / pmax / pmin,
  ``all_gather``, ``collective_permute`` for the ring), calls, sites and
  the largest operand bytes a shard; and for the reductions and gathers,
  whether every shard received the same bits (``divergent`` counts those
  that did not).

It stacks with `obs.cost.CostCounter` (either may be the outer mode), so
one run can be counted and audited. The pair seams (`obs.cost.seamed`)
need nothing from it: a seam suspends only the cost counter's own aten
counting, and this mode sees every op inside a seam as it sees any other.
What it cannot see is the kernels themselves (A-H launch through ctypes):
their operand staging, casts included, runs in torch and is seen.
"""

from __future__ import annotations

import os
import sys
import weakref
from collections import Counter

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_DIRS = (os.path.join(PACKAGE_DIR, "audit") + os.sep,)
_SKIP_FILES = (os.path.join(PACKAGE_DIR, "obs", "cost.py"),)

#: ops that wait for the card to size or check their output, with the
#: syncs each makes on the card (``bincount`` reads the input's least and
#: largest entry; ``repeat_interleave`` without ``output_size`` its total
#: and its least repeat)
SYNC_OPS = {"nonzero": 1, "masked_select": 1, "_unique": 1, "_unique2": 1,
            "unique_dim": 1, "unique_consecutive": 1, "is_nonzero": 1,
            "allclose": 1, "bincount": 2, "histc": 1,
            "_linalg_check_errors": 1, "masked_scatter": 1, "argwhere": 1}

_FLOATS = {torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.float32: "float32", torch.float64: "float64"}
_COMPLEX = {torch.complex64: "complex64", torch.complex128: "complex128"}
_FFT = frozenset({"_fft_r2c", "_fft_c2r", "_fft_c2c"})

#: the observer observing now (the Collectives seam reports to it)
ACTIVE = None


def site(skip_qual: str = "") -> str:
    """``file:line`` of the innermost frame inside the package (outside
    `audit`, the cost counter and functions whose qualified name starts
    with ``skip_qual``), relative to the package; the innermost frame's
    when none is."""
    f = sys._getframe(1)
    first = None
    while f is not None:
        fn = f.f_code.co_filename
        if first is None:
            first = f
        if (fn.startswith(PACKAGE_DIR) and not fn.startswith(_SKIP_DIRS)
                and fn not in _SKIP_FILES
                and not (skip_qual
                         and f.f_code.co_qualname.startswith(skip_qual))):
            return f"{os.path.relpath(fn, PACKAGE_DIR)}:{f.f_lineno}"
        f = f.f_back
    return (f"{os.path.basename(first.f_code.co_filename)}:{first.f_lineno}"
            if first is not None else "?")


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _storage(t):
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return (t.device, s.data_ptr()) if s.nbytes() else None


_WRITES: dict = {}


def _written(func, args, kwargs):
    """The tensors ``func`` writes into (its schema's mutable arguments)."""
    names = _WRITES.get(func)
    if names is None:
        names = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                      if a.alias_info is not None and a.alias_info.is_write)
        _WRITES[func] = names
    out = []
    for i, name in names:
        v = args[i] if i < len(args) else kwargs.get(name)
        out.extend(_tensors(v))
    return out


class Observation:
    """What one observed run did (the module docstring's inventory)."""

    def __init__(self, device):
        self.device = torch.device(device) if device is not None else None
        self.dtype_edges = Counter()    # (edge, site) -> events
        self.mixed = Counter()          # (op, site) -> events
        self.host_syncs = Counter()     # (kind, site) -> events
        self.ffts = Counter()           # (op, site) -> events
        self.arg_writes = Counter()     # (op, site) -> events
        self.collectives: dict = {}     # kind -> {calls, sites, max_bytes}
        self.divergent = Counter()      # (kind, site) -> calls
        #: tensors made from host data with no device (host scratch, such
        #: as ``float(torch.tensor(v, dtype=...))``): reading one back is
        #: no device read, on the CPU either
        self.host_made = weakref.WeakSet()
        self._results: list = []        # (kind, site, per-shard results)

    # ---------------------------------------------------------- summaries
    @staticmethod
    def _by(counter, sites: bool):
        out = {}
        for (key, _), n in counter.items():
            out[key] = out.get(key, 0) + (1 if sites else n)
        return dict(sorted(out.items()))

    def edge_sites(self) -> dict:
        """``{"float32->float64": sites}``."""
        return self._by(self.dtype_edges, True)

    def mixed_sites(self) -> dict:
        return self._by(self.mixed, True)

    def sync_events(self) -> dict:
        """``{kind: events}`` of the host syncs."""
        return self._by(self.host_syncs, False)

    @property
    def syncs(self) -> int:
        """Every host sync event of the run."""
        return sum(self.host_syncs.values())

    def fft_sites(self) -> int:
        return len(self.ffts)

    def collective_table(self) -> dict:
        """``{kind: {"count": calls, "sites": n, "max_bytes": b}}``."""
        return {k: {"count": v["calls"], "sites": len(v["sites"]),
                    "max_bytes": v["max_bytes"]}
                for k, v in sorted(self.collectives.items())}


class _Dispatch(TorchDispatchMode):
    def __init__(self, obs: Observation, arg_storages: set):
        super().__init__()
        self.obs = obs
        self.args = arg_storages

    def _mine(self, t) -> bool:
        dev = self.obs.device
        return dev is None or t.device.type == dev.type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._see(func, args, kwargs, out)
        return out

    def _see(self, func, args, kwargs, out):
        obs = self.obs
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense":
            if self._mine(args[0]) and args[0] not in obs.host_made:
                obs.host_syncs[("item", site())] += 1
            return
        if name in ("_to_copy", "copy_"):
            if name == "_to_copy":
                src, dst = args[0], out
                blocking = not kwargs.get("non_blocking", False)
            else:
                dst, src = args[0], args[1]
                blocking = not (args[2] if len(args) > 2
                                else kwargs.get("non_blocking", False))
            self._copy(src, dst, blocking)
        elif name in SYNC_OPS:
            if any(self._mine(t) for t in _tensors(args)):
                obs.host_syncs[("sync-op", site())] += SYNC_OPS[name]
        elif (name == "repeat_interleave" and len(args) < 4
              and isinstance(args[0], torch.Tensor)
              and kwargs.get("output_size") is None):
            if self._mine(args[0]):
                obs.host_syncs[("sync-op", site())] += 2
        elif name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            idx = [t for t in (args[1] if len(args) > 1
                               else kwargs.get("indices", ())) or ()
                   if t is not None]
            if any(t.dtype in (torch.bool, torch.uint8) and self._mine(t)
                   for t in idx):
                obs.host_syncs[("sync-op", site())] += 1
            elif (self._mine(args[0]) and args[0].device.type != "cpu"
                  and any(t.device.type == "cpu" and t.ndim for t in idx)):
                # a host index tensor is copied to the card first
                obs.host_syncs[("upload", site())] += 1
        elif name in _FFT:
            obs.ffts[(name, site())] += 1
        if name not in ("_to_copy", "copy_"):
            floats = {t.dtype for t in _tensors(args)
                      if t.dtype in (torch.float32, torch.float64)}
            if len(floats) == 2:
                obs.mixed[(name, site())] += 1
        if self.args:
            for t in _written(func, args, kwargs):
                if _storage(t) in self.args:
                    obs.arg_writes[(name, site())] += 1
                    break

    def _copy(self, src, dst, blocking):
        obs = self.obs
        s, d = src.dtype, dst.dtype
        if s != d and ((s in _FLOATS and d in _FLOATS)
                       or (s in _COMPLEX and d in _COMPLEX)):
            names = {**_FLOATS, **_COMPLEX}
            obs.dtype_edges[(f"{names[s]}->{names[d]}", site())] += 1
        st, dt = src.device.type, dst.device.type
        if st != dt and blocking:
            if dt == "cpu" and self._mine(src):
                obs.host_syncs[("d2h", site())] += 1
            elif st == "cpu" and self._mine(dst):
                obs.host_syncs[("upload", site())] += 1


class _Function(TorchFunctionMode):
    """What dispatches no op: a CPU tensor's ``numpy()`` / ``tolist()`` /
    ``__array__`` on a CPU run, and on a card run ``torch.tensor`` /
    ``torch.as_tensor`` of host data that is neither a tensor nor a numpy
    array (a list, a Python or numpy scalar), whose copy to the card runs
    below the dispatcher's Python key."""

    _READS = {torch.Tensor.numpy: "numpy", torch.Tensor.tolist: "tolist",
              torch.Tensor.__array__: "numpy"}
    _MAKERS = (torch.tensor, torch.as_tensor)
    _HOST_MAKERS = (torch.tensor, torch.as_tensor, torch.from_numpy)

    def __init__(self, obs: Observation):
        super().__init__()
        self.obs = obs
        dev = obs.device
        self.cpu = dev is not None and dev.type == "cpu"
        self.card = dev is not None and dev.type == "cuda"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.cpu:
            kind = self._READS.get(func)
            if (kind is not None and args and isinstance(args[0], torch.Tensor)
                    and args[0].device.type == "cpu"
                    and args[0] not in self.obs.host_made):
                self.obs.host_syncs[(kind, site())] += 1
        out = func(*args, **kwargs)
        if (func in self._HOST_MAKERS and kwargs.get("device") is None
                and isinstance(out, torch.Tensor) and out.device.type == "cpu"
                and not (args and isinstance(args[0], torch.Tensor))):
            self.obs.host_made.add(out)
        if (self.card and func in self._MAKERS and args
                and not isinstance(args[0], torch.Tensor)
                and not _is_array(args[0])
                and isinstance(out, torch.Tensor)
                and out.device.type == "cuda"):
            self.obs.host_syncs[("upload", site())] += 1
        return out


class Observer:
    """``with Observer(device, args) as obs: fn(*args)`` records the run
    into ``obs.observation``. ``args``: the program's arguments, whose
    storages the argument-write record watches. One observer at a time."""

    def __init__(self, device=None, args=()):
        self.observation = Observation(device)
        self._arg_storages = {k for k in (_storage(t) for t in
                                          _flat_tensors(args)) if k}
        self._modes = None
        self._patched = []

    def __enter__(self):
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("an Observer is already observing")
        ACTIVE = self
        self._patch_waits()
        self._modes = (_Function(self.observation),
                       _Dispatch(self.observation, self._arg_storages))
        try:
            for m in self._modes:
                m.__enter__()
        except BaseException:
            self.__exit__(*sys.exc_info())
            raise
        return self.observation

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = None
        try:
            for m in reversed(self._modes or ()):
                m.__exit__(*exc)
        finally:
            self._modes = None
            for owner, name, fn in reversed(self._patched):
                setattr(owner, name, fn)
            self._patched = []
            obs = self.observation
            for kind, where, results in obs._results:
                if any(not bit_equal(results[0], r) for r in results[1:]):
                    obs.divergent[(kind, where)] += 1
            obs._results = []
        return False

    # --------------------------------------------------- explicit waits
    def _patch_waits(self):
        obs = self.observation
        if obs.device is None or obs.device.type != "cuda":
            return
        # `torch.cuda.synchronize` and `Event.synchronize` wait too, but
        # the sync debug mode does not count them: neither does this
        for owner, name in ((torch.cuda.Stream, "synchronize"),):
            fn = getattr(owner, name)

            def wrapped(*a, __fn=fn, **k):
                obs.host_syncs[("synchronize", site())] += 1
                return __fn(*a, **k)
            self._patched.append((owner, name, fn))
            setattr(owner, name, wrapped)

    # -------------------------------------------------- the collectives
    def collective(self, kind: str, parts, results=None) -> None:
        """One collective of ``kind`` over ``parts`` (one entry a shard);
        ``results``: what each shard received, checked for equal bits."""
        obs = self.observation
        where = site("Collectives.")
        nbytes = max((sum(t.numel() * t.element_size() for t in _tensors(p))
                      for p in parts), default=0)
        rec = obs.collectives.setdefault(kind, {"calls": 0, "sites": set(),
                                                "max_bytes": 0})
        rec["calls"] += 1
        rec["sites"].add(where)
        rec["max_bytes"] = max(rec["max_bytes"], nbytes)
        if results is not None and len(results) > 1:
            # compared after the run: a comparison here would sync the card
            obs._results.append((kind, where, list(results)))


def _flat_tensors(obj, seen=None):
    """Every tensor under ``obj``: tensors, tuples / lists (named tuples
    too), dicts and plain objects' attributes."""
    if seen is None:
        seen = set()
    if id(obj) in seen:
        return
    if isinstance(obj, torch.Tensor):
        seen.add(id(obj))
        yield obj
    elif isinstance(obj, (tuple, list)):
        seen.add(id(obj))
        for v in obj:
            yield from _flat_tensors(v, seen)
    elif isinstance(obj, dict):
        seen.add(id(obj))
        for v in obj.values():
            yield from _flat_tensors(v, seen)
    elif (hasattr(obj, "__dict__") and not callable(obj)
          and not isinstance(obj, (type, torch.device, torch.dtype))):
        seen.add(id(obj))
        for v in vars(obj).values():
            yield from _flat_tensors(v, seen)


# ------------------------------------------------------------ the leaves

def flatten(obj, prefix: str = ""):
    """``[(path, leaf)]`` of a program's arguments or outputs, the JAX
    package's dotted pytree paths (``"0.fibers.active"``): named tuples by
    field, tuples / lists by index, dicts by key; tensors, numpy arrays
    and Python scalars are leaves, and so is a list or tuple of host data
    alone (a solver's residual history); None and other objects (a mesh,
    a string) hold none. A whole-output leaf is ``"result"``."""
    out = []

    def walk(v, path):
        if v is None or isinstance(v, (str, bytes)):
            return
        if isinstance(v, torch.Tensor) or _is_array(v) \
                or isinstance(v, (bool, int, float)):
            out.append((path or "result", v))
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f in v._fields:
                walk(getattr(v, f), f"{path}.{f}" if path else f)
        elif isinstance(v, (tuple, list)):
            if v and not any(True for _ in _flat_tensors(v)) and all(
                    isinstance(x, (bool, int, float, tuple, list))
                    for x in v):
                out.append((path or "result", v))   # host data: one leaf
                return
            for i, x in enumerate(v):
                walk(x, f"{path}.{i}" if path else str(i))
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(v[k], f"{path}.{k}" if path else str(k))

    walk(obj, prefix)
    return out


def _is_array(v) -> bool:
    return type(v).__module__ == "numpy" and hasattr(v, "dtype")


def bit_equal(a, b) -> bool:
    """Same bits: tensors (shape, dtype and every bit, NaNs included),
    numpy arrays, Python scalars and nested tuples / lists of them."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        a, b = a.detach(), b.detach().to(a.device)
        if a.is_floating_point() or a.is_complex():
            return bool(torch.equal(_bits(a), _bits(b)))
        return bool(torch.equal(a, b))
    if _is_array(a) or _is_array(b):
        import numpy as np

        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.tobytes() == b.tobytes())
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return len(a) == len(b) and all(bit_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        import struct

        return struct.pack("<d", a) == struct.pack("<d", b)
    return type(a) is type(b) and a == b


def _bits(t):
    """A float / complex tensor's bits as integers (NaN == NaN, -0 != 0)."""
    if t.is_complex():
        t = torch.view_as_real(t.resolve_conj())
    t = t.contiguous()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])
