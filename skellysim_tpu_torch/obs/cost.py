"""Cost accounting: flops, bytes and memory per registered program, with
baselines.

Counterpart of `skellysim_tpu.obs.cost`. For every entry of the registry
(`audit.programs.all_programs()`, the layers' ``auditable_programs()``
seams) the program is run once under `CostCounter`, and its counts are
compared with a checked-in baseline (``obs/baselines/<name>.toml``,
written by ``python -m skellysim_tpu_torch.obs cost --update``). The gate
is the JAX package's:

* a registered program with no baseline file is a finding;
* a gated metric drifting beyond the baseline's ``tol_pct`` (default
  25) is a finding, a regression or an improvement alike, so the baseline
  always describes the current program;
* a baseline file whose program is no longer registered is a finding;
* deliberate changes are recorded with ``[[suppress]]`` entries (``check``
  + ``match`` + a mandatory ``reason``; unused entries are findings),
  `audit.engine.apply_suppressions`.

**The counter.** The JAX package reads XLA's static analyses of the
compiled module (``cost_analysis()`` / ``memory_analysis()``). Eager
torch compiles nothing, so `CostCounter`, a
`torch.utils._python_dispatch.TorchDispatchMode`, sees every aten op the
program runs, re-dispatches it unchanged (a counted run gives the
uncounted bits) and counts it from its shapes alone: no op reads a value
back to the host for counting. The model:

* **flops**: matrix products by `torch.utils.flop_counter`'s formulas
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``mv`` / ``addmv`` 2 m n,
  ``dot`` / ``vdot`` 2 n); pointwise ops (`torch.Tag.pointwise`, copies
  and casts among them) one a output element; reductions
  (`torch.Tag.reduction`, and the scans ``cumsum`` / ``cumprod``) one an
  input element; LU factor ⅔ n³, an LU or Cholesky solve 2 n² a right-hand
  side, a triangular solve n² a right-hand side, an inverse 2 n³,
  Cholesky ⅓ n³, a solve ⅔ n³ + 2 n² a right-hand side (each a batch
  entry); FFTs 5 n log₂ n a transform; every other op (indexing, sorts,
  gathers, scatters, fills) 0;
* **bytes_accessed**: each op's input and output bytes (``numel x
  element size``); views and aliases count 0, and so does a copy between
  devices (an upload of a table made on the host, the read-back of a
  host sync): it is a transfer, not work on the device, and a run on the
  CPU makes no such op, so counting it would make the card's count differ
  from the CPU's (XLA's analysis likewise sees host constants as
  literals);
* **memory**: ``argument_bytes`` and ``output_bytes`` are the distinct
  storages of the program's inputs and outputs; ``temp_bytes`` is the
  peak of the live storages the ops create, each tracked by weak
  references to the tensors over it (a storage lives while one of them
  does); ``peak_bytes`` is their sum, as in the JAX package. The same
  rule on the CPU and on the card; on the card the run's peak of
  `torch.cuda.max_memory_allocated` is reported beside it
  (``device_max_allocated``), never gated;
* **the pair sums**: kernels A–H run through ctypes, which no dispatch
  mode sees, and their plain twins run other ops than the kernels. So
  each pair sum is counted once, at the seam where its family is chosen,
  whatever computes it: ``ops.kernels._direct`` (A–D, the plain twin,
  ``"df"``, ``"mxu"``), the member-axis and lone wrappers of
  ``ops.cuda_kernels`` (the fused ring E / F among them), the ring's
  per-hop blocks (A–D through those wrappers, the ``"mxu"`` and ``"df"``
  tiles seamed with `block_work`) and the treecode's pass
  (G / H and their twin). A sum counts ``22 · n_trg · n_src`` flops
  (Stokeslet) or ``40 · …`` (stresslet), times the members, and the
  bytes of the JAX package's ``CostEstimate`` at the operands' item size
  (`pair_bytes`); the treecode counts the pairs its pass sums, near real
  pairs plus far proxy pairs (a host read of its lists, made only while a
  counter is active). While a seam counts, the aten counting inside it
  is suspended, so the operand staging and a plain twin's own ops never
  count a second time: the CPU and the card give equal counts;
* **collectives**: at the `parallel.spmd.Collectives` seam, the largest
  operand bytes a shard per kind (``all_reduce`` for psum / pmax / pmin,
  ``all_gather``, ``collective_permute`` for the ring), written into the
  baseline as ``[collectives.<kind>] max_bytes`` (the port has no audit
  contracts to pin them).

Every seam is made by `seamed`. Outside a counter it costs one
comparison (``_ACTIVE is None``): no device allocation and no host read.
"""

from __future__ import annotations

import functools
import math
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..audit.engine import Finding, apply_suppressions, suppress_findings

BASELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baselines")

#: relative drift tolerance (percent) when a baseline pins no tol_pct
DEFAULT_TOL_PCT = 25.0

#: gated metrics, in table order. A baseline may pin a subset (only pinned
#: keys gate), but `--update` always writes all of them.
COST_KEYS = ("flops", "bytes_accessed", "argument_bytes", "output_bytes",
             "temp_bytes", "peak_bytes")

#: the pair seams' totals, written beside the cost as ``[pair_seam]``
#: (informational: the card's run must give the CPU's exactly)
PAIR_KEYS = ("pairs", "pair_flops", "pair_bytes")

CHECK_ID = "cost-baseline"

#: flops a pair of each family (the JAX package's CostEstimate)
PAIR_FLOPS = {"stokeslet": 22, "stresslet": 40}

#: the counter counting now; None: every seam costs one comparison
_ACTIVE = None


def pair_bytes(family: str, n_trg: int, n_src: int, itemsize: int) -> int:
    """The bytes of one pair sum: the JAX package's CostEstimate
    (``4 * 3 * (2 nt + 2 ns)`` for the Stokeslet, ``4 * (6 nt + 12 ns)``
    for the stresslet) at the operands' item size: targets read and
    written, sources and their payload read once."""
    if family == "stokeslet":
        return itemsize * 3 * (2 * n_trg + 2 * n_src)
    return itemsize * (6 * n_trg + 12 * n_src)


def dense_work(family, r_src, r_trg, payload, *_, **__):
    """(pairs, bytes) of a dense sum of lone ([n, c]) or member-batched
    ([B, n, c]) operands."""
    members = r_trg.shape[0] if r_trg.ndim == 3 else 1
    n_trg, n_src = r_trg.shape[-2], r_src.shape[-2]
    return (members * n_trg * n_src,
            members * pair_bytes(family, n_trg, n_src, r_trg.element_size()))


def block_work(family, trg, src, pay, *_, **__):
    """`dense_work` of a ring block ``fn(trg, src, pay)``."""
    return dense_work(family, src, trg, pay)


def ring_lists_work(family, r_trg, src, payload=None, mesh=None, *_,
                    **__):
    """(pairs, bytes) of a fused ring call (E / F) over equal source
    blocks (this process's target blocks ``r_trg``, a source block
    ``src[0]``): every target block against every shard's source block,
    each block pair counted as one dense sum, as the hop-by-hop ring's
    per-hop seams count it. ``mesh`` (a mesh that spans processes) or the
    lists' own length gives the shards."""
    n_shards = mesh.size if mesh is not None else len(r_trg)
    ns = src[0].shape[0]
    item = r_trg[0].element_size()
    pairs = sum(t.shape[0] for t in r_trg) * ns * n_shards
    nbytes = n_shards * sum(pair_bytes(family, t.shape[0], ns, item)
                            for t in r_trg)
    return pairs, nbytes


def tree_work(family, r_trg, src, payload, items, segs, *_, **__):
    """(pairs, bytes) of one treecode pass over segment lists: the pairs
    it sums (each item's targets against its segments' sources: near real
    sources plus far proxies), read back to the host."""
    if items.shape[0] == 0:
        return 0, 0
    ends = torch.cumsum(segs[:, 1], 0)
    starts = torch.cat([ends.new_zeros(1), ends])
    first, n_seg = items[:, 2], items[:, 3]
    n_src = starts[first + n_seg] - starts[first]
    pairs = int(torch.sum(items[:, 1] * n_src).item())
    return pairs, pair_bytes(family, r_trg.shape[0], src.shape[0],
                             r_trg.element_size())


# ------------------------------------------------------------ the counter

def _tensors(obj, seen=None):
    """Every tensor in ``obj``: tensors, tuples / lists (named tuples
    too), dicts and dataclass-like objects' attributes, each once."""
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
            yield from _tensors(v, seen)
    elif isinstance(obj, dict):
        seen.add(id(obj))
        for v in obj.values():
            yield from _tensors(v, seen)
    elif hasattr(obj, "__dict__") and not callable(obj) \
            and not isinstance(obj, (type, torch.device, torch.dtype)):
        seen.add(id(obj))
        for v in vars(obj).values():
            yield from _tensors(v, seen)


def _storage_key(t):
    s = t.untyped_storage()
    return (t.device, s.data_ptr()), s.nbytes()


def storage_bytes(*objs) -> int:
    """The bytes of the distinct storages under ``objs``' tensors."""
    seen = {}
    for t in _tensors(objs):
        key, nbytes = _storage_key(t)
        if nbytes:
            seen[key] = nbytes
    return sum(seen.values())


def _flat(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (tuple, list)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _fft_flops(name, args, out) -> float:
    x, dims = args[0], args[1]
    ref = out if name == "_fft_c2r" else x
    n = math.prod(ref.shape[d] for d in dims)
    if n <= 1:
        return 0.0
    return 5.0 * n * math.log2(n) * (ref.numel() // n)


def _linalg_flops(name, args) -> float:
    """Textbook counts over a batch of n x n systems; a solve's right-hand
    sides are B's columns over every batch entry."""
    if name == "cholesky_solve":
        B, A = args[0], args[1]
    else:
        A = args[0]
        B = args[2] if name == "linalg_lu_solve" else args[1] \
            if len(args) > 1 else None
    n = A.shape[-1]
    batch = A.numel() // max(n * n, 1)
    if name == "linalg_lu_factor_ex":
        return 2.0 / 3.0 * n ** 3 * batch
    if name == "linalg_inv_ex":
        return 2.0 * n ** 3 * batch
    if name == "linalg_cholesky_ex":
        return n ** 3 / 3.0 * batch
    rhs = B.numel() // max(n, 1)
    if name in ("linalg_lu_solve", "cholesky_solve"):
        return 2.0 * n ** 2 * rhs
    if name == "linalg_solve_triangular":
        return float(n ** 2 * rhs)
    # _linalg_solve_ex: factor and solve
    return 2.0 / 3.0 * n ** 3 * batch + 2.0 * n ** 2 * rhs


_LINALG = frozenset({"linalg_lu_factor_ex", "linalg_inv_ex",
                     "linalg_cholesky_ex", "linalg_lu_solve",
                     "cholesky_solve", "linalg_solve_triangular",
                     "_linalg_solve_ex"})
_FFT = frozenset({"_fft_r2c", "_fft_c2r", "_fft_c2c"})
_SCANS = frozenset({"cumsum", "cumprod", "cummax", "cummin",
                    "logcumsumexp"})
#: ops that copy between devices when their operands lie on two
_COPIES = frozenset({"_to_copy", "copy_"})
#: ops that alias their input without the view tag
_ALIASES = frozenset({"_unsafe_view", "_reshape_alias", "lift_fresh"})


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes and storages of every aten op run inside it
    (the module docstring's model), and the pair sums the seams report.

    ``flops`` / ``bytes_accessed`` hold everything; ``pairs``,
    ``pair_flops`` and ``pair_bytes`` the seams' share; ``seams`` the
    totals by family; ``collectives`` the largest operand bytes a shard
    by kind; ``live_bytes`` / ``temp_bytes`` the tracked storages' live
    and peak bytes. One counter at a time."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.ops = 0
        self.pairs = 0
        self.pair_flops = 0.0
        self.pair_bytes = 0.0
        self.seams: dict = {}
        self.collectives: dict = {}
        self.live_bytes = 0
        self.temp_bytes = 0
        self._live: dict = {}
        self._excluded: set = set()
        self._depth = 0

    # ------------------------------------------------------------ context

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a CostCounter is already counting")
        _ACTIVE = self
        try:
            return super().__enter__()
        except BaseException:
            _ACTIVE = None
            raise

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    def exclude(self, *objs) -> None:
        """Storages under ``objs`` (the program's arguments) are not
        temporaries: ops that write into them or view them track
        nothing."""
        for t in _tensors(objs):
            self._excluded.add(_storage_key(t)[0])

    # ----------------------------------------------------------- the ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth == 0:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        packet = func.overloadpacket
        name = packet.__name__
        outs = list(_flat(out if isinstance(out, (tuple, list)) else (out,)))
        for t in outs:
            self._track(t)
        if func.is_view or name in _ALIASES:
            return
        ins = list(_flat(args)) + list(_flat(kwargs.values()))
        if name in _COPIES and len({t.device for t in ins + outs}) > 1:
            return
        self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        self.flops += self._op_flops(func, packet, name, args, kwargs, out,
                                     ins, outs)

    def _op_flops(self, func, packet, name, args, kwargs, out, ins, outs):
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            return float(flop_registry[packet](*args, **kwargs, out_val=out))
        if name in ("mv", "addmv"):
            A = args[1] if name == "addmv" else args[0]
            return 2.0 * A.shape[0] * A.shape[1]
        if name in ("dot", "vdot"):
            return 2.0 * args[0].numel()
        if name in _LINALG:
            return _linalg_flops(name, args)
        if name in _FFT:
            return _fft_flops(name, args, out)
        tags = func.tags
        if torch.Tag.reduction in tags or name in _SCANS:
            return float(ins[0].numel()) if ins else 0.0
        if torch.Tag.pointwise in tags:
            return float(outs[0].numel()) if outs else 0.0
        return 0.0

    # ---------------------------------------------------------- storages

    def _track(self, t) -> None:
        key, nbytes = _storage_key(t)
        if not nbytes or key in self._excluded:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [nbytes, 0]
            self.live_bytes += nbytes
            self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            del self._live[key]
            self.live_bytes -= entry[0]

    # ------------------------------------------------------------ seams

    def seam(self, family: str, work, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` counted as one pair sum of ``family``:
        ``work(family, *args, **kwargs) -> (pairs, bytes)``; the aten
        counting is suspended inside, and only the result's storage is
        tracked. A seam inside another counts nothing."""
        if self._depth:
            return fn(*args, **kwargs)
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
            pairs, nbytes = work(family, *args, **kwargs)
        finally:
            self._depth -= 1
        flops = float(PAIR_FLOPS[family] * pairs)
        self.pairs += pairs
        self.pair_flops += flops
        self.pair_bytes += nbytes
        self.flops += flops
        self.bytes_accessed += nbytes
        agg = self.seams.setdefault(family, {"calls": 0, "pairs": 0,
                                             "flops": 0.0, "bytes": 0.0})
        agg["calls"] += 1
        agg["pairs"] += pairs
        agg["flops"] += flops
        agg["bytes"] += nbytes
        for t in _tensors(out):
            self._track(t)
        return out

    def collective(self, kind: str, parts) -> None:
        """Record one collective of ``kind`` over ``parts`` (one entry a
        shard: a tensor or a tuple of tensors): its largest operand bytes
        a shard."""
        nbytes = max((_nbytes(_tensors(p)) for p in parts), default=0)
        self.collectives[kind] = max(self.collectives.get(kind, 0), nbytes)


def seamed(family, work):
    """Decorator: the call ``run(*args, **kwargs)`` made a pair seam of
    ``family`` (None: the call's first argument names it), counted by
    ``work(family, *args, **kwargs) -> (pairs, bytes)`` while a counter is
    active (`CostCounter.seam`), else ``run`` itself after one comparison.
    The returned wrapper keeps ``run`` as ``.uncounted``."""
    def wrap(run):
        @functools.wraps(run)
        def wrapper(*args, **kwargs):
            counter = _ACTIVE
            if counter is None:
                return run(*args, **kwargs)
            return counter.seam(family or args[0], work, run, *args,
                                **kwargs)
        wrapper.uncounted = run
        return wrapper
    return wrap


# ------------------------------------------------------------ measuring

def baseline_path(name: str, baseline_dir: str | None = None) -> str:
    return os.path.join(baseline_dir or BASELINE_DIR, f"{name}.toml")


def measure_built(built) -> dict:
    """Run one `audit.registry.BuiltProgram` under a `CostCounter`: a flat
    metrics dict (`COST_KEYS`, `PAIR_KEYS`, ``collectives``, ``ops``,
    ``run_s``, and on the card ``device_max_allocated``: the peak of
    `torch.cuda.max_memory_allocated` over what was allocated before the
    run, informational)."""
    device = torch.device(built.device) if built.device is not None \
        else None
    on_card = device is not None and device.type == "cuda"
    arg_b = storage_bytes(built.args, built.kwargs)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    with CostCounter() as counter:
        counter.exclude(built.args, built.kwargs)
        out = built.fn(*built.args, **built.kwargs)
    if on_card:
        torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    out_b = storage_bytes(out)
    row = {
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes_accessed),
        "argument_bytes": arg_b,
        "output_bytes": out_b,
        "temp_bytes": counter.temp_bytes,
        "peak_bytes": arg_b + out_b + counter.temp_bytes,
        "pairs": counter.pairs,
        "pair_flops": float(counter.pair_flops),
        "pair_bytes": float(counter.pair_bytes),
        "collectives": dict(counter.collectives),
        "ops": counter.ops,
        "run_s": round(run_s, 3),       # informational, never gated
    }
    if on_card:
        row["device_max_allocated"] = (torch.cuda.max_memory_allocated(device)
                                       - held)
    return row


def load_baseline(name: str, baseline_dir: str | None = None):
    """(baseline dict | None, [Finding]) — validation findings only."""
    from ..config import toml_io

    path = baseline_path(name, baseline_dir)
    if not os.path.exists(path):
        return None, [Finding(name, CHECK_ID, (
            f"no cost baseline at obs/baselines/{name}.toml — every "
            "registered program must pin its cost (run `python -m "
            "skellysim_tpu_torch.obs cost --update` and commit the "
            "result)"))]
    data = toml_io.load(path)
    out = []
    declared = data.get("program", {}).get("name")
    if declared is not None and declared != name:
        out.append(Finding(name, CHECK_ID, (
            f"baseline file {name}.toml declares program.name="
            f"{declared!r} — copy-paste drift")))
    out.extend(suppress_findings(name, data, CHECK_ID))
    return data, out


def cost_findings(name: str, measured: dict, baseline: dict):
    """Drift findings for one program against its (loaded) baseline."""
    out = []
    base = baseline.get("cost", {})
    tol = float(base.get("tol_pct", DEFAULT_TOL_PCT))
    for key in COST_KEYS:
        if key not in base:
            continue
        b = float(base[key])
        m = float(measured[key])
        denom = max(abs(b), 1.0)
        drift = (m - b) / denom * 100.0
        if abs(drift) > tol:
            kind = "regression" if m > b else "improvement"
            out.append(Finding(name, CHECK_ID, (
                f"{key} drifted {drift:+.1f}% ({kind}): baseline {b:g}, "
                f"measured {m:g} (tol ±{tol:g}%) — fix the program or "
                "re-baseline deliberately with `obs cost --update`")))
    return out


def write_baseline(name: str, measured: dict,
                   baseline_dir: str | None = None) -> str:
    """Write/refresh one baseline file, preserving an existing file's
    ``tol_pct`` and ``[[suppress]]`` entries (the deliberate knobs). The
    pair seams' totals go into ``[pair_seam]`` and the collectives'
    largest operands into ``[collectives.<kind>] max_bytes``."""
    from ..config import toml_io

    path = baseline_path(name, baseline_dir)
    prev = toml_io.load(path) if os.path.exists(path) else {}
    cost = {k: measured[k] for k in COST_KEYS}
    if "tol_pct" in prev.get("cost", {}):
        cost["tol_pct"] = prev["cost"]["tol_pct"]
    data = {"program": {"name": name}, "cost": cost}
    if all(k in measured for k in PAIR_KEYS):
        data["pair_seam"] = {k: measured[k] for k in PAIR_KEYS}
    if measured.get("collectives"):
        data["collectives"] = {k: {"max_bytes": int(v)} for k, v
                               in sorted(measured["collectives"].items())}
    if prev.get("suppress"):
        data["suppress"] = prev["suppress"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    toml_io.dump(data, path)
    return path


def audit_costs(progs, baseline_dir: str | None = None,
                update: bool = False, registry_names=None, device=None):
    """Measure every program on ``device`` and gate against baselines.

    Returns ``(rows, findings)``: one row dict per program (name + the
    measured metrics; ``error`` instead when the build or run failed) and
    the unsuppressed findings. ``update=True`` rewrites baseline files from
    the measurements instead of gating (validation findings still count).

    ``registry_names`` is the FULL registered-program name set for the
    stale-baseline scan; it defaults to ``progs``'s names, but a caller
    auditing a filtered subset (``--program NAME``) must pass the full set
    or every other program's valid baseline reads as stale.
    """
    rows = []
    findings = []
    seen = (set(registry_names) if registry_names is not None else
            {p.name for p in progs})
    for prog in progs:
        baseline, f_load = load_baseline(prog.name, baseline_dir)
        prog_findings = [] if (update and baseline is None) else list(f_load)
        try:
            measured = measure_built(prog.build(device))
        except Exception as e:  # a program that no longer runs IS a finding
            rows.append({"name": prog.name,
                         "error": f"{type(e).__name__}: {e}"})
            prog_findings.append(Finding(prog.name, CHECK_ID, (
                f"entry point failed to build/run: "
                f"{type(e).__name__}: {e}")))
            findings.extend(apply_suppressions(prog.name, baseline,
                                               prog_findings))
            continue
        rows.append(dict({"name": prog.name}, **measured))
        if update:
            write_baseline(prog.name, measured, baseline_dir)
        elif baseline is not None:
            prog_findings.extend(cost_findings(prog.name, measured, baseline))
        findings.extend(apply_suppressions(prog.name, baseline,
                                           prog_findings))
    # stale baseline files: the registry no longer names them
    bdir = baseline_dir or BASELINE_DIR
    if os.path.isdir(bdir):
        for fn in sorted(os.listdir(bdir)):
            stem, ext = os.path.splitext(fn)
            if ext == ".toml" and stem not in seen:
                findings.append(Finding(stem, CHECK_ID, (
                    f"stale baseline obs/baselines/{fn}: no registered "
                    "program by that name — remove it (or the program "
                    "lost its registration silently)")))
    return rows, findings


def render_table(rows) -> str:
    """Fixed-width cost table (the CLI's report body)."""
    cols = ("name", "flops", "bytes_accessed", "pair_flops", "peak_bytes",
            "argument_bytes", "temp_bytes", "run_s")
    heads = ("program", "flops", "bytes", "pair_flops", "peak_B", "arg_B",
             "temp_B", "run_s")

    def fmt(row, key):
        if "error" in row and key != "name":
            return "build error" if key == "flops" else ""
        v = row.get(key, "")
        if isinstance(v, float) and key in ("flops", "bytes_accessed",
                                            "pair_flops"):
            return f"{v:.3e}"
        return str(v)

    table = [heads] + [tuple(fmt(r, c) for c in cols) for r in rows]
    widths = [max(len(line[i]) for line in table) for i in range(len(cols))]
    return "\n".join("  ".join(cell.ljust(w) for cell, w in
                               zip(line, widths)).rstrip()
                     for line in table)
