"""The physics flight recorder: a ring of per-step diagnostics with anomaly
provenance.

Counterpart of `skellysim_tpu.obs.flight`, whose docstring gives the
design. The recorder is a fixed ``[K, 13]`` float32 ring on the state's
device (`FlightRecorder`, riding `system.SimState.flight`), written once a
trial step by `record_step` with device operations only: no ``.item()``,
no Python branch on a device value, no copy of a host value to the card
(host scalars enter through `torch.full`, a fill kernel), so that arming it
adds no host sync to the step. ``Params.flight_window = 0`` (the default)
leaves the field None and the step exactly as it was.

One row a trial (`FLIGHT_FIELDS`, storage order): the entry time, the dt
the trial solved with, the largest fiber strain over active fibers and its
fiber (a NaN strain records as +inf), the largest node speed, the smallest
signed node-wall clearance (`periphery.signed_clearance`; NaN without a
shell), the body solution's norm, the solution's norm, the true residual,
the health word (`guard.verdict`), and the provenance of the first
nonfinite value as (field, fiber, node) in the `PROV_FIELDS` order.

The sharded step writes the same row on every shard
(`record_step_sharded`): each reduction is a `parallel.spmd.Collectives`
``pmax`` / ``pmin`` over the shards' partials, and the argmax ids take the
JAX package's index-min tie-break, so every shard's ring is the same bits.
The ensemble records one row a member (`ensemble.runner`), each reduced
over the member's own fibers.

The host side (`decode_row`, `ring_rows`, `last_row`, `failure_payload`,
the blast-radius report) is numpy and JSON, a copy of the JAX module's.
"""

from __future__ import annotations

import json
import math
from typing import NamedTuple

import numpy as np
import torch

#: ring row columns, in storage order (see the module docstring)
FLIGHT_FIELDS = ("t", "dt_used", "max_strain", "strain_fiber", "max_speed",
                 "min_clearance", "body_norm", "solution_norm",
                 "residual_true", "health", "prov_field", "prov_fiber",
                 "prov_node")

#: provenance field ids (``prov_field`` values) in scan priority order: the
#: FIRST field holding a nonfinite value is named
PROV_FIELDS = ("none", "fiber_x", "fiber_tension", "shell_density",
               "shell_nodes", "body_solution", "solution")

#: integer-valued ring columns (decoded back to int on the host)
_ID_FIELDS = frozenset(("strain_fiber", "health", "prov_field",
                        "prov_fiber", "prov_node"))

#: provenance order-key base of the sharded tie-break: within one field,
#: offenders rank by ``fiber * 1024 + node`` (or the flat row), clamped
#: below this
_ORDER_BASE = 1 << 26

#: "no candidate" of the index-min tie-breaks
_NONE = 1 << 30


class FlightRecorder(NamedTuple):
    """The ring: ``rows`` [K, 13] float32 (NaN until written) and ``count``
    (int32 0-d, rows written; monotonic, `ring_rows` decodes the wrap);
    [B, K, 13] and [B] on a stacked ensemble state."""

    rows: torch.Tensor
    count: torch.Tensor


def new_ring(window: int, device=None):
    """A fresh ring for ``Params.flight_window = window`` on ``device``
    (None when the window is 0)."""
    if not window:
        return None
    return FlightRecorder(
        rows=torch.full((int(window), len(FLIGHT_FIELDS)), torch.nan,
                        dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------- device recorder

def _f32(v, device):
    """``v`` (a host number or a 0-d tensor) as a 0-d float32 tensor on
    ``device``; a host number enters through a fill kernel, never a copy."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _first_bad(t):
    """(any nonfinite, flat index of the first) of a tensor; index 0 when
    there is none."""
    bad = (~torch.isfinite(t)).reshape(-1)
    return bad.any(), bad.to(torch.uint8).argmax()


def _node_mask2d(g):
    m = g.active[:, None]
    if g.rt_mats is not None:
        m = m & g.rt_mats.node_mask.to(m.device)[None, :]
    return m.expand(g.n_fibers, g.n_nodes)


class _Parts(NamedTuple):
    """One shard's (or the one card's) part of a row, before the
    reductions across shards: 0-d tensors on the shard's device."""

    max_strain: torch.Tensor     # f32
    strain_fiber: torch.Tensor   # int64, -1 for none
    max_speed: torch.Tensor      # f32
    min_clear: torch.Tensor      # f32
    body_norm: torch.Tensor      # f32
    field: torch.Tensor          # int64, 0 for none
    p_fib: torch.Tensor          # int64
    p_node: torch.Tensor         # int64


def _row_parts(entry_state, new_state, solution, dt_used, shell_shape,
               shard: int = 0, axis_size: int = 1, sol_scan_rows=None,
               shell_sharded: bool = False) -> _Parts:
    """The JAX `record_step`'s reductions over this shard's data.
    ``shard`` / ``axis_size`` globalize fiber ids (shard k of ``axis_size``
    holds each bucket's k-th block of whole fibers), node rows of a
    ``shell_sharded`` shell and the ``sol_scan_rows`` head of the
    solution."""
    from ..bodies import bodies as bd
    from ..fibers import container as fc

    f32, i64 = torch.float32, torch.int64
    dev = solution.device
    old_buckets = fc.as_buckets(entry_state.fibers)
    new_buckets = fc.as_buckets(new_state.fibers)

    def lit(v, dtype=i64):
        return torch.full((), v, dtype=dtype, device=dev)

    # largest strain over active fibers and its fiber (a NaN strain is
    # +inf: a fiber that blew up must win the max)
    max_strain, strain_fiber = lit(-1.0, f32), lit(-1)
    goff = 0
    for g in new_buckets:
        errs = fc.fiber_errors(g).to(f32)
        errs = torch.where(torch.isnan(errs), torch.inf, errs)
        errs = torch.where(g.active, errs, -1.0)
        i = errs.argmax()
        v = errs.amax()       # errs[i], without a host read of i
        gid = i + (goff + shard * g.n_fibers)
        take = v > max_strain
        max_strain = torch.where(take, v, max_strain)
        strain_fiber = torch.where(take, gid, strain_fiber)
        goff += g.n_fibers * axis_size

    # largest node speed |x_new - x_old| / dt over live nodes
    max_speed = lit(0.0, f32)
    dt_f = torch.clamp_min(_f32(dt_used, dev), 1e-30)
    for g_old, g_new in zip(old_buckets, new_buckets):
        d = torch.linalg.vector_norm(g_new.x - g_old.x, dim=-1).to(f32) / dt_f
        d = torch.where(_node_mask2d(g_new), d, 0.0)
        d = torch.where(torch.isnan(d), torch.inf, d)
        max_speed = torch.maximum(max_speed, d.amax())

    # smallest signed node-wall clearance (negative: through the wall)
    min_clear = lit(math.nan, f32)
    if (shell_shape is not None and new_state.shell is not None
            and new_buckets):
        from ..periphery import periphery as peri

        vals = []
        for g in new_buckets:
            c = peri.signed_clearance(shell_shape,
                                      g.x.reshape(-1, 3)).to(f32)
            # a NaN position reads as the worst clearance, not a masked one
            c = torch.where(torch.isnan(c), -torch.inf, c)
            vals.append(torch.where(_node_mask2d(g).reshape(-1), c,
                                    torch.inf))
        min_clear = torch.cat(vals).amin()

    # the body solution block's norm (replicated on a mesh)
    b_list = bd.as_buckets(new_state.bodies)
    if b_list:
        sq = sum(torch.sum(g.solution * g.solution) for g in b_list)
        body_norm = torch.sqrt(sq).to(f32)
    else:
        body_norm = lit(0.0, f32)

    # provenance: the first nonfinite as (field, fiber, node), candidates
    # in PROV_FIELDS order; the reverse fold keeps the first that has any
    cands = []
    goff = 0
    for g in old_buckets:
        per = g.n_nodes * 3
        # & active: a dead slot's bits must never be named
        bad = ((~torch.isfinite(g.x)) & g.active[:, None, None]).reshape(-1)
        idx = bad.to(torch.uint8).argmax()
        fib = idx // per + (goff + shard * g.n_fibers)
        cands.append((1, bad.any(), fib, (idx % per) // 3))
        goff += g.n_fibers * axis_size
    goff = 0
    for g in old_buckets:
        bad = ((~torch.isfinite(g.tension)) & g.active[:, None]).reshape(-1)
        idx = bad.to(torch.uint8).argmax()
        fib = idx // g.n_nodes + (goff + shard * g.n_fibers)
        cands.append((2, bad.any(), fib, idx % g.n_nodes))
        goff += g.n_fibers * axis_size
    if entry_state.shell is not None:
        rho = entry_state.shell.density
        any_, idx = _first_bad(rho)
        node = idx // 3
        if shell_sharded:
            node = node + shard * (rho.shape[0] // 3)
        cands.append((3, any_, lit(-1), node))
        nodes = entry_state.shell.nodes
        any_, idx = _first_bad(nodes)
        node = idx // 3
        if shell_sharded:
            node = node + shard * nodes.shape[0]
        cands.append((4, any_, lit(-1), node))
    for g in bd.as_buckets(entry_state.bodies):
        any_, idx = _first_bad(g.solution)
        cands.append((5, any_, lit(-1), idx))
    sol_scan = (solution if sol_scan_rows is None
                else solution[:sol_scan_rows])
    any_, idx = _first_bad(sol_scan)
    if sol_scan_rows is not None:
        idx = idx + shard * sol_scan_rows
    cands.append((6, any_, lit(-1), idx))

    field, p_fib, p_node = lit(0), lit(-1), lit(-1)
    for fid, any_, fb, nd in reversed(cands):
        field = torch.where(any_, fid, field)
        p_fib = torch.where(any_, fb.to(i64), p_fib)
        p_node = torch.where(any_, nd.to(i64), p_node)
    return _Parts(max_strain, strain_fiber.to(i64), max_speed, min_clear,
                  body_norm, field, p_fib, p_node)


def _row(parts: _Parts, time, dt_used, sol_norm, residual_true, health):
    dev = parts.max_strain.device
    return torch.stack([
        _f32(time, dev), _f32(dt_used, dev), parts.max_strain,
        parts.strain_fiber.to(torch.float32), parts.max_speed,
        parts.min_clear, parts.body_norm, _f32(sol_norm, dev),
        _f32(residual_true, dev), _f32(int(health), dev),
        parts.field.to(torch.float32), parts.p_fib.to(torch.float32),
        parts.p_node.to(torch.float32)])


def _write(ring: FlightRecorder, row) -> FlightRecorder:
    """``ring`` with ``row`` written at ``count % K`` (a new tensor; the
    ring passed in is not touched)."""
    window = ring.rows.shape[0]
    count = ring.count.to(torch.int32)
    slot = torch.remainder(count, window).to(torch.int64).reshape(1)
    rows = ring.rows.index_copy(0, slot, row[None].to(ring.rows.device))
    return FlightRecorder(rows=rows, count=count + 1)


def _armed(new_state):
    if new_state.flight is None:
        raise ValueError(
            "record_step needs an armed ring on new_state.flight: arm the "
            "state with System.ensure_flight / make_state "
            "(Params.flight_window > 0)")
    return new_state.flight


def record_step(entry_state, new_state, solution, *, residual_true, health,
                dt_used, shell_shape=None, solution_norm=None):
    """``new_state.flight`` with this trial's row appended (callers
    ``_replace`` it back). ``entry_state`` is the trial's input state,
    ``new_state`` its advanced state, ``solution`` the flat solution;
    ``residual_true`` / ``health`` / ``dt_used`` the trial's
    (`system.StepInfo`). Device operations only: no host sync."""
    ring = _armed(new_state)
    parts = _row_parts(entry_state, new_state, solution, dt_used,
                       shell_shape)
    if solution_norm is None:
        solution_norm = torch.linalg.vector_norm(solution)
    return _write(ring, _row(parts, entry_state.time, dt_used, solution_norm,
                             residual_true, health))


def record_step_sharded(entries, news, solutions, *, comm, residual_true,
                        health, dt_used, shell_shape=None, solution_norm,
                        sol_scan_rows, shell_sharded):
    """`record_step` on a mesh (`parallel.spmd`): one ring a shard of this
    process, each the same bits. ``entries`` / ``news`` / ``solutions``
    hold one entry a local shard (``comm.mesh.local``); ``solution_norm``
    is the replicated norm (the shards' partial squares summed in shard
    order); ``sol_scan_rows`` the shard-resident head of each solution
    part (its replicated tail is the body block, scanned as its own
    field); ``shell_sharded`` globalizes the shell's node rows. The
    extrema are ``comm.pmax`` / ``pmin``; the argmax ids keep the JAX
    package's index-min tie-break."""
    n = comm.size
    parts = [_row_parts(e, nw, s, dt_used, shell_shape, shard=k,
                        axis_size=n, sol_scan_rows=sol_scan_rows,
                        shell_sharded=shell_sharded)
             for k, e, nw, s in zip(comm.mesh.local, entries, news,
                                    solutions)]
    i64 = torch.int64
    # extrema and the provenance key
    ext = comm.pmax([torch.stack([p.max_strain, p.max_speed])
                     for p in parts])
    clear = comm.pmin([p.min_clear for p in parts])
    keys = []
    for p in parts:
        order = torch.clamp_max(
            torch.where(p.p_fib >= 0, p.p_fib * 1024 + p.p_node, p.p_node),
            _ORDER_BASE - 1)
        keys.append(torch.where(p.field > 0, p.field * _ORDER_BASE + order,
                                _NONE))
    kmin = comm.pmin(keys)
    # tie-breaks: the least fiber id at the largest strain; the one
    # offender at the least key
    cand = comm.pmin([torch.where(p.max_strain == e[0], p.strain_fiber,
                                  _NONE) for p, e in zip(parts, ext)])
    prov = comm.pmax([torch.where(
        key == km, torch.stack([p.field, p.p_fib + 2, p.p_node + 2]),
        torch.zeros(3, dtype=i64, device=key.device))
        for p, key, km in zip(parts, keys, kmin)])
    out = []
    for k, nw in enumerate(news):
        ring = _armed(nw)
        p = parts[k]._replace(
            max_strain=ext[k][0], max_speed=ext[k][1], min_clear=clear[k],
            strain_fiber=torch.where(cand[k] < _NONE, cand[k], -1),
            field=prov[k][0], p_fib=prov[k][1] - 2, p_node=prov[k][2] - 2)
        out.append(_write(ring, _row(p, entries[k].time, dt_used,
                                     _f32(solution_norm, ring.rows.device),
                                     residual_true, health)))
    return out


# ------------------------------------------------------------- host decode

def decode_row(row) -> dict:
    """One ring row -> a named dict (`FLIGHT_FIELDS` keys + a
    ``provenance`` sub-dict when the row localized a nonfinite). Id
    columns come back as ints; NaN floats as None (absent diagnostic);
    ±inf floats as the STRINGS ``"inf"``/``"-inf"`` — the blow-up signal
    survives, while the JSONL streams these rows feed stay RFC-8259
    (Python's json would emit a bare ``Infinity`` token that jq /
    JSON.parse / pandas all reject, exactly on the faulted lines).
    Numeric consumers (the report's extrema) filter on
    isinstance(v, (int, float)) and skip them; health and provenance
    still mark the fault."""
    out = {}
    for name, v in zip(FLIGHT_FIELDS, row):
        v = float(v)
        if name in _ID_FIELDS:
            out[name] = int(v) if math.isfinite(v) else None
        elif math.isnan(v):
            out[name] = None
        elif math.isinf(v):
            out[name] = "inf" if v > 0 else "-inf"
        else:
            out[name] = v
    prov = None
    fid = out.get("prov_field")
    if fid:
        fname = (PROV_FIELDS[fid] if 0 <= fid < len(PROV_FIELDS)
                 else str(fid))
        prov = {"field": fname, "fiber": out.get("prov_fiber"),
                "node": out.get("prov_node")}
    out["provenance"] = prov
    return out


def ring_rows(rows, count) -> list:
    """Chronological decoded rows actually written into a ring — the
    host-side wrap decode, same invariant as `solver.gmres.history_rows`:
    with ``count > K`` the buffer holds the LAST K rows, rotated oldest
    first. Host-only (never traced)."""
    if rows is None:
        return []
    h = np.asarray(rows)
    c = int(count)
    cap = h.shape[0]
    if cap == 0 or c == 0:
        return []
    if c <= cap:
        ordered = h[:c]
    else:
        start = c % cap
        ordered = np.concatenate([h[start:], h[:start]], axis=0)
    return [decode_row(r) for r in ordered]


def last_row(rows, count):
    """The most recent decoded row, or None before any write — O(1):
    decodes only the row at ``(count - 1) % K`` (the run loop and the
    scheduler call this per step/lane; the full-ring decode is the
    failure path's job, `failure_payload`)."""
    if rows is None:
        return None
    h = np.asarray(rows)
    c = int(count)
    if h.shape[0] == 0 or c == 0:
        return None
    return decode_row(h[(c - 1) % h.shape[0]])


def read_last(ring: FlightRecorder):
    """`last_row` of a device ring, read in one copy to the host (the run
    loop's one read a step)."""
    K = ring.rows.shape[-2]
    flat = torch.cat([ring.rows.reshape(-1),
                      ring.count.to(torch.float32).reshape(1)]).cpu().numpy()
    return last_row(flat[:-1].reshape(K, -1), int(flat[-1]))


def read_rows(ring: FlightRecorder):
    """(rows, counts) of a device ring (or a stacked ensemble's [B, K, 13]
    and [B]) as numpy, in one copy to the host."""
    rows = ring.rows
    flat = torch.cat([rows.reshape(-1),
                      ring.count.to(torch.float32).reshape(-1)]).cpu().numpy()
    n = rows.numel()
    return (flat[:n].reshape(tuple(rows.shape)),
            flat[n:].astype(np.int64).reshape(tuple(ring.count.shape)))


def failure_payload(rows, count) -> dict:
    """The structured blast-radius attachment for ``failed`` retirement
    records / tenant status: the ring tail (chronological) plus the last
    row's provenance (`io.ensemble_io.ENSEMBLE_FAILURE_FIELDS`)."""
    tail = ring_rows(rows, count)
    return {"tail": tail,
            "provenance": tail[-1]["provenance"] if tail else None}


# ------------------------------------------------------- the flight report

def iter_jsonl_tolerant(path: str):
    """(record, is_torn_tail) pairs over a JSONL file. A FINAL line that
    fails to parse (kill -9 mid-write) yields ``(None, True)`` instead of
    raising; mid-file garbage, and any line that parses to a non-dict,
    yields ``(None, False)`` so callers count it as unparseable."""
    def parse(line, is_last):
        line = line.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except ValueError:
            return (None, is_last)
        return (rec, False) if isinstance(rec, dict) else (None, False)

    # streamed with one line of lookahead (not readlines(): a long run's
    # stream can reach GB; only the torn tail needs to know the last line)
    with open(path) as fh:
        prev = None
        for line in fh:
            if prev is not None:
                out = parse(prev, False)
                if out is not None:
                    yield out
            prev = line
        if prev is not None:
            out = parse(prev, True)
            if out is not None:
                yield out


def flight_row_key(member: str, row: dict) -> tuple:
    """Dedupe key for one member's flight row — the run loop writes the
    SAME trial row to the metrics JSONL (``flight`` column) and the
    telemetry stream (``flight`` event); reports ingesting both must
    count it once."""
    return (member,) + tuple(
        row.get(k) for k in ("t", "dt_used", "solution_norm",
                             "residual_true", "health"))


def member_of(rec: dict) -> str:
    """Normalized member label of one record: ``member`` then ``tenant``,
    explicit None checks (member id 0 is falsy but real), str()'d so
    metrics records and fault events key identically; a sequential
    run-loop record with neither keys as ``"run"``."""
    member = rec.get("member")
    if member is None:
        member = rec.get("tenant")
    return "run" if member is None else str(member)


class FlightRowDedup:
    """Pair each metrics-column flight row with its telemetry-event twin.

    A naive value-keyed set would ALSO collapse two bitwise-identical
    runs' rows when their files are summarized together (this repo pins
    bitwise determinism everywhere, so identical values across runs are
    the expected case, not a coincidence). Credit matching instead: a
    row of one KIND ("metrics" column vs "trace" event) is a duplicate
    only if an unmatched row of the OTHER kind carries the same key —
    and consuming the match re-arms the pair, so run 2's metrics+trace
    pair dedupes against itself, never against run 1's."""

    _KINDS = ("metrics", "trace")

    def __init__(self):
        self._pending = {k: set() for k in self._KINDS}

    def is_duplicate(self, key: tuple, kind: str) -> bool:
        other = self._KINDS[1 - self._KINDS.index(kind)]
        if key in self._pending[other]:
            self._pending[other].discard(key)
            return True
        self._pending[kind].add(key)
        return False


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


class FlightReport:
    """Accumulate flight-recorder records from any mix of telemetry /
    metrics JSONL streams and render the blast-radius report."""

    def __init__(self):
        #: member -> list of per-step decoded flight rows (run-loop
        #: metrics "flight" values, ensemble step records, "flight"
        #: telemetry events)
        self.steps: dict = {}
        #: member -> failure payload ({"tail": rows, "provenance": ...})
        #: from failed/dt_underflow retirement records
        self.failures: dict = {}
        #: member -> {"verdict": ..., "health": ...} failure context
        self.verdicts: dict = {}
        #: fault-event provenance counters (field name -> count)
        self.fault_fields: dict = {}
        self.torn_tails = 0
        self.unparsed = 0
        #: metrics-column vs telemetry-event row pairing — the run loop
        #: writes the SAME trial row to both streams; two separate
        #: (bitwise-identical) runs' rows must NOT collapse
        self._dedup = FlightRowDedup()
        #: (member, field) pairs whose fault provenance already counted —
        #: one quarantine emits BOTH a failure record (metrics) and a
        #: fault event (trace); feeding both files must count the fault
        #: once
        self._fault_counted: set = set()

    def _count_fault_field(self, member: str, field):
        key = (member, str(field))
        if key in self._fault_counted:
            return
        self._fault_counted.add(key)
        f = str(field)
        self.fault_fields[f] = self.fault_fields.get(f, 0) + 1

    def _add_step(self, member: str, row: dict, kind: str):
        if self._dedup.is_duplicate(flight_row_key(member, row), kind):
            return
        self.steps.setdefault(member, []).append(row)

    def add_record(self, rec: dict):
        ev = rec.get("ev")
        member = member_of(rec)
        if ev == "flight":
            row = {k: rec.get(k) for k in FLIGHT_FIELDS if k in rec}
            if row:
                row["provenance"] = rec.get("provenance")
                self._add_step(member, row, "trace")
            return
        if ev == "fault":
            if rec.get("prov_field"):
                self._count_fault_field(member, rec["prov_field"])
            if rec.get("verdict"):
                ctx = self.verdicts.setdefault(member, {})
                ctx.update(verdict=rec["verdict"], health=rec.get("health"))
                if rec.get("prov_field"):
                    # trace-only streams carry provenance on the fault
                    # event (the scheduler flattens it there); keep it so
                    # the report localizes without the metrics file
                    ctx["provenance"] = {"field": rec["prov_field"],
                                         "fiber": rec.get("prov_fiber"),
                                         "node": rec.get("prov_node")}
            return
        if ev is not None:
            return
        event = rec.get("event", "step")
        if event == "step" and isinstance(rec.get("flight"), dict):
            self._add_step(member, rec["flight"], "metrics")
        elif event in ("failed", "dt_underflow"):
            if isinstance(rec.get("flight"), dict):
                self.failures[member] = rec["flight"]
            self.verdicts.setdefault(member, {}).update(
                verdict=rec.get("verdict"), health=rec.get("health"))
            prov = (rec.get("flight") or {}).get("provenance")
            if prov and prov.get("field"):
                self._count_fault_field(member, prov["field"])

    def add_file(self, path: str):
        for rec, torn in iter_jsonl_tolerant(path):
            if rec is None:
                if torn:
                    self.torn_tails += 1
                else:
                    self.unparsed += 1
                continue
            self.add_record(rec)

    # ------------------------------------------------------------ render

    def _tail_table(self, out: list, rows: list, limit: int = 8):
        cols = ("t", "dt_used", "max_strain", "max_speed", "min_clearance",
                "solution_norm", "residual_true", "health")
        table = [cols]
        for r in rows[-limit:]:
            table.append(tuple(_fmt(r.get(c)) for c in cols))
        widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
        out.extend("  " + "  ".join(c.ljust(w) for c, w in zip(row, widths))
                   .rstrip() for row in table)

    def render(self) -> str:
        out: list = []
        members = sorted(set(self.steps) | set(self.failures)
                         | set(self.verdicts))
        faulted = [m for m in members
                   if m in self.failures or m in self.verdicts]
        for m in faulted:
            ctx = self.verdicts.get(m, {})
            verdict = ctx.get("verdict") or "?"
            if isinstance(verdict, list):
                verdict = "|".join(verdict) or "ok"
            out.append(f"== {m}: FAULT ({verdict}) ==")
            payload = self.failures.get(m) or {}
            tail = payload.get("tail") or self.steps.get(m, [])
            prov = payload.get("provenance")
            if prov is None and tail:
                prov = tail[-1].get("provenance")
            if prov is None:
                prov = ctx.get("provenance")
            if prov and prov.get("field"):
                where = (f"fiber {prov.get('fiber')} node "
                         f"{prov.get('node')}"
                         if prov.get("fiber", -1) not in (None, -1)
                         else f"row {prov.get('node')}")
                out.append(f"first offender: field={prov['field']} {where}")
            else:
                out.append("first offender: (not localized)")
            if tail:
                out.append(f"trajectory into the fault "
                           f"(last {min(len(tail), 8)} of {len(tail)} "
                           "recorded steps):")
                self._tail_table(out, tail)
            out.append("")
        healthy = [m for m in members if m not in faulted and self.steps.get(m)]
        if healthy:
            out.append(f"== healthy members ({len(healthy)}) ==")
            for m in healthy:
                rows = self.steps[m]
                # numeric filter: blow-up rows carry "inf" STRINGS (see
                # decode_row) — extrema are over the finite points
                strains = [r["max_strain"] for r in rows
                           if isinstance(r.get("max_strain"), (int, float))]
                speeds = [r["max_speed"] for r in rows
                          if isinstance(r.get("max_speed"), (int, float))]
                out.append(
                    f"{m}: {len(rows)} step(s)"
                    + (f"  max_strain {max(strains):.3g}" if strains else "")
                    + (f"  max_speed {max(speeds):.3g}" if speeds else ""))
            out.append("")
        if self.fault_fields:
            out.append("fault localization (offender field -> faults): "
                       + ", ".join(f"{k}={v}" for k, v in
                                   sorted(self.fault_fields.items())))
        if self.torn_tails:
            out.append(f"({self.torn_tails} torn trailing line(s) ignored — "
                       "partial write, e.g. kill -9 mid-record)")
        if self.unparsed:
            out.append(f"({self.unparsed} unparseable line(s) skipped)")
        if not out:
            out.append("no flight-recorder records found (arm with "
                       "Params.flight_window > 0)")
        return "\n".join(out).rstrip() + "\n"


def render_flight_report(paths) -> str:
    rep = FlightReport()
    for p in paths:
        rep.add_file(p)
    return rep.render()
