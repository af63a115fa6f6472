"""Per-phase roofline attribution over a profile dump.

Counterpart of `skellysim_tpu.obs.roofline`. `obs profile` answers WHERE
a step spends device time (per-phase walls, `obs.profile`); `obs cost`
pins WHAT each program costs (flops / bytes_accessed / peak_bytes and the
collectives' largest operands, `obs/baselines/*.toml`). This module joins
the two against the checked-in device-peak table (`obs/device_peaks.toml`,
keyed by the ``device_kind`` every dump's provenance carries) into the
roofline question per phase: achieved FLOP/s and bytes/s, arithmetic
intensity, a compute-/memory-/comms-bound verdict, and an MFU-style
achieved-vs-peak ratio.

Attribution model (the JAX package's, stated, not hidden):

* the cost tables are PROGRAM totals, not per-op tables, so per-phase
  flops/bytes are the program totals apportioned over the measured
  per-phase COMPUTE self-time (wall minus collective time). Every phase
  therefore reads the program's intensity and the same achieved rate;
  the informative figures are the window's ``totals.mfu`` and the
  verdict;
* collective bytes per executed op are the baseline's ``max_bytes`` for
  that kind — an upper bound, so the interconnect's utilization is a
  ceiling;
* walls sum over device lanes; flops scale with ``n_devices``, so
  achieved rates are PER CARD and compare with the per-card peaks. The
  lanes are the distinct pids of the dump's device events (kernels,
  memcpys, memsets): a Kineto dump gives its host ops another pid than
  the card's, so the JAX package's count of every pid would read 2 on one
  card;
* ``executions`` is the number of program executions inside the
  profiling window (default 1).

Unknown device kinds rate as ``unrated``: comms-bound verdicts (a measured
fact) survive, compute/memory verdicts and achieved-vs-peak ratios degrade
to None — never a crash.

json/toml parsing only: nothing here touches the card.
"""

from __future__ import annotations

import json
import os
from typing import Optional

DEVICE_PEAKS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "device_peaks.toml")

#: the verdict vocabulary (docs/observability.md "Roofline")
VERDICTS = ("compute-bound", "memory-bound", "comms-bound", "unrated")

#: a phase is comms-bound when collectives take more than half its wall
COMM_BOUND_FRAC = 0.5

#: keys every device_peaks.toml row must carry
PEAK_KEYS = ("peak_flops", "hbm_gbps", "ici_gbps")



def _load_toml(path: str) -> dict:
    from ..config import toml_io

    return toml_io.load(path)


# ------------------------------------------------------------- input tables

def load_device_peaks(path: Optional[str] = None) -> dict:
    """{device_kind key: {peak_flops, hbm_gbps, ici_gbps}} from the
    checked-in rating table."""
    return dict(_load_toml(path or DEVICE_PEAKS_PATH).get("device") or {})


def peaks_for_kind(device_kind, table: Optional[dict] = None):
    """(matched key | None, peaks dict | None) — case-insensitive
    SUBSTRING match, longest key wins ("NVIDIA H100 80GB HBM3" rates
    as "H100").
    Unknown/missing kinds return (None, None): the unrated path."""
    if not device_kind:
        return None, None
    if table is None:
        table = load_device_peaks()
    kind = str(device_kind).lower()
    best_key, best_peaks = None, None
    for key, peaks in table.items():
        if key.lower() in kind and (best_key is None
                                    or len(key) > len(best_key)):
            best_key, best_peaks = key, peaks
    if best_peaks is not None and not all(k in best_peaks
                                          for k in PEAK_KEYS):
        return None, None   # malformed row degrades to unrated, not a crash
    return best_key, best_peaks


def load_cost_table(program: str,
                    baseline_dir: Optional[str] = None) -> Optional[dict]:
    """The program's checked-in cost table (`obs/baselines/<program>.toml`
    ``[cost]``) or None."""
    from .cost import baseline_path

    path = baseline_path(program, baseline_dir)
    if not os.path.exists(path):
        return None
    cost = _load_toml(path).get("cost")
    return dict(cost) if isinstance(cost, dict) else None


def load_collective_bytes(program: str,
                          baseline_dir: Optional[str] = None) -> dict:
    """{collective kind: max_bytes} from the program's baseline
    ``[collectives]`` (the port has no audit contracts: `obs.cost` writes
    the largest operand a shard by kind there)."""
    from .cost import baseline_path

    path = baseline_path(program, baseline_dir)
    if not os.path.exists(path):
        return {}
    out = {}
    for kind, spec in (_load_toml(path).get("collectives") or {}).items():
        if isinstance(spec, dict) and "max_bytes" in spec:
            out[kind] = float(spec["max_bytes"])
    return out


def load_cost_sidecar(path: str):
    """(cost dict | None, {kind: max_bytes}) from a standalone cost-table
    TOML (``[cost]`` + optional ``[collectives.<kind>] max_bytes``) — the
    `--cost-table` override for fixtures and unregistered programs."""
    data = _load_toml(path)
    cost = data.get("cost")
    coll = {k: float(v["max_bytes"])
            for k, v in (data.get("collectives") or {}).items()
            if isinstance(v, dict) and "max_bytes" in v}
    return (dict(cost) if isinstance(cost, dict) else None), coll


def load_profile_provenance(profile_dir: str) -> dict:
    """The ``provenance.json`` sidecar `profile_session` drops next to the
    dump (torch_version/device_kind/backend/card); {} when absent."""
    try:
        with open(os.path.join(profile_dir, "provenance.json")) as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else {}
    except Exception:
        return {}


# ------------------------------------------------------------ the roofline

def _phase_groups(trace) -> list:
    """Per-phase rollup KEEPING per-kind collective counts (by_phase()
    only keeps durations; counts size the comm bytes)."""
    groups: dict = {}
    for r in trace.rows:
        key = r["phase"] or "(unattributed)"
        g = groups.setdefault(key, {"phase": key, "dur_us": 0.0, "ops": 0,
                                    "collectives": {}})
        g["dur_us"] += r["dur_us"]
        g["ops"] += r["count"]
        if r["collective"]:
            c = g["collectives"].setdefault(
                r["collective"], {"dur_us": 0.0, "count": 0})
            c["dur_us"] += r["dur_us"]
            c["count"] += r["count"]
    out = sorted(groups.values(), key=lambda g: -g["dur_us"])
    return out


def device_lanes(trace) -> int:
    """The device lanes of a dump: the distinct pids of its device events
    (kernels, memcpys, memsets), at least 1 (a CPU dump has none)."""
    from .profile import DEVICE_CATEGORIES

    pids = {e.get("pid") for e in trace.events
            if e.get("op") in DEVICE_CATEGORIES}
    return max(1, len(pids))


def analyze(trace, cost: Optional[dict] = None,
            collective_bytes: Optional[dict] = None,
            peaks: Optional[dict] = None,
            executions: int = 1,
            n_devices: Optional[int] = None) -> dict:
    """The roofline join over a parsed `DeviceTrace` — pure math, every
    input injectable (the oracle tests drive this directly)."""
    collective_bytes = collective_bytes or {}
    if n_devices is None:
        n_devices = device_lanes(trace)
    executions = max(int(executions), 1)

    flops_total = float(cost["flops"]) if cost and "flops" in cost else None
    bytes_total = (float(cost["bytes_accessed"])
                   if cost and "bytes_accessed" in cost else None)
    ai = (flops_total / bytes_total
          if flops_total is not None and bytes_total else None)

    peak_flops = peak_bps = ici_bps = ridge = None
    if peaks is not None:
        peak_flops = float(peaks["peak_flops"])
        peak_bps = float(peaks["hbm_gbps"]) * 1e9
        ici_bps = float(peaks["ici_gbps"]) * 1e9
        ridge = peak_flops / peak_bps if peak_bps else None

    groups = _phase_groups(trace)
    total_us = trace.total_us
    total_compute_us = sum(
        max(g["dur_us"] - sum(c["dur_us"] for c in g["collectives"].values()),
            0.0) for g in groups)

    phases = []
    classified_us = 0.0
    for g in groups:
        wall_us = g["dur_us"]
        if wall_us <= 0:
            continue
        comm_us = sum(c["dur_us"] for c in g["collectives"].values())
        compute_us = max(wall_us - comm_us, 0.0)
        comm_frac = comm_us / wall_us
        # per-chip wall of this phase inside the window (lane-summed / lanes)
        wall_chip_s = wall_us * 1e-6 / n_devices

        frac = (compute_us / total_compute_us) if total_compute_us > 0 else 0.0
        flops = flops_total * executions * frac if flops_total is not None else None
        bytes_ = bytes_total * executions * frac if bytes_total is not None else None
        achieved_fps = (flops / wall_chip_s
                        if flops is not None and wall_chip_s > 0 else None)
        achieved_bps = (bytes_ / wall_chip_s
                        if bytes_ is not None and wall_chip_s > 0 else None)

        # comm bytes from the pinned per-op bounds: count * max_bytes per
        # kind; kinds without a pin stay unsized (ici rate from sized only)
        comm_bytes = 0.0
        unsized = []
        colls = {}
        for kind, c in sorted(g["collectives"].items()):
            b = collective_bytes.get(kind)
            colls[kind] = {"dur_us": round(c["dur_us"], 3),
                           "count": c["count"],
                           "bytes": (c["count"] * b) if b is not None
                           else None}
            if b is None:
                unsized.append(kind)
            else:
                comm_bytes += c["count"] * b
        comm_bps = (comm_bytes / (comm_us * 1e-6)
                    if comm_bytes and comm_us > 0 else None)

        if comm_frac > COMM_BOUND_FRAC:
            verdict = "comms-bound"
            vs_peak = (comm_bps / ici_bps
                       if comm_bps is not None and ici_bps else None)
        elif ai is None or ridge is None:
            verdict = "unrated"
            vs_peak = None
        elif ai >= ridge:
            verdict = "compute-bound"
            vs_peak = (achieved_fps / peak_flops
                       if achieved_fps is not None and peak_flops else None)
        else:
            verdict = "memory-bound"
            vs_peak = (achieved_bps / peak_bps
                       if achieved_bps is not None and peak_bps else None)

        if (g["phase"] != "(unattributed)"
                and verdict != "unrated" and vs_peak is not None):
            classified_us += wall_us

        phases.append({
            "phase": g["phase"],
            "wall_us": round(wall_us, 3),
            "share": round(wall_us / total_us, 4) if total_us > 0 else 0.0,
            "ops": g["ops"],
            "comm_us": round(comm_us, 3),
            "comm_frac": round(comm_frac, 4),
            "flops": round(flops, 1) if flops is not None else None,
            "bytes": round(bytes_, 1) if bytes_ is not None else None,
            "ai": round(ai, 4) if ai is not None else None,
            "achieved_flops_per_s": (round(achieved_fps, 1)
                                     if achieved_fps is not None else None),
            "achieved_bytes_per_s": (round(achieved_bps, 1)
                                     if achieved_bps is not None else None),
            "comm_bytes": round(comm_bytes, 1) if comm_bytes else 0.0,
            "ici_bytes_per_s": (round(comm_bps, 1)
                                if comm_bps is not None else None),
            "unsized_collectives": unsized,
            "collectives": colls,
            "verdict": verdict,
            "achieved_vs_peak": (round(vs_peak, 6)
                                 if vs_peak is not None else None),
        })

    # window totals: the MFU-style per-chip utilization of the whole step
    window_chip_s = total_us * 1e-6 / n_devices
    tot_fps = (flops_total * executions / window_chip_s
               if flops_total is not None and window_chip_s > 0 else None)
    tot_bps = (bytes_total * executions / window_chip_s
               if bytes_total is not None and window_chip_s > 0 else None)
    totals = {
        "achieved_flops_per_s": (round(tot_fps, 1)
                                 if tot_fps is not None else None),
        "achieved_bytes_per_s": (round(tot_bps, 1)
                                 if tot_bps is not None else None),
        "mfu": (round(tot_fps / peak_flops, 6)
                if tot_fps is not None and peak_flops else None),
        "hbm_util": (round(tot_bps / peak_bps, 6)
                     if tot_bps is not None and peak_bps else None),
        "comm_us": round(sum(p["comm_us"] for p in phases), 3),
    }
    return {
        "total_us": round(total_us, 3),
        "attributed_frac": round(trace.attributed_frac, 4),
        "classified_frac": (round(classified_us / total_us, 4)
                            if total_us > 0 else 0.0),
        "n_devices": n_devices,
        "executions": executions,
        "ai": round(ai, 4) if ai is not None else None,
        "ridge_flops_per_byte": round(ridge, 4) if ridge is not None else None,
        "peak_memory_bytes": (int(cost["peak_bytes"])
                              if cost and "peak_bytes" in cost else None),
        "phases": phases,
        "totals": totals,
    }


def roofline_report(profile_dir: str, program: Optional[str] = None,
                    cost_table: Optional[str] = None,
                    device_kind: Optional[str] = None,
                    executions: int = 1,
                    n_devices: Optional[int] = None,
                    baseline_dir: Optional[str] = None,
                    peaks_path: Optional[str] = None) -> dict:
    """The `obs roofline DIR` document: parse the dump, resolve the cost
    table (``--cost-table`` sidecar > ``--program`` baseline),
    resolve device_kind (flag > the dump's provenance sidecar), rate
    against the peak table, and run `analyze`.

    Raises FileNotFoundError for a missing dump (ValueError for a card
    dump with no device event); an unknown program (no baseline) raises
    KeyError — the CLI maps all three to exit 2. Unknown
    device kinds are NOT errors: they rate as unrated."""
    from .profile import load_device_trace

    trace = load_device_trace(profile_dir)

    cost, coll = None, {}
    if cost_table:
        if not os.path.exists(cost_table):
            raise FileNotFoundError(f"no cost table at {cost_table!r}")
        cost, coll = load_cost_sidecar(cost_table)
    elif program:
        cost = load_cost_table(program, baseline_dir)
        if cost is None:
            raise KeyError(
                f"no cost baseline for program {program!r} under "
                f"obs/baselines/ — run `python -m skellysim_tpu_torch.obs "
                "cost --update` or pass --cost-table")
        coll = load_collective_bytes(program, baseline_dir)

    provenance = load_profile_provenance(profile_dir)
    kind = device_kind or provenance.get("device_kind")
    rated_as, peaks = peaks_for_kind(kind, load_device_peaks(peaks_path))

    doc = analyze(trace, cost=cost, collective_bytes=coll, peaks=peaks,
                  executions=executions, n_devices=n_devices)
    doc.update({
        "profile_dir": str(profile_dir),
        "program": program,
        "device_kind": kind,
        "rated_as": rated_as,
        "peaks": dict(peaks) if peaks else None,
        "provenance": provenance or None,
    })
    return doc


# -------------------------------------------------------------- rendering

def _fmt_rate(v, unit: str) -> str:
    if v is None:
        return "-"
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{prefix}{unit}"
    return f"{v:.2f}{unit}"


def render_roofline(doc: dict) -> str:
    """The `obs roofline` text report."""
    rows = [("phase", "time_ms", "share", "verdict", "vs-peak", "comm%",
             "flop/s", "B/s", "ici B/s")]
    for p in doc["phases"]:
        rows.append((
            p["phase"], f"{p['wall_us'] / 1e3:.3f}", f"{p['share']:.1%}",
            p["verdict"],
            ("-" if p["achieved_vs_peak"] is None
             else f"{p['achieved_vs_peak']:.2%}"),
            f"{p['comm_frac']:.0%}",
            _fmt_rate(p["achieved_flops_per_s"], "F/s"),
            _fmt_rate(p["achieved_bytes_per_s"], "B/s"),
            _fmt_rate(p["ici_bytes_per_s"], "B/s"),
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
           for r in rows]
    out.append("")
    kind = doc.get("device_kind") or "unknown"
    rating = (f"rated as {doc['rated_as']!r}" if doc.get("rated_as")
              else "UNRATED (no device_peaks.toml row — verdicts from the "
                   "comm/compute split only)")
    out.append(f"device_kind: {kind} — {rating}; "
               f"{doc['n_devices']} device lane(s), "
               f"{doc['executions']} execution(s)")
    if doc.get("ai") is not None:
        ridge = doc.get("ridge_flops_per_byte")
        out.append(f"program intensity: {doc['ai']:g} flop/byte"
                   + (f" (ridge {ridge:g})" if ridge is not None else "")
                   + (f"; static peak memory {doc['peak_memory_bytes']:,} B"
                      if doc.get("peak_memory_bytes") else ""))
    mfu = doc["totals"].get("mfu")
    if mfu is not None:
        out.append(f"window MFU {mfu:.2%}, HBM util "
                   f"{doc['totals']['hbm_util']:.2%} (per chip)")
    out.append(f"classified {doc['classified_frac']:.1%} of device time "
               f"({doc['attributed_frac']:.1%} attributed to named phases)")
    return "\n".join(out) + "\n"
