"""The ``dma`` check of the hand-written kernels, on the card.

Runtime twin of `skellysim_tpu.audit.dmaflow`, the JAX package's static
verifier of a Pallas kernel's DMA program (read-before-arrival,
overwrite-in-flight, semaphore balance, the VMEM footprint against the
shared budget). The port's kernels A-H stage their sources through shared
memory (``cp.async`` double buffers in G / H, the tile loads of A-F), and
the card's machine runs no compute-sanitizer, so the check has two halves:

* **resources**: each compiled function's registers, static shared bytes
  and spill bytes, read from the build's ``-Xptxas -v`` report
  (`ops.cuda_build.build`), plus the dynamic shared bytes it launches
  with, against the card's per-block shared-memory limit
  (``shared_memory_per_block_optin``) and the contract's pins (the
  counterpart of the VMEM footprint against the shared budget). A spill
  is a finding;
* **repeats**: `REPEATS` back-to-back launches at a ragged shape (no
  multiple of a tile, a chunk or a warp) give the same bits every time,
  and the first matches the plain version within its gate. A read before
  the data arrived, or a buffer overwritten while a warp still reads it,
  shows as launches that disagree, or a result off the plain one.

A run shows these launches: an ordering fault that these shapes and this
card's timing do not expose stays unseen, where the static analysis would
prove its absence.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

#: back-to-back launches a case makes
REPEATS = 20


@dataclass
class DmaReport:
    observed: dict
    findings: list
    table: list         # one row a compiled function: name, regs, smem, spill
    errors: dict        # case -> the first launch's error from the plain one
    smem_limit: int     # the card's shared bytes a block (opt-in)


def ptxas_entries(report: str) -> dict:
    """``{mangled name: {"registers", "smem", "spill"}}`` of every entry
    function in a ``-Xptxas -v`` report."""
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            out[current] = {"registers": 0, "smem": 0, "spill": 0}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[current]["smem"] = int(s.group(1)) if s else 0
    return out


def _rel_err(got, ref) -> float:
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale else 1.0)


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def analyze(built, repeats: int = REPEATS) -> DmaReport:
    """Both halves over one `registry.BuiltKernel` (its cases on the
    card)."""
    from ..ops import cuda_build
    from .observe import bit_equal

    findings, table = [], []
    entries = ptxas_entries(cuda_build.build(built.source)["ptxas"])
    props = torch.cuda.get_device_properties(
        torch.device(built.device or "cuda"))
    smem_limit = int(getattr(props, "shared_memory_per_block_optin", 0)
                     or props.shared_memory_per_block)
    registers, smem, spills, errors = {}, {}, 0, {}
    for case in built.cases:
        for pattern in case.entries:
            names = [n for n in entries if re.search(pattern, n)]
            if len(names) != 1:
                findings.append(
                    f"{case.label}: {len(names)} compiled functions match "
                    f"{pattern!r} in {built.source}.cu's ptxas report")
                continue
            e = entries[names[0]]
            total = e["smem"] + case.dynamic_smem
            table.append({"case": case.label, "function": pattern,
                          "registers": e["registers"],
                          "smem_static": e["smem"],
                          "smem_dynamic": case.dynamic_smem,
                          "spill_bytes": e["spill"]})
            registers[case.label] = max(registers.get(case.label, 0),
                                        e["registers"])
            smem[case.label] = max(smem.get(case.label, 0), total)
            spills += e["spill"]
            if e["spill"]:
                findings.append(f"{case.label}: {pattern} spills "
                                f"{e['spill']} bytes")
            if total > smem_limit:
                findings.append(
                    f"{case.label}: {pattern} takes {total} shared bytes a "
                    f"block, over the card's {smem_limit}")
        outs = []
        for _ in range(repeats):
            outs.append([t.clone() for t in _as_list(case.wrapper(
                *case.args))])
        torch.cuda.synchronize()
        differ = [k for k in range(1, repeats)
                  if not bit_equal(outs[0], outs[k])]
        if differ:
            findings.append(
                f"{case.label}: {len(differ)} of {repeats - 1} repeated "
                f"launches gave other bits than the first (launches "
                f"{differ[:5]}) — a read before arrival or an overwrite in "
                "flight")
        ref = _as_list(case.plain(*case.args))
        err = max(_rel_err(g.double().cpu(), r.double().cpu())
                  for g, r in zip(outs[0], ref))
        errors[case.label] = err
        if not all(bool(torch.isfinite(g).all()) for g in outs[0]):
            findings.append(f"{case.label}: non-finite output")
        if not err <= case.rtol:
            findings.append(
                f"{case.label}: {err:.3e} from the plain version, over its "
                f"gate {case.rtol:g}")
    observed = {"source": built.source, "repeats": repeats,
                "registers": registers, "smem_bytes": smem,
                "spill_bytes": spills}
    return DmaReport(observed, findings, table, errors, smem_limit)
