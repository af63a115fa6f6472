"""Replication across shards, checked on a run of the sharded step.

Runtime twin of `skellysim_tpu.audit.repflow`, which proves by abstract
interpretation over each ``shard_map`` region that the manual-SPMD
programs cannot deadlock and that their replicated outputs are
replicated. The port's sharded step (`parallel.spmd`) runs every shard in
one process, one host loop steering all of them, so a deadlock has no
form here; what can go wrong is a shard's copy of a replicated value
drifting from the others'. A run of ``System.step_spmd``'s program checks:

* **replicated outputs**: every output leaf that is not a block of a
  sharded quantity has the same bits on every shard. The sharded leaves
  are the ones whose inputs are: a leaf of the input `ShardedState` whose
  shards hold different blocks of one storage (`shard_state` on one
  device makes views), or different values; the solution's fiber and
  sharded shell blocks. Everything else (time, dt, the background, the
  bodies, a replicated shell, the flight ring, the body solution, the
  step's `StepInfo`, one host object) is replicated;
* **host decisions**: every reduction and gather of the `Collectives`
  seam handed each shard the same bits (`observe.Observer` records
  ``divergent`` calls), so whichever shard's copy the host reads to stop
  the Krylov loop, take the guard's verdict or pick the step size, every
  shard would have taken the same decision;
* **the surface**: the counts of replicated and varying output leaves
  (over one shard's outputs) are pinned in ``[replication]``, with the
  mesh axis (``"fib"``, the JAX package's).

A run shows the fixture: a divergence its values do not trigger stays
unseen, where the static analysis would flag the site.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .observe import _storage, bit_equal, flatten

MESH_AXES = ["fib"]


@dataclass
class RepReport:
    observed: dict      # mesh_axes, replicated_outputs, varying_outputs
    findings: list      # messages


def _is_sharded_state(v) -> bool:
    return (isinstance(v, tuple) and hasattr(v, "_fields")
            and "shards" in v._fields and "mesh" in v._fields)


def _sharded_inputs(state) -> set:
    """Shard-relative paths of the input leaves that differ between shards
    (distinct views of one storage, or distinct bits)."""
    per = [dict(flatten(s)) for s in state.shards]
    out = set()
    for path, first in per[0].items():
        others = [p.get(path) for p in per[1:]]
        if isinstance(first, torch.Tensor):
            keys = {(_storage(t), t.storage_offset()) if isinstance(
                t, torch.Tensor) else None for t in [first, *others]}
            # one device: distinct blocks of a storage, whatever their
            # values; several: distinct bits
            if len(keys) > 1 and (first.device == others[0].device or not all(
                    bit_equal(first, o) for o in others)):
                out.add(path)
        elif not all(bit_equal(first, o) for o in others):
            out.add(path)
    return out


def analyze(run, out=None):
    """The `RepReport` of a sharded program's run (an `engine.ProgramRun`
    whose first argument is a `ShardedState`), or None for a program that
    is not sharded. ``out``: other outputs to judge (tests perturb one)."""
    state = run.args[0] if run.args else None
    if not _is_sharded_state(state):
        return None
    out = run.out if out is None else out
    new_state, solution, info = out
    sharded_in = _sharded_inputs(state)
    findings, replicated, varying = [], [], []

    per = [dict(flatten(s)) for s in new_state.shards]
    for path, first in per[0].items():
        if path in sharded_in:
            varying.append(f"state.{path}")
            continue
        replicated.append(f"state.{path}")
        for k, p in enumerate(per[1:], start=1):
            if not bit_equal(first, p.get(path)):
                findings.append(
                    f"replicated output 'state.{path}' differs between "
                    f"shard 0 and shard {k}")
                break

    sharded_shell = new_state.shell_mode == "sharded"
    for field in solution._fields:
        part = getattr(solution, field)
        if part is None:
            continue
        if field == "fibers":
            varying.extend(f"solution.fibers.{i}" for i in range(len(part)))
        elif field == "shell" and sharded_shell:
            varying.append("solution.shell")
        else:
            replicated.append(f"solution.{field}")
            for k in range(1, len(part)):
                if not bit_equal(part[0], part[k]):
                    findings.append(
                        f"replicated output 'solution.{field}' differs "
                        f"between shard 0 and shard {k}")
                    break
    replicated.extend(f"info.{p}" for p, _ in flatten(info))

    obs = run.observation
    for (kind, where), n in sorted(obs.divergent.items()):
        findings.append(
            f"{n} {kind} call(s) at {where} handed the shards different "
            "bits: a host decision read from one shard's copy would not be "
            "every shard's")
    observed = {"mesh_axes": list(MESH_AXES),
                "replicated_outputs": len(replicated),
                "varying_outputs": len(varying)}
    return RepReport(observed, findings)
