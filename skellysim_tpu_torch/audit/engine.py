"""Contract loading, the suppression discipline, and the per-program and
per-kernel drivers.

Counterpart of `skellysim_tpu.audit.engine`. A contract
(``audit/contracts/<name>.toml``) pins what one run of a registered
program, or one registered kernel family, is allowed to do; a deviation is
a `Finding`; a deliberate deviation is suppressed in the contract file
with a mandatory reason::

    [[suppress]]
    check = "dtype-flow"
    match = "float64->float32"
    reason = "the f32 Krylov loop reads an f32 view of the operator"

A suppression that matches no finding is itself a finding, so every entry
stays load-bearing. The same entries gate the cost baselines
(`obs.cost`, check ``cost-baseline``).

The JAX package's checks read a lowered program; the port's run it once
under `observe.Observer` (`ProgramRun`) and read what it did. The mask
check runs it again with its dead slots poisoned, the retrace check runs
the registered probe, and the replication check compares the shards'
outputs of the same run.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

CONTRACT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "contracts")

#: contract sections the engine understands (the JAX package's); anything
#: else is drift: a typo'd section would otherwise silently stop gating
_KNOWN_SECTIONS = ("program", "collectives", "dtype", "host_sync",
                   "donation", "retrace", "fft", "replication", "dma",
                   "mask", "suppress")


@dataclass(frozen=True)
class Finding:
    program: str
    check: str
    message: str

    def render(self) -> str:
        return f"{self.program}: {self.check}: {self.message}"


def suppress_findings(name: str, data: dict, check: str) -> list:
    """The findings of a file's malformed ``[[suppress]]`` entries, under
    ``check``: each needs a ``check``, a non-empty ``match`` (an empty one
    would match every finding of the check: a blanket suppression must
    not be expressible) and a ``reason``."""
    out = []
    for i, sup in enumerate((data or {}).get("suppress", [])):
        if not sup.get("check") or not sup.get("match"):
            out.append(Finding(name, check, (
                f"suppress entry #{i + 1} needs both `check` and a "
                "non-empty `match`")))
        if not sup.get("reason"):
            out.append(Finding(name, check, (
                f"suppress entry #{i + 1} is missing its reason: every "
                "suppression must say why")))
    return out


def apply_suppressions(name, contract, findings, active_checks=None):
    """Filter ``findings`` through the file's ``[[suppress]]`` entries;
    unused entries become findings (the lint-pragma rule, file-side).

    ``active_checks`` limits the unused-suppression enforcement: a
    filtered run must not flag entries for checks it skipped.
    """
    entries = [dict(e, used=False) for e in (contract or {}).get(
        "suppress", [])]
    kept = []
    for f in findings:
        hit = False
        for e in entries:
            if (e.get("check") == f.check and e.get("reason")
                    and e.get("match") and e["match"] in f.message):
                e["used"] = True
                hit = True
        if not hit:
            kept.append(f)
    for e in entries:
        if (not e["used"] and e.get("reason") and e.get("check")
                and (active_checks is None or e["check"] in active_checks)):
            kept.append(Finding(name, "contract", (
                f"unused suppression (check={e['check']!r}, "
                f"match={e.get('match')!r}): it matches no finding — "
                "remove it or it hides the next real one")))
    return kept


# ------------------------------------------------------------- contracts

def contract_path(name: str, contract_dir: str | None = None) -> str:
    return os.path.join(contract_dir or CONTRACT_DIR, f"{name}.toml")


def load_contract(name: str, contract_dir: str | None = None):
    """(contract dict, [Finding]): findings for a missing file, an unknown
    section, a ``program.name`` that is not the file's and a malformed
    ``[[suppress]]`` entry."""
    from ..config import toml_io

    path = contract_path(name, contract_dir)
    if not os.path.exists(path):
        return None, [Finding(name, "contract", (
            f"no contract file at audit/contracts/{name}.toml — every "
            "registered program must pin what its run does (run "
            f"`python -m skellysim_tpu_torch.audit --dump-contract {name}` "
            "for the observed inventory)"))]
    data = toml_io.load(path)
    out = []
    for key in data:
        if key not in _KNOWN_SECTIONS:
            out.append(Finding(name, "contract", (
                f"unknown contract section [{key}] (known: "
                f"{', '.join(_KNOWN_SECTIONS)}) — a typo here would "
                "silently stop gating")))
    declared = data.get("program", {}).get("name")
    if declared is not None and declared != name:
        out.append(Finding(name, "contract", (
            f"contract file {name}.toml declares program.name="
            f"{declared!r} — copy-paste drift")))
    out.extend(suppress_findings(name, data, "contract"))
    return data, out


# ---------------------------------------------------------- program runs

class ProgramRun:
    """One observed run of a registered program: the fixture built on
    ``device`` with the dead slots its contract's ``[[mask.axes]]``
    declare (`maskflow.with_dead_slots`), run once unobserved on a build
    of its own, then observed: its arguments' bits before the call, the
    outputs and the `observe.Observation`. The checks read it;
    the mask check's clean half is this run."""

    def __init__(self, prog, device=None, contract=None):
        from . import maskflow
        from .observe import Observer, flatten

        self.name = prog.name
        self.prog = prog
        self.built = prog.build(device)
        self.device = self.built.device
        axes, _ = maskflow.axes_from_contract(
            (contract or {}).get("mask", {}), prog.name)
        self.axes = axes
        self.args = maskflow.with_dead_slots(self.built.args, axes)
        self.kwargs = self.built.kwargs
        # a first run on a build of its own: libraries, cached tables and
        # plans are built there, so the observed run is the steady state
        # (what a second call builds is the retrace check's)
        warm = prog.build(device)
        warm.fn(*maskflow.with_dead_slots(warm.args, axes), **warm.kwargs)
        del warm
        self.before = [(p, _snapshot(v)) for p, v in flatten(self.args)]
        with Observer(self.device, (self.args, self.kwargs)) as obs:
            self.out = self.built.fn(*self.args, **self.kwargs)
        self.observation = obs
        self.after = flatten(self.args)
        self._mask = self._traces = None

    def rerun(self, args):
        """The program again on ``args`` (unobserved)."""
        return self.built.fn(*args, **self.kwargs)

    def mask_report(self):
        """`maskflow.analyze` of this run (its poisoned runs made once)."""
        if self._mask is None:
            from . import maskflow

            self._mask = maskflow.analyze(self)
        return self._mask

    def traces(self):
        """The program's retrace probe on this run's device (run once)."""
        if self._traces is None:
            self._traces = self.prog.retrace_probe(self.device)
        return self._traces


def _snapshot(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if hasattr(v, "copy"):
        return v.copy()
    return v


def run_program_audit(prog, contract=None, checks=None, device=None,
                      run=None, contract_dir: str | None = None):
    """Audit one registered `AuditProgram` on ``device`` (None: the card);
    returns the unsuppressed findings.

    ``contract=None`` loads the program's file from ``contract_dir``
    (`CONTRACT_DIR`); tests pass a dict directly. ``run``: a `ProgramRun`
    already made (tests share one run of the registry between checks).
    """
    from .checks import CHECKS

    if contract is None:
        contract, findings = load_contract(prog.name, contract_dir)
        if contract is None:
            return findings
    else:
        findings = []
    program_checks = tuple(c for c in CHECKS if c.over_programs)
    active = program_checks if checks is None else tuple(
        c for c in program_checks if c.id in set(checks))
    active_ids = None if checks is None else {c.id for c in active}
    if run is None:
        try:
            run = ProgramRun(prog, device, contract)
        except Exception as e:  # a program that no longer runs IS the finding
            findings.append(Finding(prog.name, "build", (
                f"entry point failed to build/run: {type(e).__name__}: "
                f"{e}")))
            return apply_suppressions(prog.name, contract, findings,
                                      active_ids)
    for check in active:
        probe = prog.retrace_probe if check.wants_probe else None
        try:
            findings.extend(check.run(prog.name, run, contract, probe))
        except Exception as e:
            findings.append(Finding(prog.name, check.id, (
                f"the check failed to run: {type(e).__name__}: {e}")))
    return apply_suppressions(prog.name, contract, findings, active_ids)


def run_kernel_audit(kern, contract=None, checks=None, device=None,
                     contract_dir: str | None = None):
    """Audit one registered `AuditKernel` (the kernel twin of
    `run_program_audit`): only the kernel-scoped checks (``dma``,
    ``mask``) apply; contract loading, the suppression discipline and the
    build finding are the same. ``dma`` needs the card: on a CPU device
    the caller leaves it out (the CLI says so on its own line)."""
    from .checks import CHECKS

    if contract is None:
        contract, findings = load_contract(kern.name, contract_dir)
        if contract is None:
            return findings
    else:
        findings = []
    active = tuple(c for c in CHECKS if c.over_kernels
                   and (checks is None or c.id in set(checks)))
    active_ids = {c.id for c in active}
    try:
        built = kern.build(device)
    except Exception as e:  # a kernel that no longer builds IS the finding
        findings.append(Finding(kern.name, "build", (
            f"kernel failed to build: {type(e).__name__}: {e}")))
        return apply_suppressions(kern.name, contract, findings, active_ids)
    for check in active:
        try:
            findings.extend(check.run(kern.name, built, contract, None))
        except Exception as e:
            findings.append(Finding(kern.name, check.id, (
                f"the check failed to run: {type(e).__name__}: {e}")))
    return apply_suppressions(kern.name, contract, findings, active_ids)


# --------------------------------------------------------------- dumping

def dump_kernel_contract(kern, device=None) -> str:
    """The observed ``[dma]`` inventory of one registered kernel family in
    contract TOML (needs the card)."""
    from ..config import toml_io
    from . import dmaflow

    report = dmaflow.analyze(kern.build(device))
    data = {"program": {"name": kern.name}, "dma": dict(report.observed),
            "mask": {"axes": []}}
    return toml_io.dumps(data)


def dump_contract(prog, device=None, contract_dir: str | None = None,
                  run=None) -> str:
    """The observed inventory of ``prog`` in contract TOML: the starting
    point for writing (or deliberately updating) its contract file. The
    ``[[mask.axes]]`` come from the existing contract (a declaration is a
    human decision, not an observation), the pad classes from the run."""
    from ..config import toml_io
    from . import checks, repflow

    existing = {}
    path = contract_path(prog.name, contract_dir)
    if os.path.exists(path):
        existing = toml_io.load(path)
    run = run or ProgramRun(prog, device, existing)
    obs = run.observation
    data = {"program": {"name": prog.name}}
    coll = obs.collective_table()
    if coll:
        data["collectives"] = coll
    edges, mixed = obs.edge_sites(), obs.mixed_sites()
    if edges or mixed:
        data["dtype"] = {}
        if edges:
            data["dtype"]["promotions"] = edges
        if mixed:
            data["dtype"]["mixed"] = mixed
    data["host_sync"] = checks.host_sync_observed(obs)
    data["donation"] = {"donated": bool(checks.changed_arguments(run))}
    if prog.retrace_probe is not None:
        data["retrace"] = {"max_traces": 1}
    if obs.fft_sites():
        data["fft"] = {"count": obs.fft_sites()}
    rep = repflow.analyze(run)
    if rep is not None:
        data["replication"] = rep.observed
    mask = {"axes": existing.get("mask", {}).get("axes", [])}
    if run.axes:
        mask["outputs"] = run.mask_report().observed
    data["mask"] = mask
    return toml_io.dumps(data)
