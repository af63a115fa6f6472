"""Findings and the suppression discipline of a checked-in file.

Counterpart of `skellysim_tpu.audit.engine` in the part `obs.cost` needs:
a deviation from a pinned file is a `Finding`; a deliberate deviation is
suppressed in that file with a mandatory reason::

    [[suppress]]
    check = "cost-baseline"
    match = "temp_bytes drifted"
    reason = "the shell operator is kept in f32 since ..."

A suppression that matches no finding is itself a finding, so every entry
stays load-bearing. The JAX package's contract files and their checks
(`load_contract`, `run_program_audit`, `dump_contract`) read lowered XLA
programs and have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass


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
