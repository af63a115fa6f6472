"""skelly-audit for the port: ``python -m skellysim_tpu_torch.audit
[--program NAME]... [--check ID]... [--list-checks] [--list-programs]
[--dump-contract NAME] [--device cpu|cuda]``.

The exit status is the JAX package's (`skellysim_tpu.audit.cli`): 0 when
every audited program and kernel is contract-clean, 1 when an
unsuppressed finding remains, 2 on a usage error. The programs run on the
card when there is one, else on the CPU (``--device`` chooses), as
``obs cost`` does. The ``dma`` check launches kernels A-H, so it needs the
card: ``--check dma`` without one exits 2, and a run on the CPU says on
its own line that ``dma`` was not run; it never counts as clean there.
"""

from __future__ import annotations

import argparse
import sys


def _device(arg):
    import torch

    if arg is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    from ..device import resolve_device

    return resolve_device(arg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m skellysim_tpu_torch.audit",
        description="Runtime program auditor: one observed run of each "
                    "registered program against its contract (collectives, "
                    "dtype flow, host syncs, donation, retraces, FFTs, "
                    "replication, masking) and the hand-written kernels' "
                    "resources and repeats on the card (dma).")
    parser.add_argument("--program", action="append", default=None,
                        metavar="NAME",
                        help="audit only this program or kernel (repeatable)")
    parser.add_argument("--check", action="append", default=None,
                        metavar="CHECK-ID",
                        help="run only this check (repeatable)")
    parser.add_argument("--list-checks", action="store_true",
                        help="print every check id with its summary and exit")
    parser.add_argument("--list-programs", action="store_true",
                        help="print every registered program and kernel and "
                             "exit")
    parser.add_argument("--dump-contract", metavar="NAME",
                        help="print NAME's observed inventory as contract "
                             "TOML (the starting point for a deliberate "
                             "contract update) and exit")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the programs run (default: the card if "
                             "there is one, else the CPU)")
    args = parser.parse_args(argv)

    from .checks import CHECKS

    if args.list_checks:
        width = max(len(c.id) for c in CHECKS)
        for c in CHECKS:
            print(f"{c.id:<{width}}  {c.summary}")
        return 0
    if args.check:
        known = {c.id for c in CHECKS}
        unknown = [c for c in args.check if c not in known]
        if unknown:
            print(f"skelly-audit: unknown check id(s): "
                  f"{', '.join(unknown)} (try --list-checks)",
                  file=sys.stderr)
            return 2
    try:
        device = _device(args.device)
    except RuntimeError as e:
        print(f"skelly-audit: {e}", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"
    card_checks = {c.id for c in CHECKS if c.needs_card}
    wanted = set(args.check or ()) & card_checks
    if wanted and not on_card:
        print(f"skelly-audit: --check {', '.join(sorted(wanted))} "
              "launches the hand-written kernels and needs the card; "
              "torch.cuda.is_available() is False here", file=sys.stderr)
        return 2

    from .engine import run_kernel_audit, run_program_audit
    from .kernels import all_kernels
    from .programs import all_programs

    progs = all_programs()
    kerns = all_kernels()
    if args.list_programs:
        width = max(len(p.name) for p in progs + kerns)
        for p in progs:
            print(f"{p.name:<{width}}  [{p.layer}] {p.summary}")
        for k in kerns:
            print(f"{k.name:<{width}}  [{k.layer}/kernel {k.kernels}] "
                  f"{k.summary}")
        return 0

    if args.dump_contract:
        from .engine import dump_contract, dump_kernel_contract

        prog = next((p for p in progs if p.name == args.dump_contract),
                    None)
        if prog is not None:
            print(dump_contract(prog, device), end="")
            return 0
        kern = next((k for k in kerns if k.name == args.dump_contract),
                    None)
        if kern is not None:
            if not on_card:
                print(f"skelly-audit: {kern.name}'s [dma] inventory is read "
                      "from the card's build and launches; there is no card "
                      "here", file=sys.stderr)
                return 2
            print(dump_kernel_contract(kern, device), end="")
            return 0
        print(f"skelly-audit: unknown program {args.dump_contract!r} "
              f"(try --list-programs)", file=sys.stderr)
        return 2

    if args.program:
        known = {p.name for p in progs} | {k.name for k in kerns}
        unknown = [n for n in args.program if n not in known]
        if unknown:
            print(f"skelly-audit: unknown program(s): "
                  f"{', '.join(unknown)} (try --list-programs)",
                  file=sys.stderr)
            return 2
        progs = [p for p in progs if p.name in set(args.program)]
        kerns = [k for k in kerns if k.name in set(args.program)]

    # --check filters route each matrix to the checks that cover it: a
    # `--check dma` run never runs a program, and `--check mask` covers
    # both matrices
    checks = args.check
    if checks is not None:
        selected = set(checks)
        if not selected & {c.id for c in CHECKS if c.over_programs}:
            progs = []
        if not selected & {c.id for c in CHECKS if c.over_kernels}:
            kerns = []
    kernel_checks = checks
    skipped = []
    if not on_card and kerns:
        kernel_checks = [c.id for c in CHECKS if c.over_kernels
                         and not c.needs_card
                         and (checks is None or c.id in checks)]
        skipped = sorted(card_checks & ({c.id for c in CHECKS}
                                        if checks is None else set(checks)))

    findings = []
    for prog in progs:
        findings.extend(run_program_audit(prog, checks=checks,
                                          device=device))
    for kern in kerns:
        findings.extend(run_kernel_audit(kern, checks=kernel_checks,
                                         device=device))
    for f in findings:
        print(f.render())
    for cid in skipped:
        print(f"skelly-audit: {cid}: not run on the CPU: it launches the "
              f"hand-written kernels ({', '.join(k.kernels for k in kerns)})"
              " on the card — not counted as clean")
    audited = len(progs) + len(kerns)
    if findings:
        print(f"skelly-audit: {len(findings)} finding(s) across "
              f"{audited} program(s) on {device.type}. Fix the program, or "
              "record the deliberate change in its "
              "audit/contracts/<name>.toml.", file=sys.stderr)
        return 1
    print(f"skelly-audit: {len(progs)} program(s) and {len(kerns)} "
          f"kernel famil{'y' if len(kerns) == 1 else 'ies'} contract-clean "
          f"on {device.type}"
          + (f" (without {', '.join(skipped)})" if skipped else "") + ".")
    return 0


if __name__ == "__main__":
    sys.exit(main())
