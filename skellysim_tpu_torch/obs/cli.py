"""The obs CLI: `python -m skellysim_tpu_torch.obs
<summarize|flight|cost|profile|roofline|timeline>`.

Counterpart of `skellysim_tpu.obs.cli`, with its flags and exit codes (0
done, 1 findings, 2 a usage error or a missing input):

``summarize FILE [FILE...]`` renders any mix of telemetry/metrics JSONL
streams (run-loop metrics, ``--trace-file`` traces, ensemble metrics) into
per-span timings, compile events, lane occupancy, device phases and
solver convergence stats (`obs.summarize`).

``flight FILE [FILE...]`` renders the flight recorder's blast-radius
report from any mix of metrics/telemetry JSONL: each faulted member's
diagnostics trajectory into the fault plus the anomaly provenance naming
the first nonfinite's field/fiber/node (`obs.flight`).

``profile DIR [--by phase|collective|op] [--json]`` attributes the device
op time of a ``--profile`` dump to the phase-scope vocabulary
(`obs.profile`).

``timeline TRACE.jsonl [TRACE...] [--profile DIR] -o out.perfetto.json``
merges telemetry spans, compile instants, and (optionally) the profiler's
device phases into ONE Chrome-trace/Perfetto artifact (`obs.timeline`).

``cost [--check] [--update] [--program NAME] [--baseline-dir DIR]
[--device DEV]`` runs every registered program (`audit.programs`) under
the cost counter (`obs.cost`) and gates it against `obs/baselines/*.toml`:
0 clean, 1 findings (with or without ``--check``), 2 usage errors.
``--update`` rewrites the baselines from the current measurement
(``tol_pct`` and ``[[suppress]]`` entries are kept). The programs run on
``--device`` (default: the card when there is one, else the CPU: the
counts are the same on both, and the checked-in baselines are the CPU's).

``roofline DIR [--program P | --cost-table TOML] [--device-kind K]
[--executions N] [--n-devices D] [--json]`` joins a dump's per-phase
device walls with a program's cost table (its baseline, or a sidecar
``[cost]`` + ``[collectives.<kind>] max_bytes``) against the checked-in
peak table (`obs/device_peaks.toml`): achieved FLOP/s and bytes/s,
arithmetic intensity, bound verdicts and achieved-vs-peak per phase, the
window's MFU (`obs.roofline`). Unknown device kinds rate as "unrated".

``perf`` and ``campaign`` read the benchmark's archived rounds and
manifests; they take their flags and exit 2 until the port's first
benchmark PR brings them (ROADMAP.md §1 item 14).

Every subcommand but ``cost`` parses files only and touches no card.
"""

from __future__ import annotations

import argparse
import sys

#: the subcommands the port accepts and refuses, with what they wait for
NOT_PORTED = {
    "perf": "reads the benchmark's archived rounds",
    "campaign": "reads the benchmark's campaign manifests",
}


def _cmd_summarize(args) -> int:
    import os

    from .summarize import summarize_files

    missing = [p for p in args.files if not os.path.exists(p)]
    if missing:
        print(f"skelly-scope: no such file(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    print(summarize_files(args.files), end="")
    return 0


def _cmd_flight(args) -> int:
    import os

    from .flight import render_flight_report

    missing = [p for p in args.files if not os.path.exists(p)]
    if missing:
        print(f"skelly-flight: no such file(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    print(render_flight_report(args.files), end="")
    return 0


def _cmd_profile(args) -> int:
    import json as json_mod

    from . import profile as profile_mod

    try:
        trace = profile_mod.load_device_trace(args.dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"skelly-pulse: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json_mod.dumps(profile_mod.profile_json(trace)))
    else:
        print(profile_mod.render_table(trace, by=args.by), end="")
    return 0


def _cmd_timeline(args) -> int:
    import os

    from . import timeline as timeline_mod

    missing = [p for p in args.traces if not os.path.exists(p)]
    if missing:
        print(f"skelly-pulse: no such trace file(s): "
              f"{', '.join(missing)}", file=sys.stderr)
        return 2
    try:
        counts = timeline_mod.write_timeline(args.traces, args.out,
                                             profile_dir=args.profile)
    except (FileNotFoundError, ValueError) as e:
        print(f"skelly-pulse: {e}", file=sys.stderr)
        return 2
    print(f"skelly-pulse: {args.out}: {counts['events']} events "
          f"({counts['host_slices']} host slices, {counts['instants']} "
          f"instants, {counts['device_slices']} device slices) — open in "
          "ui.perfetto.dev or chrome://tracing")
    return 0


def _cmd_cost(args) -> int:
    import torch

    from ..audit.programs import all_programs
    from .cost import audit_costs, render_table

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    progs = all_programs()
    registry_names = {p.name for p in progs}
    if args.program:
        unknown = [n for n in args.program if n not in registry_names]
        if unknown:
            print(f"skelly-scope: unknown program(s): {', '.join(unknown)} "
                  f"(registered: {', '.join(sorted(registry_names))})",
                  file=sys.stderr)
            return 2
        progs = [p for p in progs if p.name in set(args.program)]

    # registry_names keeps the stale-baseline scan honest under --program:
    # a filtered run must not read the other programs' baselines as stale
    rows, findings = audit_costs(progs, baseline_dir=args.baseline_dir,
                                 update=args.update,
                                 registry_names=registry_names,
                                 device=device)
    print(render_table(rows))
    if args.json:
        import json as json_mod

        print(json_mod.dumps({"device": str(device), "rows": rows}))
    if args.update:
        print(f"skelly-scope: {len(rows)} baseline(s) written under "
              f"{args.baseline_dir or 'obs/baselines/'}")
    for f in findings:
        print(f.render())
    if findings:
        # exit 1 with or without --check: a drift must never ride a 0 out
        # of a scripted run; --check is the gate's explicit spelling
        print(f"skelly-scope: {len(findings)} cost finding(s) across "
              f"{len(progs)} program(s). Fix the program, or re-baseline "
              "deliberately (`obs cost --update`).", file=sys.stderr)
        return 1
    print(f"skelly-scope: {len(progs)} program(s) within cost baselines "
          f"(run on {device}).")
    return 0


def _cmd_roofline(args) -> int:
    import json as json_mod

    from . import roofline as roofline_mod

    try:
        doc = roofline_mod.roofline_report(
            args.dir, program=args.program, cost_table=args.cost_table,
            device_kind=args.device_kind, executions=args.executions,
            n_devices=args.n_devices)
    except (FileNotFoundError, KeyError, ValueError) as e:
        msg = e.args[0] if e.args else e
        print(f"skelly-roofline: {msg}", file=sys.stderr)
        return 2
    if args.json:
        print(json_mod.dumps(doc))
    else:
        print(roofline_mod.render_roofline(doc), end="")
    return 0


def _cmd_not_ported(args) -> int:
    print(f"skelly-scope: `{args.cmd}` {NOT_PORTED[args.cmd]}, which "
          "skellysim_tpu_torch does not have before its first benchmark PR "
          "(ROADMAP.md §1 item 14)", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m skellysim_tpu_torch.obs",
        description="runtime telemetry of the PyTorch/CUDA port — span/"
                    "compile event summaries, the flight report, the "
                    "program cost gate, device-time attribution, the "
                    "roofline and merged timelines.")
    sub = parser.add_subparsers(dest="cmd")

    p_sum = sub.add_parser(
        "summarize", help="render telemetry/metrics JSONL file(s) into "
                          "span/compile/lane/convergence tables")
    p_sum.add_argument("files", nargs="+", metavar="JSONL")

    p_flight = sub.add_parser(
        "flight", help="flight recorder blast-radius report: diagnostics "
                       "trajectory into each fault + anomaly provenance "
                       "(offender field/fiber/node) from metrics/"
                       "telemetry JSONL")
    p_flight.add_argument("files", nargs="+", metavar="JSONL")

    p_prof = sub.add_parser(
        "profile", help="attribute a --profile dump's device op time to "
                        "named phases")
    p_prof.add_argument("dir", metavar="DIR",
                        help="profile_session dump directory")
    p_prof.add_argument("--by", default="phase",
                        choices=("phase", "collective", "op"),
                        help="grouping for the attribution table")
    p_prof.add_argument("--json", action="store_true",
                        help="machine-readable report (all groupings)")

    p_tl = sub.add_parser(
        "timeline", help="merge telemetry JSONL (+ profiler dump) into one "
                         "perfetto/chrome-trace JSON")
    p_tl.add_argument("traces", nargs="+", metavar="TRACE.jsonl")
    p_tl.add_argument("--profile", default=None, metavar="DIR",
                      help="profiler dump dir for the device-phase track")
    p_tl.add_argument("-o", "--out", required=True,
                      help="output path (e.g. out.perfetto.json)")

    p_roof = sub.add_parser(
        "roofline", help="per-phase roofline attribution over a --profile "
                         "dump: achieved vs peak, AI, bound verdicts")
    p_roof.add_argument("dir", metavar="DIR",
                        help="profile_session dump directory")
    p_roof.add_argument("--program", default=None, metavar="NAME",
                        help="registered program whose cost baseline "
                             "(obs/baselines/) sizes the flops/bytes and "
                             "collective traffic")
    p_roof.add_argument("--cost-table", default=None, metavar="TOML",
                        help="standalone cost-table sidecar ([cost] + "
                             "[collectives.*] max_bytes) overriding "
                             "--program")
    p_roof.add_argument("--device-kind", default=None, metavar="KIND",
                        help="device kind to rate against (default: the "
                             "dump's provenance.json sidecar; unknown "
                             "kinds rate as 'unrated')")
    p_roof.add_argument("--executions", type=int, default=1, metavar="N",
                        help="program executions inside the profiling "
                             "window (default 1)")
    p_roof.add_argument("--n-devices", type=int, default=None, metavar="D",
                        help="device lanes in the window (default: the "
                             "distinct pids of the dump's device events)")
    p_roof.add_argument("--json", action="store_true")

    p_cost = sub.add_parser(
        "cost", help="count every registered program's flops, bytes and "
                     "memory; --check gates against obs/baselines/")
    p_cost.add_argument("--check", action="store_true",
                        help="the gate's explicit spelling (findings exit "
                             "1 with or without it: drift, uncovered "
                             "program, stale baseline)")
    p_cost.add_argument("--update", action="store_true",
                        help="rewrite baselines from the current "
                             "measurements (preserves tol_pct/suppress)")
    p_cost.add_argument("--program", action="append", default=None,
                        metavar="NAME", help="restrict to this program "
                                             "(repeatable)")
    p_cost.add_argument("--baseline-dir", default=None,
                        help="baseline directory (default: obs/baselines/)")
    p_cost.add_argument("--device", default=None,
                        help="device the programs run on (default: the card "
                             "when there is one, else the CPU)")
    p_cost.add_argument("--json", action="store_true",
                        help="also print the measured rows as one JSON line")

    # the benchmark's tools: their flags, refused
    p_camp = sub.add_parser("campaign", help="not ported (exit 2)")
    p_camp.add_argument("file", metavar="FILE")
    p_camp.add_argument("--json", action="store_true")

    p_perf = sub.add_parser("perf", help="not ported (exit 2)")
    p_perf.add_argument("--compare", metavar="DIR")
    p_perf.add_argument("--gate", type=float, default=25.0, metavar="PCT")
    p_perf.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    if args.cmd == "summarize":
        return _cmd_summarize(args)
    if args.cmd == "flight":
        return _cmd_flight(args)
    if args.cmd == "profile":
        return _cmd_profile(args)
    if args.cmd == "timeline":
        return _cmd_timeline(args)
    if args.cmd == "roofline":
        return _cmd_roofline(args)
    if args.cmd == "cost":
        if args.check and args.update:
            print("skelly-scope: --check and --update are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        return _cmd_cost(args)
    if args.cmd in NOT_PORTED:
        return _cmd_not_ported(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
