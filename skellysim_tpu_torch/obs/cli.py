"""The obs CLI: `python -m skellysim_tpu_torch.obs
<summarize|flight|profile|timeline>`.

Counterpart of `skellysim_tpu.obs.cli`, with its flags and exit codes (0
done, 2 a usage error or a missing input):

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

``cost`` and ``roofline`` read the JAX package's XLA cost tables and TPU
peak table; ``perf`` and ``campaign`` read the benchmark's archives. They
take their flags and exit 2: the port has none of them yet (ROADMAP.md §1
item 14).

Every subcommand parses files only: none touches the card.
"""

from __future__ import annotations

import argparse
import sys

#: the subcommands the port accepts and refuses, with what they wait for
NOT_PORTED = {
    "cost": "reads XLA cost analyses and their baselines",
    "roofline": "joins a dump with XLA cost tables and TPU peaks",
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


def _cmd_not_ported(args) -> int:
    print(f"skelly-scope: `{args.cmd}` {NOT_PORTED[args.cmd]}, which "
          "skellysim_tpu_torch does not have yet (ROADMAP.md §1 item 14)",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m skellysim_tpu_torch.obs",
        description="runtime telemetry of the PyTorch/CUDA port — span/"
                    "compile event summaries, the flight report, "
                    "device-time attribution and merged timelines.")
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

    # the JAX package's XLA and benchmark tools: their flags, refused
    p_roof = sub.add_parser("roofline", help="not ported (exit 2)")
    p_roof.add_argument("dir", metavar="DIR")
    p_roof.add_argument("--program", default=None, metavar="NAME")
    p_roof.add_argument("--cost-table", default=None, metavar="TOML")
    p_roof.add_argument("--device-kind", default=None, metavar="KIND")
    p_roof.add_argument("--executions", type=int, default=1, metavar="N")
    p_roof.add_argument("--n-devices", type=int, default=None, metavar="D")
    p_roof.add_argument("--json", action="store_true")

    p_camp = sub.add_parser("campaign", help="not ported (exit 2)")
    p_camp.add_argument("file", metavar="FILE")
    p_camp.add_argument("--json", action="store_true")

    p_perf = sub.add_parser("perf", help="not ported (exit 2)")
    p_perf.add_argument("--compare", metavar="DIR")
    p_perf.add_argument("--gate", type=float, default=25.0, metavar="PCT")
    p_perf.add_argument("--json", action="store_true")

    p_cost = sub.add_parser("cost", help="not ported (exit 2)")
    p_cost.add_argument("--check", action="store_true")
    p_cost.add_argument("--update", action="store_true")
    p_cost.add_argument("--program", action="append", default=None,
                        metavar="NAME")
    p_cost.add_argument("--baseline-dir", default=None)

    args = parser.parse_args(argv)
    if args.cmd == "summarize":
        return _cmd_summarize(args)
    if args.cmd == "flight":
        return _cmd_flight(args)
    if args.cmd == "profile":
        return _cmd_profile(args)
    if args.cmd == "timeline":
        return _cmd_timeline(args)
    if args.cmd in NOT_PORTED:
        return _cmd_not_ported(args)
    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
