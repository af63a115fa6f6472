"""Ensemble driver: sweep-spec TOML -> per-member trajectories + metrics.

Usage: python -m skellysim_tpu_torch.ensemble --sweep-file=ensemble.toml
           [--output-dir=DIR] [--batch=B] [--batch-impl=vmap|unroll]
           [--overwrite] [--metrics-file=F] [--trace-file=F]
           [--profile=DIR] [--device=cuda|cpu]

Counterpart of `skellysim_tpu.ensemble.cli`. The sweep spec
(`config.sweep`) names a base run config and the member expansion
(replicas x sweep axes). Every member is built through
`builder.build_simulation`, as a single run is, lands on the base config's
`[runtime]` bucket (`system.buckets.bucketize`), and must share the base's
runtime Params (up to seed and t_final) and bucket; then the members stream
through the continuous-batching scheduler, or, with dynamic instability,
through `scenarios.ScenarioEnsemble`. The output directory gets one
reference-format `<member_id>.out` a member and `ensemble_metrics.jsonl`.
Runs on the CUDA card unless ``--device=cpu``; a missing card raises.
``--trace-file`` appends the drain's telemetry (`obs.tracer`: lane
admit / backfill / retire events, one ``ensemble_step`` span a round,
faults, compile events) as JSON lines; ``--profile DIR`` runs the drain
under `torch.profiler` (`obs.profile.profile_session`) and appends its
device time by phase to the trace as ``device_phase`` events.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def _members_from_sweep(sweep_file: str, device=None):
    """(system, [MemberSpec], spec, policy): every member simulation, on
    the base config's bucket, checked to share the base's Params."""
    from ..builder import build_simulation
    from ..config import schema
    from ..config.sweep import apply_overrides, load_members
    from ..system import buckets as bucket_mod
    from ..utils.rng import SimRNG
    from .scheduler import MemberSpec

    spec, base_path, base, plans = load_members(sweep_file)
    if ((spec.replicas > 1 or any(ax.key == "params.seed"
                                  for ax in spec.sweep))
            and base.params.dynamic_instability.n_nodes == 0):
        # nothing in the batched round draws from a member's RNG without
        # dynamic instability: replicas would write identical physics
        logging.getLogger("skellysim_tpu_torch").warning(
            "replicas/seed sweep without dynamic instability: members of "
            "one sweep point run identical deterministic physics (they "
            "differ only in their recorded RNG streams); use replicas=1, "
            "or enable [dynamic_instability] for stochastic members")
    config_dir = os.path.dirname(os.path.abspath(base_path)) or "."
    if not plans:
        sys.exit(f"sweep spec '{sweep_file}' expands to zero members")
    norm = schema.normalized_member_params
    policy = bucket_mod.BucketPolicy.from_runtime(
        schema.load_runtime_config(base_path))

    system = None
    members = []
    base_key = base_norm = None
    for plan in plans:
        cfg = apply_overrides(base, plan.overrides)
        sys_i, state_i, _ = build_simulation(cfg, config_dir=config_dir,
                                             device=device)
        sys_i.grid_ladder = policy.grid_ladder
        state_i, key_i = bucket_mod.bucketize(
            state_i, policy, pair_evaluator=sys_i.params.pair_evaluator)
        if system is None:
            system, base_norm, base_key = sys_i, norm(cfg.params), key_i
        elif norm(cfg.params) != base_norm:
            sys.exit(f"member {plan.member_id}: overrides changed runtime "
                     "params; ensemble members must share one set of Params "
                     "(sweep state values, not params)")
        elif key_i != base_key:
            sys.exit(f"member {plan.member_id}: lands in bucket "
                     f"{key_i.describe()} but member 0's is "
                     f"{base_key.describe()}; widen the [runtime] "
                     "bucket_ladder/node_ladder so all members share one "
                     "bucket")
        members.append(MemberSpec(
            member_id=plan.member_id, state=state_i, t_final=plan.t_final,
            rng=SimRNG(plan.seed).member(plan.index)))
    return system, members, spec, policy


def run(sweep_file: str, output_dir: str | None = None,
        batch: int | None = None, batch_impl: str | None = None,
        overwrite: bool = False, metrics_path: str | None = None,
        trace_path: str | None = None,
        device=None, profile_dir: str | None = None) -> list:
    """Expand and drain a sweep; returns the retired member ids.
    ``trace_path`` opens a telemetry stream for the drain; ``profile_dir``
    wraps the drain in the profiler (`obs.profile.profile_session`) and,
    after it closes, folds the dump into that stream as ``device_phase``
    events."""
    import contextlib

    from ..io.ensemble_io import EnsembleMetricsWriter, MemberTrajectoryWriters
    from ..obs import tracer as obs_tracer
    from .runner import EnsembleRunner
    from .scheduler import EnsembleScheduler

    out_dir = output_dir or (os.path.dirname(os.path.abspath(sweep_file))
                             or ".")
    system, members, spec, policy = _members_from_sweep(sweep_file, device)
    metrics_path = metrics_path or os.path.join(out_dir,
                                                "ensemble_metrics.jsonl")
    writers = MemberTrajectoryWriters(out_dir, overwrite=overwrite)
    if not overwrite:
        clobbered = [m.member_id for m in members
                     if os.path.exists(writers.path(m.member_id))]
        if clobbered:
            sys.exit(f"member trajectories already exist ({clobbered[0]}.out"
                     f" + {len(clobbered) - 1} more); pass --overwrite")
    runner = EnsembleRunner(system, batch_impl=batch_impl or spec.batch_impl)
    tracer = obs_tracer.Tracer(trace_path) if trace_path else None
    scope = (obs_tracer.use(tracer) if tracer is not None
             else contextlib.nullcontext())
    if profile_dir is not None:
        from ..obs.profile import profile_session

        prof = profile_session(profile_dir, device=system.device)
    else:
        prof = contextlib.nullcontext()
    try:
        with writers, EnsembleMetricsWriter(metrics_path) as metrics, \
                scope, prof:
            if runner.di_enabled:
                # growth reseats land on the ladder admission bucketized
                # onto
                from ..scenarios import ScenarioEnsemble

                sched = ScenarioEnsemble(
                    system, members, batch or spec.batch, runner=runner,
                    policy=policy, writer=writers, metrics=metrics,
                    write_initial_frames=True,
                    on_dt_underflow="retire", on_failure="retire")
            else:
                sched = EnsembleScheduler(
                    runner, members, batch or spec.batch, writer=writers,
                    metrics=metrics, write_initial_frames=True,
                    on_dt_underflow="retire", on_failure="retire")
            retired = sched.run()
        if profile_dir is not None:
            # the dump is written at prof's exit above
            from ..obs.profile import emit_device_phases

            emit_device_phases(profile_dir, tracer)
    finally:
        if tracer is not None:
            tracer.close()
    print(f"ensemble finished: {len(retired)}/{len(members)} members "
          f"retired over {sched.rounds} batched steps")
    return retired


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="skellysim-tpu-torch-ensemble",
        description="batched ensemble sweeps with a continuous-batching "
                    "scheduler (PyTorch/CUDA port)")
    ap.add_argument("--sweep-file", default="ensemble.toml",
                    help="sweep-spec TOML ([ensemble] table)")
    ap.add_argument("--output-dir", default=None,
                    help="member trajectories + metrics land here "
                         "(default: the sweep file's directory)")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the spec's lane count B")
    ap.add_argument("--batch-impl", default=None, choices=("vmap", "unroll"),
                    help="override the spec's execution plan")
    ap.add_argument("--overwrite", action="store_true",
                    help="overwrite existing member trajectories")
    ap.add_argument("--metrics-file", default=None,
                    help="aggregated ensemble metrics JSONL "
                         "(default: <output-dir>/ensemble_metrics.jsonl)")
    ap.add_argument("--trace-file", default=None,
                    help="telemetry JSONL (lane/span/fault/compile events; "
                         "render with skellysim_tpu_torch.obs.summarize)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler capture of the drain "
                         "(obs.profile.profile_session); the dump is "
                         "parsed afterwards and device_phase events are "
                         "appended to --trace-file — render with `obs "
                         "profile DIR` / `obs timeline`")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the CUDA card; raises when "
                         "there is none)")
    ap.add_argument("--log-level",
                    default=os.environ.get("SKELLYSIM_LOG", "INFO"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper(),
                        format="[%(asctime)s] [%(levelname)s] %(message)s",
                        stream=sys.stderr)
    run(args.sweep_file, output_dir=args.output_dir, batch=args.batch,
        batch_impl=args.batch_impl, overwrite=args.overwrite,
        metrics_path=args.metrics_file, device=args.device,
        trace_path=args.trace_file, profile_dir=args.profile)
