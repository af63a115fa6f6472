"""The service's entry point: `python -m skellysim_tpu_torch.serve`.

Counterpart of `skellysim_tpu.serve.cli`: boots the long-lived
multi-tenant simulation service. The config file's fibers / params define
the contract tenants admit against, its `[serve]` table (host, port,
buckets, lanes, queue, journal) sizes the service. `--port 0` binds an
ephemeral port; pair it with `--port-file` so spawners
(`serve.client.SpawnedServer`) can find it. The lanes run on the CUDA card
unless `--device=cpu` is given; a missing card raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="skellysim-tpu-torch-serve",
        description="persistent multi-tenant simulation service with "
                    "warm-bucket admission control (PyTorch/CUDA port)")
    ap.add_argument("--config-file", default="skelly_config.toml",
                    help="server run config; its [serve] table sizes the "
                         "service, its fibers/params define the contract "
                         "tenants admit against")
    ap.add_argument("--host", default=None,
                    help="override [serve] host")
    ap.add_argument("--port", type=int, default=None,
                    help="override [serve] port (0 = ephemeral)")
    ap.add_argument("--port-file", default=None,
                    help="publish the bound port to this file once listening")
    ap.add_argument("--max-lanes", type=int, default=None,
                    help="override [serve] max_lanes (tenant slots/bucket)")
    ap.add_argument("--trace-file", default=None,
                    help="telemetry JSONL (lane/compile/span events; "
                         "render with skellysim_tpu_torch.obs.summarize)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup warm-up round (kernels then "
                         "load on the first admission)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the lanes run (default: the CUDA card; "
                         "raises when there is none)")
    ap.add_argument("--log-level",
                    default=os.environ.get("SKELLYSIM_LOG", "INFO"))
    args = ap.parse_args(argv)

    import logging

    logging.basicConfig(level=args.log_level.upper(),
                        format="[%(asctime)s] [%(levelname)s] %(message)s",
                        stream=sys.stderr)

    from ..config import schema
    from .server import SimulationServer

    serve_cfg = schema.load_serve_config(args.config_file)
    if args.host is not None:
        serve_cfg.host = args.host
    if args.port is not None:
        serve_cfg.port = args.port
    if args.max_lanes is not None:
        serve_cfg.max_lanes = args.max_lanes

    server = SimulationServer(args.config_file, serve_cfg=serve_cfg,
                              trace_path=args.trace_file,
                              warmup=not args.no_warmup, device=args.device)
    server.serve_forever(port_file=args.port_file)
    print("serve: shutdown complete "
          f"({server.metrics.stats()['retired']} tenant(s) retired)")
