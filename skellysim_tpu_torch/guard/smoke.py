"""The chaos smoke: boot a real server, break it on purpose, check recovery.

Counterpart of `skellysim_tpu.guard.smoke`:
``python -m skellysim_tpu_torch.guard.smoke WORKDIR [--device cpu]``
exits 0 when both acts pass, over spawned `python -m
skellysim_tpu_torch.serve` subprocesses (on the card unless ``--device
cpu``):

1. **Quarantine**: two tenants in one capacity bucket; a ``chaos`` request
   NaN-poisons tenant A's lane. A must answer ``status=failed`` with the
   nonfinite verdict and the flight recorder's provenance (field
   ``fiber_x``, fiber 0) while B finishes healthy; the server's own
   telemetry stream localizes the same fault (`obs.flight
   .render_flight_report`).
2. **Crash recovery**: a longer tenant, SIGKILL of the server mid-flight,
   a restart on the same config and journal. The restarted server must
   re-admit the live tenant from the write-ahead journal and drive it to
   its t_final; the failed tenant's terminal record (with its provenance)
   must survive too.

Each request's round-trip time is printed at the end, by request type.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _scene(shift: float):
    from ..config import BackgroundSource, Config, Fiber

    cfg = Config()
    cfg.params.dt_initial = cfg.params.dt_write = 0.005
    cfg.params.t_final = 0.02
    cfg.params.gmres_tol = 1e-10
    cfg.params.adaptive_timestep_flag = False
    # the recorder armed: the quarantine check below needs the anomaly
    # provenance naming the poisoned fiber; tenants share the server's
    # params contract, so every scene carries the same window
    cfg.params.flight_window = 16
    fib = Fiber(n_nodes=8, length=1.0, bending_rigidity=0.01)
    fib.fill_node_positions(np.array([shift, 0.0, 0.0]),
                            np.array([0.0, 0.0, 1.0]))
    cfg.fibers = [fib]
    cfg.background = BackgroundSource(uniform=[1.0, 0.0, 0.0])
    return cfg


class _Timed:
    """Round-trip times of a `ServeClient`'s requests, by request type."""

    def __init__(self):
        self.times: dict = {}

    def wrap(self, client):
        send = client.request

        def request(req):
            t0 = time.perf_counter()
            try:
                return send(req)
            finally:
                self.times.setdefault(req["type"], []).append(
                    time.perf_counter() - t0)

        client.request = request
        return client

    def report(self) -> str:
        parts = []
        for kind, ts in sorted(self.times.items()):
            ts = sorted(ts)
            parts.append(f"{kind} n={len(ts)} median "
                         f"{1e3 * ts[len(ts) // 2]:.2f} ms max "
                         f"{1e3 * ts[-1]:.2f} ms")
        return "; ".join(parts)


def main(workdir: str, device: str = "cuda") -> int:
    from ..config import schema
    from ..config.toml_io import dumps as toml_dumps
    from ..obs.flight import render_flight_report
    from ..serve.client import SpawnedServer
    from .verdict import NONFINITE

    def toml_of(cfg):
        return toml_dumps(schema.unpack(cfg))

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "chaos_config.toml")
    journal = os.path.join(workdir, "chaos_journal.bin")
    _scene(0.0).save(path)
    with open(path, "a") as fh:
        fh.write('\n[serve]\nmax_lanes = 2\nbatch_impl = "unroll"\n'
                 'chaos_enabled = true\njournal_every = 2\n'
                 f'journal_path = "{journal}"\n')
    args = ["--device", device, "--log-level", "WARNING"]
    # the servers import this checkout's package wherever they start
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    timed = _Timed()

    # act 1: NaN quarantine, the sibling survives. Tenants seat at submit
    # (free lanes); 20 rounds leave the chaos request time to land while A
    # still runs
    trace = os.path.join(workdir, "chaos_trace.jsonl")
    t0 = time.perf_counter()
    srv = SpawnedServer(path, args=args + ["--trace-file", trace], env=env)
    print(f"chaos smoke: server up in {time.perf_counter() - t0:.1f} s")
    with timed.wrap(srv.client()) as c:
        ta = c.submit(toml_of(_scene(0.1)), t_final=0.1)["tenant"]
        tb = c.submit(toml_of(_scene(0.3)), t_final=0.1)["tenant"]
        c.chaos("nan_lane", tenant=ta)
        sa = c.wait(ta, timeout=120)
        sb = c.wait(tb, timeout=120)
        assert sa["status"] == "failed", sa
        assert sa["health"] & NONFINITE, sa
        assert sa["verdict"], sa
        # poison_lane NaNs every fiber position: the first offender is
        # fiber 0 of the fiber_x field
        prov = (sa.get("flight") or {}).get("provenance")
        assert prov, sa.get("flight")
        assert prov["field"] == "fiber_x", prov
        assert prov["fiber"] == 0, prov
        assert (sa["flight"]["tail"]
                and sa["flight"]["tail"][-1]["health"] & NONFINITE), \
            sa["flight"]
        assert sb["status"] == "finished", sb
        assert sb["health"] == 0, sb
        frames_b = c.stream(tb)["frames"]
        assert len(frames_b) >= 2, len(frames_b)
        stats = c.stats()
        assert stats["faults"].get("chaos_nan") == 1, stats["faults"]
        assert stats["faults"].get("lane_failed") == 1, stats["faults"]
        assert stats["fault_fields"].get("fiber_x") == 1, \
            stats["fault_fields"]
        print(f"chaos smoke act 1 ok: {ta} failed "
              f"(verdict {sa['verdict']}, offender {prov['field']} fiber "
              f"{prov['fiber']}), {tb} finished with "
              f"{len(frames_b)} frames")

        # the server's telemetry stream (flushed each event, readable
        # while it runs) localizes the same fault
        report = render_flight_report([trace])
        assert f"{ta}: FAULT" in report, report
        assert "field=fiber_x fiber 0" in report, report
        print("chaos smoke: the flight report localizes the fault "
              f"({ta}: fiber_x fiber 0)")

        # act 2: SIGKILL mid-flight, journal recovery
        tc = c.submit(toml_of(_scene(0.5)), t_final=0.5)["tenant"]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = c.status(tc)
            if st["status"] == "running" and st["steps"] >= 2:
                break
            time.sleep(0.05)
        assert st["status"] == "running", st
        # SIGKILL while the client is still connected: a graceful
        # disconnect would evict tc (by design); the crash must beat it
        srv.kill()
    print(f"chaos smoke: server SIGKILLed with {tc} at t={st['t']:g}")

    t0 = time.perf_counter()
    srv2 = SpawnedServer(path, args=args, env=env)
    print(f"chaos smoke: restarted server up in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        with timed.wrap(srv2.client()) as c:
            sc = c.wait(tc, timeout=120)
            assert sc["status"] == "finished", sc
            assert abs(sc["t"] - 0.5) < 1e-9, sc
            sa2 = c.status(ta)
            assert sa2["status"] == "failed", sa2
            prov2 = (sa2.get("flight") or {}).get("provenance")
            assert prov2 and prov2["field"] == "fiber_x" \
                and prov2["fiber"] == 0, sa2.get("flight")
            assert c.status(tb)["status"] == "finished", c.status(tb)
            stats = c.stats()
            assert stats["journal"], stats
        rc = srv2.stop()
        assert rc == 0, f"restarted server exited rc={rc}"
    finally:
        if srv2._proc.poll() is None:
            srv2._proc.kill()
    print(f"chaos smoke act 2 ok: {tc} recovered from journal and "
          f"finished after SIGKILL; terminal records intact")
    print(f"chaos smoke: request round trips: {timed.report()}")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m skellysim_tpu_torch.guard.smoke",
        description="chaos smoke of the simulation service")
    ap.add_argument("workdir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the spawned servers run (default: the "
                         "CUDA card)")
    a = ap.parse_args()
    sys.exit(main(a.workdir, device=a.device))
