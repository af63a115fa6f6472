"""Client for the simulation service.

Counterpart of `skellysim_tpu.serve.client`: `ServeClient` speaks the
serve request schema over one TCP connection (the framing of
`serve.protocol`); `SpawnedServer` launches `python -m
skellysim_tpu_torch.serve` as a subprocess, waits for its ``--port-file``,
hands out connected clients and guarantees teardown. A client touches no
device: it only frames requests.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional

from . import protocol


class ServeClient:
    """One connection to a running serve server (request/response)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._decoder = protocol.FrameDecoder()

    # ------------------------------------------------------------ transport

    def request(self, req: dict) -> dict:
        """Send one request; block for its response dict."""
        err = protocol.validate_request(req)
        if err:
            raise ValueError(err)
        buf = protocol.pack_message(req)
        self._sock.sendall(protocol.HEADER.pack(len(buf)) + buf)
        while True:
            data = self._sock.recv(1 << 16)
            if not data:
                raise ConnectionError("serve server closed the connection")
            frames = self._decoder.feed(data)
            if frames:
                if isinstance(frames[0], protocol.OversizedFrame):
                    raise ConnectionError(
                        f"server answered an oversized frame "
                        f"({frames[0].size} bytes)")
                return protocol.unpack_message(frames[0])

    def _checked(self, req: dict) -> dict:
        resp = self.request(req)
        if not resp.get("ok"):
            raise RuntimeError(f"serve {req['type']} failed: "
                               f"{resp.get('error', '?')}")
        return resp

    # ------------------------------------------------------------- requests

    def submit(self, config_toml: str, *, tenant: Optional[str] = None,
               t_final: Optional[float] = None,
               resume_frame: Optional[bytes] = None) -> dict:
        """Admit a simulation; returns the submit response ({tenant, bucket,
        lane/queued, ...}). ``config_toml`` is full run-config TOML text;
        ``resume_frame`` resumes from a previously fetched snapshot."""
        fields = {}
        if tenant is not None:
            fields["tenant"] = tenant
        if t_final is not None:
            fields["t_final"] = float(t_final)
        if resume_frame is not None:
            fields["resume_frame"] = resume_frame
        return self._checked(protocol.make_request(
            "submit", config=config_toml, **fields))

    def status(self, tenant: str) -> dict:
        return self._checked(protocol.make_request("status", tenant=tenant))

    def stream(self, tenant: str, max_frames: Optional[int] = None) -> dict:
        """Drain pending trajectory frames; response ``frames`` is a list of
        raw trajectory-v1 frame bytes, ``eof`` True once the tenant is done
        and drained."""
        fields = {"max_frames": max_frames} if max_frames is not None else {}
        return self._checked(protocol.make_request(
            "stream", tenant=tenant, **fields))

    def snapshot(self, tenant: str) -> bytes:
        """The tenant's CURRENT state as one trajectory frame (the exact
        resume point)."""
        return bytes(self._checked(protocol.make_request(
            "snapshot", tenant=tenant))["frame"])

    def cancel(self, tenant: str) -> dict:
        return self._checked(protocol.make_request("cancel", tenant=tenant))

    def stats(self) -> dict:
        return self._checked(protocol.make_request("stats"))["stats"]

    def stats_prometheus(self) -> str:
        """`/stats` rendered as a Prometheus text exposition page
        (`protocol.render_prometheus`): counters, fault / retire labels
        and the SLO latency histograms with cumulative ``le`` buckets."""
        return protocol.render_prometheus(self.stats())

    def chaos(self, action: str, tenant: Optional[str] = None) -> dict:
        """Fault injection (`guard.chaos`); the server refuses unless its
        config sets ``[serve] chaos_enabled``."""
        fields = {"tenant": tenant} if tenant is not None else {}
        return self._checked(protocol.make_request(
            "chaos", action=action, **fields))

    def shutdown(self) -> dict:
        return self._checked(protocol.make_request("shutdown"))

    def wait(self, tenant: str, timeout: float = 300.0,
             interval: float = 0.05) -> dict:
        """Poll ``status`` until the tenant leaves queued/running."""
        t0 = time.monotonic()
        while True:
            st = self.status(tenant)
            if st["status"] not in ("queued", "running"):
                return st
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"tenant {tenant} still {st['status']} after {timeout}s")
            time.sleep(interval)

    # ------------------------------------------------------------ lifecycle

    def close(self):
        if self._sock is not None:
            try:
                # the in-band goodbye: the server evicts our tenants
                self._sock.sendall(protocol.HEADER.pack(0))
            except OSError:
                pass
            self._sock.close()
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SpawnedServer:
    """`python -m skellysim_tpu_torch.serve` as a managed subprocess.

    Publishes its ephemeral port through ``--port-file``; `client()` hands
    out connected `ServeClient`s. The context exit terminates the server
    (after a best-effort ``shutdown`` request). The server runs on the
    card unless ``args`` holds ``--device cpu``.
    """

    def __init__(self, config_file: str, *, args: Optional[list] = None,
                 startup_timeout: float = 240.0, env: Optional[dict] = None):
        self.port_file = config_file + ".serve_port"
        if os.path.exists(self.port_file):
            os.unlink(self.port_file)
        cmd = [sys.executable, "-m", "skellysim_tpu_torch.serve",
               f"--config-file={config_file}", "--port", "0",
               f"--port-file={self.port_file}"] + list(args or [])
        self._proc = subprocess.Popen(cmd, env=env)
        self.port = self._wait_port(startup_timeout)

    def _wait_port(self, timeout: float) -> int:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if self._proc.poll() is not None:
                raise RuntimeError(
                    f"serve server exited rc={self._proc.returncode} "
                    "before publishing its port")
            if os.path.exists(self.port_file):
                text = open(self.port_file).read().strip()
                if text:
                    return int(text)
            time.sleep(0.1)
        self._proc.terminate()
        raise TimeoutError(f"serve server did not publish a port within "
                           f"{timeout}s (warm-up too slow?)")

    def client(self, **kw) -> ServeClient:
        return ServeClient(port=self.port, **kw)

    def kill(self) -> None:
        """SIGKILL the server, the crash-recovery injector (`guard.chaos`):
        no shutdown request, no graceful teardown, exactly what the
        write-ahead journal must survive. Pair with a fresh
        `SpawnedServer` on the same config / journal to test recovery."""
        import signal

        if self._proc.poll() is None:
            self._proc.send_signal(signal.SIGKILL)
            self._proc.wait()
        if os.path.exists(self.port_file):
            os.unlink(self.port_file)

    def stop(self, timeout: float = 30.0) -> int:
        if self._proc.poll() is None:
            try:
                with self.client(timeout=timeout) as c:
                    c.shutdown()
            except Exception:
                self._proc.terminate()
            try:
                self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        if os.path.exists(self.port_file):
            os.unlink(self.port_file)
        return self._proc.returncode

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def main(argv=None) -> int:
    """Scraper-facing CLI: ``python -m skellysim_tpu_torch.serve.client
    stats [--prometheus]`` prints a running server's `/stats` as JSON or
    as the Prometheus text page."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m skellysim_tpu_torch.serve.client",
        description="simulation service client utility")
    ap.add_argument("command", choices=("stats",),
                    help="request to perform")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--prometheus", action="store_true",
                    help="render stats as Prometheus text exposition "
                         "(GET /metrics-style) instead of JSON")
    args = ap.parse_args(argv)
    with ServeClient(host=args.host, port=args.port) as client:
        if args.prometheus:
            print(client.stats_prometheus(), end="")
        else:
            print(json.dumps(client.stats(), indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
