"""Client of the listener-mode post-processing server.

Counterpart of `skellysim_tpu.io.listener_client`, and a mirror of the
reference Python toolkit's `Listener` / `Request` dataclasses
(`src/skelly_sim/reader.py:64-194`): it starts the port in
``--listen`` mode and exchanges framed msgpack messages over its stdin and
stdout (`serve.protocol`). The wire schema is the reference's, so this
client drives either package's server, or the reference binary.
"""

from __future__ import annotations

import subprocess
import sys
from dataclasses import asdict, dataclass, field

import numpy as np

from ..serve import protocol


def _default_seeds() -> np.ndarray:
    return np.zeros((0, 3), dtype=np.float64)


@dataclass
class StreamlinesRequest:
    """Streamline batch request (`reader.py:65-89` field set)."""

    dt_init: float = 0.1
    t_final: float = 1.0
    abs_err: float = 1e-10
    rel_err: float = 1e-6
    back_integrate: bool = True
    x0: np.ndarray = field(default_factory=_default_seeds)


@dataclass
class VelocityFieldRequest:
    x: np.ndarray = field(default_factory=_default_seeds)


@dataclass
class Request:
    frame_no: int = 0
    evaluator: str = "CPU"
    streamlines: StreamlinesRequest = field(default_factory=StreamlinesRequest)
    vortexlines: StreamlinesRequest = field(default_factory=StreamlinesRequest)
    velocity_field: VelocityFieldRequest = field(
        default_factory=VelocityFieldRequest)


class Listener:
    """Drives a ``--listen`` server subprocess: ``python -m
    skellysim_tpu_torch --listen`` on the config (``device``: "cuda", the
    default, or "cpu"), or the command ``binary``. ``stderr`` goes to the
    server's standard error (default: this process's)."""

    def __init__(self, toml_file: str = "skelly_config.toml",
                 binary: list[str] | None = None, device: str | None = None,
                 stderr=None, env=None):
        cmd = binary or ([sys.executable, "-m", "skellysim_tpu_torch",
                          "--listen", f"--config-file={toml_file}"]
                         + ([f"--device={device}"] if device else []))
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, stderr=stderr,
                                      env=env)

    def request(self, command: Request) -> dict | None:
        """Send one request; returns the decoded response dict (or None for an
        invalid frame)."""
        protocol.write_message(self._proc.stdin, asdict(command))
        payload = protocol.read_frame(self._proc.stdout)
        if payload is None:
            raise RuntimeError("listener server closed unexpectedly")
        if payload == b"":
            return None
        return protocol.unpack_message(payload)

    def close(self, timeout: float = 10) -> int | None:
        """Send the terminate frame and wait for the server (terminated
        after ``timeout`` seconds); returns its exit code."""
        if self._proc.poll() is None:
            try:
                protocol.write_empty(self._proc.stdin)
                self._proc.wait(timeout=timeout)
            except (BrokenPipeError, subprocess.TimeoutExpired):
                self._proc.terminate()
                self._proc.wait()
        return self._proc.returncode

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
