"""Ensemble I/O: per-member trajectory writers and one metrics JSONL.

Counterpart of `skellysim_tpu.io.ensemble_io`: each member gets its own
reference-format trajectory (`<out_dir>/<member_id>.out`, written by
`io.trajectory.TrajectoryWriter`), opened on the member's first frame and
closed when its lane frees, so the open handles follow the lanes, not the
sweep. The metrics stream is one JSONL file of lane / member / step records,
``event`` telling the kinds apart; the key sets below are the JAX
package's, so one reader serves both packages' sweeps.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .trajectory import TrajectoryWriter

#: keys of an ``event == "step"`` record, one a member trial step: the
#: run loop's METRICS_FIELDS plus the ensemble coordinates. ``wall_s`` /
#: ``wall_ms`` are the batched round's wall time, shared by every lane of
#: that ``round``; ``gmres_cycles`` / ``gmres_history`` are per member
ENSEMBLE_STEP_FIELDS = ("event", "member", "lane", "round", "step", "t",
                        "dt", "iters", "gmres_cycles", "residual",
                        "residual_true", "fiber_error", "accepted",
                        "refines", "loss_of_accuracy", "health",
                        "guard_retries", "nucleations", "catastrophes",
                        "active_fibers", "wall_s", "wall_ms",
                        "gmres_history", "flight")

#: keys of an ``event == "start"`` record (a member entered a lane);
#: ``queue_wait_s`` is the admission latency (queue entry -> lane seat)
ENSEMBLE_START_FIELDS = ("event", "member", "lane", "t", "t_final",
                         "queue_wait_s")

#: keys of an ``event == "retire"`` record (lane freed at t_final)
ENSEMBLE_RETIRE_FIELDS = ("event", "member", "lane", "t", "steps", "frames")

#: keys of an ``event == "failed"`` / ``"dt_underflow"`` record (a lane
#: quarantined or frozen): the retire keys plus the packed health word, its
#: decoded bit names (`guard.verdict`) and the flight recorder's payload
#: (``{"tail": [decoded rows], "provenance": {field, fiber, node} | None}``,
#: `obs.flight.failure_payload`; None at ``Params.flight_window == 0``)
ENSEMBLE_FAILURE_FIELDS = ENSEMBLE_RETIRE_FIELDS + ("health", "verdict",
                                                    "flight")

#: keys of an ``event == "growth"`` record: a dynamic-instability member's
#: nucleation outgrew its fiber ``capacity``; the lane froze un-advanced
#: and the member reseats on the next capacity rung (`scenarios.sweep`)
ENSEMBLE_GROWTH_FIELDS = ENSEMBLE_RETIRE_FIELDS + ("capacity",)


class EnsembleMetricsWriter:
    """Append ensemble records as JSON lines; usable as the scheduler's
    ``metrics`` callable."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        self._fh = open(path, "a" if append else "w")

    def write(self, record: dict):
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    __call__ = write

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemberTrajectoryWriters:
    """Per-member trajectory files under one directory; usable as the
    scheduler's ``writer`` callable.

    Handles open on a member's first frame and close on `close_member` /
    `close`. Existing member files are refused unless ``overwrite`` (the
    single-run CLI's no-clobber guard, per member).
    """

    def __init__(self, out_dir: str, *, overwrite: bool = False):
        self.out_dir = out_dir
        self.overwrite = overwrite
        os.makedirs(out_dir, exist_ok=True)
        self._writers: dict = {}

    def path(self, member_id: str) -> str:
        return os.path.join(self.out_dir, f"{member_id}.out")

    def _writer(self, member_id: str) -> TrajectoryWriter:
        w = self._writers.get(member_id)
        if w is None:
            path = self.path(member_id)
            if os.path.exists(path) and not self.overwrite:
                raise FileExistsError(
                    f"member trajectory '{path}' already exists; pass "
                    "overwrite=True (or the CLI's --overwrite) to replace it")
            w = self._writers[member_id] = TrajectoryWriter(path)
        return w

    def write_frame(self, member_id: str, state, *,
                    rng_state: Optional[list] = None):
        self._writer(member_id).write_frame(state, rng_state=rng_state)

    __call__ = write_frame

    def close_member(self, member_id: str):
        w = self._writers.pop(member_id, None)
        if w is not None:
            w.close()

    def close(self):
        for member_id in list(self._writers):
            self.close_member(member_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
