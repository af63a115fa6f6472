"""Counter-based RNG stream state, the analogue of the reference's trng4
`yarn2` engines.

Counterpart of `skellysim_tpu.utils.rng` for the STATE only: two named streams
(``shared``, ``distributed``), each ``seed:stream_id:counter``, dumped into
every trajectory frame's ``rng_state`` and restored from it, so frames written
by both packages carry the same payload. The draws themselves need a
bit-exact port of jax's threefry2x32 to keep dynamic-instability
trajectories comparable; they raise until that slice lands (ROADMAP.md §1
item 8). Only dynamic instability draws, and this slice refuses it.
"""

from __future__ import annotations


class Stream:
    """One counter-based draw stream: (seed, stream_id, counter)."""

    def __init__(self, seed: int, stream_id: int, counter: int = 0):
        self.seed = int(seed)
        self.stream_id = int(stream_id)
        self.counter = int(counter)

    def _draw(self, *args, **kwargs):
        raise NotImplementedError(
            "random draws need the threefry2x32 port that comes with dynamic "
            "instability (ROADMAP.md §1 item 8)")

    uniform = uniform_int = normal = poisson_int = _draw

    def dump(self) -> str:
        return f"{self.seed}:{self.stream_id}:{self.counter}"

    @staticmethod
    def load(s: str) -> "Stream":
        seed, stream_id, counter = (int(v) for v in s.split(":"))
        return Stream(seed, stream_id, counter)


class SimRNG:
    """The two-stream RNG bundle."""

    def __init__(self, seed: int = 1):
        self.shared = Stream(seed, 0)
        self.distributed = Stream(seed, 1)

    def member(self, i: int) -> "SimRNG":
        """Per-member bundle for ensemble replicas: stream ids (2i+2, 2i+3)
        of the same seeds (see the JAX package)."""
        if i < 0:
            raise ValueError(f"member index must be >= 0, got {i}")
        rng = SimRNG.__new__(SimRNG)
        rng.shared = Stream(self.shared.seed, 2 * i + 2)
        rng.distributed = Stream(self.distributed.seed, 2 * i + 3)
        return rng

    def dump_state(self):
        """Trajectory ``rng_state`` payload: [[name, state], ...]."""
        return [["shared", self.shared.dump()],
                ["distributed", self.distributed.dump()]]

    @staticmethod
    def from_state(state) -> "SimRNG":
        rng = SimRNG()
        names = {name: s for name, s in state}
        if "shared" in names:
            rng.shared = Stream.load(names["shared"])
        if "distributed" in names:
            rng.distributed = Stream.load(names["distributed"])
        return rng
