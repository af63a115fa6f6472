"""The packed solver health word: bit constants and host-side decoding.

Same bit layout as `skellysim_tpu.guard.verdict` (docs/robustness.md), so a
health word means the same in both packages' metrics. The solver here runs
a host-driven loop, so the word is a plain int built from host scalars.
"""

from __future__ import annotations

import math

NONFINITE = 1 << 0
STAGNATION = 1 << 1
#: the s-step cycle's Cholesky-ridge column recovery ended a cycle early
BREAKDOWN = 1 << 2
#: the ensemble's adaptive dt fell below dt_min (the lane froze)
DT_UNDERFLOW = 1 << 3

#: name -> bit, in bit order (the decode table)
HEALTH_BITS = {
    "nonfinite": NONFINITE,
    "stagnation": STAGNATION,
    "breakdown": BREAKDOWN,
    "dt_underflow": DT_UNDERFLOW,
}

#: verdicts no retry can repair (the ensemble quarantines such a lane)
TERMINAL_MASK = NONFINITE | DT_UNDERFLOW


def nonfinite_word(value: float) -> int:
    """NONFINITE where ``value`` is not finite, else 0."""
    return 0 if math.isfinite(value) else NONFINITE


def decode(word) -> list:
    """The set bit names of one health word, in bit order."""
    w = int(word)
    return [name for name, bit in HEALTH_BITS.items() if w & bit]


def describe(word) -> str:
    """Log spelling: ``"stagnation|breakdown"`` or ``"ok"``."""
    names = decode(word)
    return "|".join(names) if names else "ok"


def is_terminal(word) -> bool:
    """True where the word carries a verdict no retry can repair
    (nonfinite, dt_underflow)."""
    return (int(word) & TERMINAL_MASK) != 0


def retryable(word) -> bool:
    """True where the word is bad but not terminal (stagnation,
    breakdown): the escalation ladder's retry predicate
    (`guard.escalate`)."""
    w = int(word)
    return w != 0 and (w & TERMINAL_MASK) == 0
