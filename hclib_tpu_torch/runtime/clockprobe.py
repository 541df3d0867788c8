"""Rounds to wall-clock time for the streaming front door: the
``EpochBracket`` of ``hclib_tpu/runtime/clockprobe.py`` (the port takes
only this class of that module)."""

from __future__ import annotations

from typing import Optional

__all__ = ["EpochBracket"]


class EpochBracket:
    """Rounds -> wall-clock conversion for the telemetry plane.

    The megakernel has no device wall clock; latency histograms count
    *scheduler rounds*. Each streaming entry brackets its jitted call
    with ``time.monotonic_ns()`` and reports the round-gauge delta the
    kernel echoed; ``accumulate`` folds those (t0, t1, rounds) triples
    into a cumulative epoch so ``ns_per_round`` is the session-wide
    wall-ns / rounds ratio. Entries that advanced zero rounds (pure
    host-side polls) still contribute wall time - the ratio reflects
    what a round *costs end to end* from the host, which is the
    honest conversion for host-facing latency quantiles.

    Monotone by construction: ``total_ns`` and ``total_rounds`` only
    grow, and negative brackets (clock steps, resume re-seeds) are
    clamped to zero rather than rewinding the epoch.
    """

    def __init__(self) -> None:
        self.total_ns = 0
        self.total_rounds = 0
        self.entries = 0

    def accumulate(self, t0_ns: int, t1_ns: int, rounds: int) -> None:
        self.total_ns += max(int(t1_ns) - int(t0_ns), 0)
        self.total_rounds += max(int(rounds), 0)
        self.entries += 1

    def ns_per_round(self) -> Optional[float]:
        """Wall nanoseconds per scheduler round; None before any rounds."""
        if self.total_rounds <= 0:
            return None
        return self.total_ns / self.total_rounds

    def to_ns(self, rounds: float) -> Optional[float]:
        """Convert a round count to nanoseconds (None before any epoch)."""
        npr = self.ns_per_round()
        if npr is None:
            return None
        return float(rounds) * npr
