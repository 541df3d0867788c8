"""Structured failures of the port (the subset of
``hclib_tpu/runtime/resilience.py`` that the scheduler megakernel raises)."""

from __future__ import annotations

from typing import Optional

__all__ = ["StallError"]


class StallError(RuntimeError):
    """A bounded-latency failure: deadline exceeded, wait timed out, or
    the watchdog escalated a stall. ``stats`` is the runtime (or device)
    counter snapshot at detection time."""

    def __init__(self, message: str, stats: Optional[dict] = None) -> None:
        super().__init__(message)
        self.stats = stats or {}
