"""Live telemetry plane: on-device latency histograms and lifecycle
stamps. The port's own copy of ``hclib_tpu/device/telemetry.py`` (numpy
and threads only), names and semantics unchanged:

- **Timebase**: the stream's cumulative scheduler-round counter
  (``TG_ROUNDS``), bumped once per inner scheduling round by the
  scheduler's ``round_hook`` seam and carried across entries and
  checkpoint cuts in the echoed telemetry block; the host converts
  rounds to ns with ``runtime/clockprobe.EpochBracket``, the wall
  bracket around each entry.
- **Per-row stamp table** ``tlat[capacity, LAT_WORDS]``: admit round
  (the ring row's TEN_ADMIT_ROUND word), install round and fire round
  of each task-table row; retire round == fire round.
- **Histogram + gauge block** ``tele[1 + T, LAT_BUCKETS]``: row 0 the
  live gauges (``TG_*``), rows 1..T per-tenant log2 latency histograms
  the egress publish folds into.

``bucket_of`` / ``unpack_spans`` / ``hist_fold_reference`` are the
executable spec of the stream kernel's fold (``device/inject.py``,
``csrc/stream.cuh``); ``TelemetryBlock`` and ``TelemetryPoller`` read
the echoed block mid-stream.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "LAT_BUCKETS",
    "LAT_ADMIT",
    "LAT_INSTALL",
    "LAT_FIRE",
    "LAT_WORDS",
    "TG_ROUNDS",
    "TG_INSTALLS",
    "TG_RETIRES",
    "TG_PARKED",
    "TG_BACKLOG",
    "TG_ENTRIES",
    "TG_WORDS",
    "bucket_of",
    "bucket_edges",
    "unpack_spans",
    "hist_fold_reference",
    "quantile_from_hist",
    "TelemetryBlock",
    "TelemetryPoller",
]

# ------------------------------------------------------------- word ABI
#
# Histogram shape: LAT_BUCKETS log2 buckets of (retire - admit) in
# scheduler rounds. Bucket 0 is [0, 2); bucket i is [2^i, 2^(i+1)) for
# 1 <= i <= LAT_BUCKETS - 2; the LAST bucket is the overflow bucket
# [2^(LAT_BUCKETS - 1), inf) - overflow is COUNTED, never dropped (the
# tracebuf overflow-counted idiom). The in-kernel fold computes the
# bucket branch-free as b = sum_k [d >= 2^k] for k in 1..LAT_BUCKETS-1,
# which lands exactly on these edges (bucket_of is the host spec).
LAT_BUCKETS = 16

# Per-row stamp words (the tlat table, one row per task-table slot).
# All in cumulative scheduler rounds; 0 = unstamped. Word 3 reserved.
LAT_ADMIT = 0    # TEN_ADMIT_ROUND of the installed ring row (host pump
                 # stamp; ring-wait time is INSIDE the measured span)
LAT_INSTALL = 1  # round the tenant poll installed the row
LAT_FIRE = 2     # round the scheduler dispatched it (== retire round)
LAT_WORDS = 4

# Live-gauge words (row 0 of the tele block). Cumulative counters are
# monotonic across entries AND checkpoint cuts (the host re-seeds the
# echoed block on resume); point-in-time gauges are refreshed every
# round by the round_hook.
TG_ROUNDS = 0    # cumulative inner scheduler rounds (the timebase)
TG_INSTALLS = 1  # cumulative ring-row installs (tracked + untracked)
TG_RETIRES = 2   # cumulative tracked retirements (== histogram mass)
TG_PARKED = 3    # point-in-time: rows in the egress park buffer
TG_BACKLOG = 4   # point-in-time: ready-ring occupancy (tail - head)
TG_ENTRIES = 5   # cumulative kernel entries (host-bumped per call)
TG_WORDS = 8     # words 6..7 reserved; row padded to LAT_BUCKETS


def bucket_of(d: int) -> int:
    """Host spec of the in-kernel bucket formula: the log2 bucket of a
    latency delta ``d`` (rounds). Negative deltas (clock-free streams
    never produce them; the kernel clamps anyway) land in bucket 0."""
    d = int(d)
    b = 0
    for k in range(1, LAT_BUCKETS):
        if d >= (1 << k):
            b += 1
    return b


def bucket_edges() -> List[Tuple[int, Optional[int]]]:
    """``[(lo, hi), ...]`` per bucket - hi exclusive, ``None`` for the
    unbounded overflow bucket."""
    edges: List[Tuple[int, Optional[int]]] = [(0, 2)]
    for k in range(1, LAT_BUCKETS - 1):
        edges.append((1 << k, 1 << (k + 1)))
    edges.append((1 << (LAT_BUCKETS - 1), None))
    return edges


def unpack_spans(admit: int, spans: int) -> Tuple[int, int, int, int]:
    """Decode EGR_T_ADMIT / EGR_T_SPANS into absolute rounds
    ``(admit, install, fire, retire)``. retire == fire by construction
    (see egress.py EGR_T_SPANS)."""
    admit = int(admit)
    spans = int(spans) & 0xFFFFFFFF
    install = admit + (spans & 0xFFFF)
    fire = install + ((spans >> 16) & 0xFFFF)
    return admit, install, fire, fire


def hist_fold_reference(
    tele: np.ndarray, retirements: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """EXECUTABLE SPEC of the in-kernel egress fold: fold a sequence of
    ``(tenant, delta_rounds)`` retirements into a copy of a tele block.
    Each retirement bumps one per-tenant bucket and TG_RETIRES; deltas
    clamp at 0 exactly as the kernel does."""
    out = np.array(tele, dtype=np.int64, copy=True)
    if out.ndim != 2 or out.shape[1] != LAT_BUCKETS:
        raise ValueError(f"tele block must be (1+T, {LAT_BUCKETS}), got {out.shape}")
    for ten, d in retirements:
        ten = int(ten)
        if not (0 <= ten < out.shape[0] - 1):
            raise ValueError(f"tenant {ten} out of range for {out.shape[0] - 1} lanes")
        out[1 + ten, bucket_of(max(int(d), 0))] += 1
        out[0, TG_RETIRES] += 1
    return out


def quantile_from_hist(counts: Sequence[int], q: float) -> Optional[float]:
    """The q-quantile latency (rounds) from one histogram row: the
    UPPER edge of the bucket holding the ceil(q * total)-th sample -
    conservative, at most one log2 bucket above the exact order
    statistic. The overflow bucket has no upper edge, so it reports its
    LOWER edge (a floor: "at least this"). None on an empty histogram."""
    c = np.asarray(counts, dtype=np.int64)
    total = int(c.sum())
    if total == 0:
        return None
    q = float(q)
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    rank = max(1, int(np.ceil(q * total)))
    cum = np.cumsum(c)
    b = int(np.searchsorted(cum, rank))
    lo, hi = bucket_edges()[b]
    return float(hi if hi is not None else lo)


class TelemetryBlock:
    """Host wrapper over one scraped ``tele`` block: gauge access,
    per-tenant histograms, quantiles, merge/delta arithmetic. Rows->ns
    conversion rides an optional ``ns_per_round`` (from the entry
    epoch brackets, clockprobe.EpochBracket)."""

    def __init__(self, tele: np.ndarray, ns_per_round: Optional[float] = None):
        self.tele = np.array(tele, dtype=np.int64, copy=True)
        if self.tele.ndim != 2 or self.tele.shape[1] != LAT_BUCKETS:
            raise ValueError(
                f"tele block must be (1+T, {LAT_BUCKETS}), got {self.tele.shape}"
            )
        self.ns_per_round = None if ns_per_round is None else float(ns_per_round)

    @property
    def tenants(self) -> int:
        return self.tele.shape[0] - 1

    def gauges(self) -> Dict[str, int]:
        g = self.tele[0]
        return {
            "rounds": int(g[TG_ROUNDS]),
            "installs": int(g[TG_INSTALLS]),
            "retires": int(g[TG_RETIRES]),
            "parked": int(g[TG_PARKED]),
            "backlog": int(g[TG_BACKLOG]),
            "entries": int(g[TG_ENTRIES]),
        }

    def hist(self, tenant: Optional[int] = None) -> np.ndarray:
        """One tenant's bucket counts, or the all-tenant sum."""
        if tenant is None:
            return self.tele[1:].sum(axis=0)
        return np.array(self.tele[1 + int(tenant)])

    def total(self, tenant: Optional[int] = None) -> int:
        return int(self.hist(tenant).sum())

    def quantile(self, q: float, tenant: Optional[int] = None) -> Optional[float]:
        """q-quantile in ROUNDS (see quantile_from_hist)."""
        return quantile_from_hist(self.hist(tenant), q)

    def quantile_s(self, q: float, tenant: Optional[int] = None) -> Optional[float]:
        """q-quantile in SECONDS via ns_per_round; None without a
        conversion factor or on an empty histogram."""
        if self.ns_per_round is None:
            return None
        r = self.quantile(q, tenant)
        return None if r is None else r * self.ns_per_round / 1e9

    def merge(self, other: "TelemetryBlock") -> "TelemetryBlock":
        """Element-wise sum (mesh: fold per-device blocks into one).
        Point-in-time gauges sum too - a mesh's backlog is the sum of
        its devices' backlogs."""
        if other.tele.shape != self.tele.shape:
            raise ValueError("cannot merge tele blocks of different shapes")
        return TelemetryBlock(self.tele + other.tele, self.ns_per_round)

    def delta(self, prev: "TelemetryBlock") -> "TelemetryBlock":
        """Histogram/counter advance since ``prev`` (same-stream earlier
        snapshot): the SLO estimator's windowed input."""
        if prev.tele.shape != self.tele.shape:
            raise ValueError("cannot diff tele blocks of different shapes")
        return TelemetryBlock(self.tele - prev.tele, self.ns_per_round)


class TelemetryPoller:
    """Host thread that snapshots a live stream's telemetry MID-RUN.

    ``source`` is a zero-arg callable returning a snapshot dict (the
    ``StreamingMegakernel.telemetry_snapshot`` face: ``seq``, ``tele``,
    ``rounds``, ``ns_per_round``, ...) or None before the first entry
    completes. The poller keeps every DISTINCT snapshot (seq-deduped)
    in ``snapshots`` and invokes ``on_snapshot(snap)`` for each - the
    seam the MetricsRegistry live source and the SLO estimator hang off.
    """

    def __init__(
        self,
        source: Callable[[], Optional[Dict[str, Any]]],
        interval_s: float = 0.05,
        on_snapshot: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        interval_s = float(interval_s)
        if interval_s <= 0:
            raise ValueError(f"poll interval must be > 0 seconds, got {interval_s}")
        self._source = source
        self._interval_s = interval_s
        self._on_snapshot = on_snapshot
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.snapshots: List[Dict[str, Any]] = []

    def _poll_once(self) -> bool:
        snap = self._source()
        if snap is None:
            return False
        with self._lock:
            if self.snapshots and self.snapshots[-1].get("seq") == snap.get("seq"):
                return False
            self.snapshots.append(snap)
        if self._on_snapshot is not None:
            self._on_snapshot(snap)
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            self._poll_once()
            self._stop.wait(self._interval_s)

    def start(self) -> "TelemetryPoller":
        if self._thread is not None:
            raise RuntimeError("poller already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hclib-telemetry-poller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, final_poll: bool = True) -> None:
        """Stop the thread; by default take one last synchronous poll so
        the stream's final state is never missed by sampling."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if final_poll:
            self._poll_once()

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.snapshots[-1] if self.snapshots else None

    def latest_block(self) -> Optional[TelemetryBlock]:
        snap = self.latest()
        if snap is None:
            return None
        return TelemetryBlock(snap["tele"], snap.get("ns_per_round"))

    def wait_for(self, n: int, timeout_s: float = 30.0) -> bool:
        """Block until ``n`` distinct snapshots exist (tests/CI smoke)."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.snapshots) >= n:
                    return True
            time.sleep(min(self._interval_s, 0.01))
        with self._lock:
            return len(self.snapshots) >= n
