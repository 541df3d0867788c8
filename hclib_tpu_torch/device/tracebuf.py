"""The scheduler's flight recorder: a fixed-width trace ring of int32
records written from inside the megakernel's round loop.

Port of ``hclib_tpu/device/tracebuf.py`` (its host half is plain numpy
and is kept here as the port's own copy; the device half is the
recorder compiled into ``csrc/megakernel.cu``). The rules are JAX's:

- **Compiled in only when enabled.** ``Megakernel(trace=None)`` builds no
  ring and launches the instance without the recorder (``kObs`` false in
  ``mk_kernel``), so an untraced run executes the same code as before the
  recorder existed.
- **Overflow counted, not crashed.** The write cursor is monotonic and
  records land at ``cursor % capacity``: a full ring keeps the *last*
  ``capacity`` records and the decoder reports ``dropped = max(0,
  written - capacity)``.
- **Rounds, not clocks, as the timebase.** Records carry the scheduler's
  round index (``tick()`` mints one per round). The host brackets the
  launch with ``time.monotonic_ns()`` (after a ``torch.cuda.synchronize``
  on the card) and ``tools/timeline.py --trace`` interpolates rounds into
  that epoch, so a port trace renders as a JAX one does.

Record layout: 4 int32 words ``[tag, t, a, b]`` where ``t`` is the round
index and ``a``/``b`` are per-tag payloads (see the TR_* table). The ring
row is ``HDR`` header words followed by ``capacity * TR_WORDS`` record
words; header word 0 is the monotonic write cursor and word 1 the
entry-relative round cursor. On the card thread 0 keeps both cursors in
shared memory during a rep and writes the header at the rep's end; the
records go to the ring in global memory as they are emitted.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

__all__ = [
    "TraceRing",
    "Tracer",
    "NullTracer",
    "decode_ring",
    "lane_partial_age",
    "trace_info",
    "trace_to_jsonable",
    "records_of",
    "trace_from_jsonable",
    "summarize",
    "TR_WORDS",
    "HDR",
    "TR_ROUND_BEGIN",
    "TR_ROUND_END",
    "TR_FIRE_SCALAR",
    "TR_FIRE_BATCH",
    "TR_PREFETCH_ISSUE",
    "TR_PREFETCH_DRAIN",
    "TR_SPILL",
    "TR_CREDIT",
    "TR_XFER",
    "TR_ABORT",
    "TR_FAULT",
    "TR_INJECT",
    "TR_QUIESCE",
    "TR_CKPT",
    "TR_SCALE",
    "TR_TENANT",
    "TR_FIRE_AGE",
    "TR_FIRE_BUCKET",
    "TR_EGRESS",
    "TR_LATENCY",
    "TR_SPLICE",
    "bucket_occupancy",
    "SC_HOLD",
    "SC_OUT",
    "SC_IN",
    "SC_EVACUATE",
    "SC_CHECKPOINT",
    "SC_FINISH",
    "SC_DEADLINE_OUT",
    "SC_STRAND_HOLD",
    "SC_SLO_OUT",
    "SC_NAMES",
    "CK_SAVE",
    "CK_LOAD",
    "CK_FALLBACK",
    "CK_QUARANTINE",
    "CK_POISON",
    "CK_NAMES",
    "CR_NAMES",
    "FLT_NAMES",
    "host_trace_info",
    "TAG_NAMES",
]

# Header words (HDR total; the rest reserved/zero).
TH_COUNT = 0  # records ever written (monotonic; slot = count % capacity)
TH_ROUND = 1  # entry-relative round cursor (single-core megakernel only)
HDR = 8

TR_WORDS = 4  # [tag, t, a, b]

# Record tags. Payload conventions (a, b):
TR_ROUND_BEGIN = 1     # a = ready backlog, b = pending
TR_ROUND_END = 2       # a = executed since entry, b = pending
TR_FIRE_SCALAR = 3     # a = kernel-table F_FN, b = descriptor row
TR_FIRE_BATCH = 4      # a = (lane_fn << 16) | take, b = prefetched count
TR_PREFETCH_ISSUE = 5  # a = lane F_FN, b = descriptors announced
TR_PREFETCH_DRAIN = 6  # a = lane F_FN, b = in-flight descriptors retired
TR_SPILL = 7           # a = lane F_FN, b = entries spilled to the ring
TR_CREDIT = 8          # a = (hop << 8) | peer, b = delta code (CR_*)
TR_XFER = 9            # a = partner/hop, b = rows sent
TR_ABORT = 10          # a = round the folded abort word was observed
TR_FAULT = 11          # a = fault code (FLT_*), b = detail (peer/mask)
TR_INJECT = 12         # a = rows installed from the injection ring
TR_QUIESCE = 13        # a = executed-since-entry (or round) at observation
TR_CKPT = 14           # a = pending rows exported, b = ready backlog
TR_SCALE = 15          # a = (from_ndev << 8) | to_ndev, b = SC_* kind
                       # (host-emitted by runtime/autoscaler.py; rides
                       # the same record ABI so timeline.py renders
                       # scale events beside device rounds)
TR_TENANT = 16         # a = (tenant_lane << 16) | rows installed this
                       # poll, b = rows dropped expired (the counted
                       # TenantExpired records) - emitted by the WRR
                       # tenant inject poll, device/inject.py
TR_FIRE_AGE = 17       # a = (lane_fn << 16) | take, b = starved age at
                       # fire - the FIRE REASON record: this batch round
                       # jumped the ring-drain-first policy because the
                       # lane's starved-round age reached lane_max_age
                       # (megakernel.py firing site). Every TR_FIRE_AGE
                       # is paired with the TR_FIRE_BATCH of the same
                       # round; a ring-drained fire emits only the
                       # latter, so the reason split is exact.
TR_FIRE_BUCKET = 18    # a = (bucket << 16) | take, b = lane F_FN - the
                       # priority-bucket tier's fire record
                       # (priority_buckets builds only): which bucket
                       # ring this round's batch retired, at what
                       # occupancy. Paired with the round's
                       # TR_FIRE_BATCH (same take); bucket_occupancy()
                       # folds these into the per-bucket gauge.
TR_EGRESS = 19         # a = submit token of the retired row, b = park
                       # depth after the event - the completion-mailbox
                       # BACKPRESSURE record (egress builds only):
                       # emitted when retirement finds the mailbox
                       # full and PARKS the row instead of publishing
                       # (counted in ectl[EC_PARKED], never dropped,
                       # never an OVF abort). A publish emits
                       # nothing: the write-cursor echo already counts
                       # it, and the hot path stays record-free.
TR_LATENCY = 20        # a = (tenant << 16) | latency bucket, b = raw
                       # (retire - admit) delta in scheduler rounds -
                       # the per-retirement LATENCY record (telemetry
                       # builds only, device/telemetry.py): emitted at
                       # the egress fold that also bumps the on-device
                       # histogram, so the Perfetto track and the
                       # scraped histogram are two views of one event.
TR_SPLICE = 21         # a = (applied << 16) | dropped delta observed
                       # this pump visit, b = spare blocks in use
                       # (V_FREE) after it - the dynamic-graph SPLICE
                       # progress record (device/dyngraph.py
                       # serving pump; host-emitted off the device
                       # counters, the TR_SCALE ring discipline, so
                       # update-storm progress renders beside the
                       # rounds that absorbed it).

# TR_SCALE kind codes (b word) - mirror autoscaler.ScaleEvent.kind.
SC_HOLD = 0
SC_OUT = 1
SC_IN = 2
SC_EVACUATE = 3
SC_CHECKPOINT = 4
SC_FINISH = 5
SC_DEADLINE_OUT = 6   # tenant deadline-pressure scale-out (no gates:
                      # it must beat the watchdog's strike ladder)
SC_STRAND_HOLD = 7    # scale-in refused: it would strand a tenant's
                      # in-flight quota / ring residue
SC_SLO_OUT = 8        # SLO burn-rate scale-out (runtime/slo.py): the
                      # latency histogram's multi-window burn rate
                      # crossed HCLIB_TPU_SLO_BURN. Like deadline_out
                      # it bypasses hysteresis AND cooldown - an SLO
                      # on fire must not wait out a cooldown window.

# TR_CKPT store subcodes (the durable BundleStore, runtime/checkpoint
# .py): host-emitted records ride the TR_CKPT tag with a NEGATIVE a
# word - ``a = -(1 + CK_code)`` - so they can never collide with the
# device export records, whose a word is a pending-row count (>= 0);
# the b word is the store generation the event acted on.
CK_SAVE = 0        # a generation published (staged, fsync'd, renamed)
CK_LOAD = 1        # a generation validated and loaded
CK_FALLBACK = 2    # load_latest fell back past >= 1 bad generation
CK_QUARANTINE = 3  # a torn/corrupt/mismatched generation set aside
CK_POISON = 4      # no generation validates: the store is unrecoverable

# The ONE name table for SC_* codes: runtime/autoscaler.py derives its
# kind->code map from it and tools/timeline.py labels TR_SCALE spans
# with it, so a new kind is one edit here, not three drifting copies.
SC_NAMES: Dict[int, str] = {
    SC_HOLD: "hold",
    SC_OUT: "scale out",
    SC_IN: "scale in",
    SC_EVACUATE: "evacuate",
    SC_CHECKPOINT: "checkpoint",
    SC_FINISH: "finish",
    SC_DEADLINE_OUT: "deadline out",
    SC_STRAND_HOLD: "strand hold",
    SC_SLO_OUT: "slo out",
}

# The ONE name table for CK_* codes - runtime/checkpoint.py's
# BundleStore emits them and tools/timeline.py labels the store spans
# from this table, the SC_NAMES discipline exactly.
CK_NAMES: Dict[int, str] = {
    CK_SAVE: "store save",
    CK_LOAD: "store load",
    CK_FALLBACK: "store fallback",
    CK_QUARANTINE: "store quarantine",
    CK_POISON: "store poison",
}

TAG_NAMES: Dict[int, str] = {
    TR_ROUND_BEGIN: "round_begin",
    TR_ROUND_END: "round_end",
    TR_FIRE_SCALAR: "fire_scalar",
    TR_FIRE_BATCH: "fire_batch",
    TR_PREFETCH_ISSUE: "prefetch_issue",
    TR_PREFETCH_DRAIN: "prefetch_drain",
    TR_SPILL: "spill",
    TR_CREDIT: "credit",
    TR_XFER: "xfer",
    TR_ABORT: "abort",
    TR_FAULT: "fault",
    TR_INJECT: "inject",
    TR_QUIESCE: "quiesce",
    TR_CKPT: "ckpt_export",
    TR_SCALE: "scale",
    TR_TENANT: "tenant",
    TR_FIRE_AGE: "fire_age",
    TR_FIRE_BUCKET: "fire_bucket",
    TR_EGRESS: "egress_park",
    TR_LATENCY: "latency",
    TR_SPLICE: "splice",
}

# TR_CREDIT delta codes (b word).
CR_DROPPED = 1      # granter dropped the credit it owed
CR_DUPED = 2        # granter signalled twice
CR_REGENERATED = 3  # starved waiter skipped an owed wait (regeneration)

# TR_FAULT codes (a word).
FLT_DEAD_QUARANTINE = 1  # b = peer quarantined by heartbeat timeout
FLT_WEDGE = 2            # b = starved-channel encoding ((hop<<8)|granter)+1
FLT_DELAY = 3            # b = hop whose export quota was zeroed

# Name tables for the payload codes above - the SAME one-table-edit
# discipline as SC_NAMES: tools/timeline.py labels TR_CREDIT/TR_FAULT
# payloads from these, so a new code is one edit here.
CR_NAMES: Dict[int, str] = {
    CR_DROPPED: "dropped",
    CR_DUPED: "duplicated",
    CR_REGENERATED: "regenerated",
}
FLT_NAMES: Dict[int, str] = {
    FLT_DEAD_QUARANTINE: "dead-chip quarantine",
    FLT_WEDGE: "wedge",
    FLT_DELAY: "delay",
}


class TraceRing:
    """Host-side spec of a trace ring (capacity in RECORDS). The ring is
    one int32 row of ``HDR + capacity * TR_WORDS`` words on the
    megakernel's device (``row``)."""

    def __init__(self, capacity: int = 2048) -> None:
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.capacity = capacity

    @property
    def words(self) -> int:
        return HDR + self.capacity * TR_WORDS

    def row(self, device) -> "torch.Tensor":
        """A zeroed ring row on ``device``."""
        import torch

        return torch.zeros(self.words, dtype=torch.int32, device=device)

    @staticmethod
    def of(trace: Union[None, int, "TraceRing"]) -> Optional["TraceRing"]:
        """Normalize a ``trace=`` argument (None / record count / ring)."""
        if trace is None:
            return None
        if isinstance(trace, TraceRing):
            return trace
        if isinstance(trace, bool):
            return TraceRing() if trace else None
        return TraceRing(int(trace))


def _wrap32(x: int) -> int:
    return ((int(x) + 0x80000000) % 0x100000000) - 0x80000000


class Tracer:
    """The plain core's writer over one ring (a Python list of int32
    words): the same cursor arithmetic the card's recorder runs
    (``csrc/megakernel.cu`` ``Obs``)."""

    enabled = True

    def __init__(self, row: list, capacity: int) -> None:
        self._ref = row
        self._cap = int(capacity)

    def reset(self) -> None:
        """Zero the header (per rep, from stage())."""
        for w in range(HDR):
            self._ref[w] = 0

    def emit(self, tag: int, t, a=0, b=0) -> None:
        n = self._ref[TH_COUNT]
        base = HDR + (n % self._cap) * TR_WORDS
        self._ref[base:base + TR_WORDS] = [
            int(tag), _wrap32(t), _wrap32(a), _wrap32(b)]
        self._ref[TH_COUNT] = n + 1

    def tick(self) -> int:
        """Mint the next entry-relative round index."""
        r = self._ref[TH_ROUND]
        self._ref[TH_ROUND] = r + 1
        return r

    def now(self) -> int:
        """The current round cursor, without advancing it."""
        return self._ref[TH_ROUND]


class NullTracer:
    """The disabled recorder: every method is a no-op."""

    enabled = False

    def reset(self) -> None:
        return None

    def emit(self, tag: int, t, a=0, b=0) -> None:
        return None

    def tick(self) -> int:
        return 0

    def now(self) -> int:
        return 0


# ------------------------------------------------------------------ decode

def decode_ring(row, capacity: Optional[int] = None) -> Dict[str, Any]:
    """Decode one ring row into ``{written, dropped, records}``.

    ``records`` is an (n, 4) int64 array of [tag, t, a, b] in emission
    order; when the ring wrapped it holds the LAST ``capacity`` records
    and ``dropped`` counts the overwritten prefix."""
    row = np.asarray(row).astype(np.int64).ravel()
    if capacity is None:
        capacity = (len(row) - HDR) // TR_WORDS
    written = int(row[TH_COUNT])
    body = row[HDR : HDR + capacity * TR_WORDS].reshape(capacity, TR_WORDS)
    if written <= capacity:
        records = body[:written].copy()
    else:
        start = written % capacity
        records = np.roll(body, -start, axis=0).copy()
    return {
        "written": written,
        "dropped": max(0, written - capacity),
        "capacity": int(capacity),
        "records": records,
    }


def trace_info(
    rows: Sequence, t0_ns: int, t1_ns: int,
    capacity: Optional[int] = None,
) -> Dict[str, Any]:
    """The uniform ``info['trace']`` shape every traced runner returns:
    one decoded ring per device plus the host-wall-clock epoch that
    bracketed the kernel launch (``time.monotonic_ns()``, the clock host
    EventLog records share - what lets tools/timeline.py place device
    rounds on the host timeline)."""
    return {
        "epoch": {"t0_ns": int(t0_ns), "t1_ns": int(t1_ns)},
        "rings": [decode_ring(r, capacity) for r in rows],
    }


def host_trace_info(
    records: Sequence[Sequence[int]], t0_ns: int, t1_ns: int,
) -> Dict[str, Any]:
    """A trace_info-shaped dict built from HOST-emitted records (rows of
    [tag, t, a, b] - e.g. the autoscaler's TR_SCALE events, with ``t``
    the control-slice index). It rides the same epoch-bracket contract
    as a device ring, so ``tools/timeline.py --perfetto`` merges host
    control-loop events onto the same timeline as device rounds."""
    arr = np.asarray(list(records), dtype=np.int64).reshape(-1, TR_WORDS)
    return {
        "epoch": {"t0_ns": int(t0_ns), "t1_ns": int(t1_ns)},
        "rings": [{
            "written": int(arr.shape[0]),
            "dropped": 0,
            "capacity": max(1, int(arr.shape[0])),
            "records": arr,
        }],
    }


def records_of(trace: Dict[str, Any], tag: int, ring: int = 0) -> np.ndarray:
    """Records of one tag from ``info['trace']`` (rows: [tag, t, a, b])."""
    recs = np.asarray(trace["rings"][ring]["records"])
    if recs.size == 0:
        return recs.reshape(0, TR_WORDS)
    return recs[recs[:, 0] == tag]


def trace_to_jsonable(trace: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe copy of a trace_info dict (record arrays -> lists), so
    run infos can be saved next to perf logs and fed back to
    ``tools/timeline.py --trace``."""
    return {
        "epoch": dict(trace["epoch"]),
        "rings": [
            {
                "written": r["written"],
                "dropped": r["dropped"],
                "capacity": r["capacity"],
                "records": np.asarray(r["records"]).tolist(),
            }
            for r in trace["rings"]
        ],
    }


def trace_from_jsonable(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of trace_to_jsonable (tools/timeline.py --trace loader)."""
    return {
        "epoch": dict(obj["epoch"]),
        "rings": [
            {
                "written": int(r["written"]),
                "dropped": int(r["dropped"]),
                "capacity": int(r["capacity"]),
                "records": np.asarray(
                    r["records"], dtype=np.int64
                ).reshape(-1, TR_WORDS),
            }
            for r in obj["rings"]
        ],
    }


def lane_partial_age(
    trace: Dict[str, Any], widths: Dict[int, int], ring: int = 0,
    max_gap: int = 8,
) -> Dict[int, int]:
    """Partial-batch starvation detector (the ROADMAP lane-firing-policy
    watch item), computed off TR_FIRE_BATCH occupancy records: for each
    batch lane, the longest streak of CONSECUTIVE partial fires
    (``take < width``), measured in rounds spanned (last.t - first.t + 1
    of the streak). A healthy static tile set fires full batches with at
    most one partial tail (age <= 1); a dynamic spawner that keeps the
    ready ring hot under the ring-drain-first policy starves the lanes
    into long runs of width-1 fires - exactly what this gauge surfaces
    (exported as ``lane_partial_age`` by ``MetricsRegistry.add_run_info``
    via ``info['tiers']``). ``widths`` maps lane F_FN -> batch width
    (``Megakernel`` passes its routed specs').

    ``max_gap`` bounds what "consecutive" means in rounds: a starved
    lane still fires every few rounds (each momentary ring drain fires
    it), so a silence longer than ``max_gap`` rounds means the lane was
    EMPTY - no entry was waiting - and two partial tails separated by a
    long idle stretch must read as two short streaks, not one huge
    starvation age."""
    recs = records_of(trace, TR_FIRE_BATCH, ring)
    out: Dict[int, int] = {int(f): 0 for f in widths}
    streak_start: Dict[int, Optional[int]] = {int(f): None for f in widths}
    last_t: Dict[int, int] = {}
    for tag, t, a, _b in recs:
        fid = int(a) >> 16
        take = int(a) & 0xFFFF
        if fid not in out:
            continue
        if take < widths[fid]:
            if (
                streak_start[fid] is None
                or int(t) - last_t[fid] > max_gap
            ):
                streak_start[fid] = int(t)
            last_t[fid] = int(t)
            out[fid] = max(out[fid], last_t[fid] - streak_start[fid] + 1)
        else:
            streak_start[fid] = None
    return out


def bucket_occupancy(
    trace: Dict[str, Any], widths: Dict[int, int], buckets: int,
    ring: int = 0,
) -> Dict[int, float]:
    """Per-bucket occupancy off the TR_FIRE_BUCKET records (the priority
    tier's structural gauge): for each bucket id, retired
    descriptors over the slots its fired rounds offered - the same
    tasks/offered ratio ``batch_occupancy`` reports per kind, split by
    bucket ring. A healthy ordered workload shows the low buckets firing
    near-full (the frontier lives there) and the high buckets sparse;
    a flat profile means the priority function isn't separating the
    work. ``widths`` maps lane F_FN -> batch width (the b word names the
    firing lane); buckets without a single fire report 0.0."""
    recs = records_of(trace, TR_FIRE_BUCKET, ring)
    takes = {b: 0 for b in range(int(buckets))}
    offered = {b: 0 for b in range(int(buckets))}
    for _tag, _t, a, fid in recs:
        b = int(a) >> 16
        if b not in takes:
            continue
        takes[b] += int(a) & 0xFFFF
        offered[b] += int(widths.get(int(fid), 0))
    return {
        b: (takes[b] / offered[b] if offered[b] else 0.0)
        for b in takes
    }


def summarize(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Flat numeric summary of a trace (MetricsRegistry food): per-tag
    record counts plus written/dropped totals across rings."""
    out: Dict[str, Any] = {
        "rings": len(trace["rings"]),
        "written": sum(r["written"] for r in trace["rings"]),
        "dropped": sum(r["dropped"] for r in trace["rings"]),
    }
    for tag, name in TAG_NAMES.items():
        n = 0
        for r in trace["rings"]:
            recs = np.asarray(r["records"])
            if recs.size:
                n += int((recs[:, 0] == tag).sum())
        out[name] = n
    return out
