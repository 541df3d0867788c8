"""Host -> resident-kernel task injection: the streaming front door on an
H100 (``StreamingMegakernel``), with tenant lanes, the completion mailbox
and live telemetry.

Port of ``hclib_tpu/device/inject.py``. The TPU runs one ``pallas_call``
a kernel entry (``StreamingMegakernel._kernel``, :473): the scalar
scheduler core of the megakernel interleaved, round by round, with a poll
of an injection ring in HBM. Here one entry is one launch of
``stream_kernel`` (``csrc/stream.cuh``), one block whose thread 0 runs the
same rounds over the megakernel's scalar core (stage, pop, step, complete,
spawn and the flight recorder):

- ``ring[R, 256]`` int32 rows: words 0..15 the descriptor ABI
  (device/descriptor.py), 16..20 the tenant transport words (``TEN_*``).
- ``ctl[8]``: [0] tail (rows ever appended), [1] close flag, [2] the
  device-consumed cursor (echoed), [3] the host abort word, polled by the
  kernel inside its round loop, [4] echoes the round the abort was
  observed, [5]/[6] the quiesce word and its executed-count threshold
  (checkpoint builds; the echo's [5] is the round the quiesce was
  observed, -1 never).
- Each outer round: ``sched(quantum)`` with the three seams of the core
  (the egress publish as ``complete_hook``, the telemetry fire stamp as
  ``fire_hook``, the round tick as ``round_hook``), a fresh read of
  ``ctl``, then the single-firehose poll (install rows ``[consumed,
  tail)``) or, with tenant lanes, the weighted round-robin poll over the
  ``tctl[T, 8]`` lanes (at most ``min(weight, avail, headroom())`` rows a
  lane, the egress credit gate, expired rows dropped and counted, paused
  lanes swept). The entry stops when the table is idle and the ring
  drained, on the abort word, on the quiesce word, or after
  ``max_rounds``.

Tenant lanes, admission and the futures are the host half
(device/tenants.py, device/egress.py, device/telemetry.py); ``run_stream``
drives entries until the stream is closed and drained, aborted, or
quiesced for a checkpoint (runtime/checkpoint.py ``snapshot_stream`` /
``restore_stream``).

What differs from the JAX class:

- **The driver keeps the scheduler state on the card.** The JAX driver
  round-trips the task table, ready ring, values and data through numpy
  every entry (inject.py:1537). Here they stay resident: per entry the
  driver uploads only the ring rows published (or marked expired) since
  the last entry and one packed block of the small control words (ctl,
  tctl, the mailbox and park rings, ectl, the counts row and the
  telemetry gauges and histograms), and reads back only that block.
  ``tasks`` / ``ready`` / ``ivalues`` / data / ``etok`` / ``tlat`` and the
  trace ring come to the host only at a quiesce export, an abort or the
  final exit. This changes no result: the kernel reads and writes the
  same words in the same order.
- **No program cache** (ROADMAP A13): ``info`` carries no
  ``program_cache`` entry; the kernel is built once per process.
- **Tables the stream kernel holds**: the scalar bodies of
  ``mk_kernel``'s instances 0, 4 and 5 (fib, sum, UTS; the frontier and
  knapsack bodies; the dynamic-graph bodies). A table with batch routes
  is refused with ``ValueError`` as JAX refuses it at trace time (the
  stream embeds the scalar tier only); on the card a table with tile
  (Cholesky, forasync), SW or vector bodies raises
  ``NotImplementedError`` (ROADMAP A14). The plain version (``device=
  "cpu"``) runs every scalar body.
- **Delivery lands at entry boundaries** as in JAX: zero-copy production
  into mapped pinned host memory mid-entry is not built (ROADMAP A14).

On CPU tensors (``Megakernel(device="cpu")``) an entry runs the plain
version (``_PlainStream``) over the plain scheduler core; on CUDA tensors
it launches ``stream_kernel`` or raises.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..runtime import resilience
from ..runtime.clockprobe import EpochBracket
from ..runtime.env import env_bool
from ..runtime.resilience import CancelledError, StallError
from .descriptor import (
    DESC_WORDS,
    F_FN,
    F_OUT,
    NO_TASK,
    RING_ROW,
    TEN_ADMIT_ROUND,
    TEN_EXPIRED,
    TEN_ID,
    TEN_TOKEN,
    TaskGraphBuilder,
)
from .egress import (
    EC_CONSUMED,
    EC_INFLIGHT,
    EC_PARK_COUNT,
    EC_PARK_HEAD,
    EC_PARKED,
    EC_WRITE,
    EGR_OK,
    EGR_STATUS,
    EGR_T_ADMIT,
    EGR_T_SPANS,
    EGR_TOKEN,
    EGR_VALUE,
    EGR_WORDS,
    TOKEN_LIMIT,
    EgressProtocolError,
)
from .megakernel import (
    C_ALLOC,
    C_EXECUTED,
    C_HEAD,
    C_OVERFLOW,
    C_PENDING,
    C_TAIL,
    C_VALLOC,
    MAX_DATA,
    NDISPATCH,
    POLICY_BODIES,
    Megakernel,
    _i32,
    _PlainCore,
)
from .state import numpy_of, tensor_of
from .telemetry import (
    LAT_ADMIT,
    LAT_BUCKETS,
    LAT_FIRE,
    LAT_INSTALL,
    LAT_WORDS,
    TG_BACKLOG,
    TG_ENTRIES,
    TG_INSTALLS,
    TG_PARKED,
    TG_RETIRES,
    TG_ROUNDS,
    unpack_spans,
)
from .tenants import (
    TC_CONSUMED,
    TC_DROPPED,
    TC_EXPIRED,
    TC_INSTALLED,
    TC_PAUSE,
    TC_TAIL,
    TC_WEIGHT,
    Admission,
    TenantTable,
    build_row,
    normalize_tenants,
)
from .tracebuf import (
    TR_ABORT,
    TR_CKPT,
    TR_EGRESS,
    TR_INJECT,
    TR_LATENCY,
    TR_QUIESCE,
    TR_TENANT,
    trace_info,
)

__all__ = ["StreamingMegakernel", "EntryBlocks", "RING_ROW", "RING_WORDS"]

# Ring-row words the kernel reads: the descriptor and the five TEN_* words.
RING_WORDS = TEN_ADMIT_ROUND + 1


def _rem(a: int, b: int) -> int:
    """jax.lax.rem / C's %: the remainder takes the dividend's sign."""
    r = abs(a) % b
    return r if a >= 0 else -r


class EntryBlocks:
    """The small per-entry words as ONE int32 array: ctl in and out, the
    scheduler's counts row, tctl, the mailbox and park rings, ectl and the
    telemetry block. The host seeds it before an entry and reads the echo
    after (on the card one upload and one read back); ``v`` holds numpy
    views of it by name. ``StreamingMegakernel.entry_log`` holds copies of
    ``arr``: copy one into ``EntryBlocks(T, depth, telemetry).arr`` to
    read it by name."""

    def __init__(self, T: int, depth: int, tele: bool) -> None:
        shapes = [("ctl_in", (8,)), ("ctl_out", (8,)), ("counts", (8,)),
                  ("tctl", (T, 8)), ("egr", (depth, EGR_WORDS)),
                  ("park", (depth, EGR_WORDS)), ("ectl", (8,)),
                  ("tele", ((1 + T) if tele else 0, LAT_BUCKETS))]
        self.off: Dict[str, int] = {}
        n = 0
        for name, shape in shapes:
            self.off[name] = n
            n += int(np.prod(shape))
        self.arr = np.zeros(n, np.int32)
        self.v = {name: self.arr[self.off[name]:self.off[name]
                                 + int(np.prod(shape))].reshape(shape)
                  for name, shape in shapes}


class _PlainStream:
    """The plain version of ``stream_kernel``: one entry of
    ``StreamingMegakernel._kernel`` (JAX inject.py:473-984) in Python over
    the plain scheduler core, on the entry's state and blocks (updated in
    place). It is what runs on the CPU; on the card, nothing on the main
    path calls it."""

    def __init__(self, sm: "StreamingMegakernel", ctx: "_Ctx") -> None:
        self.sm = sm
        self.ctx = ctx

    def entry(self, quantum: int, max_rounds: int) -> None:
        sm, ctx = self.sm, self.ctx
        mk = sm.mk
        v = ctx.blocks.v
        T = len(sm.tenants) if sm.tenants is not None else 0
        negr = ctx.depth > 0
        ntele = sm.telemetry
        depth = park_cap = ctx.depth
        region = sm.tenants.region_rows if T else 0
        ring = ctx.ring
        core = _PlainCore(mk, ctx.st)
        tr = core.tr
        tasks, counts = core.tasks, core.counts
        tctl = v["tctl"].tolist()
        egr = v["egr"].tolist()
        park = v["park"].tolist()
        ectl = v["ectl"].tolist()
        etok = ctx.etok.tolist() if negr else None
        tele = v["tele"].tolist() if ntele else None
        tlat = ctx.tlat.tolist() if ntele else None

        def egress_complete(idx: int) -> None:
            packed = etok[idx]
            if packed == 0:
                return
            token = _rem(packed, TOKEN_LIMIT)
            ten = packed // TOKEN_LIMIT
            r = idx * DESC_WORDS
            slot = tasks[r + F_OUT]
            write = ectl[EC_WRITE]
            room = depth - (write - ectl[EC_CONSUMED])
            # EGR_STATUS .. EGR_VALUE, then EGR_T_ADMIT, EGR_T_SPANS.
            row = [EGR_OK, token, ten, tasks[r + F_FN], slot,
                   core.ivalues[slot]]
            if ntele:
                now = tele[0][TG_ROUNDS]
                admit, inst = tlat[idx][LAT_ADMIT], tlat[idx][LAT_INSTALL]
                spans = _i32((min(max(now - inst, 0), 0xFFFF) << 16)
                             | min(max(inst - admit, 0), 0xFFFF))
                row += [admit, spans]
            if room > 0:
                egr[_rem(write, depth)][:len(row)] = row
                ectl[EC_WRITE] = write + 1
            else:
                n = ectl[EC_PARK_COUNT]
                park[_rem(ectl[EC_PARK_HEAD] + n, park_cap)][:len(row)] = row
                ectl[EC_PARK_COUNT] = n + 1
                ectl[EC_PARKED] += 1
                tr.emit(TR_EGRESS, tr.now(), token, n + 1)
            if ntele:
                d = max(now - admit, 0)
                b = sum(d >= (1 << k) for k in range(1, LAT_BUCKETS))
                tele[1 + ten][b] += 1
                tele[0][TG_RETIRES] += 1
                tr.emit(TR_LATENCY, tr.now(), (ten << 16) | b, d)
            etok[idx] = 0
            ectl[EC_INFLIGHT] -= 1

        def tele_fire(idx: int) -> None:
            tlat[idx][LAT_FIRE] = tele[0][TG_ROUNDS]

        def tele_round() -> None:
            g = tele[0]
            g[TG_ROUNDS] += 1
            g[TG_BACKLOG] = counts[C_TAIL] - counts[C_HEAD]
            g[TG_PARKED] = ectl[EC_PARK_COUNT]

        if negr:
            core.complete_hook = egress_complete
        if ntele:
            core.fire_hook = tele_fire
            core.round_hook = tele_round
        core.stage(True)

        def install(row: List[int]) -> None:
            idx = core.install_descriptor(lambda w: row[w])
            if ntele:
                tlat[idx][LAT_ADMIT] = row[TEN_ADMIT_ROUND]
                tlat[idx][LAT_INSTALL] = tele[0][TG_ROUNDS]
                tele[0][TG_INSTALLS] += 1
            if negr and row[TEN_TOKEN] != 0:
                etok[idx] = _i32(row[TEN_TOKEN] + row[TEN_ID] * TOKEN_LIMIT)
                ectl[EC_INFLIGHT] += 1

        def tpoll(r: int) -> int:
            newly = 0
            for k in range(T):
                lane = _rem(r + k, T)
                tc = tctl[lane]
                tail, cons = tc[TC_TAIL], tc[TC_CONSUMED]
                paused = tc[TC_PAUSE] != 0
                avail = tail - cons
                take = 0 if paused else min(tc[TC_WEIGHT], avail,
                                            core.headroom())
                if negr:
                    take = min(take, max(park_cap - ectl[EC_PARK_COUNT]
                                         - ectl[EC_INFLIGHT], 0))
                inst = exp = 0
                c = cons
                while c < cons + take:
                    row = ring[lane * region + c, :RING_WORDS].tolist()
                    if row[TEN_EXPIRED] != 0:
                        exp += 1
                    else:
                        install(row)
                        inst += 1
                    c += 1
                tc[TC_CONSUMED] = tail if paused else c
                tc[TC_DROPPED] += avail if paused else 0
                tc[TC_INSTALLED] += inst
                tc[TC_EXPIRED] += exp
                if inst > 0 or exp > 0:
                    tr.emit(TR_TENANT, tr.now(), (lane << 16) | inst, exp)
                newly += inst
            return newly

        if negr:
            # The entry-start flush of parked rows into the mailbox.
            for _ in range(park_cap):
                cnt = ectl[EC_PARK_COUNT]
                room = depth - (ectl[EC_WRITE] - ectl[EC_CONSUMED])
                if cnt > 0 and room > 0:
                    h = ectl[EC_PARK_HEAD]
                    egr[_rem(ectl[EC_WRITE], depth)] = list(park[h])
                    park[h] = [0] * EGR_WORDS
                    ectl[EC_PARK_HEAD] = _rem(h + 1, park_cap)
                    ectl[EC_PARK_COUNT] = cnt - 1
                    ectl[EC_WRITE] += 1
        ctl_in = v["ctl_in"]
        ctlbuf = ctl_in.tolist()
        consumed = ctlbuf[2]
        ckpt = mk.checkpoint
        r, done, abr, qr = 0, False, -1, -1
        while not done and r < max_rounds:
            core.sched(quantum)
            ctlbuf = ctl_in.tolist()
            if T:
                newly = tpoll(r)
                if newly > 0:
                    tr.emit(TR_INJECT, tr.now(), newly)
            else:
                c0 = consumed
                while consumed < ctlbuf[0]:
                    install(ring[consumed, :RING_WORDS].tolist())
                    consumed += 1
                if consumed > c0:
                    tr.emit(TR_INJECT, tr.now(), consumed - c0)
            aborted = ctlbuf[3] != 0
            if aborted and abr < 0:
                tr.emit(TR_ABORT, tr.now(), r)
                abr = r
            qz = False
            if ckpt:
                qz = ctlbuf[5] != 0 and counts[C_EXECUTED] >= ctlbuf[6]
                if qz and qr < 0:
                    tr.emit(TR_QUIESCE, tr.now(), r)
                    qr = r
            idle = counts[C_PENDING] == 0
            if T:
                drained = all(tc[TC_CONSUMED] == tc[TC_TAIL] for tc in tctl)
            else:
                drained = consumed == ctlbuf[0]
            done = (idle and drained) or aborted or qz
            r += 1
        v["ctl_out"][:] = [ctlbuf[0], ctlbuf[1], consumed, ctlbuf[3], abr,
                           qr if ckpt else 0, 0, 0]
        if ckpt and qr >= 0:
            tr.emit(TR_CKPT, tr.now(), counts[C_PENDING], ctlbuf[0] - consumed)
        core.write_back()
        if T:
            v["tctl"][:] = tctl
        if negr:
            v["egr"][:] = egr
            v["park"][:] = park
            v["ectl"][:] = ectl
            ctx.etok[:] = etok
        if ntele:
            v["tele"][:] = tele
            ctx.tlat[:] = tlat


class _Ctx:
    """One stream's live state for ``run_stream``: the scheduler state
    (tensors on the megakernel's device, updated in place by each entry),
    the ring (host copy, and its device copy on the card), the packed
    control blocks, the egress token table and the telemetry stamp table.
    On the card ``st['counts']`` is a view of the device block, so the
    counts row rides the block's one upload and one read back."""

    def __init__(self, sm: "StreamingMegakernel", state: Dict[str, Any],
                 data: Dict[str, Any]) -> None:
        mk = sm.mk
        dev = mk.device
        self.cuda = dev.type == "cuda"
        T = len(sm.tenants) if sm.tenants is not None else 0
        self.depth = sm._egress.depth if sm._egress is not None else 0
        self.blocks = EntryBlocks(T, self.depth, sm.telemetry)
        self.blocks.v["counts"][:] = np.asarray(state["counts"], np.int32)
        self.ring = np.zeros((sm.ring_capacity, RING_ROW), np.int32)
        st = {k: tensor_of(np.asarray(state[k], np.int32), dev)
              for k in ("tasks", "succ", "ready", "ivalues")}
        st["data"] = {
            k: (d.to(dev).clone() if isinstance(d, torch.Tensor)
                else tensor_of(d, dev)) for k, d in data.items()}
        mk._check_data(st["data"])
        if mk.trace is not None:
            st["trace"] = mk.trace.row(dev)
        self.etok = np.zeros(mk.capacity, np.int32)
        self.tlat = np.zeros((mk.capacity, LAT_WORDS), np.int32)
        if self.cuda:
            self.blk_dev = torch.from_numpy(self.blocks.arr).to(dev)
            o = self.blocks.off["counts"]
            st["counts"] = self.blk_dev[o:o + 8]
            self.ring_dev = torch.zeros((sm.ring_capacity, RING_WORDS),
                                        dtype=torch.int32, device=dev)
            self.etok_dev = torch.zeros(mk.capacity, dtype=torch.int32,
                                        device=dev)
            self.tlat_dev = torch.zeros((mk.capacity, LAT_WORDS),
                                        dtype=torch.int32, device=dev)
            self.free = torch.empty(mk.capacity + 1, dtype=torch.int32,
                                    device=dev)
            self.dispatch = torch.zeros(NDISPATCH, dtype=torch.int32,
                                        device=dev)
            self.meta = torch.tensor(mk._meta, dtype=torch.int32, device=dev)
            # Ring rows the device holds, by region (firehose: one).
            self.uploaded = [0] * max(T, 1)
        else:
            st["counts"] = torch.from_numpy(self.blocks.v["counts"])
        self.st = st

    # ---- host <-> device (the card only) ----

    def put_tables(self) -> None:
        """Upload the host's etok / tlat tables (a resume seeds them)."""
        if self.cuda:
            self.etok_dev.copy_(torch.from_numpy(self.etok))
            self.tlat_dev.copy_(torch.from_numpy(self.tlat))

    def publish(self, lo_hi: Sequence[Tuple[int, int]]) -> None:
        """Upload ring rows ``[lo, hi)`` (their RING_WORDS words) for each
        range."""
        for lo, hi in lo_hi:
            if hi > lo:
                self.ring_dev[lo:hi].copy_(torch.from_numpy(
                    np.ascontiguousarray(self.ring[lo:hi, :RING_WORDS])))

    def get_tables(self) -> None:
        """Bring etok / tlat back to the host (export and exit only)."""
        if self.cuda:
            self.etok[:] = self.etok_dev.cpu().numpy()
            self.tlat[:] = self.tlat_dev.cpu().numpy()

    def trace_row(self) -> Optional[np.ndarray]:
        t = self.st.get("trace")
        return None if t is None else t.cpu().numpy()

    def state_numpy(self, mk: Megakernel) -> Dict[str, Any]:
        st = self.st
        return {
            "tasks": numpy_of(st["tasks"]),
            "succ": numpy_of(st["succ"]),
            "ready": numpy_of(st["ready"]),
            "counts": self.blocks.v["counts"].copy(),
            "ivalues": numpy_of(st["ivalues"]),
            "data": {k: numpy_of(st["data"][k]) for k in mk.data_specs},
        }


class StreamingMegakernel:
    """Megakernel + injection ring: a resident scheduler whose task supply
    is open-ended (the streaming substrate), as ``hclib_tpu``'s class of
    the same name.

    ``mk`` supplies the kernel table, capacities and device (a
    ``Megakernel``; its ``device`` default is the card, and it raises
    without one); the injection ring holds ``ring_capacity`` rows, a
    linear (non-wrapping) append log per stream.

    ``tenants=`` (device/tenants.py): an int N, a sequence of
    TenantSpec / str / dict lane specs, or a prebuilt TenantTable. None
    reads the ``HCLIB_TPU_TENANTS*`` spelling; False forces the single
    firehose. With lanes the ring splits into per-tenant regions of
    ``ring_capacity // N`` rows (rounded up to 8-row chunks), producers
    ``submit()`` for a typed ``Admission`` and the in-kernel poll runs
    weighted round-robin. An egress-enabled table (``EgressSpec`` or
    ``HCLIB_TPU_EGRESS_DEPTH``) adds the completion mailbox: each
    submission's ``Admission.future`` resolves to its row's out-slot
    value. ``telemetry=True`` (``HCLIB_TPU_TELEMETRY``) adds the lifecycle
    stamps and the per-tenant latency histograms (needs egress).

    ``timing`` (reset by each ``run_stream``): ``entries``, ``entry_ms``
    (host wall time inside the entries: upload, launch and read back, or
    the plain entry) and ``kernel_ms`` (the launches' CUDA-event time; 0
    on the CPU); the rest of a stream's wall time is the host's pump,
    drain and admission.

    ``entry_log``: set it to a list and every entry appends a copy of
    its echoed control block (ctl, counts, tctl, mailbox, park, ectl,
    telemetry), and the drained exit keeps the whole final state in
    ``final_state`` (numpy, etok and tlat included), so two streams can
    be compared entry by entry and word for word.
    """

    def __init__(self, mk: Megakernel, ring_capacity: int = 1024,
                 tenants=None, telemetry=None) -> None:
        self.mk = mk
        # Whole 8-row chunks: JAX's layout, kept so rings and bundles
        # cross between the packages.
        self.ring_capacity = -(-int(ring_capacity) // 8) * 8
        if isinstance(tenants, TenantTable):
            self.tenants: Optional[TenantTable] = tenants
        else:
            specs = normalize_tenants(tenants)
            if specs is None:
                self.tenants = None
            else:
                region = -(-self.ring_capacity // (8 * len(specs))) * 8
                self.tenants = TenantTable(specs, region)
        if self.tenants is not None:
            self.ring_capacity = len(self.tenants) * self.tenants.region_rows
        self._egress = (
            self.tenants.egress if self.tenants is not None else None
        )
        if telemetry is None:
            telemetry = env_bool("HCLIB_TPU_TELEMETRY")
        self.telemetry = bool(telemetry)
        if self.telemetry and self._egress is None:
            raise ValueError(
                "telemetry needs an egress-enabled tenant stream (the "
                "latency histograms are per-tenant and fold at the "
                "egress publish hook): build with tenants= plus an "
                "EgressSpec, or set HCLIB_TPU_EGRESS_DEPTH"
            )
        self.entry_log: Optional[list] = None
        self.final_state: Optional[Dict[str, Any]] = None
        self.timing: Dict[str, Any] = {}
        self._tele_seq = 0
        self._tele_snapshot: Optional[Dict[str, Any]] = None
        self._spans: Dict[int, Tuple[int, int, int]] = {}
        self._lock = threading.Lock()
        self._pending_rows: List[np.ndarray] = []
        self._closed = False
        # A quiesce-induced close (undone by a same-object resume) versus
        # an explicit close()/abort() (sticky).
        self._closed_by_quiesce = False
        self._abort_reason: Optional[str] = None
        self._abort_t: Optional[float] = None
        self._quiesce_after: Optional[int] = None
        self._quiesce_t: Optional[float] = None
        self._stats: Dict[str, Any] = {
            "aborts": 0,
            "abort_reason": None,
            "abort_observed_round": None,
            "abort_latency_s": None,
            "abort_drain_executed": None,
            "quiesces": 0,
            "resumes": 0,
            "last_quiesce_latency_s": None,
        }

    # ---- lifecycle ----

    def __enter__(self) -> "StreamingMegakernel":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # An open ring would leave run_stream re-entering forever.
        self.close()
        return False

    def abort(self, reason: str = "aborted") -> None:
        """Stop accepting injections and stop the running stream: at its
        next entry boundary run_stream publishes the ctl abort word, runs
        ONE final entry (the round loop polls the word and exits within a
        round, remaining rows dropped) and raises ``CancelledError``. The
        latency is in ``stats_dict()``."""
        with self._lock:
            if self._abort_reason is None:
                self._abort_reason = str(reason)
                self._abort_t = time.monotonic()
            self._closed = True
            self._closed_by_quiesce = False

    def quiesce(self, after_executed: int = 0) -> None:
        """Checkpoint request (``mk`` built with ``checkpoint=True``): the
        next entry publishes the ctl quiesce word; the kernel observes it
        in its round loop once ``after_executed`` tasks have run, and
        run_stream returns ``info['quiesced']=True`` with ``info['state']``
        (``runtime.checkpoint.snapshot_stream`` / ``run_stream(
        resume_state=...)``), the ring closed."""
        if not self.mk.checkpoint:
            raise ValueError(
                "quiesce() needs Megakernel(checkpoint=True): the quiesce "
                "word is compiled into the round loop only then"
            )
        with self._lock:
            if self._quiesce_after is None:
                self._quiesce_after = max(0, int(after_executed))
                self._quiesce_t = time.monotonic()

    def stats_dict(self) -> dict:
        """Resilience counters (abort latency included), the per-tenant
        admission counters and the egress ledger."""
        with self._lock:
            d = dict(self._stats)
        if self.tenants is not None:
            d["tenants"] = self.tenants.stats()
            if self.tenants.futures is not None:
                d["egress"] = self.tenants.futures.stats_dict()
        return d

    # ---- producer side (host; any thread) ----

    def inject(self, fn: int, args: Sequence[int] = (), out: int = 0,
               dep_count: int = 0, succ0: int = NO_TASK,
               succ1: int = NO_TASK) -> None:
        """Queue one descriptor for the stream (thread-safe; rows reach the
        ring at the next entry boundary). On a tenant stream this is
        ``submit()`` on the first lane, raising if the lane rejects."""
        if dep_count != 0:
            raise ValueError("injected tasks must have dep_count == 0")
        if self.tenants is not None:
            adm = self.submit(self.tenants.ids[0], fn, args=args, out=out,
                              succ0=succ0, succ1=succ1)
            if not adm:
                raise RuntimeError(
                    f"inject rejected by tenant lane "
                    f"{self.tenants.ids[0]!r}: {adm.reason}"
                )
            return
        row = build_row(fn, args, out, succ0, succ1)
        with self._lock:
            if self._closed:
                reason = self._abort_reason
                raise RuntimeError(
                    "stream closed" + (f" ({reason})" if reason else "")
                )
            self._pending_rows.append(row)

    def submit(self, tenant, fn: int, args: Sequence[int] = (),
               out: int = 0, succ0: int = NO_TASK, succ1: int = NO_TASK,
               deadline_s: Optional[float] = None, cancel_scope=None,
               wait: bool = False,
               wait_timeout_s: float = 30.0) -> Admission:
        """Admit one task into a tenant lane (thread-safe): ACCEPTED,
        QUEUED or REJECTED(reason). ``deadline_s`` / ``cancel_scope`` feed
        deadline admission; ``wait=True`` turns the transient rejections
        ("rate", "backlog") into a bounded blocking wait."""
        if self.tenants is None:
            raise ValueError(
                "submit() needs tenant lanes: build the stream with "
                "tenants= (or set HCLIB_TPU_TENANTS)"
            )
        table = self.tenants
        table._lane(tenant)  # unknown tenants raise KeyError up front
        row = build_row(fn, args, out, succ0, succ1)
        deadline_at = table.resolve_deadline(tenant, deadline_s,
                                             cancel_scope)
        with self._lock:
            closed = self._closed
        if closed:
            return table.record_reject(tenant, "closed")
        if not wait:
            return table.admit(tenant, row, deadline_at, cancel_scope)
        # A wall-clock bound even under an injected table clock.
        t_end = time.monotonic() + float(wait_timeout_s)
        backoff = 0.0005
        while True:
            adm = table.admit(tenant, row, deadline_at, cancel_scope,
                              record_reject=False)
            if adm:
                return adm
            if adm.reason not in ("rate", "backlog"):
                return table.record_reject(tenant, adm.reason)
            if deadline_at is not None and table.clock() >= deadline_at:
                return table.record_reject(tenant, "expired")
            if time.monotonic() >= t_end:
                return table.record_reject(tenant, adm.reason)
            with self._lock:
                if self._closed:
                    return table.record_reject(tenant, "closed")
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.05)

    def close(self) -> None:
        """No more injections: the stream drains and run_stream returns."""
        with self._lock:
            self._closed = True
            self._closed_by_quiesce = False

    # ---- the kernel ----

    def _check_table(self) -> int:
        """Refuse what the stream kernel does not hold; returns the
        ``stream_kernel`` instance (0, 4 or 5) of the table."""
        mk = self.mk
        if mk.batch_specs:
            routed = sorted(mk.kernel_names[f] for f, _, _ in mk.batch_specs)
            raise ValueError(
                f"batch-routed kernels ({routed}): the stream embeds the "
                "scalar tier only (no batch-lane scratch), as "
                "hclib_tpu's StreamingMegakernel refuses them; drop the "
                "BatchSpec routes for this stream"
            )
        if mk.device.type == "cuda" and (
                mk.tile_bodies or mk.sw_bodies or mk.vector_specs
                or mk.slab_words):
            raise NotImplementedError(
                "a stream over tile (Cholesky, forasync), SW or vector "
                "bodies has no stream_kernel instance on the card "
                "(ROADMAP A14); run it with device='cpu'")
        if not set(mk.body_names) & set(POLICY_BODIES):
            return 0
        return 5 if mk.params["dyn"] else 4

    def _entry(self, ctx: _Ctx, quantum: int, max_rounds: int,
               mode: int) -> None:
        """One kernel entry over ``ctx`` (blocks seeded by the caller)."""
        t0 = time.perf_counter()
        if not ctx.cuda:
            _PlainStream(self, ctx).entry(quantum, max_rounds)
        else:
            self._launch_cuda(ctx, quantum, max_rounds, mode)
        self.timing["entries"] += 1
        self.timing["entry_ms"] += (time.perf_counter() - t0) * 1e3
        if self.entry_log is not None:
            self.entry_log.append(ctx.blocks.arr.copy())

    def _launch_cuda(self, ctx: _Ctx, quantum: int, max_rounds: int,
                     mode: int) -> None:
        mk = self.mk
        st = ctx.st
        dev = st["tasks"].device
        blk = ctx.blk_dev
        blk.copy_(torch.from_numpy(ctx.blocks.arr))
        o = ctx.blocks.off
        T = len(self.tenants) if self.tenants is not None else 0
        data = st["data"]
        ptrs = (ctypes.c_void_p * MAX_DATA)(
            *[data[k].data_ptr() for k in mk.data_specs])
        ring = st.get("trace")
        base = blk.data_ptr()

        def at(name: str) -> int:
            return base + 4 * o[name]

        lib = _build.library("megakernel")
        fn = lib.hclib_stream_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        err = fn(
            st["tasks"].data_ptr(), st["succ"].data_ptr(),
            st["ready"].data_ptr(), st["counts"].data_ptr(),
            st["ivalues"].data_ptr(), ctx.free.data_ptr(),
            ctx.meta.data_ptr(), ctx.dispatch.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ring.data_ptr() if ring is not None else None,
            ctx.ring_dev.data_ptr(), at("ctl_in"), at("ctl_out"),
            at("tctl"), at("egr"), at("park"), at("ectl"),
            ctx.etok_dev.data_ptr(), at("tele"), ctx.tlat_dev.data_ptr(),
            mk.trace.capacity if ring is not None else 0,
            len(mk.kernel_names), mk.capacity, mk.num_values, T,
            self.tenants.region_rows if T else 0, ctx.depth,
            int(self.telemetry), min(int(quantum), 0x7FFFFFFF),
            int(max_rounds), int(mk.checkpoint), mode, 32,
            mk._smem_bytes(), torch.cuda.current_stream(dev).cuda_stream,
        )
        ev1.record()
        _build.check(lib, err, "stream")
        _build.LAUNCHES["stream"] += 1
        ctx.blocks.arr[:] = blk.cpu().numpy()
        self.timing["kernel_ms"] += ev0.elapsed_time(ev1)

    # ---- the stream driver ----

    def run_stream(
        self,
        builder: Optional[TaskGraphBuilder] = None,
        ivalues: Optional[np.ndarray] = None,
        data: Optional[Dict[str, Any]] = None,
        quantum: int = 1 << 10,
        max_rounds: int = 64,
        poll_interval_s: float = 0.001,
        deadline_s: Optional[float] = None,
        cancel_scope=None,
        resume_state: Optional[Dict[str, Any]] = None,
    ) -> Tuple[np.ndarray, dict]:
        """Run the stream to completion: entries re-enter the resident
        scheduler while the host (any thread) injects; returns after
        close() once everything drained. Returns (ivalues, info).

        ``deadline_s`` bounds the whole stream (a ``StallError`` past it);
        ``abort()`` stops it via the ctl abort word and raises
        ``CancelledError``; ``cancel_scope`` ties it to a host scope
        (its cancel aborts the stream). Any exception escaping the driver
        closes the ring. ``quiesce()`` (checkpoint builds) stops it at a
        round boundary WITH its state: run_stream returns
        ``info['quiesced']=True`` and ``info['state']``, which a later
        ``run_stream(resume_state=...)`` - on this object or a fresh
        equivalent one - continues. Entries re-enter back to back, as in
        the JAX driver (``poll_interval_s`` is accepted for its
        signature and unused there too). The drained exit's info also
        carries ``allocated`` (the bump cursor: the most rows the table
        held), as ``Megakernel.run``'s does; JAX's stream info has no
        such key."""
        if (builder is None) == (resume_state is None):
            raise ValueError(
                "run_stream wants exactly one of builder= (a fresh "
                "stream) or resume_state= (a checkpointed one)"
            )
        if resume_state is not None and (
                data is not None or ivalues is not None):
            raise ValueError(
                "resume_state= carries its own data/ivalues; passing "
                "them too would be silently ignored"
            )
        unregister = None
        if cancel_scope is not None:
            unregister = resilience.bind_abort_to_scope(self.abort,
                                                        cancel_scope)
        try:
            return self._run_stream(builder, ivalues, data, quantum,
                                    max_rounds, deadline_s, resume_state)
        except BaseException:
            with self._lock:
                self._closed = True
            raise
        finally:
            if unregister is not None:
                unregister()

    @staticmethod
    def _drain_egress(table, egr, park, ectl, spans=None) -> int:
        """Consume the mailbox AND the park ring at an entry boundary,
        resolving each row's future exactly once (arrays mutated in
        place: consumed slots re-zero, EC_CONSUMED catches up to EC_WRITE,
        the park ring empties). ``spans`` collects ``token -> (admit,
        install, fire)`` rounds (telemetry). Returns rows consumed."""
        futures = table.futures

        def _one(row):
            if spans is not None:
                spans[int(row[EGR_TOKEN])] = unpack_spans(
                    row[EGR_T_ADMIT], row[EGR_T_SPANS])[:3]
            futures.resolve(int(row[EGR_TOKEN]), int(row[EGR_VALUE]))
            row[:] = 0

        depth = egr.shape[0]
        n = 0
        consumed = int(ectl[EC_CONSUMED])
        while consumed < int(ectl[EC_WRITE]):
            row = egr[consumed % depth]
            if int(row[EGR_STATUS]) != EGR_OK:
                raise EgressProtocolError(
                    f"mailbox slot {consumed % depth} consumed twice or "
                    f"never published (status {int(row[EGR_STATUS])})"
                )
            _one(row)
            consumed += 1
            n += 1
        ectl[EC_CONSUMED] = consumed
        head, cnt = int(ectl[EC_PARK_HEAD]), int(ectl[EC_PARK_COUNT])
        cap = park.shape[0]
        for k in range(cnt):
            row = park[(head + k) % cap]
            if int(row[EGR_STATUS]) != EGR_OK:
                raise EgressProtocolError(
                    f"park slot {(head + k) % cap} empty but counted "
                    f"(status {int(row[EGR_STATUS])})"
                )
            _one(row)
            n += 1
        ectl[EC_PARK_HEAD] = 0
        ectl[EC_PARK_COUNT] = 0
        return n

    # ---- live telemetry ----

    def telemetry_snapshot(self) -> Optional[Dict[str, Any]]:
        """Thread-safe copy of the LAST entry's echoed telemetry block
        (None before the first): ``seq``, ``tele`` (the (1+T,
        LAT_BUCKETS) block), ``rounds`` / ``entries`` (cumulative) and
        ``ns_per_round`` (the entry epoch brackets' conversion)."""
        with self._lock:
            if self._tele_snapshot is None:
                return None
            snap = dict(self._tele_snapshot)
        snap["tele"] = np.array(snap["tele"])
        return snap

    def telemetry_spans(self) -> Dict[int, Tuple[int, int, int]]:
        """``token -> (admit, install, fire)`` rounds of every retirement
        drained so far (telemetry builds; retire == fire)."""
        with self._lock:
            return dict(self._spans)

    @staticmethod
    def _adopt_etok(table, etok, tasks) -> None:
        """Re-adopt installed-but-unretired submit tokens off a resumed
        snapshot's etok table (packed ``token + tenant * TOKEN_LIMIT``),
        so their retirements resolve into this table's ledger."""
        tasks = np.asarray(tasks)
        for idx in np.flatnonzero(etok):
            packed = int(etok[idx])
            table.futures.adopt_row_token(
                packed % TOKEN_LIMIT,
                table.ids[packed // TOKEN_LIMIT],
                int(tasks[idx, F_FN]),
                int(tasks[idx, F_OUT]),
            )

    def _run_stream(self, builder, ivalues, data, quantum, max_rounds,
                    deadline_s, resume_state=None) -> Tuple[np.ndarray, dict]:
        deadline = (
            None if deadline_s is None else time.monotonic() + deadline_s
        )
        mk = self.mk
        mode = self._check_table()
        self.timing = {"entries": 0, "entry_ms": 0.0, "kernel_ms": 0.0}
        table = self.tenants
        egspec = self._egress if table is not None else None
        injected = 0
        if self.telemetry:
            bracket = EpochBracket()
            prev_rounds = 0
            if resume_state is None:
                with self._lock:
                    self._spans = {}
                    self._tele_snapshot = None
                    self._tele_seq = 0
        if resume_state is not None:
            # A same-object resume behaves like a fresh stream: clear the
            # quiesce request and undo a QUIESCE-induced close (explicit
            # close()/abort() stay sticky).
            with self._lock:
                self._quiesce_after = None
                self._quiesce_t = None
                self._stats["resumes"] += 1
                if self._closed_by_quiesce:
                    self._closed = False
                    self._closed_by_quiesce = False
            st = resume_state
            data = dict(st.get("data") or {})
            ctx = _Ctx(self, st, data)
            v = ctx.blocks.v
            if table is not None:
                table.resume_from(st)
                if egspec is not None:
                    et = np.asarray(
                        st.get("etok", np.zeros(mk.capacity, np.int32)),
                        np.int32).reshape(-1)
                    if et.shape[0] != mk.capacity:
                        raise ValueError(
                            f"resume etok table has {et.shape[0]} rows; "
                            f"this kernel's task table has {mk.capacity}"
                        )
                    ctx.etok[:] = et
                    self._adopt_etok(table, ctx.etok, st["tasks"])
                    # The adopted tokens ARE in flight: the credit gate
                    # reads EC_INFLIGHT, so seed it with their count.
                    v["ectl"][EC_INFLIGHT] = int(np.count_nonzero(ctx.etok))
                if self.telemetry:
                    # The telemetry block rides the cut (the round gauge
                    # is cumulative); absent keys start it from zero.
                    for name, cur in (("tele", v["tele"]),
                                      ("tlat", ctx.tlat)):
                        blk = st.get(name)
                        if blk is None:
                            continue
                        blk = np.asarray(blk, np.int32)
                        if blk.shape != cur.shape:
                            raise ValueError(
                                f"resume {name} block has shape "
                                f"{blk.shape}; this stream expects "
                                f"{cur.shape}"
                            )
                        cur[:] = blk
                    prev_rounds = int(v["tele"][0, TG_ROUNDS])
                ctx.put_tables()
            elif "tctl" in st or "tstats" in st:
                raise ValueError(
                    "resume state carries per-tenant lane blocks "
                    "(tctl/tstats): it was exported from a tenant-enabled "
                    "stream and cannot resume on a plain one"
                )
            else:
                residue = np.asarray(
                    st.get("ring_rows", np.zeros((0, RING_ROW), np.int32))
                ).reshape(-1, RING_ROW)
                if len(residue) > self.ring_capacity:
                    raise ValueError(
                        f"resume residue ({len(residue)} rows) exceeds "
                        f"this stream's ring_capacity {self.ring_capacity}"
                    )
                ctx.ring[:len(residue)] = residue
                injected = len(residue)
        else:
            tasks, succ, ring0, counts = builder.finalize(
                capacity=mk.capacity, succ_capacity=mk.succ_capacity)
            if ivalues is None:
                ivalues = np.zeros(mk.num_values, np.int32)
            else:
                counts = counts.copy()
                mk.widen_value_alloc(counts, ivalues)
            mk.check_row_values(int(counts[C_VALLOC]))
            data = dict(data or {})
            if set(data.keys()) != set(mk.data_specs.keys()):
                raise ValueError("data buffers != declared data_specs")
            ctx = _Ctx(self, {"tasks": tasks, "succ": succ, "ready": ring0,
                              "counts": counts, "ivalues": ivalues}, data)
        v = ctx.blocks.v
        ctl = v["ctl_in"]
        ring = ctx.ring
        entry_t0_ns = entry_t1_ns = time.monotonic_ns()
        while True:
            # Publish queued rows: rows first, then tail.
            with self._lock:
                rows, self._pending_rows = self._pending_rows, []
                closed = self._closed
                abort_reason = self._abort_reason
                quiesce_after = self._quiesce_after
            if abort_reason is not None:
                # Publish the abort word and run ONE final entry (the
                # kernel exits within a round; pending work abandoned,
                # queued rows dropped), then surface latency and raise.
                # Tenant lanes get a frozen all-paused tctl.
                e0 = int(v["counts"][C_EXECUTED])
                ctl[0] = injected
                ctl[1] = 1
                ctl[3] = 1
                if table is not None:
                    v["tctl"][:] = 0
                    v["tctl"][:, TC_PAUSE] = 1
                self._entry(ctx, quantum, max_rounds, mode)
                if egspec is not None:
                    # Results already in the mailbox or park ring resolve;
                    # every other outstanding future is poisoned.
                    sp = {} if self.telemetry else None
                    self._drain_egress(table, v["egr"], v["park"],
                                       v["ectl"], spans=sp)
                    if self.telemetry:
                        with self._lock:
                            self._spans.update(sp)
                    table.futures.poison_all(
                        f"stream aborted: {abort_reason}")
                with self._lock:
                    t0 = self._abort_t
                    self._stats.update({
                        "aborts": self._stats["aborts"] + 1,
                        "abort_reason": abort_reason,
                        "abort_observed_round": int(v["ctl_out"][4]),
                        "abort_latency_s": (
                            None if t0 is None
                            else round(time.monotonic() - t0, 6)
                        ),
                        "abort_drain_executed": (
                            int(v["counts"][C_EXECUTED]) - e0
                        ),
                    })
                self._fold_dispatch(ctx)
                raise CancelledError(f"stream aborted: {abort_reason}")
            if deadline is not None and time.monotonic() >= deadline:
                raise StallError(
                    f"run_stream deadline of {deadline_s}s exceeded "
                    f"(injected={injected}, closed={closed})",
                    stats=self.stats_dict(),
                )
            new_rows = []
            for row in rows:
                if injected >= self.ring_capacity:
                    raise RuntimeError(
                        f"injection ring exhausted ({self.ring_capacity} "
                        "rows per stream)"
                    )
                ring[injected] = row
                injected += 1
            if table is not None:
                if self.telemetry:
                    # Rows this pump publishes carry the round gauge the
                    # last entry echoed: ring wait is inside the span.
                    table.set_admit_round(int(v["tele"][0, TG_ROUNDS]))
                marks = self._marks(ctx) if ctx.cuda else None
                v["tctl"][:] = table.pump(ring)
                injected = table.total_published()
                ctl[0] = 0
                if ctx.cuda:
                    new_rows = self._changed_rows(ctx, marks)
            elif ctx.cuda:
                new_rows = [(ctx.uploaded[0], injected)]
                ctx.uploaded[0] = injected
            ctl[1] = 1 if closed else 0
            if quiesce_after is not None:
                ctl[5] = 1
                ctl[6] = quiesce_after
            if table is None:
                ctl[0] = injected
            if ctx.cuda:
                ctx.publish(new_rows)
            entry_t0_ns = time.monotonic_ns()
            self._entry(ctx, quantum, max_rounds, mode)
            entry_t1_ns = time.monotonic_ns()
            ctl_o = v["ctl_out"]
            if table is not None:
                table.absorb(v["tctl"].copy())
            if egspec is not None:
                sp = {} if self.telemetry else None
                self._drain_egress(table, v["egr"], v["park"], v["ectl"],
                                   spans=sp)
                if sp:
                    with self._lock:
                        self._spans.update(sp)
            if self.telemetry:
                tele = v["tele"]
                tele[0, TG_ENTRIES] += 1
                t1_ns = time.monotonic_ns()
                rounds = int(tele[0, TG_ROUNDS])
                bracket.accumulate(entry_t0_ns, t1_ns, rounds - prev_rounds)
                prev_rounds = rounds
                with self._lock:
                    self._tele_seq += 1
                    self._tele_snapshot = {
                        "seq": self._tele_seq,
                        "tele": tele.copy(),
                        "rounds": rounds,
                        "entries": int(tele[0, TG_ENTRIES]),
                        "ns_per_round": bracket.ns_per_round(),
                        "t0_ns": entry_t0_ns,
                        "t1_ns": t1_ns,
                    }
            counts_np = v["counts"]
            ctl[2] = ctl_o[2]  # the device-consumed cursor persists
            if bool(counts_np[C_OVERFLOW]):
                raise RuntimeError("streaming megakernel overflow")
            observed_round = (int(ctl_o[5]) if quiesce_after is not None
                              else -1)
            # A threshold the workload never reaches must not spin: once
            # drained, the entry boundary IS a round boundary.
            drained_cut = (
                quiesce_after is not None
                and int(counts_np[C_PENDING]) == 0
                and (table.drained() if table is not None
                     else int(ctl_o[2]) == injected)
            )
            if observed_round >= 0 or drained_cut:
                # The quiesce point: export the live state and stop (the
                # ring closes; rows producers queued ride as residue).
                consumed = int(ctl_o[2])
                with self._lock:
                    late, self._pending_rows = self._pending_rows, []
                    if not self._closed:
                        self._closed = True
                        self._closed_by_quiesce = True
                    t0 = self._quiesce_t
                    self._stats["quiesces"] += 1
                    self._stats["last_quiesce_latency_s"] = (
                        None if t0 is None
                        else round(time.monotonic() - t0, 6)
                    )
                ctx.get_tables()
                state = ctx.state_numpy(mk)
                info = {
                    "executed": int(counts_np[C_EXECUTED]),
                    "pending": int(counts_np[C_PENDING]),
                    "injected": injected,
                    "quiesced": True,
                    "quiesce_observed_round": observed_round,
                    "quiesce_latency_s": (
                        None if t0 is None
                        else round(time.monotonic() - t0, 6)
                    ),
                    "state": state,
                }
                if table is not None:
                    assert not late, "tenant stream held untagged rows"
                    if egspec is not None:
                        state["etok"] = ctx.etok.copy()
                    if self.telemetry:
                        state["tele"] = v["tele"].copy()
                        state["tlat"] = ctx.tlat.copy()
                    state.update(table.export_state(ring))
                else:
                    residue = list(ring[consumed:injected]) + list(late)
                    state["ring_rows"] = np.asarray(
                        residue, np.int32).reshape(-1, RING_ROW)
                self._trace_into(info, ctx, entry_t0_ns, entry_t1_ns)
                self._fold_dispatch(ctx)
                return state["ivalues"], info
            if (
                closed
                and int(counts_np[C_PENDING]) == 0
                and (table.close_if_drained() if table is not None
                     else int(ctl_o[2]) == injected)
                and not self._pending_rows
            ):
                info = {
                    "executed": int(counts_np[C_EXECUTED]),
                    "pending": int(counts_np[C_PENDING]),
                    "allocated": int(counts_np[C_ALLOC]),
                    "injected": (table.total_published()
                                 if table is not None else injected),
                }
                if table is not None:
                    info["tenants"] = table.stats()
                if self.telemetry:
                    info["telemetry"] = {
                        "tele": v["tele"].copy(),
                        "ns_per_round": bracket.ns_per_round(),
                        "rounds": int(v["tele"][0, TG_ROUNDS]),
                    }
                self._trace_into(info, ctx, entry_t0_ns, entry_t1_ns)
                self._fold_dispatch(ctx)
                if self.entry_log is not None:
                    ctx.get_tables()
                    self.final_state = dict(ctx.state_numpy(mk),
                                            etok=ctx.etok.copy(),
                                            tlat=ctx.tlat.copy())
                return numpy_of(ctx.st["ivalues"]), info

    # ---- driver helpers ----

    def _marks(self, ctx: _Ctx) -> List[np.ndarray]:
        """Per lane, the TEN_EXPIRED words of the rows the device holds
        but has not consumed (the pump may mark them)."""
        table = self.tenants
        R = table.region_rows
        tctl = ctx.blocks.v["tctl"]
        return [ctx.ring[i * R + int(tctl[i, TC_CONSUMED]):
                         i * R + ctx.uploaded[i], TEN_EXPIRED].copy()
                for i in range(len(table))]

    def _changed_rows(self, ctx: _Ctx, marks) -> List[Tuple[int, int]]:
        """The ring rows the pump published or marked expired since the
        last entry, as [lo, hi) ranges: a lane's new rows, and each held
        row whose TEN_EXPIRED word changed."""
        table = self.tenants
        R = table.region_rows
        tctl = ctx.blocks.v["tctl"]
        out = []
        for i in range(len(table)):
            lo = i * R + int(tctl[i, TC_CONSUMED])
            held = ctx.ring[lo:lo + len(marks[i]), TEN_EXPIRED]
            out += [(lo + j, lo + j + 1)
                    for j in np.flatnonzero(held != marks[i])]
            tail = int(tctl[i, TC_TAIL])
            out.append((i * R + ctx.uploaded[i], i * R + tail))
            ctx.uploaded[i] = max(ctx.uploaded[i], tail)
        return out

    def _trace_into(self, info, ctx: _Ctx, t0_ns: int, t1_ns: int) -> None:
        """The last entry's flight-recorder ring, bracketed by its own
        epoch (each entry resets the ring)."""
        row = ctx.trace_row()
        if row is not None:
            info["trace"] = trace_info([row], t0_ns, t1_ns,
                                       self.mk.trace.capacity)

    def _fold_dispatch(self, ctx: _Ctx) -> None:
        """Count the stream's dispatches of launch-counted bodies (the
        dynamic-graph and frontier bodies) in ``_build.LAUNCHES``."""
        if ctx.cuda:
            self.mk.fold_dispatches(ctx.dispatch)
            ctx.dispatch.zero_()
