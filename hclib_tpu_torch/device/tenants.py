"""Multi-tenant streaming front door: tenant lanes with quotas, deadline
admission and explicit backpressure. The port's own copy of
``hclib_tpu/device/tenants.py`` (numpy and threads only), names and
semantics unchanged:

- **Ring regions + WRR poll** (the stream kernel, device/inject.py and
  ``csrc/stream.cuh``; the resident kernel, device/resident.py and
  ``csrc/mesh.cuh``): the injection ring is partitioned into per-tenant
  regions of ``region_rows`` rows, each with its own tail and consumed
  cursor in an 8-word ``tctl`` row (``TC_*``). The in-kernel poll
  visits the lanes weighted-round-robin, at most ``weight`` rows a lane
  a poll, never more than the scheduler's live ``headroom()``, so a
  full task table is backpressure on the ring, not an overflow.
  ``wrr_poll_reference`` is its executable spec.
- **Admission** (host, ``TenantTable``): every submission gets a typed
  ``Admission`` verdict - ACCEPTED, QUEUED or REJECTED(reason) - from a
  per-tenant in-flight budget, a ``TokenBucket`` rate quota (injectable
  clock), deadlines (``CancelScope`` chains, expiry lazily dropped by
  the device poll and counted) and the poison ladder (throttle, then
  quarantine: the lane is paused on the device and swept).
- **Mesh-wide tenancy** (``MeshTenantTable``): one roster over every
  device of a resident mesh, a ``TenantTable`` replica a device;
  ``submit`` routes each admission to the least-backlogged replica (or
  ``device=``), the rate bucket is mesh-wide and the poison ladder and
  deadline budget act on aggregate counts. ``HCLIB_TPU_MESH_TENANTS``
  (``mesh_tenants_from_env``) is its wrapper-script spelling.
- **Survivability**: tenant identity rides the ring row (``TEN_ID``), so
  a quiesce exports per-tenant residue and the cumulative ``tctl`` /
  ``tstats`` counter blocks (``export_state``) and ``resume_from``
  re-publishes them per lane, deadlines re-armed from their remaining
  budget; ``MeshTenantTable.reshard`` re-deals a mesh's residue over
  another device count.

Not ported: ``TenantTable.protocol_model`` (the hclint explorer, ROADMAP
A13) raises ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, Union,
)

import numpy as np

from ..runtime.resilience import (
    CancelScope,
    CancelledError,
    RetryPolicy,
    StallError,
    TenantExpired,
)
from .descriptor import (
    F_A0,
    F_DEP,
    F_FN,
    F_HOME,
    F_OUT,
    F_SUCC0,
    F_SUCC1,
    NO_TASK,
    NUM_ARGS,
    RING_ROW,
    TEN_ADMIT_ROUND,
    TEN_DEADLINE_MS,
    TEN_EXPIRED,
    TEN_ID,
    TEN_TOKEN,
)
from .egress import FutureTable, normalize_egress

__all__ = [
    "ADMIT_ACCEPTED",
    "ADMIT_QUEUED",
    "ADMIT_REJECTED",
    "Admission",
    "TenantExpired",  # re-export: the deadline-drop control signal
    "TokenBucket",
    "TenantSpec",
    "TenantTable",
    "MeshTenantTable",
    "build_row",
    "normalize_tenants",
    "tenants_from_env",
    "normalize_mesh_tenants",
    "mesh_tenants_from_env",
    "per_tenant_ring_counts",
    "wrr_poll_reference",
    "TC_TAIL",
    "TC_CONSUMED",
    "TC_WEIGHT",
    "TC_PAUSE",
    "TC_EXPIRED",
    "TC_INSTALLED",
    "TC_DROPPED",
]

# ---- tctl ABI: one 8-word int32 control row per tenant lane, published
# by the host at every entry and echoed back (cumulative counters are
# host-seeded so they survive entries, resumes, and reshards).
TC_TAIL = 0       # rows published into this lane's ring region
TC_CONSUMED = 1   # device consume cursor (region-relative; echo)
TC_WEIGHT = 2     # WRR credit: rows this lane may install per poll
TC_PAUSE = 3      # nonzero = poll skips the lane (throttle/quarantine)
TC_EXPIRED = 4    # cumulative rows dropped expired at the poll (echo)
TC_INSTALLED = 5  # cumulative rows installed into the scheduler (echo)
TC_DROPPED = 6    # cumulative rows swept (consumed uninstalled) while the
                  # lane was paused - quarantine/cancel/abort drains (echo)

# ---- tstats: host-side cumulative counters serialized per tenant into
# checkpoint bundles (int32 words).
TS_ACCEPTED = 0
TS_REJECTED = 1
TS_EXPIRED_HOST = 2  # expired while queued on the host (pre-publish)
TS_POISONED = 3
TS_DROPPED = 4       # backlog dropped by quarantine / cancellation
TS_THROTTLED = 5
TS_QUARANTINED = 6

ADMIT_ACCEPTED = "ACCEPTED"
ADMIT_QUEUED = "QUEUED"
ADMIT_REJECTED = "REJECTED"


class Admission:
    """The typed verdict of one ``submit``: status, tenant, and - for
    rejections - a machine-readable reason (``rate`` | ``backlog`` |
    ``ring`` | ``expired`` | ``quarantined`` | ``cancelled`` |
    ``closed``). Truthy iff the row was admitted (accepted OR queued).
    Mesh-routed admissions (:class:`MeshTenantTable`) additionally carry
    ``device`` - the flat device id the row was routed to - and
    egress-enabled tables attach ``future`` (device/egress.py), the
    typed handle whose ``result(timeout=)`` rides the completion
    mailbox; rejections carry ``future=None``."""

    __slots__ = ("status", "tenant", "reason", "index", "device",
                 "future")

    def __init__(self, status: str, tenant: str,
                 reason: Optional[str] = None,
                 index: Optional[int] = None,
                 device: Optional[int] = None,
                 future=None) -> None:
        self.status = status
        self.tenant = tenant
        self.reason = reason
        self.index = index  # per-tenant admission sequence number
        self.device = device  # mesh routing target (MeshTenantTable)
        self.future = future  # egress-enabled tables only

    def __bool__(self) -> bool:
        return self.status != ADMIT_REJECTED

    @property
    def accepted(self) -> bool:
        return self.status == ADMIT_ACCEPTED

    @property
    def queued(self) -> bool:
        return self.status == ADMIT_QUEUED

    @property
    def rejected(self) -> bool:
        return self.status == ADMIT_REJECTED

    def __repr__(self) -> str:
        r = f", reason={self.reason!r}" if self.reason else ""
        return f"Admission({self.status}, tenant={self.tenant!r}{r})"


class TokenBucket:
    """Enqueue-rate quota: ``rate`` tokens/second up to ``burst``. The
    clock is injectable (``clock=`` any monotonic float callable), so a
    fake clock makes refill - and therefore every admission decision -
    a pure function of the submission sequence (asserted in
    tests/test_tenants.py). Not thread-safe by itself; the owning
    TenantTable serializes access under its lock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate < 0 or burst <= 0:
            raise ValueError(f"bad token bucket rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._t:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def wait_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 = now)."""
        self._refill()
        if self._tokens >= n:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self._tokens) / self.rate


class TenantSpec:
    """One tenant lane's contract.

    - ``weight``: WRR priority - rows the device poll may install per
      visit (relative throughput under contention is weight-proportional).
    - ``rate``/``burst``: host enqueue-rate token bucket (None = no rate
      quota; burst defaults to ``max(8, weight * 8)``).
    - ``max_in_flight``: cap on published-but-unconsumed rows (None = the
      lane's whole ring region).
    - ``queue_capacity``: host backlog bound - past it submissions are
      REJECTED("backlog"), the explicit form of backpressure.
    - ``deadline_s``: default admission deadline per submission (None =
      no deadline unless the submit or its CancelScope carries one).
    - ``deadline_budget``: total expirations (host + device) after which
      the lane's CancelScope cancels - the tenant is misconfigured or
      drowning, stop accepting instead of burning ring slots.
    - ``poison_throttle``/``poison_quarantine``: ladder thresholds on
      terminal task failures (validator exhaustion or
      ``report_failure``): throttled (weight -> 1), then quarantined.
    - ``retry``: RetryPolicy for validator attempts (attempts are
      immediate - the pump must not stall sibling lanes on backoff
      sleeps); None = one attempt.
    - ``validator``: optional host-side admission-time check run at
      publish (the hook chaos uses to model a poison tenant).
    """

    def __init__(
        self,
        id: str,
        weight: int = 1,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        max_in_flight: Optional[int] = None,
        queue_capacity: int = 1024,
        deadline_s: Optional[float] = None,
        deadline_budget: Optional[int] = None,
        poison_throttle: int = 2,
        poison_quarantine: int = 4,
        retry: Optional[RetryPolicy] = None,
        validator: Optional[Callable[[np.ndarray], None]] = None,
    ) -> None:
        self.id = str(id)
        self.weight = int(weight)
        if self.weight < 1:
            raise ValueError(f"tenant {id!r}: weight must be >= 1")
        self.rate = None if rate is None else float(rate)
        if burst is None:
            burst = max(8.0, self.weight * 8.0)
        self.burst = float(burst)
        self.max_in_flight = (
            None if max_in_flight is None else int(max_in_flight)
        )
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ValueError(f"tenant {id!r}: max_in_flight must be >= 1")
        self.queue_capacity = int(queue_capacity)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.deadline_budget = (
            None if deadline_budget is None else int(deadline_budget)
        )
        self.poison_throttle = int(poison_throttle)
        self.poison_quarantine = int(poison_quarantine)
        if not (1 <= self.poison_throttle <= self.poison_quarantine):
            raise ValueError(
                f"tenant {id!r}: need 1 <= poison_throttle <= "
                "poison_quarantine"
            )
        self.retry = retry
        self.validator = validator


def build_row(fn: int, args: Sequence[int] = (), out: int = 0,
              succ0: int = NO_TASK, succ1: int = NO_TASK) -> np.ndarray:
    """One injection-ring row (RING_ROW int32 words) in the descriptor
    ABI; tenant metadata words are stamped by the admitting lane.
    Injected rows are dependency-free by construction (the inject()
    contract: nothing could ever decrement a dependent ring row)."""
    if len(args) > NUM_ARGS:
        raise ValueError(f"at most {NUM_ARGS} args per descriptor")
    row = np.zeros(RING_ROW, np.int32)
    row[F_FN] = int(fn)
    row[F_DEP] = 0
    row[F_SUCC0] = int(succ0)
    row[F_SUCC1] = int(succ1)
    for i, a in enumerate(args):
        row[F_A0 + i] = int(a)
    row[F_OUT] = int(out)
    row[F_HOME] = NO_TASK
    return row


class _Pending:
    """One admitted row in flight on the host side."""

    __slots__ = ("row", "deadline_at", "t_submit", "index", "marked",
                 "token")

    def __init__(self, row: np.ndarray, deadline_at: Optional[float],
                 t_submit: float) -> None:
        self.row = row
        self.deadline_at = deadline_at
        self.t_submit = t_submit
        self.index = -1     # region-relative publish index (once published)
        self.marked = False  # host marked TEN_EXPIRED on the ring
        # Submit token of a tracked request (rides the row's TEN_TOKEN
        # word; 0 = untracked). Zeroed once its future reached a
        # terminal state host-side, so each token resolves exactly once.
        self.token = int(row[TEN_TOKEN])


def _remaining_ms(deadline_at: Optional[float], now: float) -> int:
    """A live deadline's remaining budget as a TEN_DEADLINE_MS word:
    whole milliseconds, floored at 1 (a nonzero deadline must never
    round down to "no deadline"), clamped to int32."""
    if deadline_at is None:
        return 0
    return max(1, min(2**31 - 1, int((deadline_at - now) * 1000.0)))


def _readmit_pending(row: np.ndarray, now: float) -> "_Pending":
    """Rebuild a residue row's host-side pending record at resume: the
    stamped TEN_DEADLINE_MS remaining budget re-arms against the
    resuming clock, and the transport word is cleared so the republished
    ring row is identical to a freshly admitted one."""
    r = np.array(row, np.int32)
    ms = int(r[TEN_DEADLINE_MS])
    r[TEN_DEADLINE_MS] = 0
    deadline_at = (now + ms / 1000.0) if ms > 0 else None
    return _Pending(r, deadline_at, now)


class _Lane:
    __slots__ = (
        "spec", "idx", "scope", "bucket", "queue", "pub_meta",
        "published", "consumed", "dev_expired", "dev_dropped", "installed",
        "accepted", "rejected", "expired_host", "poisoned", "dropped",
        "throttled", "quarantined", "latencies",
    )

    def __init__(self, spec: TenantSpec, idx: int, parent_scope,
                 clock) -> None:
        self.spec = spec
        self.idx = idx
        self.scope = CancelScope(parent=parent_scope)
        self.bucket = (
            None if spec.rate is None
            else TokenBucket(spec.rate, spec.burst, clock)
        )
        self.queue: deque = deque()
        self.pub_meta: deque = deque()
        self.published = 0
        self.consumed = 0
        self.dev_expired = 0
        self.dev_dropped = 0
        self.installed = 0
        self.accepted = 0
        self.rejected = 0
        self.expired_host = 0
        self.poisoned = 0
        self.dropped = 0
        self.throttled = False
        self.quarantined: Optional[str] = None
        self.latencies: deque = deque(maxlen=2048)

    @property
    def in_flight(self) -> int:
        return self.published - self.consumed

    @property
    def backlog(self) -> int:
        return len(self.queue) + self.in_flight

    @property
    def expired(self) -> int:
        return self.expired_host + self.dev_expired

    def paused(self) -> bool:
        return self.quarantined is not None or self.scope.cancelled()


class TenantTable:
    """The host half of the front door: N lanes over one injection ring
    partitioned into ``region_rows``-row regions (lane i owns ring rows
    ``[i * region_rows, (i + 1) * region_rows)``). Thread-safe: any
    thread admits while the stream driver pumps/absorbs."""

    def __init__(self, specs: Sequence[TenantSpec], region_rows: int,
                 clock: Callable[[], float] = time.monotonic,
                 egress=None,
                 futures: Optional[FutureTable] = None) -> None:
        specs = list(specs)
        if not specs:
            raise ValueError("at least one tenant lane")
        ids = [s.id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate tenant ids: {ids}")
        if region_rows < 8 or region_rows % 8:
            raise ValueError(
                f"region_rows must be a positive multiple of 8 (whole "
                f"8-row chunks, the ring layout both packages share), got "
                f"{region_rows}"
            )
        self.region_rows = int(region_rows)
        self.clock = clock
        self.scope = CancelScope()
        self._lock = threading.Lock()
        # Set under the lock by export_state (quiesce cut) and
        # close_if_drained (normal drain exit): a submit racing either
        # stream exit lands before it (its row rides along in the
        # residue / next pump) or sees this flag and gets a clean
        # "closed" verdict - never an ACCEPTED row that silently never
        # runs. resume_from reopens.
        self._closed = False
        # Telemetry admit-round stamp (device/telemetry.py):
        # the stream driver feeds back the last echoed cumulative round
        # gauge and the next pump stamps it onto newly published rows'
        # TEN_ADMIT_ROUND word. 0 = telemetry off / first entry.
        self._admit_round = 0
        self._lanes: List[_Lane] = [
            _Lane(s, i, self.scope, clock) for i, s in enumerate(specs)
        ]
        self._by_id: Dict[str, _Lane] = {
            lane.spec.id: lane for lane in self._lanes
        }
        # Completion-mailbox egress (device/egress.py): ``futures=``
        # shares an existing FutureTable (mesh replica tables all feed
        # the MeshTenantTable's one ledger); otherwise an egress spec -
        # explicit or HCLIB_TPU_EGRESS_DEPTH - makes this table OWN one.
        # ``self.futures is None`` on non-serving tables: admit then
        # stamps TEN_TOKEN = 0 and attaches no future, so every
        # pre-egress call site behaves bit-identically.
        self.egress = normalize_egress(egress)
        if futures is not None:
            self.futures: Optional[FutureTable] = futures
            self._owns_futures = False
        elif self.egress is not None:
            self.futures = FutureTable(
                backoff_s=self.egress.backoff_s, clock=clock
            )
            self._owns_futures = True
        else:
            self.futures = None
            self._owns_futures = False

    # ---- lookups ----

    def __len__(self) -> int:
        return len(self._lanes)

    @property
    def ids(self) -> List[str]:
        return [lane.spec.id for lane in self._lanes]

    @property
    def specs(self) -> List[TenantSpec]:
        return [lane.spec for lane in self._lanes]

    def protocol_model(self, rows_per_lane: int = 2,
                       capacity: int = 3, quiesce: bool = True):
        """This roster as a model for the bounded-interleaving explorer
        (hclint's ``InjectQuiesceModel``): not ported."""
        raise NotImplementedError(
            "TenantTable.protocol_model builds hclint's InjectQuiesceModel; "
            "the hclint explorer is ROADMAP A13")

    def _lane(self, tenant: Union[str, int]) -> _Lane:
        if isinstance(tenant, int):
            if not 0 <= tenant < len(self._lanes):
                # No negative wrap-around: an off-by-one producer must
                # not silently charge the LAST tenant's quota.
                raise KeyError(f"no tenant lane {tenant}")
            return self._lanes[tenant]
        lane = self._by_id.get(str(tenant))
        if lane is None:
            raise KeyError(
                f"unknown tenant {tenant!r} (have {self.ids})"
            )
        return lane

    # ---- admission (any thread) ----

    def resolve_deadline(self, tenant: Union[str, int],
                         deadline_s: Optional[float],
                         cancel_scope: Optional[CancelScope]) -> (
                             Optional[float]):
        """The absolute admission deadline for one submit: explicit
        ``deadline_s`` wins, else the nearest CancelScope deadline, else
        the tenant's default ``deadline_s``."""
        lane = self._lane(tenant)
        now = self.clock()
        if deadline_s is not None:
            return now + float(deadline_s)
        if cancel_scope is not None:
            t = cancel_scope.effective_deadline()
            if t is not None:
                # Scope deadlines are absolute instants in the TABLE'S
                # clock domain: with the default clock that is what
                # set_deadline(seconds=) produces; with an injected
                # clock, arm scopes via set_deadline(at=table.clock()+s)
                # (a raw monotonic instant would never compare sanely
                # against a fake clock - the deterministic tests use the
                # at= spelling for exactly this reason).
                return t
        if lane.spec.deadline_s is not None:
            return now + lane.spec.deadline_s
        return None

    def admit(self, tenant: Union[str, int], row: np.ndarray,
              deadline_at: Optional[float] = None,
              cancel_scope: Optional[CancelScope] = None,
              record_reject: bool = True) -> Admission:
        """Non-blocking admission of one prepared ring row. Checks run
        cheapest-first and quota checks only consume a rate token when
        every cheaper gate already passed."""
        lane = self._lane(tenant)
        tid = lane.spec.id
        now = self.clock()

        def reject(reason: str) -> Admission:
            if record_reject:
                with self._lock:
                    lane.rejected += 1
            return Admission(ADMIT_REJECTED, tid, reason)

        if lane.quarantined is not None:
            return reject("quarantined")
        if lane.scope.cancelled() or (
            cancel_scope is not None and cancel_scope.cancelled()
        ):
            return reject("cancelled")
        if deadline_at is not None and now >= deadline_at:
            return reject("expired")
        with self._lock:
            if self._closed:
                lane.rejected += record_reject
                return Admission(ADMIT_REJECTED, tid, "closed")
            # Ring lifetime budget: the region is a linear append log per
            # stream (device/inject.py), so published + queued rows may
            # never exceed it - rejecting here keeps QUEUED an eventual-
            # service promise instead of a silent wedge.
            if lane.published + len(lane.queue) >= self.region_rows:
                lane.rejected += record_reject
                return Admission(ADMIT_REJECTED, tid, "ring")
            if len(lane.queue) >= lane.spec.queue_capacity:
                lane.rejected += record_reject
                return Admission(ADMIT_REJECTED, tid, "backlog")
            if lane.bucket is not None and not lane.bucket.try_take(1):
                lane.rejected += record_reject
                return Admission(ADMIT_REJECTED, tid, "rate")
            over = (
                lane.spec.max_in_flight is not None
                and lane.backlog >= lane.spec.max_in_flight
            )
            r = np.array(row, np.int32).reshape(RING_ROW)
            r[TEN_ID] = lane.idx
            r[TEN_EXPIRED] = 0
            r[TEN_DEADLINE_MS] = 0  # stamped only at checkpoint export
            fut = None
            if self.futures is not None:
                # Token minted only after every admission gate passed:
                # a rejected submit never enters the conservation ledger.
                fut = self.futures.create(
                    tid, int(r[F_FN]), int(r[F_OUT])
                )
                r[TEN_TOKEN] = fut.token
            else:
                r[TEN_TOKEN] = 0
            lane.queue.append(_Pending(r, deadline_at, now))
            lane.accepted += 1
            return Admission(
                ADMIT_QUEUED if over else ADMIT_ACCEPTED, tid,
                index=lane.accepted - 1, future=fut,
            )

    def record_reject(self, tenant: Union[str, int], reason: str) -> (
            Admission):
        """Count a terminal rejection decided by an outer wait loop
        (submit(wait=True) probes with record_reject=False)."""
        lane = self._lane(tenant)
        with self._lock:
            lane.rejected += 1
        return Admission(ADMIT_REJECTED, lane.spec.id, reason)

    def submit(self, tenant: Union[str, int], fn: int,
               args: Sequence[int] = (), out: int = 0,
               succ0: int = NO_TASK, succ1: int = NO_TASK,
               deadline_s: Optional[float] = None,
               cancel_scope: Optional[CancelScope] = None) -> Admission:
        """Build, deadline-resolve, and admit one request in a single
        call - the serving-loop face (mirrors MeshTenantTable.submit).
        On an egress-enabled table the returned Admission carries
        ``.future``, whose ``result(timeout=)`` rides the completion
        mailbox to exactly one terminal rung of the degradation ladder:
        RESULT | EXPIRED | POISONED | PREEMPTED(resume_token)."""
        row = build_row(fn, args, out, succ0, succ1)
        deadline_at = self.resolve_deadline(tenant, deadline_s,
                                            cancel_scope)
        return self.admit(tenant, row, deadline_at, cancel_scope)

    def reattach(self, resume_token):
        """Re-attach a PREEMPTED future across a checkpoint cut: feed
        the ``resume_token`` a FuturePreempted carried to the successor
        table and get a fresh Future bound to the same in-flight
        request (its token rode the residue row / etok export)."""
        if self.futures is None:
            raise ValueError(
                "reattach needs an egress-enabled table (pass egress= "
                "or set HCLIB_TPU_EGRESS_DEPTH)"
            )
        return self.futures.reattach(resume_token)

    # ---- future-ledger plumbing (all called with the lock held) ----

    def _expire_token_locked(self, p: _Pending, reason: str) -> None:
        if self.futures is not None and p.token:
            self.futures.expire(p.token, reason)
        p.token = 0

    def _poison_queue_locked(self, lane: _Lane, reason: str) -> None:
        """Resolve the futures of every host-queued row the caller is
        about to drop (quarantine / cancel / deadline-budget drains):
        POISONED, never a hang - the ladder's no-wedge rung."""
        if self.futures is None:
            return
        for p in lane.queue:
            if p.token:
                self.futures.poison(p.token, reason)
                p.token = 0

    # ---- failure reporting / isolation ----

    def _note_poison_locked(self, lane: _Lane) -> None:
        lane.poisoned += 1
        if lane.poisoned >= lane.spec.poison_quarantine:
            self._quarantine_locked(
                lane,
                f"poison quarantine ({lane.poisoned} terminal failures)",
            )
        elif lane.poisoned >= lane.spec.poison_throttle:
            lane.throttled = True

    def _quarantine_locked(self, lane: _Lane, reason: str) -> None:
        if lane.quarantined is None:
            lane.quarantined = reason
        self._poison_queue_locked(lane, f"quarantined: {reason}")
        lane.dropped += len(lane.queue)
        lane.queue.clear()

    def report_failure(self, tenant: Union[str, int],
                       exc: Optional[BaseException] = None) -> None:
        """Tell the front door a task attributed to ``tenant`` failed
        TERMINALLY (its RetryPolicy exhausted attempts and quarantined
        the task). Climbs the poison ladder: throttle, then quarantine.
        Cancellation is a control signal, never poison."""
        if isinstance(exc, CancelledError):
            return
        lane = self._lane(tenant)
        with self._lock:
            self._note_poison_locked(lane)

    def quarantine(self, tenant: Union[str, int], reason: str) -> None:
        lane = self._lane(tenant)
        with self._lock:
            self._quarantine_locked(lane, reason)

    def throttle(self, tenant: Union[str, int]) -> None:
        """Clamp the lane's WRR weight to 1 at the next entry (the
        ladder's first rung, applied externally - the mesh front door's
        aggregate poison enforcement uses it on every replica)."""
        lane = self._lane(tenant)
        with self._lock:
            lane.throttled = True

    def cancel(self, tenant: Union[str, int],
               reason: str = "tenant cancelled") -> None:
        """Per-tenant cancellation: the lane's CancelScope cancels (its
        siblings' scopes are untouched), the host backlog drops, and the
        device poll pauses the lane at the next entry. Published rows
        already consumed stay consumed - cancellation is prospective."""
        lane = self._lane(tenant)
        lane.scope.cancel(reason)
        with self._lock:
            self._poison_queue_locked(lane, f"cancelled: {reason}")
            lane.dropped += len(lane.queue)
            lane.queue.clear()

    # ---- the stream driver's half (pump before entry, absorb after) ----

    def set_admit_round(self, r: int) -> None:
        """Telemetry: record the stream's last echoed
        cumulative round gauge; the next :meth:`pump` stamps it onto
        newly published rows' TEN_ADMIT_ROUND word (never overwriting a
        nonzero stamp - resumed residue keeps its original admission)."""
        with self._lock:
            self._admit_round = int(r)

    def pump(self, ring: np.ndarray) -> np.ndarray:
        """Expire, publish, and build the tctl block for one entry:
        drops expired host-queued rows, marks expired published rows for
        the device poll to drop, publishes backlog into each lane's ring
        region up to its in-flight budget, and returns the (T, 8) tctl
        array the entry uploads."""
        now = self.clock()
        T = len(self._lanes)
        tctl = np.zeros((T, 8), np.int32)
        with self._lock:
            for lane in self._lanes:
                base = lane.idx * self.region_rows
                spec = lane.spec
                if lane.paused() and lane.queue:
                    self._poison_queue_locked(
                        lane, lane.quarantined or "cancelled scope"
                    )
                    lane.dropped += len(lane.queue)
                    lane.queue.clear()
                # Deadline budget: too many expirations cancels the lane
                # (checked before publishing so a storm cuts off fast).
                if (
                    spec.deadline_budget is not None
                    and lane.expired >= spec.deadline_budget
                    and not lane.scope.cancelled()
                ):
                    lane.scope.cancel(
                        f"tenant {spec.id}: deadline budget exhausted "
                        f"({lane.expired} expired >= "
                        f"{spec.deadline_budget})"
                    )
                    self._poison_queue_locked(
                        lane, "deadline budget exhausted"
                    )
                    lane.dropped += len(lane.queue)
                    lane.queue.clear()
                # Expire published-but-unconsumed rows: mark the ring row
                # so the device poll drops it (lazily, counted).
                for p in lane.pub_meta:
                    if (
                        not p.marked
                        and p.deadline_at is not None
                        and now >= p.deadline_at
                    ):
                        ring[base + p.index, TEN_EXPIRED] = 1
                        p.marked = True
                        # The client learns EXPIRED the moment the host
                        # knows, not when the device sweeps the row.
                        self._expire_token_locked(p, "deadline (on ring)")
                # Publish backlog into the region, respecting the
                # in-flight budget (budget freed as the consume cursor
                # echoes forward).
                cap = (
                    self.region_rows if spec.max_in_flight is None
                    else spec.max_in_flight
                )
                while (
                    lane.queue
                    and lane.published < self.region_rows
                    and lane.in_flight < cap
                    and not lane.paused()
                ):
                    p = lane.queue.popleft()
                    if p.deadline_at is not None and now >= p.deadline_at:
                        lane.expired_host += 1
                        self._expire_token_locked(p, "deadline (queued)")
                        continue
                    if spec.validator is not None and not self._validate(
                        lane, p
                    ):
                        continue
                    ring[base + lane.published] = p.row
                    # Telemetry admit stamp - PRESERVE a nonzero word:
                    # residue re-published after a checkpoint cut keeps
                    # its ORIGINAL admission round (the round gauge is
                    # cumulative across the cut), so measured latency
                    # spans the preemption, not just the resumed tail.
                    if (
                        self._admit_round
                        and ring[base + lane.published,
                                 TEN_ADMIT_ROUND] == 0
                    ):
                        ring[base + lane.published, TEN_ADMIT_ROUND] = (
                            self._admit_round
                        )
                    p.index = lane.published
                    lane.pub_meta.append(p)
                    lane.published += 1
                tctl[lane.idx, TC_TAIL] = lane.published
                tctl[lane.idx, TC_CONSUMED] = lane.consumed
                tctl[lane.idx, TC_WEIGHT] = (
                    1 if lane.throttled else spec.weight
                )
                tctl[lane.idx, TC_PAUSE] = 1 if lane.paused() else 0
                tctl[lane.idx, TC_EXPIRED] = lane.dev_expired
                tctl[lane.idx, TC_INSTALLED] = lane.installed
        return tctl

    def _validate(self, lane: _Lane, p: _Pending) -> bool:
        """Run the lane's validator with IMMEDIATE retries per its
        RetryPolicy; a terminal failure poisons (ladder) and drops the
        row. Returns True when the row may publish. Lock is held - the
        validator must be fast and must not call back into the table."""
        spec = lane.spec
        attempts = spec.retry.max_attempts if spec.retry else 1
        for attempt in range(attempts):
            try:
                spec.validator(p.row)
                return True
            except BaseException as e:  # noqa: BLE001 - policy decides
                if spec.retry is not None and spec.retry.should_retry(
                    attempt, e
                ):
                    continue
                if isinstance(e, (CancelledError, StallError)):
                    # Control signals drop the row without poisoning
                    # the LANE; its future still resolves POISONED (the
                    # request will never run - a hang would be worse).
                    lane.dropped += 1
                    if self.futures is not None and p.token:
                        self.futures.poison(
                            p.token, "cancelled in validation"
                        )
                        p.token = 0
                    return False
                # The poisoned row IS a dropped row: counting it keeps
                # accepted == completed + expired + dropped reconciling
                # exactly for validator-poisoned lanes too (the storm
                # soak's per-cut identity).
                lane.dropped += 1
                if self.futures is not None and p.token:
                    self.futures.poison(p.token, f"validator: {e!r}")
                    p.token = 0
                self._note_poison_locked(lane)
                return False
        return False

    def absorb(self, tctl_out: np.ndarray) -> None:
        """Fold one entry's tctl echo back into the lanes: advance the
        consume cursors, record admission-to-install latencies, and
        refresh the cumulative device counters. A paused lane's consume
        advance is the device SWEEP (quarantine/cancel drain): those
        rows count as dropped, never as install latencies."""
        now = self.clock()
        tctl_out = np.asarray(tctl_out)
        with self._lock:
            for lane in self._lanes:
                swept = int(tctl_out[lane.idx, TC_PAUSE]) != 0
                new_consumed = int(tctl_out[lane.idx, TC_CONSUMED])
                while lane.pub_meta and lane.pub_meta[0].index < (
                    new_consumed
                ):
                    p = lane.pub_meta.popleft()
                    if not p.marked and not swept:
                        lane.latencies.append(now - p.t_submit)
                    elif swept and self.futures is not None and p.token:
                        # Device SWEEP of a paused lane: the row was
                        # consumed without installing - resolve its
                        # future POISONED so no client waits on it.
                        self.futures.poison(p.token, "swept (lane paused)")
                        p.token = 0
                lane.consumed = new_consumed
                lane.dev_expired = int(tctl_out[lane.idx, TC_EXPIRED])
                lane.installed = int(tctl_out[lane.idx, TC_INSTALLED])
                # TC_DROPPED is per-entry (pump seeds it 0): fold the
                # sweep count into the host's cumulative dropped so
                # accepted == completed + expired + dropped still holds
                # for quarantined/cancelled lanes.
                d = int(tctl_out[lane.idx, TC_DROPPED])
                lane.dev_dropped += d
                lane.dropped += d

    def total_published(self) -> int:
        with self._lock:
            return sum(lane.published for lane in self._lanes)

    def _drained_locked(self) -> bool:
        return all(
            not lane.queue and lane.consumed == lane.published
            for lane in self._lanes
        )

    def drained(self) -> bool:
        """Every lane's backlog is empty and its region fully consumed
        (paused lanes count as drained for their *unpublished* side -
        a quarantined tenant must not wedge the stream exit)."""
        with self._lock:
            return self._drained_locked()

    def close_if_drained(self) -> bool:
        """The stream driver's final-exit check: atomically verify every
        lane is drained AND close the front door. A submit racing the
        drain exit either lands first (the drained check fails and the
        driver pumps it next entry) or gets a "closed" verdict - it can
        never get an ACCEPTED for a row the returned stream will not
        run."""
        with self._lock:
            if self._drained_locked():
                self._closed = True
                return True
            return False

    # ---- checkpoint / resume ----

    def export_state(self, ring: np.ndarray) -> Dict[str, np.ndarray]:
        """The per-tenant half of a quiesce export: residue rows (host
        backlog + published-but-unconsumed, tenant-tagged; rows already
        expired - host-marked on the ring OR past their deadline at the
        cut - are folded into the expired count rather than carried),
        plus the cumulative tctl/tstats counter blocks. Deadlines
        SURVIVE the cut as remaining budget: each live residue row is
        stamped with ``TEN_DEADLINE_MS`` (milliseconds left at export;
        0 = no deadline) and ``resume_from`` re-arms it against the
        resuming clock."""
        T = len(self._lanes)
        now = self.clock()
        rows: List[np.ndarray] = []
        tctl = np.zeros((T, 8), np.int32)
        tstats = np.zeros((T, 8), np.int32)

        def carry(lane: _Lane, p: _Pending, row: np.ndarray) -> None:
            if p.marked or (
                p.deadline_at is not None and now >= p.deadline_at
            ):
                # Doomed either way; count it now so the conservation
                # identity holds across the cut.
                lane.expired_host += 1
                self._expire_token_locked(p, "deadline (at export)")
                return
            r = np.array(row, np.int32)
            r[TEN_DEADLINE_MS] = _remaining_ms(p.deadline_at, now)
            rows.append(r)

        with self._lock:
            self._closed = True
            for lane in self._lanes:
                base = lane.idx * self.region_rows
                for p in lane.pub_meta:
                    carry(lane, p, ring[base + p.index])
                lane.pub_meta.clear()
                for p in lane.queue:
                    carry(lane, p, p.row)
                lane.queue.clear()
                lane.published = 0
                lane.consumed = 0
                tctl[lane.idx, TC_WEIGHT] = lane.spec.weight
                tctl[lane.idx, TC_PAUSE] = 1 if lane.paused() else 0
                tctl[lane.idx, TC_EXPIRED] = lane.dev_expired
                tctl[lane.idx, TC_INSTALLED] = lane.installed
                tstats[lane.idx, TS_ACCEPTED] = lane.accepted
                tstats[lane.idx, TS_REJECTED] = lane.rejected
                tstats[lane.idx, TS_EXPIRED_HOST] = lane.expired_host
                tstats[lane.idx, TS_POISONED] = lane.poisoned
                tstats[lane.idx, TS_DROPPED] = lane.dropped
                tstats[lane.idx, TS_THROTTLED] = int(lane.throttled)
                tstats[lane.idx, TS_QUARANTINED] = int(
                    lane.quarantined is not None
                )
        ring_rows = (
            np.stack(rows).astype(np.int32)
            if rows else np.zeros((0, RING_ROW), np.int32)
        )
        # Everything still pending at the cut - carried residue AND
        # installed-but-unretired tasks - is preempted: each live future
        # resolves PREEMPTED carrying a resume token the client feeds to
        # the successor table's reattach(). Only the table that OWNS its
        # FutureTable preempts; mesh replicas share the mesh ledger and
        # the MeshTenantTable preempts once after every replica export.
        if self.futures is not None and self._owns_futures:
            self.futures.preempt_all()
        # tenant_ids rides the in-memory state dict so the direct
        # run_stream(resume_state=) path can validate the roster the
        # same way checkpoint.restore_stream's manifest guard does
        # (CheckpointBundle ignores keys outside its schema, so the
        # bundle path keeps using its manifest check).
        return {"ring_rows": ring_rows, "tctl": tctl, "tstats": tstats,
                "tenant_ids": np.array(self.ids)}

    def resume_from(self, state: Dict[str, Any]) -> None:
        """Seed the lanes from a checkpointed state: cumulative counters
        restore from tctl/tstats and residue rows re-enter their lanes'
        host backlogs (re-published by the next pump from region slot 0,
        so per-tenant accepted/completed/expired/backlog counts are
        conserved exactly across the cut). Rows carrying a stamped
        ``TEN_DEADLINE_MS`` remaining budget re-arm their deadlines
        against THIS table's clock."""
        if "tctl" not in state or "tstats" not in state:
            # A plain stream's quiesce state has ring_rows but no lane
            # blocks: adopting it would misfile every residue row (all
            # TEN_ID words are 0) into lane 0's budget and quotas.
            raise ValueError(
                "resume state carries no per-tenant counter blocks "
                "(tctl/tstats): it was exported from a stream without "
                "tenant lanes and cannot resume on a tenant-enabled one"
            )
        tctl = np.asarray(state["tctl"])
        tstats = np.asarray(state["tstats"])
        if tctl.shape[0] != len(self._lanes):
            raise ValueError(
                f"resume state carries {tctl.shape[0]} tenant lanes, this "
                f"stream has {len(self._lanes)}"
            )
        ids = state.get("tenant_ids")
        if ids is not None:
            want = [str(x) for x in np.asarray(ids).tolist()]
            if want != self.ids:
                # Residue rows and the tctl/tstats blocks are keyed by
                # lane index: a same-count reordered roster would
                # silently credit one tenant's work and quotas to
                # another.
                raise ValueError(
                    f"tenant roster mismatch: resume state carries "
                    f"{want!r}, this stream has {self.ids!r} (ids and "
                    f"order must match - lane state is keyed by index)"
                )
        now = self.clock()
        with self._lock:
            self._closed = False
            for lane in self._lanes:
                i = lane.idx
                lane.queue.clear()
                lane.pub_meta.clear()
                lane.published = 0
                lane.consumed = 0
                lane.dev_expired = int(tctl[i, TC_EXPIRED])
                lane.installed = int(tctl[i, TC_INSTALLED])
                lane.accepted = int(tstats[i, TS_ACCEPTED])
                lane.rejected = int(tstats[i, TS_REJECTED])
                lane.expired_host = int(tstats[i, TS_EXPIRED_HOST])
                lane.poisoned = int(tstats[i, TS_POISONED])
                lane.dropped = int(tstats[i, TS_DROPPED])
                lane.throttled = bool(tstats[i, TS_THROTTLED])
                if tstats[i, TS_QUARANTINED] and lane.quarantined is None:
                    lane.quarantined = "quarantined before checkpoint"
            rows = np.asarray(
                state.get("ring_rows", np.zeros((0, RING_ROW), np.int32)),
                np.int32,
            ).reshape(-1, RING_ROW)
            for r in rows:
                t = int(r[TEN_ID])
                if not (0 <= t < len(self._lanes)):
                    raise ValueError(
                        f"residue row tagged for tenant lane {t}; this "
                        f"stream has {len(self._lanes)} lanes"
                    )
                self._lanes[t].queue.append(_readmit_pending(r, now))
                self._adopt_row_locked(self._lanes[t], r)
            for lane in self._lanes:
                # The same residue-vs-capacity guard the plain stream
                # raises: a lane's re-published residue must fit its
                # ring region, or the pump could never drain the queue
                # and a closed stream would re-enter forever.
                if len(lane.queue) > self.region_rows:
                    raise ValueError(
                        f"tenant {lane.spec.id!r}: resume residue "
                        f"({len(lane.queue)} rows) exceeds this "
                        f"stream's ring region ({self.region_rows} "
                        f"rows); raise ring_capacity"
                    )

    def readmit(self, tenant: Union[str, int], row: np.ndarray) -> None:
        """Append one residue row to a lane's host backlog (the mesh
        resume re-deal path; the deadline re-arms from the row's stamped
        TEN_DEADLINE_MS remaining budget)."""
        lane = self._lane(tenant)
        now = self.clock()
        with self._lock:
            lane.queue.append(_readmit_pending(row, now))
            self._adopt_row_locked(lane, np.asarray(row))

    def _adopt_row_locked(self, lane: _Lane, r: np.ndarray) -> None:
        """A residue row stamped with a nonzero TEN_TOKEN re-enters the
        conservation ledger on the resuming side: the token becomes
        re-attachable (reattach binds a fresh Future to it)."""
        if self.futures is not None and int(r[TEN_TOKEN]):
            self.futures.adopt_row_token(
                int(r[TEN_TOKEN]), lane.spec.id,
                int(r[F_FN]), int(r[F_OUT]),
            )

    # ---- telemetry ----

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant counter snapshot keyed by tenant id (numbers plus
        the quarantine reason string; MetricsRegistry flattening drops
        strings by design). ``completed`` counts INSTALLS - rows the
        device poll handed to the scheduler, which a non-aborted stream
        runs to completion before returning (the megakernel executes
        every installed task or the run errors); the same install event
        stamps the admission-to-complete latency sample."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for lane in self._lanes:
                out[lane.spec.id] = {
                    "accepted": lane.accepted,
                    "rejected": lane.rejected,
                    "expired": lane.expired,
                    "completed": lane.installed,
                    "backlog": lane.backlog,
                    "queued": len(lane.queue),
                    "in_flight": lane.in_flight,
                    "published": lane.published,
                    "consumed": lane.consumed,
                    "poisoned": lane.poisoned,
                    "dropped": lane.dropped,
                    "throttled": int(lane.throttled),
                    "quarantined": int(lane.quarantined is not None),
                    "weight": lane.spec.weight,
                    "quarantine_reason": lane.quarantined,
                }
        return out

    def metrics(self) -> Dict[str, Dict[str, float]]:
        """The live-source shape for ``MetricsRegistry.register(
        "tenant", table.metrics)``: numeric-only per-tenant series, so
        snapshots carry ``tenant.<id>.accepted`` etc."""
        snap = self.stats()
        return {
            tid: {
                k: float(v) for k, v in s.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            for tid, s in snap.items()
        }

    def latency_stats(self, tenant: Union[str, int]) -> Dict[str, float]:
        """Admission-to-install latency percentiles for one lane (from
        the bounded reservoir; seconds)."""
        lane = self._lane(tenant)
        with self._lock:
            xs = sorted(lane.latencies)
        if not xs:
            return {"n": 0}
        def pct(p: float) -> float:
            return xs[min(len(xs) - 1, int(p * len(xs)))]
        return {
            "n": len(xs),
            "p50_s": pct(0.50),
            "p99_s": pct(0.99),
            "mean_s": sum(xs) / len(xs),
        }

class MeshTenantTable:
    """The mesh-wide admission front door: one tenant roster spanning
    every device of a resident mesh. Device ``d``'s injection ring is
    partitioned into the same per-tenant contiguous regions as the
    single-device front door - internally one :class:`TenantTable`
    replica per device, all sharing the roster - and the in-kernel WRR
    poll runs unchanged per device against that device's tctl block.

    **Routing** (``submit``): an admission lands on one device - an
    explicit ``device=``, else the least-backlogged replica of the
    tenant's lane among its ``placement`` candidates (ties to the
    lowest id). Devices whose region/backlog gates would reject are
    passed over before any quota is charged, so a full device spills to
    its siblings and the whole mesh must be saturated before a
    ``REJECTED("ring"/"backlog")`` verdict surfaces. The Admission
    ladder itself is the single-device ladder verbatim (the routed
    replica's ``admit`` decides).

    **Quota scope**: ``rate`` is MESH-WIDE (one aggregate token bucket
    per tenant, charged once before the routed admit; replicas are
    built rate-free so nothing double-charges); ``max_in_flight`` /
    ``queue_capacity`` / the ring budget are per device-lane region.
    The poison ladder and the ``deadline_budget`` are enforced on
    AGGREGATE counts at every pump - throttle clamps the lane's WRR
    weight on every device, quarantine pauses it everywhere - so a
    tenant cannot evade isolation by spreading failures across devices.

    **Survivability**: ``export_state`` packs per-device tenant-tagged
    residue (each live row stamped with its TEN_DEADLINE_MS remaining
    budget) plus aggregate tctl/tstats counter blocks in the resident
    bundle schema; ``resume_from`` accepts any exported mesh size and
    re-deals residue round-robin per tenant across THIS table's devices
    (per-tenant counts conserved by construction, deadlines re-armed),
    so a ``reshard(N -> M)`` cut is a fresh M-device table resuming the
    N-device state. ``pressure()`` is the autoscaler feed: per-tenant
    backlog / in-flight / ring-residue / deadline-budget drain.
    """

    def __init__(self, specs: Sequence[TenantSpec], ndev: int,
                 region_rows: int,
                 clock: Callable[[], float] = time.monotonic,
                 placement: Optional[Dict[str, Sequence[int]]] = None,
                 egress=None, futures: "Optional[FutureTable]" = None,
                 ) -> None:
        self.specs = list(specs)
        if not self.specs:
            raise ValueError("at least one tenant lane")
        self.ndev = int(ndev)
        if self.ndev < 1:
            raise ValueError(f"ndev must be >= 1, got {ndev}")
        self.region_rows = int(region_rows)
        self.clock = clock
        self._lock = threading.Lock()
        # Mesh-wide rate quota: one aggregate bucket per tenant; the
        # replicas are rate-free and their poison/budget thresholds are
        # disabled (enforced on aggregates here instead).
        self._buckets: Dict[str, Optional[TokenBucket]] = {
            s.id: (
                None if s.rate is None
                else TokenBucket(s.rate, s.burst, clock)
            )
            for s in self.specs
        }
        self._replicas = [
            TenantSpec(
                s.id, weight=s.weight, rate=None,
                max_in_flight=s.max_in_flight,
                queue_capacity=s.queue_capacity,
                deadline_s=s.deadline_s, deadline_budget=None,
                poison_throttle=2**30, poison_quarantine=2**30,
                retry=s.retry, validator=s.validator,
            )
            for s in self.specs
        ]
        # Completion-mailbox egress: ONE mesh-wide FutureTable shared by
        # every replica (a future routed to device d must resolve no
        # matter which successor device retires it after a reshard).
        # Replicas are built egress=False so an env knob can never make
        # one privately own a second ledger.
        self.egress = normalize_egress(egress)
        if futures is not None and self.egress is None:
            raise ValueError(
                "futures= (a shared ledger) needs egress= on too"
            )
        # ``futures=`` shares a predecessor mesh's ledger across a
        # reshard cut (resized() passes it), so PREEMPTED tokens
        # reattach against the SAME conservation identity.
        self.futures: Optional[FutureTable] = (
            futures if futures is not None
            else None if self.egress is None
            else FutureTable(backoff_s=self.egress.backoff_s, clock=clock)
        )
        self.tables: List[TenantTable] = [
            TenantTable(self._replicas, self.region_rows, clock,
                        egress=False, futures=self.futures)
            for _ in range(self.ndev)
        ]
        if placement is not None:
            for tid, devs in placement.items():
                if tid not in self.ids:
                    raise ValueError(
                        f"placement names unknown tenant {tid!r} "
                        f"(have {self.ids})"
                    )
                devs = [int(d) for d in devs]
                if not devs or any(
                    not 0 <= d < self.ndev for d in devs
                ):
                    raise ValueError(
                        f"placement for {tid!r} must be a non-empty "
                        f"subset of devices 0..{self.ndev - 1}, got "
                        f"{devs}"
                    )
        self.placement = (
            None if placement is None
            else {tid: [int(d) for d in devs]
                  for tid, devs in placement.items()}
        )
        T = len(self.specs)
        # Aggregate counter base from a resumed checkpoint (stats() adds
        # it on top of the live replica sums).
        self._base_tctl = np.zeros((T, 8), np.int64)
        self._base_tstats = np.zeros((T, 8), np.int64)
        self._rotor = [0] * T  # per-tenant resume re-deal cursor
        self._budget_cancelled: set = set()

    # ---- lookups ----

    def __len__(self) -> int:
        return len(self.specs)

    @property
    def ids(self) -> List[str]:
        return [s.id for s in self.specs]

    def _idx(self, tenant: Union[str, int]) -> int:
        return self.tables[0]._lane(tenant).idx

    def _candidates(self, tid: str) -> List[int]:
        if self.placement is not None and tid in self.placement:
            return self.placement[tid]
        return list(range(self.ndev))

    # ---- admission (any thread) ----

    def resolve_deadline(self, tenant, deadline_s, cancel_scope):
        return self.tables[0].resolve_deadline(
            tenant, deadline_s, cancel_scope
        )

    def submit(self, tenant: Union[str, int], fn: int,
               args: Sequence[int] = (), out: int = 0,
               succ0: int = NO_TASK, succ1: int = NO_TASK,
               deadline_s: Optional[float] = None,
               cancel_scope: Optional[CancelScope] = None,
               device: Optional[int] = None) -> Admission:
        """Admit one task into the mesh: build the row, resolve the
        deadline (explicit > scope chain > lane default), route, and
        return the typed verdict (``.device`` names the landing)."""
        row = build_row(fn, args, out, succ0, succ1)
        deadline_at = self.resolve_deadline(tenant, deadline_s,
                                            cancel_scope)
        return self.submit_row(tenant, row, deadline_at, cancel_scope,
                               device=device)

    def submit_row(self, tenant: Union[str, int], row: np.ndarray,
                   deadline_at: Optional[float] = None,
                   cancel_scope: Optional[CancelScope] = None,
                   device: Optional[int] = None) -> Admission:
        """Route one prepared row to a device and admit it there. The
        routed replica's ``admit`` is the single-device ladder verbatim;
        routing only picks WHICH replica decides."""
        i = self._idx(tenant)
        tid = self.specs[i].id
        # Terminal gates FIRST, mirroring the single-device ladder's
        # cheapest-first order (quarantine/cancel flags are mesh-uniform
        # by construction - every rung applies to every replica), so a
        # doomed submission never burns a mesh-wide rate token.
        lane0 = self.tables[0]._lanes[i]
        if lane0.quarantined is not None:
            adm = self.tables[0].record_reject(tid, "quarantined")
            adm.device = 0
            return adm
        if lane0.scope.cancelled() or (
            cancel_scope is not None and cancel_scope.cancelled()
        ):
            adm = self.tables[0].record_reject(tid, "cancelled")
            adm.device = 0
            return adm
        if deadline_at is not None and self.clock() >= deadline_at:
            adm = self.tables[0].record_reject(tid, "expired")
            adm.device = 0
            return adm
        if device is not None:
            if not 0 <= int(device) < self.ndev:
                raise KeyError(f"no device {device} in a {self.ndev}-"
                               "device mesh")
            order = [int(device)]
        else:
            # Least-backlogged lane replica first; ties to the lowest
            # device id (sorted() is stable over the id-ordered list).
            order = sorted(
                self._candidates(tid),
                key=lambda d: self.tables[d]._lanes[i].backlog,
            )
        last_reason = "ring"
        target: Optional[int] = None
        for d in order:
            lane = self.tables[d]._lanes[i]
            # The region/backlog gates, probed cheaply so routing can
            # pass over a full device before any quota is charged (the
            # probe is advisory - the routed admit re-checks under its
            # own lock).
            if lane.published + len(lane.queue) >= self.region_rows:
                last_reason = "ring"
                continue
            if len(lane.queue) >= lane.spec.queue_capacity:
                last_reason = "backlog"
                continue
            target = d
            break
        if target is None:
            adm = self.tables[order[0]].record_reject(tid, last_reason)
            adm.device = order[0]
            return adm
        bucket = self._buckets[tid]
        if bucket is not None:
            with self._lock:
                ok = bucket.try_take(1)
            if not ok:
                adm = self.tables[target].record_reject(tid, "rate")
                adm.device = target
                return adm
        adm = self.tables[target].admit(
            tenant, row, deadline_at, cancel_scope
        )
        adm.device = target
        return adm

    # ---- isolation (aggregate enforcement) ----

    def report_failure(self, tenant: Union[str, int],
                       exc: Optional[BaseException] = None) -> None:
        """Aggregate poison ladder: the failure lands on the replica the
        caller routed to conceptually, but the LADDER climbs on the
        mesh-wide count (``_enforce`` at the next pump applies the
        rung everywhere)."""
        if isinstance(exc, CancelledError):
            return
        i = self._idx(tenant)
        lane = self.tables[0]._lanes[i]
        with self.tables[0]._lock:
            lane.poisoned += 1  # thresholds are mesh-level (see _enforce)
        self._enforce()

    def quarantine(self, tenant: Union[str, int], reason: str) -> None:
        for t in self.tables:
            t.quarantine(tenant, reason)

    def cancel(self, tenant: Union[str, int],
               reason: str = "tenant cancelled") -> None:
        for t in self.tables:
            t.cancel(tenant, reason)

    def _agg(self, field: str, i: int) -> int:
        return sum(
            getattr(t._lanes[i], field) for t in self.tables
        )

    def _enforce(self) -> None:
        """Apply the aggregate isolation policies: a tenant's mesh-wide
        poison count climbs the ORIGINAL spec's ladder (replicas carry
        disabled thresholds), and a mesh-wide expiry count past the
        deadline budget cancels the lane everywhere - once."""
        for i, spec in enumerate(self.specs):
            tid = spec.id
            poisoned = self._agg("poisoned", i) + int(
                self._base_tstats[i, TS_POISONED]
            )
            if poisoned >= spec.poison_quarantine:
                self.quarantine(
                    tid,
                    f"poison quarantine ({poisoned} terminal failures "
                    f"mesh-wide)",
                )
            elif poisoned >= spec.poison_throttle:
                for t in self.tables:
                    t.throttle(tid)
            if spec.deadline_budget is not None and tid not in (
                self._budget_cancelled
            ):
                expired = (
                    self._agg("expired_host", i)
                    + self._agg("dev_expired", i)
                    + int(self._base_tstats[i, TS_EXPIRED_HOST])
                    + int(self._base_tctl[i, TC_EXPIRED])
                )
                if expired >= spec.deadline_budget:
                    self._budget_cancelled.add(tid)
                    self.cancel(
                        tid,
                        f"tenant {tid}: deadline budget exhausted "
                        f"({expired} expired mesh-wide >= "
                        f"{spec.deadline_budget})",
                    )

    # ---- the mesh runner's half ----

    def set_admit_round(self, r: int, device: Optional[int] = None) -> None:
        """Telemetry admit-round feedback, mesh face: one device's round
        gauge (``device=``) or all replicas at once (mesh runners with a
        single merged gauge)."""
        if device is not None:
            self.tables[int(device)].set_admit_round(r)
            return
        for t in self.tables:
            t.set_admit_round(r)

    def pump(self, rings: np.ndarray) -> np.ndarray:
        """Expire/publish every device's lanes and build the stacked
        ``(ndev, T, 8)`` tctl block one mesh entry uploads. ``rings``
        is the host image of the per-device injection rings,
        ``(ndev, T * region_rows, RING_ROW)``."""
        rings = np.asarray(rings)
        if rings.shape[0] != self.ndev:
            raise ValueError(
                f"rings cover {rings.shape[0]} devices, this table has "
                f"{self.ndev}"
            )
        self._enforce()
        return np.stack(
            [self.tables[d].pump(rings[d]) for d in range(self.ndev)]
        )

    def absorb(self, tctl_out: np.ndarray) -> None:
        """Fold one mesh entry's stacked tctl echo back per device."""
        tctl_out = np.asarray(tctl_out)
        for d in range(self.ndev):
            self.tables[d].absorb(tctl_out[d])

    def drained(self) -> bool:
        return all(t.drained() for t in self.tables)

    def close_if_drained(self) -> bool:
        return all(t.close_if_drained() for t in self.tables)

    def total_published(self) -> int:
        return sum(t.total_published() for t in self.tables)

    # ---- telemetry ----

    _BASE_FIELDS = {
        # aggregate stat key -> (block, word) base-offset sources
        "accepted": (("tstats", TS_ACCEPTED),),
        "rejected": (("tstats", TS_REJECTED),),
        "expired": (("tstats", TS_EXPIRED_HOST), ("tctl", TC_EXPIRED)),
        "completed": (("tctl", TC_INSTALLED),),
        "poisoned": (("tstats", TS_POISONED),),
        "dropped": (("tstats", TS_DROPPED),),
    }

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Mesh-aggregate per-tenant counters (the single-device stats
        shape; counts sum across replicas plus any resumed base, flags
        OR). ``per_device_stats()`` keeps the replica detail."""
        out: Dict[str, Dict[str, Any]] = {}
        per_dev = [t.stats() for t in self.tables]
        for i, spec in enumerate(self.specs):
            tid = spec.id
            agg: Dict[str, Any] = {}
            for d in range(self.ndev):
                for k, v in per_dev[d][tid].items():
                    if isinstance(v, bool) or not isinstance(
                        v, (int, float)
                    ):
                        continue
                    if k in ("weight",):
                        agg[k] = v
                    elif k in ("throttled", "quarantined"):
                        agg[k] = max(agg.get(k, 0), v)
                    else:
                        agg[k] = agg.get(k, 0) + v
            for k, srcs in self._BASE_FIELDS.items():
                for block, word in srcs:
                    base = (
                        self._base_tstats if block == "tstats"
                        else self._base_tctl
                    )
                    agg[k] = agg.get(k, 0) + int(base[i, word])
            agg["quarantine_reason"] = next(
                (per_dev[d][tid]["quarantine_reason"]
                 for d in range(self.ndev)
                 if per_dev[d][tid]["quarantine_reason"]),
                None,
            )
            out[tid] = agg
        return out

    def per_device_stats(self) -> List[Dict[str, Dict[str, Any]]]:
        return [t.stats() for t in self.tables]

    def metrics(self) -> Dict[str, Dict[str, float]]:
        """Numeric-only aggregate series (``MetricsRegistry.register(
        "tenant", mesh_table.metrics)``)."""
        return {
            tid: {
                k: float(v) for k, v in s.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            for tid, s in self.stats().items()
        }

    def latency_stats(self, tenant: Union[str, int]) -> Dict[str, float]:
        """Admission-to-install percentiles pooled across replicas."""
        i = self._idx(tenant)
        xs: List[float] = []
        for t in self.tables:
            with t._lock:
                xs.extend(t._lanes[i].latencies)
        xs.sort()
        if not xs:
            return {"n": 0}

        def pct(p: float) -> float:
            return xs[min(len(xs) - 1, int(p * len(xs)))]

        return {"n": len(xs), "p50_s": pct(0.50), "p99_s": pct(0.99),
                "mean_s": sum(xs) / len(xs)}

    def pressure(self) -> Dict[str, Dict[str, float]]:
        """The autoscaler feed: per-tenant mesh-aggregate backlog,
        in-flight/ring residue, and deadline-budget drain. ``expired``
        and ``budget`` let the policy compute per-slice drain deltas;
        ``pressure`` is the cumulative drained fraction (1.0 = the
        watchdog rung: the lane cancels)."""
        out: Dict[str, Dict[str, float]] = {}
        snap = self.stats()
        for i, spec in enumerate(self.specs):
            s = snap[spec.id]
            budget = float(spec.deadline_budget or 0)
            out[spec.id] = {
                "backlog": float(s["backlog"]),
                "queued": float(s["queued"]),
                "in_flight": float(s["in_flight"]),
                # Alias of in_flight: published-but-unconsumed rows ARE
                # the ring residue in this design; both spellings exist
                # so hand-built Observation feeds can use either.
                "ring_residue": float(s["in_flight"]),
                "expired": float(s["expired"]),
                "budget": budget,
                "pressure": (
                    min(1.0, s["expired"] / budget) if budget else 0.0
                ),
            }
        return out

    # ---- checkpoint / reshard ----

    def export_state(self, rings: np.ndarray) -> Dict[str, np.ndarray]:
        """The mesh quiesce export, in the resident bundle schema:
        per-device packed residue (``ring_rows`` ``(ndev, R, RING_ROW)``
        + ``ictl`` live counts, every live row deadline-stamped) and the
        AGGREGATE ``tctl``/``tstats`` counter blocks (device-count-free,
        so a reshard passes them through untouched)."""
        rings = np.asarray(rings)
        T = len(self.specs)
        R = rings.shape[1]
        rr = np.zeros((self.ndev, R, RING_ROW), np.int32)
        ictl = np.zeros((self.ndev, 8), np.int32)
        tctl = self._base_tctl.copy()
        tstats = self._base_tstats.copy()
        for d in range(self.ndev):
            st = self.tables[d].export_state(rings[d])
            n = st["ring_rows"].shape[0]
            rr[d, :n] = st["ring_rows"]
            ictl[d, 0] = n
            ictl[d, 1] = 1
            for i in range(T):
                for w in (TC_EXPIRED, TC_INSTALLED):
                    tctl[i, w] += int(st["tctl"][i, w])
                for w in (TS_ACCEPTED, TS_REJECTED, TS_EXPIRED_HOST,
                          TS_POISONED, TS_DROPPED):
                    tstats[i, w] += int(st["tstats"][i, w])
                for w in (TS_THROTTLED, TS_QUARANTINED):
                    tstats[i, w] = max(
                        int(tstats[i, w]), int(st["tstats"][i, w])
                    )
                tctl[i, TC_PAUSE] = max(
                    int(tctl[i, TC_PAUSE]), int(st["tctl"][i, TC_PAUSE])
                )
                tctl[i, TC_WEIGHT] = int(st["tctl"][i, TC_WEIGHT])
        if self.futures is not None:
            # One mesh-wide preempt AFTER every replica export: the
            # replicas share this ledger (and never preempt it
            # themselves), so each export above already expired its
            # doomed rows and everything still live preempts exactly
            # once, carrying a resume token for the successor table.
            self.futures.preempt_all()
        return {
            "ring_rows": rr, "ictl": ictl,
            "tctl": tctl.astype(np.int32),
            "tstats": tstats.astype(np.int32),
            "tenant_ids": np.array(self.ids),
        }

    def resume_from(self, state: Dict[str, Any]) -> None:
        """Seed THIS table (any device count) from an exported mesh
        state: aggregate counters become the stats base, lane flags
        (throttle / quarantine / cancel) re-apply everywhere, and
        tenant-tagged residue re-deals round-robin per tenant across
        this mesh's devices - per-tenant counts conserved by
        construction, deadlines re-armed from their stamped remaining
        budgets."""
        if "tctl" not in state or "tstats" not in state:
            raise ValueError(
                "resume state carries no per-tenant counter blocks "
                "(tctl/tstats): it was exported without tenant lanes "
                "and cannot resume on a tenant-enabled mesh"
            )
        T = len(self.specs)
        tctl = np.asarray(state["tctl"])
        tstats = np.asarray(state["tstats"])
        if tctl.shape[0] != T:
            raise ValueError(
                f"resume state carries {tctl.shape[0]} tenant lanes, "
                f"this mesh has {T}"
            )
        ids = state.get("tenant_ids")
        if ids is not None:
            want = [str(x) for x in np.asarray(ids).tolist()]
            if want != self.ids:
                raise ValueError(
                    f"tenant roster mismatch: resume state carries "
                    f"{want!r}, this mesh has {self.ids!r} (ids and "
                    f"order must match - lane state is keyed by index)"
                )
        self._base_tctl = tctl.astype(np.int64).copy()
        self._base_tstats = tstats.astype(np.int64).copy()
        # Fresh replicas: live lane counters fold into the base above at
        # export, so a table resumed IN PLACE (the autoscaler's hold
        # path re-feeds the same object every slice) must not count them
        # twice.
        self.tables = [
            TenantTable(self._replicas, self.region_rows, self.clock,
                        egress=False, futures=self.futures)
            for _ in range(self.ndev)
        ]
        self._rotor = [0] * T
        self._budget_cancelled = set()
        for i, spec in enumerate(self.specs):
            if tstats[i, TS_QUARANTINED]:
                self.quarantine(spec.id, "quarantined before checkpoint")
            elif tstats[i, TS_THROTTLED]:
                for t in self.tables:
                    t.throttle(spec.id)
            elif tctl[i, TC_PAUSE]:
                # Paused but not quarantined: the lane was cancelled.
                self.cancel(spec.id, "cancelled before checkpoint")
        rr = np.asarray(
            state.get("ring_rows", np.zeros((0, RING_ROW), np.int32)),
            np.int32,
        )
        if rr.ndim == 3:
            ic = state.get("ictl")
            if ic is None:
                raise ValueError(
                    "per-device ring_rows need ictl for live row counts"
                )
            ic = np.asarray(ic)
            rows = [
                rr[d, j]
                for d in range(rr.shape[0])
                for j in range(int(ic[d, 0]))
            ]
        else:
            rows = list(rr.reshape(-1, RING_ROW))
        for row in rows:
            i = int(row[TEN_ID])
            if not 0 <= i < T:
                raise ValueError(
                    f"residue row tagged for tenant lane {i}; this mesh "
                    f"has {T} lanes"
                )
            cand = self._candidates(self.specs[i].id)
            dev = cand[self._rotor[i] % len(cand)]
            self._rotor[i] += 1
            self.tables[dev].readmit(i, row)
        for d, t in enumerate(self.tables):
            for lane in t._lanes:
                if len(lane.queue) > self.region_rows:
                    raise ValueError(
                        f"tenant {lane.spec.id!r}: resume residue on "
                        f"device {d} ({len(lane.queue)} rows) exceeds "
                        f"the ring region ({self.region_rows} rows); "
                        "resume on more devices or raise ring_capacity"
                    )

    def resized(self, ndev_new: int) -> "MeshTenantTable":
        """A fresh table of the same roster on ``ndev_new`` devices
        (state rides the exported bundle, not the table - feed the
        resharded state to the new table's ``resume_from``)."""
        return MeshTenantTable(
            self.specs, ndev_new, self.region_rows, clock=self.clock,
            placement=None if self.placement is None else {
                tid: [d for d in devs if d < ndev_new] or [0]
                for tid, devs in self.placement.items()
            },
            egress=self.egress, futures=self.futures,
        )

    def reshard(self, rings: np.ndarray, ndev_new: int
                ) -> Tuple["MeshTenantTable", Dict[str, np.ndarray]]:
        """The live-cut convenience: export this table's state, build
        the ``ndev_new``-device successor, resume it. Returns
        ``(new_table, exported_state)`` - per-tenant counts conserved
        across the cut by construction."""
        st = self.export_state(rings)
        nxt = self.resized(ndev_new)
        nxt.resume_from(st)
        return nxt, st

    def reattach(self, resume_token):
        """Re-attach a PREEMPTED future on this (successor) mesh: the
        resume token a FuturePreempted carried binds a fresh Future to
        the same in-flight request, whose TEN_TOKEN rode the re-dealt
        residue row (or the etok export for installed tasks)."""
        if self.futures is None:
            raise ValueError(
                "reattach needs an egress-enabled mesh (pass egress= "
                "or set HCLIB_TPU_EGRESS_DEPTH)"
            )
        return self.futures.reattach(resume_token)


# ------------------------------------------------------------- plumbing

def _env_float(name: str) -> Optional[float]:
    from ..runtime.env import env_raw

    v = env_raw(name)
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        # Loud, not lenient: a typo'd quota must not silently become
        # "no quota" - that is the isolation failure this module exists
        # to prevent.
        raise ValueError(f"{name}={v!r} is not a number") from None


def tenants_from_env() -> Optional[List[TenantSpec]]:
    """The wrapper-script spelling: ``HCLIB_TPU_TENANTS=N`` enables N
    equal lanes ``t0..t{N-1}``; ``HCLIB_TPU_TENANT_WEIGHTS=4,2,1``
    overrides weights (when both are set their lane counts must agree);
    ``HCLIB_TPU_TENANT_RATE`` / ``_BURST`` / ``_INFLIGHT`` /
    ``_DEADLINE_S`` apply to every lane. Returns None when unset."""
    from ..runtime.env import env_raw

    n_env = env_raw("HCLIB_TPU_TENANTS", "")
    w_env = env_raw("HCLIB_TPU_TENANT_WEIGHTS", "")
    weights: Optional[List[int]] = None
    if w_env:
        try:
            weights = [int(w) for w in w_env.split(",")]
        except ValueError:
            raise ValueError(
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r} must be a "
                f"comma-separated list of ints (e.g. '4,2,1')"
            ) from None
        if any(w < 1 for w in weights):
            # No silent clamp: 4,0,1 quietly running as 4,1,1 is an
            # isolation-policy change with no signal.
            raise ValueError(
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r}: weights must "
                f"be >= 1 (WRR shares; a lane cannot be disabled by "
                f"weight - quarantine or cancel it instead)"
            )
    n = 0
    if n_env:
        try:
            n = int(n_env)
        except ValueError:
            # A malformed enable must not silently run the stream as a
            # single anonymous firehose.
            raise ValueError(
                f"HCLIB_TPU_TENANTS={n_env!r} must be an int"
            ) from None
    if weights:
        if n and n != len(weights):
            raise ValueError(
                f"HCLIB_TPU_TENANTS={n} disagrees with "
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r} "
                f"({len(weights)} lanes) - update both or unset one"
            )
        n = len(weights)
    if n < 1:
        return None
    rate = _env_float("HCLIB_TPU_TENANT_RATE")
    burst = _env_float("HCLIB_TPU_TENANT_BURST")
    if burst is not None and rate is None:
        # A burst cap without a rate builds no token bucket at all: the
        # operator asked for a quota and would silently get none.
        raise ValueError(
            "HCLIB_TPU_TENANT_BURST needs HCLIB_TPU_TENANT_RATE: burst "
            "is the token bucket's depth, rate its refill - without a "
            "rate no bucket is built and admission is unlimited"
        )
    inflight = _env_float("HCLIB_TPU_TENANT_INFLIGHT")
    if inflight is not None and inflight != int(inflight):
        # No silent truncation: 2.9 quietly becoming 2 is an admission-
        # policy change with no signal.
        raise ValueError(
            f"HCLIB_TPU_TENANT_INFLIGHT={inflight} must be a whole "
            f"number of in-flight tasks"
        )
    deadline = _env_float("HCLIB_TPU_TENANT_DEADLINE_S")
    return [
        TenantSpec(
            f"t{i}",
            weight=(weights[i] if weights else 1),
            rate=rate,
            burst=burst,
            max_in_flight=None if inflight is None else int(inflight),
            deadline_s=deadline,
        )
        for i in range(n)
    ]

def mesh_tenants_from_env() -> Optional[List[TenantSpec]]:
    """The mesh-tenancy wrapper-script spelling:
    ``HCLIB_TPU_MESH_TENANTS=N`` enables N equal lanes ``t0..t{N-1}``
    on resident inject meshes, sharing the per-lane
    ``HCLIB_TPU_TENANT_RATE`` / ``_BURST`` / ``_INFLIGHT`` /
    ``_DEADLINE_S`` knobs (and ``_WEIGHTS``, whose lane count must
    agree) with the streaming spelling. Malformed text raises - a
    typo'd enable must not silently run the mesh unshaped. Returns
    None when unset."""
    from ..runtime.env import env_int

    n = env_int("HCLIB_TPU_MESH_TENANTS", 0)
    if not n:
        return None
    if n < 1:
        raise ValueError(
            f"HCLIB_TPU_MESH_TENANTS={n} must be >= 1 (unset or 0 "
            "disables mesh tenancy)"
        )
    return _lane_specs_from_env(n)


def _lane_specs_from_env(n: int) -> List[TenantSpec]:
    """Build N lanes from the shared per-lane env knobs (the body both
    env spellings share; weight list length must agree with ``n``)."""
    from ..runtime.env import env_raw

    w_env = env_raw("HCLIB_TPU_TENANT_WEIGHTS", "")
    weights: Optional[List[int]] = None
    if w_env:
        try:
            weights = [int(w) for w in w_env.split(",")]
        except ValueError:
            raise ValueError(
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r} must be a "
                f"comma-separated list of ints (e.g. '4,2,1')"
            ) from None
        if any(w < 1 for w in weights):
            raise ValueError(
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r}: weights must "
                f"be >= 1"
            )
        if len(weights) != n:
            raise ValueError(
                f"HCLIB_TPU_TENANT_WEIGHTS={w_env!r} names "
                f"{len(weights)} lanes but {n} were requested - "
                "update both or unset one"
            )
    rate = _env_float("HCLIB_TPU_TENANT_RATE")
    burst = _env_float("HCLIB_TPU_TENANT_BURST")
    if burst is not None and rate is None:
        raise ValueError(
            "HCLIB_TPU_TENANT_BURST needs HCLIB_TPU_TENANT_RATE: burst "
            "is the token bucket's depth, rate its refill - without a "
            "rate no bucket is built and admission is unlimited"
        )
    inflight = _env_float("HCLIB_TPU_TENANT_INFLIGHT")
    if inflight is not None and inflight != int(inflight):
        raise ValueError(
            f"HCLIB_TPU_TENANT_INFLIGHT={inflight} must be a whole "
            f"number of in-flight tasks"
        )
    deadline = _env_float("HCLIB_TPU_TENANT_DEADLINE_S")
    return [
        TenantSpec(
            f"t{i}",
            weight=(weights[i] if weights else 1),
            rate=rate,
            burst=burst,
            max_in_flight=None if inflight is None else int(inflight),
            deadline_s=deadline,
        )
        for i in range(n)
    ]


def normalize_mesh_tenants(arg: Any) -> Optional[List[TenantSpec]]:
    """Normalize a resident mesh's ``tenants=`` argument: None -> the
    ``HCLIB_TPU_MESH_TENANTS`` env spelling (or disabled); everything
    else exactly as :func:`normalize_tenants` (int lane count, spec
    sequence, False to force off)."""
    if arg is None:
        return mesh_tenants_from_env()
    return normalize_tenants(arg)


def normalize_tenants(arg: Any) -> Optional[List[TenantSpec]]:
    """Normalize a ``tenants=`` argument: None -> the env spelling (or
    disabled); an int N -> N equal lanes; a sequence of TenantSpec /
    str ids / kwargs dicts -> specs."""
    if arg is None:
        return tenants_from_env()
    if arg is False:
        return None
    if arg is True:
        # bool is an int: True would silently become one anonymous,
        # quota-less lane (ignoring the HCLIB_TPU_TENANTS* env) - the
        # unshaped firehose the caller was trying to turn off.
        raise ValueError(
            "tenants=True is ambiguous: pass a lane count (int), a "
            "spec sequence, or leave tenants=None and set "
            "HCLIB_TPU_TENANTS"
        )
    if isinstance(arg, int):
        if arg < 1:
            raise ValueError(f"tenants must be >= 1, got {arg}")
        return [TenantSpec(f"t{i}") for i in range(arg)]
    specs: List[TenantSpec] = []
    for item in arg:
        if isinstance(item, TenantSpec):
            specs.append(item)
        elif isinstance(item, str):
            specs.append(TenantSpec(item))
        elif isinstance(item, dict):
            specs.append(TenantSpec(**item))
        else:
            raise TypeError(
                f"tenants entries must be TenantSpec/str/dict, got "
                f"{type(item).__name__}"
            )
    return specs


def wrr_poll_reference(ring: np.ndarray, tctl: np.ndarray,
                       region_rows: int, round_idx: int,
                       headroom: int) -> List[np.ndarray]:
    """Numpy reference model of ONE in-kernel WRR tenant poll - the
    executable spec of ``tpoll`` in device/inject.py, shared by the
    deterministic fairness tests and the chaos scenarios so they run
    (and mean the same thing) without Mosaic interpret. Semantics
    mirrored exactly: visit lane ``(round_idx + k) % T`` for k in
    [0, T), install at most ``min(weight, avail, headroom-left)`` rows
    from the lane's ring region, drop host-marked TEN_EXPIRED rows
    (counted, not installed), and sweep paused lanes - cursor jumps to
    tail, swept rows counted in TC_DROPPED, nothing installed. Mutates
    ``tctl`` in place exactly like the device echo (feed it back through
    ``TenantTable.absorb``); returns the installed rows in install
    order. One divergence, conservative by construction: the kernel
    re-reads live scheduler headroom per lane visit, the model debits a
    single ``headroom`` budget as it installs."""
    T = tctl.shape[0]
    remaining = int(headroom)
    installed: List[np.ndarray] = []
    for k in range(T):
        lane = (int(round_idx) + k) % T
        tail = int(tctl[lane, TC_TAIL])
        cons = int(tctl[lane, TC_CONSUMED])
        paused = int(tctl[lane, TC_PAUSE]) != 0
        avail = tail - cons
        weight = int(tctl[lane, TC_WEIGHT])
        take = 0 if paused else max(
            0, min(weight, avail, remaining)
        )
        inst = exp = 0
        for c in range(cons, cons + take):
            row = ring[lane * region_rows + c]
            if int(row[TEN_EXPIRED]) != 0:
                exp += 1
            else:
                installed.append(np.array(row, np.int32))
                inst += 1
        if paused:
            tctl[lane, TC_CONSUMED] = tail
            tctl[lane, TC_DROPPED] += avail
        else:
            tctl[lane, TC_CONSUMED] = cons + take
        tctl[lane, TC_INSTALLED] += inst
        tctl[lane, TC_EXPIRED] += exp
        remaining -= inst
    return installed


def per_tenant_ring_counts(ring_rows: Any,
                           ictl: Any = None) -> Dict[int, int]:
    """Count residue ring rows by tenant lane (the conservation probe
    checkpoint/reshard tests use). ``ring_rows`` is either a stream
    state's flat ``(n, RING_ROW)`` residue or a resident bundle's
    ``(ndev, R, RING_ROW)`` per-device rings - the latter needs ``ictl``
    to know each device's live row count."""
    counts: Dict[int, int] = {}
    rows = np.asarray(ring_rows)
    if rows.ndim == 3:
        if ictl is None:
            raise ValueError(
                "per-device ring_rows need ictl for live row counts"
            )
        ic = np.asarray(ictl)
        live = [
            rows[d, i]
            for d in range(rows.shape[0])
            for i in range(int(ic[d, 0]))
        ]
    else:
        live = list(rows.reshape(-1, rows.shape[-1]))
    for r in live:
        t = int(r[TEN_ID])
        counts[t] = counts.get(t, 0) + 1
    return counts
