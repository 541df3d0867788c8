"""Completion-mailbox egress: the device->host result path and the typed
``Future`` face on top of it. The port's own copy of
``hclib_tpu/device/egress.py`` (numpy and threads only), names and
semantics unchanged:

- the EGR row ABI (``EGR_*`` words, ``EGR_WORDS`` a row), the ``ectl``
  cursor block (``EC_*``) and ``TOKEN_LIMIT`` (``etok`` packs ``token +
  tenant * TOKEN_LIMIT`` in one int32 word);
- ``EgressSpec`` (mailbox depth, the result poll's backoff cap);
- ``Future`` (PENDING, then exactly one of RESULT, EXPIRED, POISONED or
  PREEMPTED with a resume token) and ``FutureTable``, the ledger whose
  ``conservation()`` closes ``submitted + adopted == resolved + expired +
  poisoned + preempted + pending``;
- ``egress_reference`` / ``flush_parked_reference`` / ``HostMailbox``,
  the executable spec of the publish the stream kernel runs at every
  tracked retirement (``device/inject.py``, ``csrc/stream.cuh``): a full
  mailbox parks the row (counted in ``EC_PARKED``, traced as
  ``TR_EGRESS``), never drops it, and the install-side credit gate
  keeps parked + in-flight rows within the park ring.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "EGR_STATUS",
    "EGR_TOKEN",
    "EGR_TEN",
    "EGR_FN",
    "EGR_SLOT",
    "EGR_VALUE",
    "EGR_T_ADMIT",
    "EGR_T_SPANS",
    "EGR_WORDS",
    "EGR_EMPTY",
    "EGR_OK",
    "EC_WRITE",
    "EC_CONSUMED",
    "EC_PARKED",
    "EC_PARK_COUNT",
    "EC_PARK_HEAD",
    "EC_INFLIGHT",
    "TOKEN_LIMIT",
    "EgressSpec",
    "egress_from_env",
    "normalize_egress",
    "Future",
    "FutureTable",
    "FutureTimeout",
    "FutureExpired",
    "FuturePoisoned",
    "FuturePreempted",
    "EgressProtocolError",
    "HostMailbox",
    "egress_reference",
    "flush_parked_reference",
]

# ---------------------------------------------------------------- EGR ABI
#
# One completion-mailbox row: EGR_WORDS int32 words (the mirror of the
# injection ring's RING_ROW rows, sized to the payload instead of a
# descriptor). Word order is pinned by hclib_tpu/analysis/layout.py with
# the same transport-word ordering invariant as TEN_ID..TEN_TOKEN.
EGR_STATUS = 0   # EGR_EMPTY | EGR_OK (a consumed slot is re-zeroed)
EGR_TOKEN = 1    # submit token (TEN_TOKEN word of the injected row);
                 # 0 = untracked task, never published
EGR_TEN = 2      # tenant lane index (TEN_ID of the injected row)
EGR_FN = 3       # kernel-table F_FN of the retired task
EGR_SLOT = 4     # result slot (descriptor F_OUT)
EGR_VALUE = 5    # ivalues[F_OUT] at retirement
EGR_T_ADMIT = 6  # telemetry builds only: the row's TEN_ADMIT_ROUND
                 # stamp (absolute cumulative scheduler round at host
                 # admission; 0 = unstamped / telemetry off)
EGR_T_SPANS = 7  # telemetry builds only: packed lifecycle deltas
                 # ((fire - install) << 16) | (install - admit), each
                 # half clamped to [0, 0xFFFF]. Retirement happens in
                 # the same inner round as fire in this core (dispatch
                 # and completion are atomic per round), so retire ==
                 # fire and two deltas reconstruct the whole span.
EGR_WORDS = 8    # row stride

EGR_EMPTY = 0
EGR_OK = 1

# ectl control words (8-word block, mirror of the inject ctl row): the
# device write cursor and park counters are echoes the host reads after
# every entry; EC_CONSUMED is host-seeded (the host is the only writer).
# Cursors are monotonic totals - slot = cursor % depth, occupancy =
# EC_WRITE - EC_CONSUMED (the tracebuf overflow-counted idiom).
EC_WRITE = 0       # rows ever published (device echo)
EC_CONSUMED = 1    # rows ever consumed (host-seeded)
EC_PARKED = 2      # cumulative park events (device echo; backpressure)
EC_PARK_COUNT = 3  # rows currently held in the park buffer (device echo)
EC_PARK_HEAD = 4   # park FIFO read cursor (the buffer is a ring: append
                   # slot is (head + count) % capacity - no compaction
                   # in-kernel)
EC_INFLIGHT = 5    # token-bearing rows installed but not yet retired
                   # (device echo; the install credit gate holds
                   # EC_PARK_COUNT + EC_INFLIGHT < park capacity, which
                   # bounds the park buffer BY CONSTRUCTION: retirement
                   # moves one in-flight token to either the mailbox or
                   # the park buffer, never both)

# Submit tokens are bounded below 2^24 so the per-task token table
# (``etok`` in device/inject.py) can pack ``token | tenant << 24`` into
# one int32 word; a serving session exhausting 16M tracked submits rolls
# over to a fresh table.
TOKEN_LIMIT = 1 << 24


class EgressSpec:
    """Host-side spec of a completion mailbox: ``depth`` rows of
    ``EGR_WORDS`` int32 words plus the bounded-backoff cap
    ``backoff_s`` that :meth:`Future.result` polls with."""

    def __init__(self, depth: int = 64, backoff_s: float = 0.05) -> None:
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"egress depth must be >= 1, got {depth}")
        backoff_s = float(backoff_s)
        if backoff_s <= 0:
            raise ValueError(
                f"egress backoff must be > 0 seconds, got {backoff_s}"
            )
        self.depth = depth
        self.backoff_s = backoff_s

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"EgressSpec(depth={self.depth}, backoff_s={self.backoff_s})"


def egress_from_env() -> Optional[EgressSpec]:
    """Build an EgressSpec from ``HCLIB_TPU_EGRESS_DEPTH`` /
    ``HCLIB_TPU_EGRESS_BACKOFF_S`` (runtime/env.py registry; malformed
    text raises naming the variable). Depth unset or 0 -> None (off)."""
    from ..runtime.env import env_float, env_int

    depth = env_int("HCLIB_TPU_EGRESS_DEPTH", 0)
    if not depth:
        return None
    backoff = env_float("HCLIB_TPU_EGRESS_BACKOFF_S", 0.05)
    return EgressSpec(depth=depth, backoff_s=backoff)


def normalize_egress(egress) -> Optional[EgressSpec]:
    """Normalize an ``egress=`` argument: None -> env (off unless
    HCLIB_TPU_EGRESS_DEPTH is set), False -> off, True -> env-or-default
    spec, int -> depth, EgressSpec -> itself."""
    if egress is None:
        return egress_from_env()
    if egress is False:
        return None
    if egress is True:
        return egress_from_env() or EgressSpec()
    if isinstance(egress, EgressSpec):
        return egress
    return EgressSpec(depth=int(egress))


# --------------------------------------------------------------- futures

PENDING = "PENDING"
RESULT = "RESULT"
EXPIRED = "EXPIRED"
POISONED = "POISONED"
PREEMPTED = "PREEMPTED"

_TERMINAL = (RESULT, EXPIRED, POISONED, PREEMPTED)


class FutureTimeout(TimeoutError):
    """``result(timeout=)`` lapsed with the future still PENDING. Carries
    the owning table's ``stats_dict()`` snapshot so the caller can see
    WHERE the request is stuck (mailbox backpressure vs ring backlog vs
    a stopped poller) without a second call."""

    def __init__(self, msg: str, stats: Dict[str, Any]) -> None:
        super().__init__(msg)
        self.stats = dict(stats)


class FutureExpired(RuntimeError):
    """Terminal EXPIRED: the deadline lapsed while the request was in
    flight (host-lapsed before publish, ring-marked and dropped by the
    device poll, or folded at a checkpoint export)."""


class FuturePoisoned(RuntimeError):
    """Terminal POISONED: the lane was quarantined or cancelled, or the
    row failed admission-time validation - the ladder rung below
    EXPIRED. Cancelled-scope futures land here; they never hang."""


class FuturePreempted(RuntimeError):
    """Terminal PREEMPTED: a checkpoint cut landed while the request was
    in flight. Carries ``resume_token``; ``reattach(resume_token)`` on
    the table resumed from that cut returns a fresh Future bound to the
    same submit token."""

    def __init__(self, msg: str, resume_token) -> None:
        super().__init__(msg)
        self.resume_token = resume_token


class EgressProtocolError(RuntimeError):
    """The exactly-once contract was violated: a token resolved twice,
    or a mailbox row carried a token this table never issued."""


class Future:
    """One submitted request's handle. States: PENDING then exactly one
    of RESULT | EXPIRED | POISONED | PREEMPTED(resume_token) - the
    degradation ladder. Thread-safe: the driving loop resolves, any
    thread may ``result()``/``wait()``."""

    __slots__ = (
        "token", "tenant", "fn", "slot", "state", "value", "reason",
        "resume_token", "t_submit", "t_done", "_event", "_table",
    )

    def __init__(self, table: "FutureTable", token: int, tenant: str,
                 fn: int, slot: int) -> None:
        self.token = int(token)
        self.tenant = tenant
        self.fn = int(fn)
        self.slot = int(slot)
        self.state = PENDING
        self.value: Optional[int] = None
        self.reason: Optional[str] = None
        self.resume_token = None
        self.t_submit = table._clock()
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._table = table

    # -- driver side (FutureTable only) --

    def _finish(self, state: str, value=None, reason=None,
                resume_token=None) -> None:
        self.state = state
        self.value = value
        self.reason = reason
        self.resume_token = resume_token
        self.t_done = self._table._clock()
        self._event.set()

    # -- client side --

    def done(self) -> bool:
        return self.state != PENDING

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block (bounded-backoff poll) until terminal; True if done."""
        if self.state != PENDING:
            return True
        backoff = self._table.backoff_s
        deadline = None if timeout is None else (
            time.monotonic() + float(timeout)
        )
        step = min(0.0005, backoff)
        while not self._event.is_set():
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return self._event.is_set()
                step = min(step, left)
            self._event.wait(step)
            step = min(step * 2, backoff)
        return True

    def result(self, timeout: Optional[float] = None) -> int:
        """The result value, or the ladder's typed raise: FutureTimeout
        (still PENDING - carries the table stats_dict), FutureExpired,
        FuturePoisoned, FuturePreempted (carries resume_token)."""
        if not self.wait(timeout):
            raise FutureTimeout(
                f"token {self.token} ({self.tenant}) still pending after "
                f"{timeout}s", self._table.stats_dict(),
            )
        if self.state == RESULT:
            return int(self.value)
        if self.state == EXPIRED:
            raise FutureExpired(
                f"token {self.token} ({self.tenant}) expired in flight"
                + (f": {self.reason}" if self.reason else "")
            )
        if self.state == POISONED:
            raise FuturePoisoned(
                f"token {self.token} ({self.tenant}) poisoned"
                + (f": {self.reason}" if self.reason else "")
            )
        raise FuturePreempted(
            f"token {self.token} ({self.tenant}) preempted by a "
            "checkpoint cut; reattach(resume_token) on the resumed table",
            self.resume_token,
        )

    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return float(self.t_done - self.t_submit)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Future(token={self.token}, tenant={self.tenant!r}, "
            f"state={self.state})"
        )


# resume_token shape: validated by reattach(), opaque to callers.
_RESUME_MAGIC = "hclib-egress-resume"


class FutureTable:
    """The submit-token ledger: allocates tokens (nonzero int32,
    monotonic), maps them to live Futures, applies the degradation
    ladder, and certifies conservation.

    Exactly-once is structural: a token is live exactly until its ONE
    terminal transition; a second ``resolve``/``expire``/``poison`` of
    the same token raises :class:`EgressProtocolError` (the mailbox
    cursor consumes each row once, so in correct operation this never
    fires - the tests force it to prove it would).

    Across a checkpoint cut the ledger hands over: ``preempt_all()``
    turns every live future PREEMPTED (terminal for ``result()``) and
    ``export_tokens()`` / ``adopt_tokens()`` move the still-pending
    token set to the successor table, where ``reattach(resume_token)``
    binds a fresh Future to the same token - the token itself rides the
    ring row's TEN_TOKEN word through export_state/reshard/resume_from,
    so a residue row retires on the resumed mesh into the SAME ledger
    entry the original submit opened."""

    def __init__(self, backoff_s: float = 0.05,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.backoff_s = float(backoff_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._next = 1
        self._live: Dict[int, Future] = {}
        # tokens adopted from a predecessor table, awaiting reattach():
        # token -> (tenant, fn, slot)
        self._unattached: Dict[int, Tuple[str, int, int]] = {}
        # adopted tokens that reached a terminal state BEFORE the client
        # re-attached (a residue row can retire immediately on resume):
        # token -> (state, value, reason)
        self._early: Dict[int, Tuple[str, Optional[int], Optional[str]]] = {}
        self._terminal: Dict[int, str] = {}
        self.submitted = 0
        self.adopted = 0
        self.resolved = 0
        self.expired = 0
        self.poisoned = 0
        self.preempted = 0
        self.reattached = 0

    # -- submit side --

    def create(self, tenant: str, fn: int, slot: int) -> Future:
        with self._lock:
            token = self._next
            if token >= TOKEN_LIMIT:
                raise EgressProtocolError(
                    f"submit-token space exhausted ({TOKEN_LIMIT} tracked "
                    "submits per serving session): roll over to a fresh "
                    "table"
                )
            self._next += 1
            fut = Future(self, token, tenant, fn, slot)
            self._live[token] = fut
            self.submitted += 1
            return fut

    # -- terminal transitions (driver side) --

    def _take(self, token: int, what: str):
        """Pop a pending token (live future OR unattached adoption); a
        token already terminal or never issued is a protocol violation."""
        token = int(token)
        fut = self._live.pop(token, None)
        if fut is not None:
            return fut, None
        meta = self._unattached.pop(token, None)
        if meta is not None:
            return None, meta
        if token in self._terminal:
            raise EgressProtocolError(
                f"double resolution: token {token} already "
                f"{self._terminal[token]} (mailbox rows are consumed "
                f"exactly once; second {what} refused)"
            )
        raise EgressProtocolError(
            f"{what} of unknown token {token}: this table never issued "
            "or adopted it"
        )

    def _terminate(self, token: int, what: str, state: str, value=None,
                   reason=None, resume_token=None) -> None:
        with self._lock:
            fut, meta = self._take(token, what)
            self._terminal[int(token)] = state
            if fut is not None:
                fut._finish(state, value=value, reason=reason,
                            resume_token=resume_token)
            else:
                self._early[int(token)] = (state, value, reason)
            if state == RESULT:
                self.resolved += 1
            elif state == EXPIRED:
                self.expired += 1
            elif state == POISONED:
                self.poisoned += 1

    def resolve(self, token: int, value: int) -> None:
        """A mailbox row for ``token`` was consumed: terminal RESULT."""
        self._terminate(token, "resolve", RESULT, value=int(value))

    def expire(self, token: int, reason: str = "deadline") -> None:
        self._terminate(token, "expire", EXPIRED, reason=reason)

    def poison(self, token: int, reason: str = "quarantined") -> None:
        self._terminate(token, "poison", POISONED, reason=reason)

    def poison_all(self, reason: str = "stream aborted") -> int:
        """The abort rung: every pending token - live futures AND
        unattached adoptions - resolves POISONED, so an aborted stream
        never leaves a single client hanging. Returns tokens poisoned."""
        with self._lock:
            tokens = (
                list(self._live.keys()) + list(self._unattached.keys())
            )
        for t in tokens:
            self.poison(t, reason)
        return len(tokens)

    # -- checkpoint-cut handover --

    def preempt_all(self) -> List[Tuple[str, str, int, int, int]]:
        """A checkpoint cut landed: every live future turns PREEMPTED
        (terminal, with a resume token) and its still-pending token
        moves to the export set. Returns the resume tokens issued."""
        out = []
        with self._lock:
            for token, fut in list(self._live.items()):
                rt = (_RESUME_MAGIC, fut.tenant, token, fut.fn, fut.slot)
                del self._live[token]
                self._unattached[token] = (fut.tenant, fut.fn, fut.slot)
                fut._finish(PREEMPTED, resume_token=rt)
                self.preempted += 1
                out.append(rt)
        return out

    def export_tokens(self) -> Dict[int, Tuple[str, int, int]]:
        """The still-pending token set (after preempt_all): what a
        successor table adopts. Early-terminal adoptions ride too so a
        twice-cut pipeline keeps its ledger."""
        with self._lock:
            return dict(self._unattached)

    def adopt_tokens(self, tokens: Dict[int, Tuple[str, int, int]]) -> None:
        """Adopt a predecessor's pending tokens (resume_from/reshard):
        they become resolvable here and reattach()-able by clients."""
        with self._lock:
            for token, meta in tokens.items():
                token = int(token)
                if token in self._live or token in self._unattached:
                    raise EgressProtocolError(
                        f"adopt of token {token} collides with a live "
                        "entry"
                    )
                self._unattached[token] = (
                    str(meta[0]), int(meta[1]), int(meta[2])
                )
                self.adopted += 1
                self._next = max(self._next, token + 1)

    def adopt_row_token(self, token: int, tenant: str, fn: int,
                        slot: int) -> None:
        """Adopt ONE token read back off a residue ring row's TEN_TOKEN
        word (resume_from's readmit loop). Idempotent against an
        adopt_tokens() that already carried it."""
        with self._lock:
            token = int(token)
            if (token in self._live or token in self._unattached
                    or token in self._terminal):
                return
            self._unattached[token] = (str(tenant), int(fn), int(slot))
            self.adopted += 1
            self._next = max(self._next, token + 1)

    def reattach(self, resume_token) -> Future:
        """Bind a fresh Future to a preempted submit token on THIS
        (resumed) table. The token must be one this table adopted - a
        foreign or stale resume token raises EgressProtocolError."""
        if (not isinstance(resume_token, tuple)
                or len(resume_token) != 5
                or resume_token[0] != _RESUME_MAGIC):
            raise EgressProtocolError(
                f"not a resume token: {resume_token!r}"
            )
        _, tenant, token, fn, slot = resume_token
        with self._lock:
            token = int(token)
            meta = self._unattached.pop(token, None)
            if meta is not None:
                fut = Future(self, token, meta[0], meta[1], meta[2])
                self._live[token] = fut
                self.reattached += 1
                return fut
            early = self._early.pop(token, None)
            if early is not None:
                # The residue row retired before the client re-attached:
                # hand back an already-terminal future.
                fut = Future(self, token, str(tenant), int(fn), int(slot))
                fut._finish(early[0], value=early[1], reason=early[2])
                self.reattached += 1
                return fut
        raise EgressProtocolError(
            f"reattach of token {token}: not pending on this table "
            "(wrong resume generation, or never exported)"
        )

    # -- ledger --

    def pending(self) -> int:
        with self._lock:
            return len(self._live) + len(self._unattached)

    def conservation(self) -> Dict[str, Any]:
        """The ledger identity, checked exactly: every token this table
        ever held (submitted + adopted) is accounted by exactly one of
        resolved / expired / poisoned / preempted-exported / pending."""
        with self._lock:
            pending = len(self._live) + len(self._unattached)
            held = self.submitted + self.adopted
            # preempt moves live -> unattached (still held here) until
            # export; `preempted` counts futures, not token departures,
            # so the identity closes over the pending set directly.
            accounted = (
                self.resolved + self.expired + self.poisoned + pending
            )
            return {
                "submitted": self.submitted,
                "adopted": self.adopted,
                "resolved": self.resolved,
                "expired": self.expired,
                "poisoned": self.poisoned,
                "preempted": self.preempted,
                "reattached": self.reattached,
                "pending": pending,
                "ok": held == accounted,
            }

    def stats_dict(self) -> Dict[str, Any]:
        d = self.conservation()
        d["backoff_s"] = self.backoff_s
        return d


# ------------------------------------------------- executable spec (host)

def egress_reference(rows, egr, park, ectl, depth: int) -> int:
    """The executable spec of the device publish path (the role
    ``tenants.wrr_poll_reference`` plays for the WRR poll): append each
    retired ``(token, ten, fn, slot, value)`` tuple to the mailbox
    ``egr`` (shape ``(depth, EGR_WORDS)``), or PARK it in ``park`` when
    the mailbox is full - counted in ``ectl[EC_PARKED]``, never dropped.
    Token-0 rows are untracked and skipped. Mutates egr/park/ectl in
    place; returns rows published. The in-kernel path in device/inject.py
    matches this word for word (asserted by tests/test_serving.py)."""
    egr = np.asarray(egr)
    park = np.asarray(park)
    published = 0
    for token, ten, fn, slot, value in rows:
        if int(token) == 0:
            continue
        write = int(ectl[EC_WRITE])
        room = int(depth) - (write - int(ectl[EC_CONSUMED]))
        if room > 0:
            r = egr[write % int(depth)]
            r[EGR_STATUS] = EGR_OK
            r[EGR_TOKEN] = int(token)
            r[EGR_TEN] = int(ten)
            r[EGR_FN] = int(fn)
            r[EGR_SLOT] = int(slot)
            r[EGR_VALUE] = int(value)
            ectl[EC_WRITE] = write + 1
            published += 1
        else:
            n = int(ectl[EC_PARK_COUNT])
            if n >= park.shape[0]:
                raise EgressProtocolError(
                    f"park buffer overflow ({n} rows): the install-side "
                    "credit gate is broken"
                )
            p = park[(int(ectl[EC_PARK_HEAD]) + n) % park.shape[0]]
            p[EGR_STATUS] = EGR_OK
            p[EGR_TOKEN] = int(token)
            p[EGR_TEN] = int(ten)
            p[EGR_FN] = int(fn)
            p[EGR_SLOT] = int(slot)
            p[EGR_VALUE] = int(value)
            ectl[EC_PARK_COUNT] = n + 1
            ectl[EC_PARKED] = int(ectl[EC_PARKED]) + 1
    return published


def flush_parked_reference(egr, park, ectl, depth: int) -> int:
    """The entry-start parked retry, as the kernel performs it: move
    parked rows (FIFO off the EC_PARK_HEAD ring cursor) into the mailbox
    while there is room. Mutates in place; returns rows flushed."""
    egr = np.asarray(egr)
    park = np.asarray(park)
    cap = park.shape[0]
    flushed = 0
    while int(ectl[EC_PARK_COUNT]) > 0:
        write = int(ectl[EC_WRITE])
        if int(depth) - (write - int(ectl[EC_CONSUMED])) <= 0:
            break
        h = int(ectl[EC_PARK_HEAD])
        egr[write % int(depth)] = park[h]
        park[h] = 0
        ectl[EC_PARK_HEAD] = (h + 1) % cap
        ectl[EC_PARK_COUNT] = int(ectl[EC_PARK_COUNT]) - 1
        ectl[EC_WRITE] = write + 1
        flushed += 1
    return flushed


class HostMailbox:
    """One device's completion mailbox, host-model form: the numpy
    arrays (``egr``/``park``/``ectl``) plus the consume side. Chaos
    serve scenarios, the tutorial, and bench drive this directly; the
    streaming driver holds one per run and drains it after every kernel
    entry. ``park_cap`` defaults to the mailbox depth - host-model
    drives publish at retirement inside the same step that installed,
    so in-flight tokens never exceed the install credit."""

    def __init__(self, spec: EgressSpec, park_cap: Optional[int] = None
                 ) -> None:
        self.spec = spec
        self.depth = int(spec.depth)
        cap = self.depth if park_cap is None else int(park_cap)
        self.egr = np.zeros((self.depth, EGR_WORDS), np.int32)
        self.park = np.zeros((max(1, cap), EGR_WORDS), np.int32)
        self.ectl = np.zeros(8, np.int32)

    def publish(self, rows) -> int:
        """Retire rows into the mailbox (park on full; see
        egress_reference)."""
        return egress_reference(rows, self.egr, self.park, self.ectl,
                                self.depth)

    def flush(self) -> int:
        return flush_parked_reference(self.egr, self.park, self.ectl,
                                      self.depth)

    def occupancy(self) -> int:
        return int(self.ectl[EC_WRITE]) - int(self.ectl[EC_CONSUMED])

    def parked(self) -> int:
        return int(self.ectl[EC_PARK_COUNT])

    def park_events(self) -> int:
        return int(self.ectl[EC_PARKED])

    def drain(self, futures: Optional[FutureTable] = None,
              limit: Optional[int] = None,
              include_parked: bool = True) -> List[Tuple[int, int]]:
        """Consume published rows (advance EC_CONSUMED), flushing parked
        rows through the mailbox as space frees so a backlogged device
        empties in one call when ``include_parked``. Each consumed row
        resolves its token on ``futures`` - exactly once: the slot is
        re-zeroed behind the cursor. Returns the (token, value) pairs
        consumed. A ``limit`` models a slow poller (consume at most N
        rows, leave the rest parked/published)."""
        out: List[Tuple[int, int]] = []
        while limit is None or len(out) < limit:
            consumed = int(self.ectl[EC_CONSUMED])
            if consumed >= int(self.ectl[EC_WRITE]):
                if include_parked and self.flush() > 0:
                    continue
                break
            slot = consumed % self.depth
            row = self.egr[slot]
            if int(row[EGR_STATUS]) != EGR_OK:
                raise EgressProtocolError(
                    f"mailbox slot {slot} consumed twice or never "
                    f"published (status {int(row[EGR_STATUS])})"
                )
            token, value = int(row[EGR_TOKEN]), int(row[EGR_VALUE])
            row[:] = 0
            self.ectl[EC_CONSUMED] = consumed + 1
            if futures is not None:
                futures.resolve(token, value)
            out.append((token, value))
        return out
