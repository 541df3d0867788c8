"""Structured failures and host cancellation of the port: the subset of
``hclib_tpu/runtime/resilience.py`` that the scheduler megakernel and
the streaming front door use, with its semantics and names.

- ``StallError`` (a bounded-latency failure), ``CancelledError`` and
  ``TenantExpired`` (control signals, never faults).
- ``CancelScope``: a cancellation flag chained along a parent chain,
  with advisory deadlines (the tenant lanes' deadline admission).
- The abort-hook registry and ``bind_abort_to_scope``: a scope's cancel
  fires a device kill switch (``StreamingMegakernel.abort``).
- The preempt hooks (``register_preempt_hook``, ``fire_preempt``,
  ``install_preempt_handler``): a preemption notice quiesces a stream
  instead of aborting it (``runtime/checkpoint.py``
  ``checkpoint_on_preempt``).
- ``RetryPolicy``: deterministic retry with backoff (a tenant lane's
  validator retries).
- ``DeviceFaultPlan`` (:497): the seeded fault plan the resident
  kernel compiles into its steal exchange (device/resident.py).

The host runtime's fault injection (``FaultPlan``) is not part of the
port.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

__all__ = [
    "CancelScope",
    "CancelledError",
    "TenantExpired",
    "StallError",
    "RetryPolicy",
    "DeviceFaultPlan",
    "register_abort_hook",
    "unregister_abort_hook",
    "bind_abort_to_scope",
    "register_preempt_hook",
    "unregister_preempt_hook",
    "fire_preempt",
    "reset_preempt",
    "preempt_requested",
    "install_preempt_handler",
]

LOG = logging.getLogger("hclib_tpu_torch.resilience")

class CancelledError(RuntimeError):
    """The enclosing scope was cancelled; a control signal, not a fault
    (the runtime does not record it as the run's first error)."""


class TenantExpired(CancelledError):
    """A tenant-lane submission's admission deadline passed - rejected at
    admission, dropped from the host backlog, or lazily discarded by the
    in-kernel tenant poll (device/tenants.py). A control signal like any
    cancellation: counted per tenant (``tenant.<id>.expired``), never
    recorded as the run's first error, and never retried."""


class StallError(RuntimeError):
    """A bounded-latency failure: deadline exceeded, wait timed out, or
    the watchdog escalated a stall. ``stats`` is the runtime (or device)
    counter snapshot at detection time."""

    def __init__(self, message: str, stats: Optional[dict] = None) -> None:
        super().__init__(message)
        self.stats = stats or {}





# ---------------------------------------------------------------- epoch/waker

# Fast path: until any scope in the process is ever cancelled, cancelled()
# is a single int comparison. One active runtime at a time (enforced in
# Runtime.run), so a module-level waker suffices.
_cancel_epoch = 0
_waker_lock = threading.Lock()
_waker = None
# Abort hooks: device-side kill switches (StreamingMegakernel.abort and
# friends) registered while a device stream is live, so cancelling ANY
# scope propagates INTO running device kernels (the abort word lands in
# the kernel's round loop) instead of waiting for the stream to drain.
_abort_hooks: List[Any] = []


def set_cancel_waker(fn) -> None:
    """Register the active runtime's unpark-everything hook (None clears)."""
    global _waker
    with _waker_lock:
        _waker = fn


def register_abort_hook(fn) -> None:
    """Register a device-abort hook fired on every scope cancel (e.g. a
    bound ``StreamingMegakernel.abort``); ``bind_abort_to_scope`` is the
    scope-filtered wrapper. Hooks must be idempotent and fast."""
    with _waker_lock:
        _abort_hooks.append(fn)


def unregister_abort_hook(fn) -> None:
    with _waker_lock:
        try:
            _abort_hooks.remove(fn)
        except ValueError:
            pass


def bind_abort_to_scope(abort_fn, scope: Optional["CancelScope"] = None):
    """Couple a device kill switch (``abort_fn(reason)``) to host
    cancellation: fires when ``scope`` cancels, or - with ``scope=None`` -
    when ANY scope cancels. The ONE implementation of the
    register-then-replay protocol: the hook is registered first and then
    replayed once, so a cancel() that landed before (or concurrently
    with) registration still aborts - cancel() only notifies hooks it
    saw. Returns an unregister callable. ``abort_fn`` must be idempotent
    (StreamingMegakernel.abort is)."""

    def hook() -> None:
        if scope is None:
            if not any_cancelled():
                return
            reason = "scope cancelled"
        elif scope.cancelled():
            r = scope.cancel_reason()
            reason = (
                "scope cancelled" if r is None
                else f"scope cancelled: {r}"
            )
        else:
            return
        abort_fn(reason)

    register_abort_hook(hook)
    hook()  # replay once: close the check/register race

    def unregister() -> None:
        unregister_abort_hook(hook)

    return unregister


# Preemption hooks (the checkpoint/restore subsystem, runtime/checkpoint
# .py): register_abort_hook's checkpoint-flavored twin. A TPU preemption
# notice (SIGTERM from the maintenance controller, or the
# HCLIB_TPU_PREEMPT env a wrapper script sets) should CHECKPOINT the
# resident megakernel - quiesce at a round boundary, export its state -
# rather than abort-and-lose it. Hooks (typically a bound
# ``StreamingMegakernel.quiesce`` or a host flag a driving loop polls)
# fire on ``fire_preempt``; the sources are the signal handler installed
# by ``install_preempt_handler`` and the watchdog's optional checkpoint
# rung (HCLIB_TPU_WATCHDOG_CHECKPOINT). Hooks must be idempotent/fast.
_preempt_hooks: List[Any] = []
_preempt_fired = False


def register_preempt_hook(fn) -> None:
    """Register a checkpoint trigger fired on preemption; if a preemption
    already fired this process, the hook replays immediately (the same
    register-then-replay protocol as ``bind_abort_to_scope`` - a SIGTERM
    that landed before the stream started must still checkpoint it)."""
    with _waker_lock:
        _preempt_hooks.append(fn)
        fired = _preempt_fired
    if fired or preempt_requested():
        try:
            fn()
        except Exception:
            LOG.exception("preempt hook failed during replay")


def unregister_preempt_hook(fn) -> None:
    with _waker_lock:
        try:
            _preempt_hooks.remove(fn)
        except ValueError:
            pass


def fire_preempt(reason: str = "preempted") -> int:
    """Invoke every registered preemption hook; returns the number
    notified. NOT called directly from signal frames: hooks and this
    function take ordinary locks, so ``install_preempt_handler`` defers
    the call to a daemon thread (same-thread lock re-entry from a signal
    handler would deadlock)."""
    global _preempt_fired
    with _waker_lock:
        _preempt_fired = True
        hooks = list(_preempt_hooks)
    LOG.warning("preemption notice (%s): firing %d checkpoint hook(s)",
                reason, len(hooks))
    for h in hooks:
        try:
            h()
        except Exception:  # a dying stream must not block the others
            LOG.exception("preempt hook failed")
    return len(hooks)


def reset_preempt() -> None:
    """Clear the process-wide preempt flag (tests / fresh launches)."""
    global _preempt_fired
    _preempt_fired = False


def preempt_requested() -> bool:
    """True when this process has been asked to preempt: fire_preempt ran
    (signal/watchdog), or the HCLIB_TPU_PREEMPT env var is set - the
    spelling for wrapper scripts that cannot deliver a signal."""
    if _preempt_fired:
        return True
    from .env import env_bool

    return env_bool("HCLIB_TPU_PREEMPT")


def install_preempt_handler(signals: Optional[Sequence[int]] = None):
    """Install a preemption handler for ``signals`` (default: SIGTERM -
    what TPU maintenance/preemption delivers). The handler itself only
    sets the process-wide flag and hands ``fire_preempt`` to a daemon
    thread: Python signal handlers run between bytecodes ON the main
    thread, so taking ``_waker_lock`` (or a stream's lock, or the
    logging lock) there could deadlock against the very frame the
    signal interrupted - the hooks run lock-safe on their own thread.
    Chains to any previous Python-level handler so an outer framework's
    shutdown logic still runs. Main thread only (CPython restriction);
    returns an uninstall callable."""
    import signal as _signal

    if signals is None:
        signals = (_signal.SIGTERM,)
    prev = {}

    def handler(signum, frame):
        global _preempt_fired
        _preempt_fired = True  # plain store: safe in a signal frame
        threading.Thread(
            target=fire_preempt, args=(f"signal {signum}",), daemon=True,
        ).start()
        p = prev.get(signum)
        if callable(p):
            p(signum, frame)

    for s in signals:
        prev[s] = _signal.signal(s, handler)

    def uninstall() -> None:
        for s, p in prev.items():
            try:
                _signal.signal(s, p)
            except (ValueError, TypeError):
                pass

    return uninstall


def any_cancelled() -> bool:
    """True once any scope has been cancelled since the last epoch reset
    (i.e. within the current launch)."""
    return _cancel_epoch != 0


def reset_cancel_epoch() -> None:
    """Restore the cancelled() fast path for a fresh launch. Scopes from a
    finished runtime are unreachable by live tasks, and without this reset
    one cancel anywhere would tax every later launch in the process with
    parent-chain walks on each spawn/execute/park check."""
    global _cancel_epoch
    _cancel_epoch = 0


class CancelScope:
    """Cancellation flag chained along the finish tree.

    ``cancelled()`` consults self and every ancestor, so cancelling a
    scope implicitly cancels all descendants - no child registry, no
    per-finish bookkeeping that could leak across millions of finishes.

    A scope may also carry a **deadline** (``set_deadline``): an absolute
    ``time.monotonic()`` instant after which admission-time consumers
    (the multi-tenant front door's deadline-aware admission,
    device/tenants.py) treat work bound to the scope as expired.
    Deadlines inherit like cancellation - the nearest deadline on the
    parent chain governs - but they are *advisory*: nothing polls them,
    so a passed deadline does not wake parked waiters by itself; the
    checker that observes it (``deadline_expired()``) decides whether to
    cancel. That keeps the epoch fast path intact: an armed deadline
    costs nothing until someone asks.
    """

    __slots__ = ("parent", "reason", "_cancelled", "deadline_t")

    def __init__(self, parent: Optional["CancelScope"] = None) -> None:
        self.parent = parent
        self.reason: Any = None
        self._cancelled = False
        self.deadline_t: Optional[float] = None

    def cancel(self, reason: Any = None) -> None:
        """Cancel this scope (and, by inheritance, its descendants).
        Idempotent; the first reason wins. Wakes every parked context of
        the active runtime so blocked waiters notice promptly."""
        global _cancel_epoch
        if self._cancelled:
            return
        if reason is not None:
            self.reason = reason
        self._cancelled = True
        _cancel_epoch += 1
        with _waker_lock:
            w = _waker
            hooks = list(_abort_hooks)
        if w is not None:
            try:
                w()
            except Exception:  # a dying runtime must not break cancel()
                pass
        for h in hooks:  # device kill switches (abort words) fire too
            try:
                h()
            except Exception:
                pass

    def cancelled(self) -> bool:
        if _cancel_epoch == 0:
            return False
        s: Optional[CancelScope] = self
        while s is not None:
            if s._cancelled:
                return True
            s = s.parent
        return False

    def describe(self) -> str:
        s: Optional[CancelScope] = self
        while s is not None:
            if s._cancelled:
                r = s.reason
                if r is None:
                    return "scope cancelled"
                return f"scope cancelled: {r}"
            s = s.parent
        return "scope not cancelled"

    def cancel_reason(self) -> Any:
        """The reason of the nearest cancelled scope on the parent chain."""
        s: Optional[CancelScope] = self
        while s is not None:
            if s._cancelled:
                return s.reason
            s = s.parent
        return None

    # -- deadlines (advisory; checked at admission points) --

    def set_deadline(self, seconds: Optional[float] = None,
                     at: Optional[float] = None) -> "CancelScope":
        """Arm a deadline ``seconds`` from now (or at absolute monotonic
        instant ``at``); the earliest armed deadline wins on re-arm.
        Returns self for chaining: ``CancelScope().set_deadline(0.5)``."""
        if (seconds is None) == (at is None):
            raise ValueError("set_deadline wants exactly one of "
                             "seconds= or at=")
        t = time.monotonic() + float(seconds) if at is None else float(at)
        if self.deadline_t is None or t < self.deadline_t:
            self.deadline_t = t
        return self

    def effective_deadline(self) -> Optional[float]:
        """The earliest deadline on self and every ancestor (deadlines
        inherit like cancellation), or None when none is armed."""
        best: Optional[float] = None
        s: Optional[CancelScope] = self
        while s is not None:
            t = s.deadline_t
            if t is not None and (best is None or t < best):
                best = t
            s = s.parent
        return best

    def deadline_expired(self, now: Optional[float] = None) -> bool:
        """True once the effective deadline has passed (``now`` defaults
        to ``time.monotonic()``; injectable for deterministic tests)."""
        t = self.effective_deadline()
        if t is None:
            return False
        return (time.monotonic() if now is None else now) >= t


# ------------------------------------------------------------- deterministic

def _hash01(seed: int, site: str, n: int) -> float:
    """Uniform [0, 1) as a pure function of (seed, site, n) - platform- and
    run-independent, unlike random.Random under thread interleaving."""
    h = hashlib.blake2b(f"{seed}/{site}/{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") / 2.0**64


# ------------------------------------------------------------------- retry

class RetryPolicy:
    """Per-spawn retry: up to ``max_attempts`` total executions, delayed by
    ``backoff_s * multiplier**(attempt-1)`` with deterministic +/-``jitter``
    fraction. ``retry_on`` restricts which exception types retry
    (cancellation and stalls never do). With ``quarantine=True`` a task
    that exhausts its attempts is recorded in the runtime's quarantine and
    *swallowed* (its result promise is poisoned, the run continues);
    otherwise the terminal error propagates to ``launch`` as usual."""

    __slots__ = (
        "max_attempts", "backoff_s", "multiplier", "jitter", "retry_on",
        "quarantine", "seed", "_n", "_lock",
    )

    def __init__(
        self,
        max_attempts: int = 3,
        backoff_s: float = 0.01,
        multiplier: float = 2.0,
        jitter: float = 0.1,
        retry_on: Tuple[type, ...] = (Exception,),
        quarantine: bool = False,
        seed: int = 0,
    ) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self.quarantine = bool(quarantine)
        self.seed = int(seed)
        self._n = 0
        self._lock = threading.Lock()

    def should_retry(self, attempt: int, exc: BaseException) -> bool:
        """True if execution ``attempt`` (0-based) failing with ``exc``
        warrants another attempt."""
        if isinstance(exc, (CancelledError, StallError)):
            return False
        return attempt + 1 < self.max_attempts and isinstance(
            exc, self.retry_on
        )

    def delay_s(self, attempt: int) -> float:
        """Backoff before execution ``attempt`` (1-based retry index)."""
        d = self.backoff_s * (self.multiplier ** max(0, attempt - 1))
        if self.jitter:
            with self._lock:
                self._n += 1
                n = self._n
            u = _hash01(self.seed, "retry-jitter", n)
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(0.0, d)



# ------------------------------------------------------------- device chaos

def _env_int(name: str, default: int) -> int:
    from .env import env_int

    return env_int(name, default, malformed=default)


class DeviceFaultPlan:
    """Seeded deterministic fault injection for the resident kernel's
    steal exchange (``device/resident.py`` and ``ICIStealMegakernel`` on
    a power-of-two mesh, which delegates to it), as in JAX.

    The plan is compiled into the kernel: every fault decision is a pure
    function of ``(seed, site, round, hop, device)`` (``fault_mix``),
    which every device of the lockstep mesh evaluates alike, so
    injection, detection and recovery agree on the schedule and the
    fault trace (``fault_stats`` in the run's info) is reproducible from
    the seed. A ``None`` plan, or one that injects nothing, compiles none
    of it.

    Faults (sites):

    - dropped steal credit (``drop_credit_rate`` / ``drop_credit_at=[(round,
      hop, granter_dev), ...]``): the granter skips the credit it owes
      its hop partner after consuming the partner's rows. The pair then
      skips that hop's row exchange for ``credit_timeout`` rounds, after
      which the starved writer regenerates the credit. With
      ``credit_timeout=0`` there is no regeneration: the mesh exits in
      lockstep and the run raises ``StallError`` naming the channel.
    - duplicated steal credit (``dup_credit_rate`` / ``dup_credit_at``):
      the granter signals twice; the surplus is absorbed.
    - delayed transfer (``delay_xfer_rate``): the sender's export quota
      for that (round, hop) is zero.
    - dead chip (``dead_device``, ``dead_round``): from ``dead_round`` on
      the device runs no task and its heartbeat stops, while its exchange
      stays up. Survivors quarantine it once its heartbeat has not moved
      for ``heartbeat_timeout`` rounds, and it re-homes its queued rows
      to its hop partners. Work that cannot re-home raises
      ``StallError`` naming the suspect chip.

    ``credit_timeout`` / ``heartbeat_timeout`` default from
    ``HCLIB_TPU_CREDIT_TIMEOUT`` / ``HCLIB_TPU_HEARTBEAT_TIMEOUT`` (rounds
    of the exchange, default 2). Rates are quantised to per-mille.
    """

    def __init__(
        self,
        seed: int = 0,
        drop_credit_rate: float = 0.0,
        drop_credit_at: Sequence[Tuple[int, int, int]] = (),
        dup_credit_rate: float = 0.0,
        dup_credit_at: Sequence[Tuple[int, int, int]] = (),
        delay_xfer_rate: float = 0.0,
        dead_device: Optional[int] = None,
        dead_round: int = 0,
        credit_timeout: Optional[int] = None,
        heartbeat_timeout: Optional[int] = None,
    ) -> None:
        for name, r in (
            ("drop_credit_rate", drop_credit_rate),
            ("dup_credit_rate", dup_credit_rate),
            ("delay_xfer_rate", delay_xfer_rate),
        ):
            if not (0.0 <= r <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {r}")
        self.seed = int(seed)
        self.drop_millis = int(round(drop_credit_rate * 1000))
        self.dup_millis = int(round(dup_credit_rate * 1000))
        self.delay_millis = int(round(delay_xfer_rate * 1000))
        self.drop_credit_at = tuple(
            (int(r), int(k), int(g)) for (r, k, g) in drop_credit_at)
        self.dup_credit_at = tuple(
            (int(r), int(k), int(g)) for (r, k, g) in dup_credit_at)
        self.dead_device = None if dead_device is None else int(dead_device)
        self.dead_round = int(dead_round)
        self.credit_timeout = (
            _env_int("HCLIB_TPU_CREDIT_TIMEOUT", 2)
            if credit_timeout is None else int(credit_timeout))
        if self.credit_timeout < 0:
            raise ValueError("credit_timeout must be >= 0 (0 = no regen)")
        self.heartbeat_timeout = max(1, (
            _env_int("HCLIB_TPU_HEARTBEAT_TIMEOUT", 2)
            if heartbeat_timeout is None else int(heartbeat_timeout)))

    def drops_credits(self) -> bool:
        return bool(self.drop_millis or self.drop_credit_at)

    def dups_credits(self) -> bool:
        return bool(self.dup_millis or self.dup_credit_at)

    def enabled(self) -> bool:
        return (self.drops_credits() or self.dups_credits()
                or self.delay_millis > 0 or self.dead_device is not None)
