"""The resident multi-device kernel on one card: one CTA a mesh device
runs the scheduler and the XOR-hop exchange in one launch.

Port of ``hclib_tpu/device/resident.py`` ``ResidentKernel`` (:322) and
``decode_fault_stats`` (:268), in four configurations of one kernel
(``csrc/mesh.cuh`` ``resident_kernel``, replacing ``_kernel`` :626):

- steal-only (``steal=True``, no channels, ``homed=False`` with no value
  args; what ``ICIStealMegakernel`` delegates to on power-of-two
  meshes): a round runs the abort word; ``sched(quantum)``; the fold over
  the XOR hops in ``hop_order`` (each hop a credited exchange of the
  stat vector with ``me ^ (1 << k)``: the recursive-doubling sums of
  pending and abort, the partner's backlog raw) and, at each hop, the
  demand-driven steal: ``clip((mine - theirs + 1) // 2, 0, W)``
  link-free whitelisted ready rows to a partner whose backlog is under
  ``min(quantum, W)``, into that hop's inbox. With no active messages or
  channels the stat vector's XOR all-to-all section is all zeros, so
  this configuration sends the seven sums and the backlog only (8 words
  a hop).
- PGAS-only (``steal=False``; what a power-of-two ``PGASMegakernel``
  delegates to): the bodies' one-sided puts, active messages and
  wait-untils (``ctx.pgas``: ``put``, ``am``, ``wait_until``, ``count``,
  ``me``, ``ndev``, ``nchan``; op_put :834, op_am :801, op_wait_until
  :862, op_count :878), the remote atomics and locks (``fadd``,
  ``fadd_get``, ``cswap``, ``lock``, ``unlock``: op_fadd :881 to
  op_unlock :903, built-in messages the owner's serial scheduler
  applies in ``handle_am`` :1231 - that order is the atomicity - with
  ``RC_REPLY`` / ``RC_GRANT`` replies that dep-decrement a parked row;
  a full lock FIFO sets OVF_LOCKQ), the outbox drain (:1189: at most
  ``am_window // 2`` messages a target a round, FIFO, OVF_OUTBOX when
  the outbox is full), the whole stat vector with its XOR all-to-all
  section (sent and received counts a source: ``SX_AM`` ndev words,
  ``SX_DATA`` ndev x nchan), the exit once the folded pending is 0,
  every outbox is empty and sent equals received, then
  ``drain_receives`` (:1322: the announced puts added to ``chan_tot``,
  the announced messages through ``handle_am``) and ``scan_waits``
  (:1381); host-declared ``run(waits=...)`` as in JAX (each parked row
  one extra dependency, off the ready ring).
- both (``steal=True`` with ``channels``): the two on the same hops.
- migrating (``steal=True`` with ``homed=True`` and migratable kinds, or
  with value args): the home-link protocol (:14-60) on the PGAS
  configuration's outbox, inbox and stat vector, channels or not. A
  ready row with links or a dynamic out slot exports as a copy naming
  its proxy (``F_HOME`` / ``F_HROW``; ``export`` :1069, ``elig_of``
  :1041 with the proxy budget ``proxy_cap`` read once a scan), the
  proxy stays pending at home off the ring; copies never re-export; the
  copy's chain forwards its value home in an ``RC_COMPLETE`` message
  (``complete_hook`` :914), which writes the proxy's out slot, completes
  it and takes back the execution count. Copies write their result into
  the reserved slots ``[rbase, num_values)`` (``install_fixed`` :993),
  below which dynamic values stay (``value_limit``); declared value args
  are dereferenced at export and rehydrated into the row's own value
  block at install. The scheduler keeps home links
  (``Megakernel.tracks_home``). On the card: ``resident_homed``.

Each of them also injects (``inject=True``: ``csrc/mesh.cuh``
``resident_kernel<.., kInject>``; poll :1404, tpoll :1458, the round
:1938-1973): every device has an injection ring of ``ring_capacity``
rows (``RING_ROW`` words each, ``run(inject_rows=...)`` packed by
``pack_inject_rows``) and an 8-word ictl row (tail, closed, consumed)
the kernel re-reads every round; after ``sched(quantum)`` the poll
installs the published rows in order (``install_fixed``; the
steal-only configuration through the core's ``install_descriptor``),
dropping and counting (``FS_TEN_EXPIRED``) a row marked
``TEN_EXPIRED``. With ``tenants=`` (mesh tenancy, lanes from
``tenants.normalize_mesh_tenants``) the ring is ``T`` lane regions of
``region_rows`` rows and the poll is the weighted round-robin lane scan
(from lane ``r mod T``, at most ``min(weight, avail, headroom())`` rows
a lane, paused lanes swept) over a ``(T, 8)`` tctl block a device that
``run(tenant_table=MeshTenantTable(...))`` pumps in and absorbs back.
The ring backlog is the fold's ``SF_INJ`` sum, and the mesh exits only
once it is 0. On the card: ``resident_inject``.

Each steal configuration also runs a fault plan
(``fault_plan=DeviceFaultPlan(...)``: ``csrc/mesh.cuh``
``resident_kernel<.., kFault>``; the predicates :738-799, the faulty row
exchange :1681-1834, heartbeat detection :1836-1870, the dead device's
round :1895-1937): dropped, duplicated and delayed steal credits, pure
functions of (seed, site, round, hop, granter) that every device
evaluates alike. A dropped credit downs the pair's row exchange on that
hop for ``credit_timeout`` rounds, after which the starved writer skips
one credit wait (regeneration, ``FS_REGEN``); with ``credit_timeout=0``
any drop raises the wedge flag (``SF_WEDGE``), every pair skips its row
exchanges and the mesh exits at the next fold, and ``run`` raises a
``StallError`` naming the starved hop and granter. A dead device runs no
task from ``dead_round`` on and its heartbeat stops, while its exchange
stays up and exports up to ``window`` queued rows a hop whatever the
demand (``FS_REHOMED``); the heartbeats ride the stat vector's XOR
all-to-all (ndev words a hop), and a survivor that sees one frozen for
``heartbeat_timeout`` rounds quarantines that device (``FS_QMASK``,
``FS_DEAD_ROUND``): no rows go to it. On the card: ``resident_fault``.

The mesh exits in lockstep. A mesh device is one co-resident CTA
(``parallel.mesh.CtaMesh``); the plain version (``_plain_resident``: the
same rounds over the plain cores device by device) is what the CPU tests
hold against JAX and the card against. The PGAS and migrating
configurations run from the table's user-body library
(``csrc/user.cuh``; a table of built-in bodies alone builds one with no
user body). ``info`` reports, under them, each device's live proxies
and their peak and the built-in messages it applied by kind.

Each of them also quiesces, resumes and records (a table built with
``checkpoint=True`` and / or ``trace=N``: ``csrc/mesh.cuh``
``resident_kernel<.., kObs>``; the hold :1909-1935, the settled exit
:1986-2018, the exit export :2035-2071, the recorder's records
:1447-2042). ``run(quiesce=)`` rides words 1-2 of each device's abort row
(flag, threshold round): from that round on every scheduler gets fuel 0
and the ring polls consume nothing while the exchange drains the wire;
the quiesce sum is folded like the abort word, and the mesh exits once it
is quiesced with every outbox empty and sent equal to received.
``info['state']`` then holds tasks, succ, ready, counts, ivalues, data
and the wait table (needs rebased to need - chan_tot, zeros past the
count), plus the ring residue and ictl of an injecting mesh or the tenant
table's export; ``run(resume_state=)`` restages it (no bump_waits pass).
A traced table gives every device a ring (``info['trace']``): the core's
round records and TR_XFER, TR_CREDIT, TR_FAULT, TR_INJECT, TR_TENANT,
TR_ABORT, TR_QUIESCE and TR_CKPT in JAX's order. On the card:
``resident_obs``.

Not ported yet, raising naming ROADMAP A11b.5: a fault plan on an
injecting or tenant mesh.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime.resilience import StallError
from .descriptor import (
    DESC_WORDS,
    RING_ROW,
    TEN_EXPIRED,
    TEN_ID,
    F_A0,
    F_CSR_N,
    F_CSR_OFF,
    F_DEP,
    F_FN,
    F_HOME,
    F_HROW,
    F_OUT,
    F_SUCC0,
    F_SUCC1,
    F_VMASK,
    NO_TASK,
    TaskGraphBuilder,
)
from .megakernel import (
    C_EXECUTED,
    C_HEAD,
    C_OVERFLOW,
    C_PENDING,
    C_ROUNDS,
    C_TAIL,
    C_VALLOC,
    C_VBASE,
    MAX_CHANS,
    MAX_HOPS,
    OVF_LOCKQ,
    OVF_OUTBOX,
    OVF_WAITS,
    PG_SECTIONS,
    VBLOCK,
    Megakernel,
    _PlainCore,
    _i32,
    decode_overflow,
    fault_mix,
    mesh_slice,
)
from .sharded import abort_words, mesh_info, mesh_state
from .tenants import (
    TC_CONSUMED,
    TC_DROPPED,
    TC_EXPIRED,
    TC_INSTALLED,
    TC_PAUSE,
    TC_TAIL,
    TC_WEIGHT,
    build_row,
    normalize_mesh_tenants,
)
from .tracebuf import (
    CR_DROPPED,
    CR_DUPED,
    CR_REGENERATED,
    FLT_DEAD_QUARANTINE,
    FLT_DELAY,
    HDR,
    TR_ABORT,
    TR_CKPT,
    TR_CREDIT,
    TR_FAULT,
    TR_INJECT,
    TR_QUIESCE,
    TR_TENANT,
    TR_WORDS,
    TR_XFER,
    Tracer,
    trace_info,
)

__all__ = ["ResidentKernel", "decode_fault_stats", "pack_inject_rows",
           "FS_WORDS", "fault_plan_words", "FP_MAX_AT",
           "SPIN_TIMEOUT_S", "MESH_MAX_SCAN", "mesh_workspace",
           "export_rows", "import_rows", "run_mesh_kernel", "export_waits",
           "exchange_info", "pgas_layout", "stat_words", "ring_stat_words",
           "parse_channels", "park_waits", "lock_block_slots",
           "RC_COMPLETE", "RC_FADD", "RC_FADD_R", "RC_CSWAP", "RC_REPLY",
           "RC_LOCK", "RC_UNLOCK", "RC_GRANT", "RC_NAMES"]

# Built-in active-message kinds (resident.py RC_*): negative F_FN values
# that the receiving scheduler applies at drain time; they never occupy a
# task row.
RC_COMPLETE = -2  # [proxy_row, value]: a migrated task's result, home
RC_FADD = -3      # [slot, delta]: fire-and-forget fetch-add
RC_FADD_R = -4    # [slot, delta, src, row, rslot]: fetch-add, reply old
RC_CSWAP = -5     # [slot, expected, new, src, row, rslot]: compare-swap
RC_REPLY = -6     # [row, value, rslot]: deposit value, dep-decrement row
RC_LOCK = -7      # [lbase, src, row, qcap]: acquire or enqueue
RC_UNLOCK = -8    # [lbase, qcap]: release, or grant the next waiter
RC_GRANT = -9     # [row]: lock granted, dep-decrement the parked row
RC_NAMES = {RC_COMPLETE: "complete", RC_FADD: "fadd", RC_FADD_R: "fadd_get",
            RC_CSWAP: "cswap", RC_REPLY: "reply", RC_LOCK: "lock",
            RC_UNLOCK: "unlock", RC_GRANT: "grant"}


def lock_block_slots(qcap: int) -> int:
    """Value slots a lock block occupies: [held, qlen, head, (dev, row) x
    qcap] (resident.py :243). The host presets it to zero at ``lbase`` on
    the owner device."""
    return 3 + 2 * int(qcap)

# Per-device fault/abort stats row (resident.py FS_*).
FS_DROPPED = 0
FS_REGEN = 1
FS_DUPED = 2
FS_DELAYED = 3
FS_DEAD_ROUND = 4
FS_QMASK = 5
FS_REHOMED = 6
FS_ABORT_ROUND = 7
FS_STARVED = 8
FS_HB = 9
FS_QUIESCE_ROUND = 10
FS_TEN_EXPIRED = 11
FS_WORDS = 16

# The stat vector (resident.py SF_* / SX_*): the sums the fold keeps, then
# (PGAS configurations) the XOR all-to-all section, then the backlog; under
# a fault plan the ndev routed heartbeats follow.
SF_PEND, SF_RECV, SF_OUTB, SF_SENT, SF_INJ, SF_ABORT, SF_WEDGE, SX_AM = (
    0, 1, 2, 3, 4, 5, 6, 7)
STAT_WORDS = 8  # steal-only: the stat words a hop sends (sums, backlog)
# A fault plan's words on the card (csrc/mesh.cuh flt::): the seed, the
# per-mille rates, the dead device (-1: none) and its round, both
# timeouts, the exact lists' lengths, whether a drop wedges the mesh,
# then FP_MAX_AT (round, hop, granter) entries a site, drops then dups.
(FP_SEED, FP_DROP, FP_DUP, FP_DELAY, FP_DEAD_DEV, FP_DEAD_ROUND, FP_CT,
 FP_HBT, FP_NDROP, FP_NDUP, FP_WEDGES) = range(11)
FP_AT, FP_MAX_AT = 16, 16
FP_WORDS = FP_AT + 6 * FP_MAX_AT
# A device's fault workspace on the card (csrc/mesh.cuh flt::): its FS_*
# words first, then per hop bit the last round of the pair's down window
# (-1 at the start), and the rest, zeroed.
FW_PAIR_DOWN, FW_WORDS = 16, 216
# The exchange's volume a device (csrc/mesh.cuh XS_*): rows it exported,
# stat words it sent, and the active messages and puts it sent.
XS_ROWS, XS_STAT_WORDS, XS_AMS, XS_PUTS, XS_WORDS = 0, 1, 2, 3, 4
# A spin of the steal kernels that waits longer than this raises: the
# card's protocol never stalls a CTA for seconds on a healthy mesh.
SPIN_TIMEOUT_S = 30.0
MESH_MAX_SCAN = 1024  # csrc/mesh.cuh MAX_SCAN
P_STAT = 32  # csrc/mesh.cuh: the word of a port where its stat slab starts
P_INBOX = 64  # csrc/mesh.cuh: steal-only, the words before the row inbox
# A device's pstate words (csrc/mesh.cuh PS_*): resident.py's RECV, NWAIT,
# SENT and PROXIES (live proxies), then the port's own: the proxies' peak,
# the built-in messages applied (kind k at PS_AMS - 2 - k), and what the
# host writes before a launch (the proxy budget, homed, rbase, whether
# spawn keeps home links, whether any kind declares value args).
PS_RECV, PS_NWAIT, PS_SENT, PS_PROXIES, PS_PEAK, PS_AMS = 0, 1, 2, 3, 7, 8
PS_CAP, PS_HOMED, PS_RBASE, PS_TRACK, PS_VARGS = 16, 17, 18, 19, 20
PS_WORDS = 24
# What stopped a mesh (csrc/mesh.cuh W_* and the protocol faults).
_WAITS = {1: "stat credit", 2: "stat arrival", 3: "row credit",
          4: "row arrival", 5: "put arrival", 6: "active-message arrival"}
_FAULTS = {7: "a put on an undeclared channel",
           8: "a put outside its channel's buffer rows",
           9: "an active message, atomic or lock op to a device outside "
              "the mesh, or ctx.pgas.am of a built-in kind (fn < 0)",
           10: "ctx.pgas.fadd, fadd_get, cswap, lock or unlock under "
               "PGASMegakernel's ring kernel (a mesh whose size is not a "
               "power of two: put, am, wait_until and count only)"}


def decode_fault_stats(row) -> Dict[str, Any]:
    """Human shape of one device's FS_* stats row."""
    row = [int(x) for x in row]
    st = row[FS_STARVED]
    return {
        "credits_dropped": row[FS_DROPPED],
        "credits_regenerated": row[FS_REGEN],
        "credits_duplicated": row[FS_DUPED],
        "xfers_delayed": row[FS_DELAYED],
        "dead_detected_round": row[FS_DEAD_ROUND],
        "quarantined": [d for d in range(31) if (row[FS_QMASK] >> d) & 1],
        "rehomed_rows": row[FS_REHOMED],
        "abort_round": row[FS_ABORT_ROUND],
        "starved_channel": (
            None if st == 0
            else {"hop": (st - 1) >> 8, "granter": (st - 1) & 0xFF}
        ),
        "heartbeat": row[FS_HB],
        "quiesce_round": row[FS_QUIESCE_ROUND],
        "tenant_expired": row[FS_TEN_EXPIRED],
    }


def fault_plan_words(plan) -> np.ndarray:
    """A ``DeviceFaultPlan``'s words as ``resident_kernel<.., kFault>``
    reads them (``FP_*``); at most ``FP_MAX_AT`` exact entries a site."""
    for name in ("drop_credit_at", "dup_credit_at"):
        if len(getattr(plan, name)) > FP_MAX_AT:
            raise ValueError(
                f"{name}: the card's kernel holds at most {FP_MAX_AT} "
                f"exact entries a site, got {len(getattr(plan, name))}")
    w = np.zeros(FP_WORDS, np.int64)
    # fault_mix reads the seed modulo 2^31 (its multiple is masked).
    w[FP_SEED] = plan.seed % (1 << 31)
    w[FP_DROP], w[FP_DUP], w[FP_DELAY] = (plan.drop_millis, plan.dup_millis,
                                          plan.delay_millis)
    w[FP_DEAD_DEV] = -1 if plan.dead_device is None else plan.dead_device
    w[FP_DEAD_ROUND] = plan.dead_round
    w[FP_CT], w[FP_HBT] = plan.credit_timeout, plan.heartbeat_timeout
    w[FP_NDROP], w[FP_NDUP] = len(plan.drop_credit_at), len(
        plan.dup_credit_at)
    w[FP_WEDGES] = int(plan.drops_credits() and plan.credit_timeout == 0)
    for base, at in ((FP_AT, plan.drop_credit_at),
                     (FP_AT + 3 * FP_MAX_AT, plan.dup_credit_at)):
        for i, e in enumerate(at):
            w[base + 3 * i:base + 3 * i + 3] = e
    return _i32(w).astype(np.int32)


class _Faults:
    """resident.py's compiled-in fault predicates (:738-799): pure in
    (seed, site, round r, hop k, granter g), so every device of the mesh
    computes the same answer for any (k, g)."""

    def __init__(self, plan, ndev: int, nh: int):
        self.plan, self.ndev, self.nh = plan, ndev, nh

    def _hit(self, site, millis, exact, r, k, g) -> bool:
        if millis > 0 and fault_mix(self.plan.seed, site, r, k, g) < millis:
            return True
        return any(kk == k and rr == r and gg == g for rr, kk, gg in exact)

    def drop(self, r: int, k: int, g: int) -> bool:
        return self._hit(0, self.plan.drop_millis, self.plan.drop_credit_at,
                         r, k, g)

    def dup(self, r: int, k: int, g: int) -> bool:
        return self._hit(1, self.plan.dup_millis, self.plan.dup_credit_at,
                         r, k, g)

    def delay(self, r: int, k: int, g: int) -> bool:
        return self._hit(2, self.plan.delay_millis, (), r, k, g)

    def dead(self, d: int, r: int) -> bool:
        """Is device ``d`` the plan's dead chip at round ``r``?"""
        return d == self.plan.dead_device and r >= self.plan.dead_round

    def wedges(self, r: int) -> bool:
        """With regeneration off, does any credit of round ``r`` drop?"""
        p = self.plan
        if not (p.drops_credits() and p.credit_timeout == 0):
            return False
        return any(self.drop(r, k, g) for k in range(self.nh)
                   for g in range(self.ndev))


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP A11b (A11b.5: fault plans on "
        "an injecting or tenant mesh); the port runs the steal, PGAS and "
        "homed-migration configurations with remote atomics and locks, "
        "the injection ring and mesh tenancy, fault plans on the steal "
        "configurations, and the quiesce, resume and flight recorder of "
        "every one of them")


def pack_inject_rows(rows: Sequence, R: int, dev: int = 0):
    """Pack one device's ``inject_rows`` specs into its ``(R, RING_ROW)``
    ring image (resident.py :221): tuples ``(fn, args[, out[,
    tenant_lane]])`` or prebuilt RING_ROW numpy rows (``build_row`` with
    a TEN_ID stamp). Returns ``(ring, n)``."""
    ring = np.zeros((R, RING_ROW), np.int32)
    if len(rows) > R:
        raise ValueError(f"device {dev}: injection ring overflow")
    for i, spec in enumerate(rows):
        if isinstance(spec, np.ndarray):
            ring[i] = np.asarray(spec, np.int32).reshape(RING_ROW)
            continue
        fn, args = spec[0], spec[1]
        out = spec[2] if len(spec) > 2 else 0
        ring[i] = build_row(fn, args, out)
        if len(spec) > 3:
            ring[i, TEN_ID] = int(spec[3])
    return ring, len(rows)


def parse_channels(mk: Megakernel, channels
                   ) -> Tuple[List[Tuple[str, int]], Dict[str, int]]:
    """``channels`` (``{name: (data_buffer, rows)}``) checked as JAX
    checks them, as the (buffer, rows) list and the name -> id map."""
    out: List[Tuple[str, int]] = []
    ids: Dict[str, int] = {}
    for cname, (bname, rows) in (channels or {}).items():
        if bname not in mk.data_specs:
            raise ValueError(f"channel {cname!r}: no data buffer {bname!r}")
        if rows < 1 or rows > mk.data_specs[bname][0][0]:
            raise ValueError(f"channel {cname!r}: bad row count {rows}")
        ids[cname] = len(out)
        out.append((bname, int(rows)))
    if len(out) > MAX_CHANS:
        raise ValueError(f"at most {MAX_CHANS} channels, got {len(out)}")
    return out, ids


def park_waits(waits, tasks, ring, counts) -> None:
    """bump_waits' wait half (resident.py, pgas_kernel.py :790): each
    task a host wait names owes one extra dependency and leaves its
    device's ready ring."""
    for d, wlist in enumerate(waits):
        for (_, _, row) in wlist:
            tasks[d, row, F_DEP] += 1
        bumped = {row for (_, _, row) in wlist}
        if not bumped:
            continue
        old_n = counts[d][C_TAIL]
        keep = [x for x in ring[d][:old_n] if x not in bumped]
        ring[d][:len(keep)] = keep
        counts[d][C_TAIL] = len(keep)


def stat_words(ndev: int, nchan: int) -> int:
    """Words of the stat vector a PGAS configuration sends a hop (JAX's
    ``S``): the seven sums, ndev message counts, ndev x nchan put counts
    and the backlog."""
    return SX_AM + ndev + ndev * nchan + 1


# The PGAS ring kernel's stat slot (csrc/mesh.cuh RS_*): what one device
# publishes a round - its pending count, messages received, outbox
# backlog, abort flag and messages sent, then from word RS_AM the
# messages it sent each target and the puts it sent each (target,
# channel).
RS_AM = 5


def ring_stat_words(ndev: int, nchan: int) -> int:
    """Words of the PGAS ring kernel's stat slot (``RS_*``): the five
    totals, ndev message counts and ndev x nchan put counts."""
    return RS_AM + ndev + ndev * nchan


# ---- the exchange pieces shared by the plain ring and resident runners


def _elig(core: _PlainCore, row: int, wl, resident: bool) -> bool:
    """ici_steal.py elig_of (``resident`` False) or resident.py elig_of
    under homed=False (True): whitelisted and link-free; the resident
    form also migrate-once (F_HOME < 0) and no dynamic out slot."""
    t = core.tasks
    r = row * DESC_WORDS
    ok = t[r + F_FN] in wl
    if resident:
        homed = (t[r + F_SUCC0] != NO_TASK or t[r + F_SUCC1] != NO_TASK
                 or t[r + F_CSR_N] > 0
                 or t[r + F_OUT] >= core.counts[C_VBASE])
        return ok and t[r + F_HOME] < 0 and not homed
    return (ok and t[r + F_SUCC0] == NO_TASK and t[r + F_SUCC1] == NO_TASK
            and t[r + F_CSR_N] == 0)


def export_rows(core: _PlainCore, quota: int, scan: int, wl,
                resident: bool, xs=None) -> List[List[int]]:
    """export (ici_steal.py :209, resident.py :1069): scan up to ``scan``
    entries behind the ring head, move up to ``quota`` eligible rows out
    (tombstoned and freed), compact the kept candidates back against the
    new head; the moved rows' words."""
    c, cap = core.counts, core.capacity
    head = c[C_HEAD]
    n = min(c[C_TAIL] - head, scan)
    cand = [core.ready[(head + j) % cap] for j in range(n)]
    nsend = min(quota, sum(_elig(core, x, wl, resident) for x in cand))
    rows: List[List[int]] = []
    kp = 0
    for x in cand:
        if len(rows) < nsend and _elig(core, x, wl, resident):
            row = core.tasks[x * DESC_WORDS:(x + 1) * DESC_WORDS]
            if resident:
                row[F_VMASK] = 0  # export owns the wire's value mask
            rows.append(row)
            core.tasks[x * DESC_WORDS + F_DEP] = -1
            core.free[0] += 1
            core.free[core.free[0]] = x
        else:
            core.ready[(head + nsend + kp) % cap] = x
            kp += 1
    c[C_HEAD] = head + nsend
    c[C_PENDING] -= nsend
    if xs is not None:
        xs[XS_ROWS] += nsend
    return rows


def import_rows(core: _PlainCore, rows: List[List[int]]) -> None:
    """import_rows / install_fixed: adopt each row through the core's
    install_descriptor (stolen rows were ready: they go back to ready)."""
    for row in rows:
        core.install_descriptor(lambda w, row=row: row[w])


def _links(core: _PlainCore, row: int) -> bool:
    """resident.py homed_elig_of: the row carries successor links or
    writes a dynamic value slot (valid only at home), so it migrates as a
    homed copy and leaves a proxy."""
    t, r = core.tasks, row * DESC_WORDS
    return (t[r + F_SUCC0] != NO_TASK or t[r + F_SUCC1] != NO_TASK
            or t[r + F_CSR_N] > 0 or t[r + F_OUT] >= core.counts[C_VBASE])


def _elig_mig(core: _PlainCore, row: int, rk: "ResidentKernel",
              allow_homed: bool) -> bool:
    """resident.py elig_of: a migratable kind, migrate-once (F_HOME < 0),
    and link-free unless homed with the proxy budget open (snapshotted
    once a scan, ``allow_homed``)."""
    r = row * DESC_WORDS
    if core.tasks[r + F_FN] not in rk.migratable or core.tasks[
            r + F_HOME] >= 0:
        return False
    return not _links(core, row) or (rk.homed and allow_homed)


def export_migrating(core: _PlainCore, quota: int, pg: "_PlainPgas",
                     xs=None) -> List[List[int]]:
    """resident.py export (:1069) of the migrating configuration: up to
    ``quota`` eligible rows of the first ``scan`` behind the ring head
    leave. A row with links (homed) ships a copy naming its proxy
    (F_HOME = me, F_HROW = the row, links cleared on the wire) and stays
    pending at home off the ring; a link-free row moves whole
    (tombstoned, freed, its pending count handed over). Declared value
    args are dereferenced into the wire (F_VMASK names them; export owns
    the mask). The moved rows' words."""
    rk, c, t, cap = pg.rk, core.counts, core.tasks, core.capacity
    head = c[C_HEAD]
    n = min(c[C_TAIL] - head, rk.scan)
    cand = [core.ready[(head + j) % cap] for j in range(n)]
    allow = pg.ps[PS_PROXIES] < rk.proxy_cap
    nsend = min(quota, sum(_elig_mig(core, x, rk, allow) for x in cand))
    rows: List[List[int]] = []
    kp = nwhole = 0
    for x in cand:
        if len(rows) < nsend and _elig_mig(core, x, rk, allow):
            r = x * DESC_WORDS
            row = t[r:r + DESC_WORDS]
            row[F_VMASK] = 0
            if rk.homed and _links(core, x):
                row[F_SUCC0] = row[F_SUCC1] = NO_TASK
                row[F_CSR_OFF] = row[F_CSR_N] = 0
                row[F_HOME], row[F_HROW] = pg.me, x
                pg.ps[PS_PROXIES] += 1
                pg.ps[PS_PEAK] = max(pg.ps[PS_PEAK], pg.ps[PS_PROXIES])
            else:
                t[r + F_DEP] = -1
                core.free[0] += 1
                core.free[core.free[0]] = x
                nwhole += 1
            vargs = rk.migratable[t[r + F_FN]]
            if vargs:
                for i in vargs:
                    row[F_A0 + i] = core.ivalues[t[r + F_A0 + i]]
                row[F_VMASK] = rk.vmask[t[r + F_FN]]
            rows.append(row)
        else:
            core.ready[(head + nsend + kp) % cap] = x
            kp += 1
    c[C_HEAD] = head + nsend
    c[C_PENDING] -= nwhole
    if xs is not None:
        xs[XS_ROWS] += nsend
    return rows


def install_fixed(core: _PlainCore, row_words, rk: "ResidentKernel") -> int:
    """resident.py install_fixed (:993): adopt a row from the wire, then
    a homed copy writes its result into its reserved slot rbase + row,
    and dereferenced value args rehydrate into the row's own value
    block (F_VMASK cleared: the wire is its only writer). The row."""
    row = core.install_descriptor(lambda w: row_words[w])
    t, r = core.tasks, row * DESC_WORDS
    if t[r + F_HOME] >= 0:
        t[r + F_OUT] = rk.rbase + row
    if rk.has_vargs:
        mask = t[r + F_VMASK]
        base = core.counts[C_VBASE] + row * VBLOCK
        jj = 0
        for i in range(6):
            if (mask >> i) & 1:
                core.ivalues[base + jj] = t[r + F_A0 + i]
                t[r + F_A0 + i] = base + jj
                jj += 1
        t[r + F_VMASK] = 0
    return row


def mesh_workspace(ndev: int, nports: int, window: int, dev,
                   p_inbox: int = P_INBOX) -> tuple:
    """The steal kernels' ports (zeroed: counters, stat slabs, inboxes)
    and error row, and the words of one port (a row inbox after
    ``p_inbox`` words when ``window``, none when 0)."""
    port_words = p_inbox + ((window + 1) * DESC_WORDS if window else 0)
    ws = torch.zeros(ndev * nports * port_words, dtype=torch.int32,
                     device=dev)
    err = torch.zeros(8, dtype=torch.int32, device=dev)
    return ws, err, port_words


def pgas_layout(ndev: int, nchan: int, amw: int, outq: int, maxw: int
                ) -> Tuple[List[int], int]:
    """The word offset of each section of one device's PGAS workspace
    (csrc/mesh.cuh PG_*, in that order) and the words of a device's
    slice: the outbox cursors, pstate, the message counts sent and
    received and sent this round a target, the put counts sent and
    received a (device, channel), chan_tot, the outbox, the wait table,
    the stat accumulator, the arrival counters a source (messages, then
    puts a channel) and the inbox rings a source. Each section starts on
    a 32-byte boundary."""
    sizes = [8, PS_WORDS, ndev, ndev, ndev, ndev * nchan, ndev * nchan, nchan,
             outq, outq * DESC_WORDS, maxw * 3, stat_words(ndev, nchan),
             ndev, ndev * nchan, ndev * amw * DESC_WORDS]
    assert len(sizes) == PG_SECTIONS
    off, o = [], 0
    for n in sizes:
        off.append(o)
        o += -(-n // 8) * 8
    return off, o


def run_mesh_kernel(kind: str, mk: Megakernel, st: Dict[str, object],
                    wl, abort_arr: np.ndarray, quantum: int,
                    max_rounds: int, window: int, scan: int,
                    hops: Sequence[int], nports: int,
                    timeout_s: float, pgas: Optional[dict] = None,
                    steal: bool = True,
                    inject: Optional[dict] = None,
                    fault: Optional[np.ndarray] = None,
                    obs: Optional[dict] = None) -> Dict[str, Any]:
    """Launch steal kernel ``kind`` (``"ici_ring"`` or
    ``"resident_steal"``; with ``pgas``, the resident kernel's PGAS
    configuration, ``steal`` or not, or ``"pgas_ring"``, PGASMegakernel's
    ring kernel, whose stat slots lie in the ports) over stacked state
    ``st`` on the card, wait for it, and raise if a spin timed out or a
    body broke the protocol. ``pgas`` holds the channels (``chans``: buffer index, rows,
    the buffer's rows, row bytes), ``nchan``, ``amw``, ``outq``, ``maxw``,
    each device's host waits (``waits``) and starting pstate words
    (``pstate``), whether the migrating configuration runs (``home``)
    and the value limit. ``inject`` (the resident kernel's injecting
    instance) holds each device's ring, ictl and tctl rows
    (``ResidentKernel._ring``). ``fault`` (the instance with the fault
    layer): the plan's words (``fault_plan_words``); each device's fault
    workspace is made here, and the stat vector gains the ndev routed
    heartbeats after the backlog. ``obs`` (the observed instance,
    ``resident_kernel<.., kObs>`` or ``ici_ring_kernel<.., kObs>``): the
    recorder's capacity a device (``cap``, 0 for none) and whether the
    quiesce word is compiled in (``ckpt``: a checkpoint build, whose stat
    vector gains the quiesce sum after the backlog and the heartbeats).
    Returns the fault-stats rows (``fstats``), the exchange volume rows
    (``xstats``), the pstate rows at exit (PGAS configurations), the tctl
    echo (a tenant mesh), under ``obs`` the recorder rows (``rings``), the
    exported wait table (``waits``, ``ckpt``) and the ictl echo
    (``ictl``, injecting), and the launch's CUDA-event time
    (``kernel_ms``)."""
    ndev = st["tasks"].shape[0]
    dev = st["tasks"].device
    if not 0 <= scan <= MESH_MAX_SCAN:
        raise ValueError(f"scan must be 0..{MESH_MAX_SCAN}, got {scan}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    mode, threads, smem = mk.mesh_config(steal_kernel=True)
    h, keep = mk.mesh_host(st, quantum, True)
    p_inbox = P_INBOX
    hb = 0 if fault is None else ndev  # the routed heartbeats
    ckpt = int(bool(obs and obs["ckpt"]))  # the quiesce sum
    if pgas is not None:
        nchan = pgas["nchan"]
        S = stat_words(ndev, nchan)
        p_inbox = P_STAT + -(-(S + hb + ckpt) // 8) * 8
        if kind == "pgas_ring":
            # Device d's port holds its stat slot of each round parity;
            # device 0's arrival sector counts every device's publishes.
            S = ring_stat_words(ndev, nchan)
            p_inbox = P_STAT + 2 * (-(-S // 8) * 8)
        off, words = pgas_layout(ndev, nchan, pgas["amw"], pgas["outq"],
                                 pgas["maxw"])
        pg = np.zeros((ndev, words), np.int32)
        for d, wlist in enumerate(pgas["waits"]):
            pg[d, off[1]:off[1] + PS_WORDS] = pgas["pstate"][d]
            for i, w in enumerate(wlist):
                pg[d, off[10] + 3 * i:off[10] + 3 * i + 3] = w
        pg_t = torch.from_numpy(pg).to(dev)
        keep["pg"] = pg_t
        h.pg, h.s_pg = pg_t.data_ptr(), words
        h.nchan, h.amw, h.outq, h.maxw = (nchan, pgas["amw"], pgas["outq"],
                                          pgas["maxw"])
        h.stat_words, h.p_inbox = S, p_inbox
        for c, (b, rows, nrows, rb) in enumerate(pgas["chans"]):
            h.chan_buf[c], h.chan_rows[c] = b, rows
            h.chan_nrows[c], h.chan_row_bytes[c] = nrows, rb
        for i, o in enumerate(off):
            h.pg_off[i] = o
        # alloc_values / free_values stay below the value limit (the
        # resident kernel's migration result slots sit above it); no
        # mesh kernel stages values, so this is num_values's only use.
        h.num_values = int(pgas["value_limit"])
    elif fault is not None or ckpt:
        h.stat_words = STAT_WORDS
        p_inbox = P_STAT + -(-(STAT_WORDS + hb + ckpt) // 8) * 8
    h.p_inbox = p_inbox
    if fault is not None:
        fws = np.zeros((ndev, FW_WORDS), np.int32)
        fws[:, FS_DEAD_ROUND] = fws[:, FS_ABORT_ROUND] = -1
        fws[:, FS_QUIESCE_ROUND] = -1
        fws[:, FW_PAIR_DOWN:FW_PAIR_DOWN + MAX_HOPS] = -1
        keep["fplan"] = torch.from_numpy(fault).to(dev)
        keep["fws"] = torch.from_numpy(fws).to(dev)
        h.fplan, h.fws = keep["fplan"].data_ptr(), keep["fws"].data_ptr()
    ws, err, port_words = mesh_workspace(
        ndev, nports, window if steal else 0, dev, p_inbox)
    wl_t = torch.zeros(32, dtype=torch.int32, device=dev)
    for f in wl:
        wl_t[f] = wl[f] if isinstance(wl, dict) else 1
    abort_t = torch.from_numpy(abort_arr).to(dev)
    fstats = torch.zeros(ndev, FS_WORDS, dtype=torch.int32, device=dev)
    xstats = torch.zeros(ndev, XS_WORDS, dtype=torch.int32, device=dev)
    keep.update(ws=ws, err=err, wl=wl_t, abort=abort_t, fstats=fstats,
                xstats=xstats)
    h.abort, h.ws, h.err = abort_t.data_ptr(), ws.data_ptr(), err.data_ptr()
    h.wl, h.fstats = wl_t.data_ptr(), fstats.data_ptr()
    h.xstats = xstats.data_ptr()
    h.quantum, h.max_rounds = int(quantum), int(max_rounds)
    h.window, h.scan, h.port_words = int(window), int(scan), port_words
    h.nhops = len(hops)
    for i, k in enumerate(hops):
        h.hops[i] = int(k)
    h.timeout_ns = int(timeout_s * 1e9)
    if inject is not None:
        for k, name in (("ring", "iring"), ("ictl", "ictl"),
                        ("tctl", "tctl")):
            if inject[k] is not None:
                keep[name] = torch.from_numpy(inject[k]).to(dev)
                setattr(h, name, keep[name].data_ptr())
        h.ring_rows = inject["ring"].shape[1]
        h.ntenants, h.region = inject["T"], inject["region"]
    if obs:
        if obs["cap"]:
            keep["rings"] = torch.zeros(ndev, HDR + TR_WORDS * obs["cap"],
                                        dtype=torch.int32, device=dev)
            h.ring, h.tr_cap = keep["rings"].data_ptr(), obs["cap"]
        h.ckpt = ckpt
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    mk.mesh_launch(kind, h, mode, threads, smem, dev, pgas=pgas is not None,
                   steal=steal, home=bool(pgas and pgas["home"]),
                   inject=inject is not None, fault=fault is not None,
                   obs=bool(obs))
    t1.record()
    t1.synchronize()
    e = err.cpu().tolist()
    if e[0]:
        if e[5] in _FAULTS:
            raise RuntimeError(
                f"{kind}: device {e[2]} stopped the mesh at round {e[3]}: "
                f"{_FAULTS[e[5]]}")
        raise RuntimeError(
            f"{kind}: device {e[2]} timed out after {timeout_s} s waiting "
            f"for a {_WAITS.get(e[5], e[5])} at round {e[3]}, hop {e[4]}; "
            "the mesh stopped")
    mk.fold_dispatches(keep["dispatch"].sum(0, dtype=torch.int32))
    out = {"fstats": fstats.cpu().numpy(), "xstats": xstats.cpu().numpy(),
           "kernel_ms": t0.elapsed_time(t1)}
    if pgas is not None:
        out["pstate"] = keep["pg"][:, off[1]:off[1] + PS_WORDS].cpu().numpy()
    if "tctl" in keep:
        out["tctl"] = keep["tctl"].cpu().numpy()
    if obs:
        if "rings" in keep:
            out["rings"] = keep["rings"].cpu().numpy()
        if inject is not None:
            out["ictl"] = keep["ictl"].cpu().numpy()
        if ckpt:
            # The wait table the run leaves (its needs rebased, as
            # resident.py exports it), from each device's workspace.
            tables = []
            if pgas is not None:
                pg_o = keep["pg"].cpu().numpy()
                for d in range(ndev):
                    n = int(pg_o[d, off[1] + PS_NWAIT])
                    w = pg_o[d, off[10]:off[10] + 3 * n].reshape(n, 3)
                    tables.append((w.tolist(), pg_o[d, off[7]:off[8]]))
            out["waits"] = export_waits(tables, ndev, pgas["maxw"]
                                        if pgas is not None else obs["maxw"])
    return out


def exchange_info(out: Dict[str, Any]) -> Dict[str, Any]:
    """A steal kernel's exchange volume (rows exported, stat words sent,
    and the active messages and puts sent, per device) and its time: the
    launch's CUDA-event time on the card, the plain version's wall time
    on the CPU."""
    xs = np.asarray(out["xstats"])
    return {"rows": xs[:, XS_ROWS].tolist(),
            "stat_words": xs[:, XS_STAT_WORDS].tolist(),
            "ams": xs[:, XS_AMS].tolist(),
            "puts": xs[:, XS_PUTS].tolist(),
            "kernel_ms": float(out["kernel_ms"])}


class _PlainPgas:
    """One device's PGAS state and operations over its plain core
    (resident.py's outbox, message and put counts, chan_tot, pstate and
    wait table; op_put, op_am, op_wait_until, op_count, the atomics and
    locks op_fadd, op_fadd_get, op_cswap, op_lock, op_unlock, and the
    round's drains with handle_am's built-in kinds): what ``ctx.pgas``
    is on the CPU."""

    def __init__(self, rk: "ResidentKernel", core: _PlainCore, me: int,
                 data: Dict[str, torch.Tensor], waits, peers: list):
        ndev, nc = rk.ndev, rk.nchan
        self.rk, self.core, self.data, self.peers = rk, core, data, peers
        self.me, self.ndev, self.nchan = me, ndev, len(rk.channels)
        self.outq: List[Tuple[int, List[int]]] = []  # the live outbox
        self.am_sent = [0] * ndev
        self.am_recv = [0] * ndev
        self.data_sent = [[0] * nc for _ in range(ndev)]
        self.chan_recv = [[0] * nc for _ in range(ndev)]
        self.chan_tot = [0] * nc
        self.ps = rk.pstate_words(len(waits))
        self.waits = [list(w) for w in waits]
        # inbox[src][slot]: the rows source src sent here, am_window slots.
        self.inbox = [[None] * rk.am_window for _ in range(ndev)]

    def put(self, dev: int, chan: int, dst_row: int, src_row: int) -> None:
        """One-sided write of channel ``chan``'s rows from my buffer's
        ``src_row`` into device ``dev``'s at ``dst_row``; the target sees
        it (``count``, ``wait_until``) once the fold announced it."""
        if not 0 <= chan < len(self.rk.channels):
            raise ValueError(
                f"channel id {chan} not configured (have "
                f"{len(self.rk.channels)}): a kernel using ctx.pgas.put "
                "needs its channel declared in ResidentKernel(channels=)")
        self._target(dev, "put")
        bname, rows = self.rk.channels[chan]
        buf = self.data[bname]
        if not (0 <= src_row and 0 <= dst_row
                and max(src_row, dst_row) + rows <= buf.shape[1]):
            raise ValueError(f"put of rows [{src_row}, +{rows}) -> "
                             f"[{dst_row}, +{rows}) outside {bname!r}")
        buf[dev, dst_row:dst_row + rows] = buf[self.me,
                                               src_row:src_row + rows]
        self.data_sent[dev][chan] += 1
        self.ps[PS_SENT] += 1

    def _target(self, dev: int, what: str) -> None:
        if not 0 <= dev < self.ndev:
            raise ValueError(f"{what} to device {dev} outside the mesh")

    def am(self, dev: int, fn: int, args: Sequence[int] = (),
           out: int = 0) -> None:
        """Queue a task descriptor of user kind ``fn`` for device
        ``dev``'s scheduler (sent by the round's drain_outbox); OVF_OUTBOX
        when the outbox is full. The built-in kinds (fn < 0) are sent by
        the atomics and locks below, never named here."""
        if len(args) > 6:
            raise ValueError("at most 6 args per AM")
        if fn < 0:
            raise ValueError(
                f"ctx.pgas.am of kind {fn}: the built-in kinds (fn < 0) "
                "are sent by ctx.pgas.fadd, fadd_get, cswap, lock and "
                "unlock")
        self._target(dev, "active message")
        self.send(dev, fn, args, out)

    def send(self, dev: int, fn: int, args: Sequence[int] = (),
             out: int = 0) -> None:
        """op_am: the row into the outbox, any kind."""
        if len(self.outq) >= self.rk.outbox:
            self.core.counts[C_OVERFLOW] |= OVF_OUTBOX
            return
        row = [0] * DESC_WORDS
        row[F_FN] = fn
        row[F_SUCC0] = row[F_SUCC1] = NO_TASK
        for i, a in enumerate(args):
            row[F_A0 + i] = _i32(int(a))
        row[F_OUT] = out
        row[F_HOME] = NO_TASK
        row[F_HROW] = row[F_CSR_OFF] = row[F_VMASK] = 0
        self.outq.append((dev, row))

    def wait_until(self, chan: int, need: int, row: int) -> None:
        """Park row ``row`` (spawned with one extra dependency) until
        ``need`` puts have been announced on channel ``chan``."""
        if len(self.waits) < self.rk.max_waits:
            self.waits.append([chan, need, row])
            self.ps[PS_NWAIT] = len(self.waits)
        else:
            self.core.counts[C_OVERFLOW] |= OVF_WAITS

    def count(self, chan: int) -> int:
        """The puts announced on channel ``chan`` so far."""
        return self.chan_tot[chan]

    def fadd(self, dev: int, slot: int, delta: int) -> None:
        """Fire-and-forget fetch-add of device ``dev``'s value slot,
        applied by its owner's scheduler."""
        self._target(dev, "fadd")
        self.send(dev, RC_FADD, (slot, delta))

    def fadd_get(self, dev: int, slot: int, delta: int, row: int,
                 rslot: int) -> None:
        """Fetch-add whose OLD value lands in my slot ``rslot`` and
        dep-decrements my parked row ``row`` (spawned with one extra
        dependency)."""
        self._target(dev, "fadd_get")
        self.send(dev, RC_FADD_R, (slot, delta, self.me, row, rslot))

    def cswap(self, dev: int, slot: int, expected: int, new: int, row: int,
              rslot: int) -> None:
        """Compare-swap of device ``dev``'s slot; the old value replies to
        (row, rslot) as fadd_get's. ``me`` is the wire's source word (the
        owner replies to it)."""
        self._target(dev, "cswap")
        self.send(dev, RC_CSWAP, (slot, expected, new, self.me, row, rslot))

    def lock(self, dev: int, lbase: int, row: int, qcap: int) -> None:
        """Acquire the lock block at ``lbase`` on ``dev``
        (``lock_block_slots(qcap)`` slots); parked row ``row`` (one extra
        dependency) is dep-decremented when the lock is granted."""
        self._target(dev, "lock")
        self.send(dev, RC_LOCK, (lbase, self.me, row, qcap))

    def unlock(self, dev: int, lbase: int, qcap: int) -> None:
        """Release the lock block, or hand it to the next waiter."""
        self._target(dev, "unlock")
        self.send(dev, RC_UNLOCK, (lbase, qcap))

    def drain_outbox(self) -> None:
        """Send the outbox FIFO, at most am_window // 2 a target this
        round; a capped head waits for the next round with what follows."""
        amw = self.rk.am_window
        sent_round = [0] * self.ndev
        n = 0
        for t, row in self.outq:
            if sent_round[t] >= amw // 2:
                break
            self.peers[t].inbox[self.me][self.am_sent[t] % amw] = row
            self.am_sent[t] += 1
            sent_round[t] += 1
            self.ps[PS_SENT] += 1
            n += 1
        del self.outq[:n]

    def dep_dec(self, row: int) -> None:
        t = self.core.tasks
        d = t[row * DESC_WORDS + F_DEP] - 1
        t[row * DESC_WORDS + F_DEP] = d
        if d == 0:
            self.core.push_ready(row)

    def handle_am(self, row: List[int]) -> None:
        """handle_am (:1231): a user kind installs (install_fixed); a
        built-in kind is applied here by the owner's serial scheduler,
        which is what makes the atomics atomic."""
        fn = row[F_FN]
        a = row[F_A0:F_A0 + 6]
        iv, c = self.core.ivalues, self.core.counts
        if fn >= 0:
            install_fixed(self.core, row, self.rk)
            return
        if RC_GRANT <= fn <= RC_COMPLETE:
            self.ps[PS_AMS - 2 - fn] += 1
        if fn == RC_COMPLETE:
            iv[self.core.tasks[a[0] * DESC_WORDS + F_OUT]] = a[1]
            self.core.complete(a[0])
            c[C_EXECUTED] -= 1  # the execution was counted on the thief
            self.ps[PS_PROXIES] -= 1
        elif fn == RC_FADD:
            iv[a[0]] = _i32(iv[a[0]] + a[1])
        elif fn == RC_FADD_R:
            old = iv[a[0]]
            iv[a[0]] = _i32(old + a[1])
            self.send(a[2], RC_REPLY, (a[3], old, a[4]))
        elif fn == RC_CSWAP:
            old = iv[a[0]]
            iv[a[0]] = a[2] if old == a[1] else old
            self.send(a[3], RC_REPLY, (a[4], old, a[5]))
        elif fn == RC_REPLY:
            iv[a[2]] = a[1]
            self.dep_dec(a[0])
        elif fn == RC_LOCK:
            lbase, src, prow, qcap = a[:4]
            if iv[lbase] == 0:
                iv[lbase] = 1
                self.send(src, RC_GRANT, (prow,))
            else:
                qlen, hq = iv[lbase + 1], iv[lbase + 2]
                if qlen < qcap:
                    pos = lbase + 3 + 2 * ((hq + qlen) % qcap)
                    iv[pos], iv[pos + 1] = src, prow
                    iv[lbase + 1] = qlen + 1
                else:
                    c[C_OVERFLOW] |= OVF_LOCKQ
        elif fn == RC_UNLOCK:
            lbase, qcap = a[:2]
            qlen = iv[lbase + 1]
            if qlen == 0:
                iv[lbase] = 0
            elif qlen > 0:
                hq = iv[lbase + 2]
                pos = lbase + 3 + 2 * (hq % qcap)
                iv[lbase + 2] = (hq + 1) % qcap
                iv[lbase + 1] = qlen - 1
                # The lock stays held: the next waiter has it.
                self.send(iv[pos], RC_GRANT, (iv[pos + 1],))
        elif fn == RC_GRANT:
            self.dep_dec(a[0])

    def drain_receives(self, am_exp: List[int], put_exp) -> None:
        """Take exactly what the fold announced from each source: puts
        into chan_tot, then the messages (handle_am), sources in me ^ p
        order."""
        for c in range(self.rk.nchan):
            for p in range(self.ndev):
                src = self.me ^ p
                delta = put_exp[src][c] - self.chan_recv[src][c]
                self.chan_recv[src][c] = put_exp[src][c]
                self.chan_tot[c] += delta
                self.ps[PS_RECV] += delta
        amw = self.rk.am_window
        for p in range(self.ndev):
            src = self.me ^ p
            base = self.am_recv[src]
            for i in range(am_exp[src] - base):
                self.handle_am(self.inbox[src][(base + i) % amw])
            self.ps[PS_RECV] += am_exp[src] - base
            self.am_recv[src] = am_exp[src]

    def scan_waits(self) -> None:
        """Release each parked row whose channel reached its need; keep
        the rest in order."""
        kept = []
        for ch, need, row in self.waits:
            if self.chan_tot[ch] >= need:
                self.dep_dec(row)
            else:
                kept.append([ch, need, row])
        self.waits = kept
        self.ps[PS_NWAIT] = len(kept)


class _PlainRing:
    """One device's injection ring and its poll (resident.py poll :1404
    and tpoll :1458): the rows of ``ring`` (``(R, RING_ROW)``), the
    consumed cursor, and on a tenant mesh the device's ``(T, 8)`` tctl
    rows, mutated in place into the echo. A quiescing round consumes
    nothing (the unread rows are the exported residue); the recorder
    gets a TR_TENANT record a row dropped expired (a lane with work, on a
    tenant mesh) and a TR_INJECT record a poll that installed rows."""

    def __init__(self, rk: "ResidentKernel", core: _PlainCore, fs, inj,
                 d: int):
        self.core, self.fs, self.ictl = core, fs, inj["ictl"][d]
        self.ring = inj["ring"][d]
        self.T, self.region = inj["T"], inj["region"]
        self.tctl = None if inj["tctl"] is None else inj["tctl"][d]
        self.consumed = int(self.ictl[2])
        # The steal-only configuration adopts rows through the core's
        # install_descriptor; the PGAS ones through install_fixed.
        self.install = ((lambda row: install_fixed(core, row, rk)) if rk.pgas
                        else (lambda row: core.install_descriptor(
                            lambda w: row[w])))

    def _take(self, slot: int) -> bool:
        """Install ring row ``slot``, or drop it (counted) when the host
        marked it expired; True when it installed."""
        row = self.ring[slot]
        if row[TEN_EXPIRED] != 0:
            return False
        self.install(row[:DESC_WORDS].tolist())
        return True

    def poll(self, r: int, quiescing: bool) -> int:
        """This round's poll; returns the ring backlog it leaves (the
        fold's SF_INJ word)."""
        tr = self.core.tr
        if self.tctl is None:
            tail = int(self.ictl[0])  # re-read every round
            c0 = self.consumed
            for c in range(c0, c0 if quiescing else tail):
                if not self._take(c):
                    self.fs[FS_TEN_EXPIRED] += 1
                    tr.emit(TR_TENANT, tr.now(),
                            int(self.ring[c, TEN_ID]) << 16, 1)
            if not quiescing:
                self.consumed = max(c0, tail)
            if self.consumed > c0:
                tr.emit(TR_INJECT, tr.now(), self.consumed - c0)
            return tail - self.consumed
        tc, T, region = self.tctl, self.T, self.region
        newly = 0
        for k in range(T):
            lane = (r + k) % T
            tail, cons = int(tc[lane, TC_TAIL]), int(tc[lane, TC_CONSUMED])
            paused = tc[lane, TC_PAUSE] != 0
            avail = tail - cons
            take = 0 if paused or quiescing else min(
                int(tc[lane, TC_WEIGHT]), avail, self.core.headroom())
            c, inst, exp = cons, 0, 0
            while c < cons + take:
                if self._take(lane * region + c):
                    inst += 1
                else:
                    exp += 1
                c += 1
            sweep = paused and not quiescing
            tc[lane, TC_CONSUMED] = tail if sweep else c
            if sweep:
                tc[lane, TC_DROPPED] += avail
            tc[lane, TC_INSTALLED] += inst
            tc[lane, TC_EXPIRED] += exp
            self.fs[FS_TEN_EXPIRED] += exp
            if inst or exp:
                tr.emit(TR_TENANT, tr.now(), (lane << 16) | inst, exp)
            newly += inst
        if newly:
            tr.emit(TR_INJECT, tr.now(), newly)
        return int((tc[:, TC_TAIL] - tc[:, TC_CONSUMED]).sum())


def _plain_resident(rk: "ResidentKernel", st, wl, abort_arr, quantum: int,
                    max_rounds: int, hop_bits: Sequence[int],
                    waits, inj: Optional[dict] = None) -> Dict[str, Any]:
    """The plain version of the resident kernel: every device's round in
    lockstep over the plain cores (the PGAS state of each on its core's
    ``pgas`` under a PGAS configuration; the migrating configuration's
    export, install_fixed and completion hook; with ``inj``, each
    device's ring poll after its sched; under a fault plan, the faulty
    row exchange and heartbeat detection; in a checkpoint build, the
    quiesce word of ``abort_arr`` words 1-2; with a traced table, each
    device's flight recorder). Returns the FS and XS rows, the pstate
    rows (PGAS configurations), the tctl echo (a tenant mesh), the
    recorder rows (``rings``), the exported wait table (``waits``, a
    checkpoint build), the ictl echo (``ictl``, an injecting mesh) and
    the wall time (``kernel_ms``)."""
    t0 = time.perf_counter()
    mk, window, scan = rk.mk, rk.window, rk.scan
    ndev = st["tasks"].shape[0]
    cores = [_PlainCore(mk, mesh_slice(st, d)) for d in range(ndev)]
    cap_tr = mk.trace.capacity if mk.trace is not None else 0
    rings_tr = [[0] * (HDR + TR_WORDS * cap_tr) for _ in range(ndev)]
    for d, c in enumerate(cores):
        if cap_tr:
            c.tr = Tracer(rings_tr[d], cap_tr)  # the core's and the mesh's
        c.stage(True)
        c.value_limit = rk.rbase
    pgs: List[_PlainPgas] = []
    if rk.pgas:
        for d, c in enumerate(cores):
            c.pgas = _PlainPgas(rk, c, d, st["data"], waits[d], pgs)
            pgs.append(c.pgas)
            if rk.homed_mig:
                c.complete_hook = _completion_hook(c, c.pgas)
    nsw = stat_words(ndev, rk.nchan) if rk.pgas else STAT_WORDS
    ckpt = rk.checkpoint
    nsw += int(ckpt)  # the quiesce sum (SF_QUIESCE)
    plan = rk.plan
    if plan is not None:
        # The fault layer's state a device (resident.py :686-694): per hop
        # bit the last round of the pair's down window and the credits
        # owed; per peer the heartbeat last seen, the round it last moved
        # and the quarantine flag; its heartbeat and the wedge flag.
        F = _Faults(plan, ndev, rk.nh)
        nsw += ndev  # the routed heartbeats
        ct = plan.credit_timeout
        pair_down = [[-1] * MAX_HOPS for _ in range(ndev)]
        owed = [[0] * MAX_HOPS for _ in range(ndev)]
        hb_seen = [[0] * ndev for _ in range(ndev)]
        hb_round = [[0] * ndev for _ in range(ndev)]
        deadmask = [[0] * ndev for _ in range(ndev)]
        hb = [0] * ndev
        wedge = 0  # raised on every device at once
    fs = np.zeros((ndev, FS_WORDS), np.int32)
    fs[:, FS_DEAD_ROUND] = -1
    fs[:, FS_ABORT_ROUND] = -1
    fs[:, FS_QUIESCE_ROUND] = -1
    xs = np.zeros((ndev, XS_WORDS), np.int32)
    starve_below = min(quantum, window)
    if inj is not None and inj["tctl"] is not None:
        inj = dict(inj, tctl=inj["tctl"].copy())
    rings = ([] if inj is None
             else [_PlainRing(rk, c, fs[d], inj, d)
                   for d, c in enumerate(cores)])
    # Each device's sticky quiesce (resident.py PS_QUIESCE): set once the
    # fold carried the quiesce word; it holds the scheduler from then on.
    held = [False] * ndev

    def backlog(c):
        return c.counts[C_TAIL] - c.counts[C_HEAD]

    r, done = 0, False
    while not done and r < max_rounds:
        local_abort = [int(abort_arr[d, 0] != 0) for d in range(ndev)]
        # The quiesce word (checkpoint builds): every device compares the
        # same round with its threshold, so the cut is lockstep.
        local_q = [ckpt and abort_arr[d, 1] != 0 and r >= abort_arr[d, 2]
                   for d in range(ndev)]
        quiescing = [local_q[d] or held[d] for d in range(ndev)]
        # A dead device's scheduler runs no task and its heartbeat stops;
        # its exchange stays up. A quiescing one pops nothing.
        dead = [plan is not None and F.dead(d, r) for d in range(ndev)]
        for d, c in enumerate(cores):
            c.sched(0 if dead[d] or quiescing[d] else quantum)
            if plan is not None and not dead[d]:
                hb[d] += 1
        inj_backlog = sum(ring.poll(r, quiescing[d])
                          for d, ring in enumerate(rings))
        for pg in pgs:
            pg.drain_outbox()
        # The fold's sums (every device ends with the same ones), and
        # what each source announced to each target this round.
        tot = [sum(c.counts[C_PENDING] for c in cores), 0, 0, 0,
               inj_backlog, sum(local_abort),
               ndev * wedge if plan is not None else 0]
        tot_q = sum(local_q)
        if pgs:
            tot[SF_RECV] = sum(pg.ps[PS_RECV] for pg in pgs)
            tot[SF_OUTB] = sum(len(pg.outq) for pg in pgs)
            tot[SF_SENT] = sum(pg.ps[PS_SENT] for pg in pgs)
            am_exp = [[pgs[s].am_sent[v] for s in range(ndev)]
                      for v in range(ndev)]
            put_exp = [[list(pgs[s].data_sent[v]) for s in range(ndev)]
                       for v in range(ndev)]
        for k in hop_bits:
            xs[:, XS_STAT_WORDS] += nsw
            if not rk.steal:
                continue
            snd = [backlog(c) for c in cores]
            boxes = []
            for d, c in enumerate(cores):
                peer_b, myb = snd[d ^ (1 << k)], backlog(c)
                tr = c.tr
                quota = (min(max((myb - peer_b + 1) // 2, 0), window)
                         if peer_b < starve_below else 0)
                if plan is not None:
                    # A down pair (a starvation window, or the wedge)
                    # skips the hop's row exchange on both sides.
                    if r <= pair_down[d][k] or wedge:
                        boxes.append(None)
                        continue
                    delay = F.delay(r, k, d)
                    fs[d, FS_DELAYED] += delay
                    if delay:
                        quota = 0
                        tr.emit(TR_FAULT, tr.now(), FLT_DELAY, k)
                    if plan.dead_device is not None:
                        # Quarantine: no rows to a dead partner; the dead
                        # device re-homes its backlog whatever the demand.
                        if deadmask[d][d ^ (1 << k)]:
                            quota = 0
                        if dead[d]:
                            quota = min(max(myb, 0), window)
                if quota <= 0:
                    boxes.append([])
                elif rk.migrating:
                    boxes.append(export_migrating(c, quota, pgs[d], xs[d]))
                else:
                    boxes.append(export_rows(c, quota, scan, wl, True,
                                             xs[d]))
                if boxes[d]:
                    tr.emit(TR_XFER, tr.now(), d ^ (1 << k), len(boxes[d]))
                if dead[d]:
                    fs[d, FS_REHOMED] += len(boxes[d])
            for d, c in enumerate(cores):
                if boxes[d] is None:
                    continue
                p, tr = d ^ (1 << k), c.tr
                if plan is not None:
                    # The credit wait; one is skipped a credit owed
                    # (regeneration).
                    if r > 0 and owed[d][k] > 0:
                        owed[d][k] -= 1
                        fs[d, FS_REGEN] += 1
                        tr.emit(TR_CREDIT, tr.now(), (k << 8) | p,
                                CR_REGENERATED)
                if rk.migrating:
                    for row in boxes[p]:
                        install_fixed(c, row, rk)
                else:
                    import_rows(c, boxes[p])
                if plan is not None:
                    # The credit I owe my partner (dropped, doubled), and
                    # the partner's decision on the one it owes me.
                    drop_mine, drop_theirs = F.drop(r, k, p), F.drop(r, k, d)
                    if drop_theirs:
                        fs[d, FS_DROPPED] += 1
                        tr.emit(TR_CREDIT, tr.now(), (k << 8) | p,
                                CR_DROPPED)
                    elif F.dup(r, k, d):
                        fs[d, FS_DUPED] += 1
                        tr.emit(TR_CREDIT, tr.now(), (k << 8) | p, CR_DUPED)
                    if drop_mine:
                        owed[d][k] += 1
                        if ct == 0 and fs[d, FS_STARVED] == 0:
                            fs[d, FS_STARVED] = ((k << 8) | p) + 1
                    if ct > 0 and (drop_mine or drop_theirs):
                        pair_down[d][k] = r + ct
        if plan is not None and plan.dead_device is not None:
            # Heartbeat detection: quarantine a peer whose heartbeat has
            # not moved for heartbeat_timeout rounds (peers in me ^ p
            # order, as the routed words sit).
            for d in range(ndev):
                tr = cores[d].tr
                for q in range(ndev):
                    src = d ^ q
                    if hb[src] != hb_seen[d][src]:
                        hb_round[d][src] = r
                    hb_seen[d][src] = hb[src]
                    if (src != d and not deadmask[d][src]
                            and r - hb_round[d][src] >= plan.heartbeat_timeout):
                        deadmask[d][src] = 1
                        fs[d, FS_QMASK] |= 1 << src
                        if fs[d, FS_DEAD_ROUND] < 0:
                            fs[d, FS_DEAD_ROUND] = r
                        tr.emit(TR_FAULT, tr.now(), FLT_DEAD_QUARANTINE,
                                src)
        aborted = tot[SF_ABORT] > 0
        folded_q = tot_q > 0
        for d, c in enumerate(cores):
            tr = c.tr
            if aborted and fs[d, FS_ABORT_ROUND] < 0:
                fs[d, FS_ABORT_ROUND] = r
                tr.emit(TR_ABORT, tr.now(), r)
            if folded_q and fs[d, FS_QUIESCE_ROUND] < 0:
                fs[d, FS_QUIESCE_ROUND] = r
                tr.emit(TR_QUIESCE, tr.now(), r)
            held[d] = held[d] or folded_q
        # The clean cut: quiesced and nothing on the wire (the ring
        # residue stays, so SF_INJ does not gate it).
        settled = folded_q and tot[SF_OUTB] == 0 and (
            tot[SF_SENT] == tot[SF_RECV])
        done = (tot[SF_PEND] == 0 and tot[SF_INJ] == 0) or aborted
        if plan is not None:
            done = done or tot[SF_WEDGE] > 0
            wedge = wedge or int(F.wedges(r))
        if pgs:
            done = (tot[SF_PEND] == 0 and tot[SF_OUTB] == 0
                    and tot[SF_INJ] == 0
                    and tot[SF_SENT] == tot[SF_RECV]) or aborted or (
                        tot[SF_WEDGE] > 0)
            for v, pg in enumerate(pgs):
                pg.drain_receives(am_exp[v], put_exp[v])
                pg.scan_waits()
        done = done or settled
        r += 1
    if plan is not None:
        fs[:, FS_HB] = hb
    for d, c in enumerate(cores):
        c.counts[C_ROUNDS] = r
        if held[d]:
            # The state-export record of a quiesced launch.
            c.tr.emit(TR_CKPT, c.tr.now(), c.counts[C_PENDING], backlog(c))
        c.write_back()
        if pgs:
            xs[d, XS_AMS] = sum(pgs[d].am_sent)
            xs[d, XS_PUTS] = sum(map(sum, pgs[d].data_sent))
    out = {"fstats": fs, "xstats": xs,
           "kernel_ms": (time.perf_counter() - t0) * 1e3}
    if pgs:
        out["pstate"] = np.array([pg.ps for pg in pgs], np.int32)
    if inj is not None and inj["tctl"] is not None:
        out["tctl"] = inj["tctl"]
    if cap_tr:
        out["rings"] = np.array(rings_tr, np.int32)
    if ckpt:
        out["waits"] = export_waits(
            [(pg.waits, pg.chan_tot) for pg in pgs], ndev, rk.max_waits)
    if inj is not None:
        ictl = np.zeros((ndev, 8), np.int32)
        ictl[:, :2] = inj["ictl"][:, :2]
        ictl[:, 2] = [ring.consumed for ring in rings]
        out["ictl"] = ictl
    return out


def export_waits(tables, ndev: int, max_waits: int) -> np.ndarray:
    """resident.py's exit export of the wait table (:2049-2063): each
    device's ``(max_waits + 1, 3)`` block, row 0 the count and rows 1..
    the live waits (channel, need rebased to need - chan_tot, row),
    zeros past the count. ``tables``: each device's (waits, chan_tot),
    none without a PGAS configuration (no wait can be parked there)."""
    out = np.zeros((ndev, max_waits + 1, 3), np.int32)
    for d, (wl, tot) in enumerate(tables):
        out[d, 0, 0] = len(wl)
        for i, (ch, need, row) in enumerate(wl):
            out[d, 1 + i] = (ch, need - tot[ch], row)
    return out


def _completion_hook(core: _PlainCore, pg: _PlainPgas):
    """resident.py complete_hook (:914): a migrated chain's last task (its
    row carries the home link) forwards its result to the home proxy in
    an RC_COMPLETE message, at the top of its completion."""
    t = core.tasks

    def hook(idx: int) -> None:
        r = idx * DESC_WORDS
        if t[r + F_HOME] >= 0:
            pg.send(t[r + F_HOME], RC_COMPLETE,
                    (t[r + F_HROW], core.ivalues[t[r + F_OUT]]))
    return hook


class ResidentKernel:
    """One resident scheduler per device of a 1D/2D/3D mesh with
    power-of-two axes (``parallel.mesh.CtaMesh``): ``steal=True`` moves
    ready rows of ``migratable_fns`` (kernel-table ids, or ``{id:
    (value_arg_index, ...)}`` naming the args that are value-slot
    references, dereferenced at export): link-free rows whole, and with
    ``homed`` (the default) rows with links as homed copies under the
    home-link protocol, at most ``proxy_cap`` live proxies a device
    (default ``max(8, capacity // 4)``); ``channels`` (``{name:
    (data_buffer, rows)}``, as PGASMegakernel) or ``steal=False`` give the
    bodies ``ctx.pgas``: one-sided puts of ``rows`` rows of a channel's
    buffer, active messages under a per-(source, target) inbox of
    ``am_window`` rows and an ``outbox`` of queued messages, and
    wait-untils in a table of ``max_waits`` entries. Devices are
    numbered by row-major flattening; the XOR hop bits of a multi-axis
    mesh flip the minor axis first, as in JAX. ``window`` bounds rows a
    hop, ``scan`` how far past the ring head the export looks (default
    2 * window)."""

    def __init__(
        self,
        mk: Megakernel,
        mesh,
        *,
        steal: bool = True,
        migratable_fns: Union[Iterable[int], Dict[int, Sequence[int]]] = (),
        homed: bool = True,
        channels: Optional[Dict[str, Tuple[str, int]]] = None,
        inject: bool = False,
        window: int = 8,
        scan: Optional[int] = None,
        am_window: int = 8,
        outbox: int = 256,
        max_waits: int = 64,
        ring_capacity: int = 256,
        proxy_cap: Optional[int] = None,
        fault_plan=None,
        tenants=None,
    ) -> None:
        if len(mesh.axis_names) not in (1, 2, 3):
            raise ValueError(
                "ResidentKernel wants a 1D/2D/3D mesh (TPU slices are at "
                "most 3D tori)"
            )
        dims = tuple(int(d) for d in mesh.dims)
        for d in dims:
            if d & (d - 1):
                raise ValueError(
                    f"mesh axes must be power-of-two, got {dims} (non-pof2 "
                    "1D meshes: use ICIStealMegakernel)"
                )
        if am_window < 2:
            raise ValueError("am_window must be >= 2")
        self.mk = mk
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.dims = dims
        self.ndev = int(np.prod(dims))
        self.nh = self.ndev.bit_length() - 1  # log2 hops (0 for 1 device)
        self.steal = bool(steal)
        self.homed = bool(homed)
        if isinstance(migratable_fns, dict):
            self.migratable: Dict[int, Tuple[int, ...]] = {
                int(f): tuple(int(i) for i in v)
                for f, v in migratable_fns.items()
            }
        else:
            self.migratable = {int(f): () for f in migratable_fns}
        bad = [f for f in self.migratable
               if not 0 <= f < len(mk.kernel_names)]
        if bad:
            raise ValueError(
                f"migratable_fns {sorted(bad)} outside the kernel "
                f"table (0..{len(mk.kernel_names) - 1})"
            )
        for f, vargs in self.migratable.items():
            if len(vargs) > VBLOCK:
                raise ValueError(
                    f"kernel {f}: at most {VBLOCK} value args (rehydration "
                    "uses the row's own value block)"
                )
            if vargs and not mk.uses_row_values:
                raise ValueError(
                    "value-arg rehydration needs uses_row_values=True "
                    "(arriving rows rehydrate into their own row block)"
                )
        # Compiled-in fault injection (None: no fault layer).
        self.plan = (fault_plan if fault_plan is not None
                     and fault_plan.enabled() else None)
        if self.plan is not None:
            if inject or tenants is not None:
                raise _later("fault_plan= on an injecting or tenant mesh "
                             "(ROADMAP A11b.5)")
            if not self.steal:
                raise ValueError(
                    "DeviceFaultPlan faults target the steal exchange "
                    "(credits, dead-chip re-homing): needs steal=True")
            if self.ndev > 31:
                raise ValueError(
                    f"DeviceFaultPlan supports at most 31 devices (the "
                    f"quarantine bitmask is one int32 stats word), got "
                    f"{self.ndev}")
            if self.plan.dead_device is not None and not (
                    0 <= self.plan.dead_device < self.ndev):
                raise ValueError(
                    f"dead_device {self.plan.dead_device} out of range for "
                    f"a {self.ndev}-device mesh")
        # A checkpoint build compiles the quiesce word into the round
        # loop (its stat vector gains the SF_QUIESCE sum) and exports the
        # wait table; a traced table gives every device a recorder.
        self.checkpoint = bool(mk.checkpoint)
        self.channels, self.chan_id = parse_channels(mk, channels)
        self.nchan = max(1, len(self.channels))
        # The injection ring; with tenants=, T lane regions of
        # region_rows rows a device (the ring is exactly their
        # concatenation) and a (T, 8) tctl block a device.
        self.inject = bool(inject)
        self.ring_capacity = -(-int(ring_capacity) // 8) * 8
        specs = normalize_mesh_tenants(tenants)
        if specs is not None and not self.inject:
            raise ValueError(
                "tenants= partitions the injection ring into per-tenant "
                "regions: needs inject=True")
        self.tenant_specs = specs
        self.T = 0 if specs is None else len(specs)
        self.region_rows = 0
        if self.T:
            self.region_rows = -(-self.ring_capacity // (8 * self.T)) * 8
            self.ring_capacity = self.T * self.region_rows
        # Homed migration (JAX's migratable and homed): the scheduler
        # keeps home links, and one result slot a row is reserved at the
        # top of the value buffer, [rbase, num_values), below which
        # dynamic value allocation stays.
        self.homed_mig = bool(self.migratable) and self.homed
        if self.homed_mig:
            mk.tracks_home = True
        self.vmask = {f: sum(1 << i for i in set(v))
                      for f, v in self.migratable.items()}
        self.has_vargs = any(self.vmask.values())
        # The migrating configuration: homed copies with their proxies
        # and completions, or value args dereferenced on the wire. It
        # runs on the PGAS configuration's outbox, inbox and stat vector
        # even without channels (a completion is an active message).
        self.migrating = self.steal and (self.homed_mig or self.has_vargs)
        # The PGAS configurations: ctx.pgas, the outbox and receive
        # drains, the stat vector's all-to-all section and the wait table.
        self.pgas = (not self.steal or bool(self.channels)
                     or self.migrating)
        # Above this many live proxies a device stops exporting
        # dependency-bearing rows (link-free rows still move).
        self.proxy_cap = (int(proxy_cap) if proxy_cap is not None
                          else max(8, mk.capacity // 4))
        self.rbase = (mk.num_values - mk.capacity if self.homed_mig
                      else mk.num_values)
        if self.rbase <= 0:
            raise ValueError(
                "migration needs num_values > capacity (one result slot "
                "per row is reserved at the top of the value buffer)")
        self.window = int(window)
        self.scan = int(scan) if scan is not None else 2 * self.window
        self.am_window = int(am_window)
        self.outbox = int(outbox)
        self.max_waits = int(max_waits)
        self.timeout_s = SPIN_TIMEOUT_S

    def pstate_words(self, nwait: int) -> List[int]:
        """A device's pstate words at the start of a run (``PS_*``): its
        host waits, and the configuration words the card's kernel reads
        (the proxy budget, homed, rbase, home tracking, value args)."""
        ps = [0] * PS_WORDS
        ps[PS_NWAIT] = nwait
        ps[PS_CAP], ps[PS_HOMED], ps[PS_RBASE] = (
            self.proxy_cap, int(self.homed), self.rbase)
        ps[PS_TRACK], ps[PS_VARGS] = int(self.mk.tracks_home), int(
            self.has_vargs)
        return ps

    def _hop_bits(self, hop_order) -> Tuple[int, ...]:
        """``hop_order`` (XOR partner deltas) as the bit-index sequence the
        exchange iterates; None = bit-position order. Every hypercube
        dimension exactly once."""
        if hop_order is None:
            return tuple(range(self.nh))
        deltas = [int(d) for d in hop_order]
        if sorted(deltas) != [1 << k for k in range(self.nh)]:
            raise ValueError(
                f"hop_order must be a permutation of the XOR deltas "
                f"{[1 << k for k in range(self.nh)]} (every hypercube "
                f"dimension exactly once), got {deltas}"
            )
        return tuple(d.bit_length() - 1 for d in deltas)

    def _waits(self, waits, builders) -> List[List[Tuple[int, int, int]]]:
        """Host-declared wait-sets per device (chan_id, need, task index),
        checked as JAX checks them."""
        waits = [list(w) for w in (waits or [])]
        waits += [[] for _ in range(self.ndev - len(waits))]
        for d, wlist in enumerate(waits):
            if len(wlist) > self.max_waits:
                raise ValueError(f"device {d}: too many waits")
            for ch, need, row in wlist:
                if not 0 <= ch < len(self.channels):
                    raise ValueError(f"bad channel id {ch}")
                if not 0 <= row < builders[d].num_tasks:
                    raise ValueError(
                        f"device {d}: wait names task {row} out of range")
        if any(waits) and not self.pgas:
            raise ValueError("waits= needs the PGAS configuration "
                             "(channels=, or steal=False)")
        return [[(int(c), int(n), int(t)) for c, n, t in w] for w in waits]

    def _resume_waits(self, state) -> List[List[Tuple[int, int, int]]]:
        """A quiesced state's exported wait table (needs already rebased
        by the exit export; the parked rows keep their dependency bump)
        as the per-device wait lists the run restages."""
        if "waits" not in state:
            return [[] for _ in range(self.ndev)]
        w = np.asarray(state["waits"], np.int32).reshape(
            -1, self.max_waits + 1, 3)
        if w.shape[0] != self.ndev:
            raise ValueError(
                f"resume_state wait table covers {w.shape[0]} devices, "
                f"this mesh has {self.ndev}")
        return [[tuple(int(x) for x in w[d, 1 + i])
                 for i in range(int(w[d, 0, 0]))] for d in range(self.ndev)]

    def _ring(self, inject_rows, tenant_table, resume_state=None
              ) -> Optional[dict]:
        """The host half of the injection ring (resident.py :2430-2541):
        each device's ``(R, RING_ROW)`` ring and its ictl row (tail,
        closed, consumed), marked closed (a run drains what it was
        given); on a tenant mesh the table's ``pump`` fills the lane
        regions and builds the stacked ``(ndev, T, 8)`` tctl block. A
        resume re-publishes the state's ring residue from slot 0 (or, on
        a tenant mesh, hands the residue to the table's ``resume_from``).
        None without ``inject``."""
        ndev = self.ndev
        if tenant_table is not None and not self.T:
            raise ValueError(
                "tenant_table= needs a tenant-enabled mesh: build the "
                "ResidentKernel with tenants= (or set "
                "HCLIB_TPU_MESH_TENANTS)")
        if not self.inject:
            if inject_rows:
                raise ValueError("inject_rows requires inject=True")
            return None
        R = self.ring_capacity
        iring = np.zeros((ndev, R, RING_ROW), np.int32)
        ictl = np.zeros((ndev, 8), np.int32)
        tctl = None
        rs = resume_state
        if self.T:
            if inject_rows:
                raise ValueError(
                    "a tenant-enabled mesh admits rows through its "
                    "MeshTenantTable (run(tenant_table=...)), not "
                    "inject_rows=")
            if tenant_table is not None and (
                    len(tenant_table) != self.T
                    or tenant_table.ndev != ndev
                    or tenant_table.region_rows != self.region_rows):
                raise ValueError(
                    f"tenant_table shape mismatch: table has "
                    f"{len(tenant_table)} lanes x {tenant_table.ndev} "
                    f"devices x {tenant_table.region_rows} region rows; "
                    f"this mesh wants {self.T} x {ndev} x "
                    f"{self.region_rows}")
            if rs is not None and "tctl" in rs:
                if tenant_table is None:
                    raise ValueError(
                        "resume state carries per-tenant lane blocks "
                        "(tctl/tstats): pass a fresh tenant_table= so "
                        "residue re-deals into its lanes instead of being "
                        "dropped")
                tenant_table.resume_from(rs)
            elif rs is not None:
                rc = rs.get("ictl")
                if (rs.get("ring_rows") is not None and rc is not None
                        and int(np.asarray(rc)[:, 0].sum()) > 0):
                    raise ValueError(
                        "resume state carries untagged inject-ring residue "
                        "but no per-tenant lane blocks: it was exported "
                        "from a tenancy-off mesh and cannot resume on a "
                        "tenant-enabled one")
            ictl[:, 1] = 1
            tctl = (tenant_table.pump(iring) if tenant_table is not None
                    else np.zeros((ndev, self.T, 8), np.int32))
        elif rs is not None:
            if "tctl" in rs:
                raise ValueError(
                    "resume state carries per-tenant lane blocks "
                    "(tctl/tstats): it was exported from a tenant-enabled "
                    "mesh and cannot resume on a tenancy-off one")
            rr, rc = rs.get("ring_rows"), rs.get("ictl")
            if rr is not None and rc is not None:
                rr, rc = np.asarray(rr, np.int32), np.asarray(rc, np.int32)
                if rr.shape[0] != ndev:
                    raise ValueError(
                        f"resume_state inject ring covers {rr.shape[0]} "
                        f"devices, this mesh has {ndev}")
                for d in range(ndev):
                    n = int(rc[d, 0])
                    if n > R:
                        raise ValueError(
                            f"device {d}: {n} residue ring rows exceed "
                            f"ring_capacity {R}")
                    iring[d, :n] = rr[d, :n]
                    ictl[d, 0] = n
                    ictl[d, 1] = 1
        else:
            for d, rows in enumerate(inject_rows or []):
                iring[d], n = pack_inject_rows(rows, R, dev=d)
                ictl[d, 0] = n
                ictl[d, 1] = 1
        return {"ring": iring, "ictl": ictl,
                "tctl": None if tctl is None else np.asarray(tctl, np.int32),
                "T": self.T, "region": self.region_rows}

    def run(
        self,
        builders: Optional[Sequence[TaskGraphBuilder]] = None,
        data: Optional[Dict[str, Any]] = None,
        ivalues: Optional[np.ndarray] = None,
        waits=None,
        inject_rows=None,
        quantum: int = 64,
        max_rounds: int = 1 << 14,
        abort=None,
        quiesce=None,
        resume_state=None,
        hop_order: Optional[Sequence[int]] = None,
        tenant_table=None,
    ):
        """Execute all partitions in one launch; returns (ivalues[ndev, V]
        numpy, data dict of stacked tensors, info) with ``rounds``,
        ``fault_stats`` (per device, ``decode_fault_stats``), ``aborted``,
        ``per_device_counts``, ``exchange`` and, batch-routed, per-device
        ``tiers``; a traced table adds ``trace`` (one decoded ring a
        device). ``waits[d]`` (the PGAS configurations): host-declared
        wait-sets (chan_id, need, task_index) of device d - the named task
        gains one extra dependency, satisfied once ``need`` puts landed on
        the channel. ``abort`` (truthy, or per-device flags) is folded into
        the termination sums: the mesh exits in lockstep with
        ``info['aborted']`` instead of running the workload out.
        ``inject_rows[d]`` (``inject=True``): device d's ring rows,
        ``pack_inject_rows`` specs. ``tenant_table`` (a tenant mesh): the
        ``MeshTenantTable`` whose admissions this run publishes (its
        ``pump``) and whose lanes absorb the tctl echo after it;
        ``info['tenant_ctl']`` is that echo, ``info['tenants']`` the
        table's stats.

        Checkpoint builds (``Megakernel(checkpoint=True)``): ``quiesce``
        (truthy: the next round; an int k: round >= k) stops every
        device's scheduler while the exchange drains the wire, and the
        mesh exits in lockstep once the outboxes are empty and sent
        equals received, with ``info['quiesced']`` and ``info['state']``
        (tasks, succ, ready, counts, ivalues, data, the wait table with
        its needs rebased; an injecting mesh's ring residue and ictl, or a
        tenant mesh's ``tenant_table.export_state``). ``resume_state``
        relaunches from such a state instead of ``builders``."""
        mk, ndev = self.mk, self.ndev
        if (builders is None) == (resume_state is None):
            raise ValueError(
                "run() wants exactly one of builders= or resume_state=")
        if quiesce is False:  # falsy boolean plumbing = off
            quiesce = None
        if quiesce is not None and not self.checkpoint:
            raise ValueError(
                "quiesce= needs Megakernel(checkpoint=True): the quiesce "
                "word is compiled into the round loop only then")
        if resume_state is not None:
            if waits or inject_rows:
                raise ValueError(
                    "resume_state= cannot be combined with waits/"
                    "inject_rows: the snapshot already carries every "
                    "pending row (incl. its wait table and inject-ring "
                    "residue)")
            if data is not None or ivalues is not None:
                raise ValueError("resume_state= carries its own data/ivalues")
            data = dict(resume_state.get("data") or {})
            waits = self._resume_waits(resume_state)
        else:
            waits = self._waits(waits, builders)
        hop_bits = self._hop_bits(hop_order)
        if len(hop_bits) > MAX_HOPS:
            raise ValueError(f"at most {MAX_HOPS} hop bits")
        ring = self._ring(inject_rows, tenant_table, resume_state)
        abort_arr = abort_words(abort, ndev)
        if quiesce is not None:
            # The quiesce word rides words 1 (flag) and 2 (round
            # threshold) of each device's abort row.
            abort_arr[:, 1] = 1
            abort_arr[:, 2] = 0 if quiesce is True else int(quiesce)

        def bump_waits(tasks, succ, ring, counts):
            # Symmetric-heap layout: host value slots occupy the SAME range
            # on every device, so a migrated task's host-slot F_OUT means
            # the same address everywhere (resident.py bump_waits); each
            # parked row owes one extra dependency and leaves the ring.
            va = max(int(counts[d][C_VALLOC]) for d in range(ndev))
            for d in range(ndev):
                counts[d][C_VALLOC] = va
            if self.homed_mig:
                # The host value region and the row-owned blocks must
                # stay below the migration result slots.
                blocks = VBLOCK * mk.capacity if mk.uses_row_values else 0
                for d in range(ndev):
                    need = int(counts[d][C_VALLOC]) + blocks
                    if need > self.rbase:
                        raise ValueError(
                            f"device {d}: value region [0, {need}) overlaps "
                            f"the migration result slots at [{self.rbase}, "
                            f"{mk.num_values}); grow num_values by at least "
                            f"{need - self.rbase}")
            park_waits(waits, tasks, ring, counts)

        # A resume restages the state as it is: no bump_waits pass (the
        # parked rows keep their bump).
        st = mesh_state(mk, ndev, self.mesh.device, builders, data, ivalues,
                        mutate=bump_waits if resume_state is None else None,
                        state=resume_state)
        # The whitelist: kind -> 1, with the kind's value-arg mask above
        # bit 0 (the migrating configuration dereferences those args).
        wl = ({f: 1 | (self.vmask[f] << 1) for f in self.migratable}
              if self.steal else {})
        traced = mk.trace is not None
        t0_ns = time.monotonic_ns()
        if st["tasks"].device.type == "cpu":
            out = _plain_resident(self, st, wl, abort_arr, quantum,
                                  max_rounds, hop_bits, waits, ring)
        else:
            pgas = None
            if self.pgas:
                names = list(mk.data_specs)
                chans = []
                for bname, rows in self.channels:
                    t = st["data"][bname]
                    chans.append((names.index(bname), rows, t.shape[1],
                                  t[0, 0].numel() * t.element_size()))
                pgas = {"nchan": self.nchan, "amw": self.am_window,
                        "outq": self.outbox, "maxw": self.max_waits,
                        "chans": chans, "waits": waits,
                        "pstate": [self.pstate_words(len(w)) for w in waits],
                        "home": self.migrating,
                        "value_limit": self.rbase}
            obs = None
            if traced or self.checkpoint:
                obs = {"cap": mk.trace.capacity if traced else 0,
                       "ckpt": self.checkpoint, "maxw": self.max_waits}
            out = run_mesh_kernel(
                "resident_steal", mk, st, wl, abort_arr, quantum,
                max_rounds, self.window, self.scan, hop_bits,
                max(len(hop_bits), 1), self.timeout_s, pgas=pgas,
                steal=self.steal, inject=ring,
                fault=(None if self.plan is None
                       else fault_plan_words(self.plan)), obs=obs)
        t1_ns = time.monotonic_ns()
        fs = out["fstats"]
        info = mesh_info(st)
        info["rounds"] = int(info["per_device_counts"][0][C_ROUNDS])
        info["exchange"] = exchange_info(out)
        fsd = [decode_fault_stats(fs[d]) for d in range(ndev)]
        info["fault_stats"] = fsd
        if traced:
            info["trace"] = trace_info(list(out["rings"]), t0_ns, t1_ns,
                                       mk.trace.capacity)
        if "pstate" in out:
            ps = np.asarray(out["pstate"])
            info["proxies"] = ps[:, PS_PROXIES].tolist()
            info["proxies_peak"] = ps[:, PS_PEAK].tolist()
            info["builtin_ams"] = {
                name: ps[:, PS_AMS - 2 - k].tolist()
                for k, name in RC_NAMES.items()}
        info["aborted"] = any(f["abort_round"] >= 0 for f in fsd)
        if self.T:
            # The stacked tctl echo (lane cursors and the cumulative
            # install / expire / sweep counters) folds back into the
            # front door before its stats are read.
            info["tenant_ctl"] = np.asarray(out["tctl"])
            if tenant_table is not None:
                tenant_table.absorb(info["tenant_ctl"])
                info["tenants"] = tenant_table.stats()
        if mk.batch_specs:
            trows = st["tstats"].cpu().numpy()
            info["tiers"] = [mk.decode_tier_stats(trows[d])
                             for d in range(ndev)]
        if self.checkpoint:
            info["quiesced"] = any(f["quiesce_round"] >= 0 for f in fsd)
            if self.inject:
                info["inject_ctl"] = np.asarray(out["ictl"])
            if info["quiesced"]:
                info["state"] = self._export(st, info, out, ring,
                                             tenant_table)
        if info["overflow"]:
            masks = [int(c[C_OVERFLOW]) for c in info["per_device_counts"]]
            agg = 0
            for m in masks:
                agg |= m
            raise RuntimeError(
                f"resident kernel overflow: {decode_overflow(agg)} "
                f"exhausted (per-device masks {masks}); raise capacity, "
                "the outbox or the wait table, or shrink the steal window"
            )
        starved = [(d, f["starved_channel"]) for d, f in enumerate(fsd)
                   if f["starved_channel"] is not None]
        if starved and info["pending"] != 0:
            d, ch = starved[0]
            raise StallError(
                f"ici steal credit starved: device {d}'s hop-{ch['hop']} "
                f"channel lost a flow-control credit from granter device "
                f"{ch['granter']} with regeneration disabled "
                f"(credit_timeout=0); mesh exited in lockstep with "
                f"{info['pending']} pending",
                stats=info,
            )
        if info["pending"] != 0 and not (
            bool(abort_arr[:, 0].any()) or info["aborted"]
            or info.get("quiesced")
        ):
            suspects = sorted({p for f in fsd for p in f["quarantined"]})
            suspect = (
                f" suspect chip: device {suspects[0]} (quarantined by "
                f"heartbeat timeout; its unmigratable work cannot re-home)."
                if suspects else "")
            raise StallError(
                f"resident kernel stalled: {info['pending']} pending after "
                f"{info['executed']} executed ({info['rounds']} rounds) - "
                "a wait whose puts never arrive, or max_rounds too small."
                + suspect,
                stats=info,
            )
        return st["ivalues"].cpu().numpy(), st["data"], info

    def _export(self, st, info, out, ring, tenant_table) -> Dict[str, Any]:
        """The stacked snapshot of a quiesced run (resident.py
        :2661-2700): what ``run(resume_state=)`` relaunches from and
        ``runtime.checkpoint.snapshot_resident`` bundles."""
        state = {
            "tasks": st["tasks"].cpu().numpy(),
            "succ": st["succ"].cpu().numpy(),
            "ready": st["ready"].cpu().numpy(),
            "counts": np.asarray(info["per_device_counts"]).copy(),
            "ivalues": st["ivalues"].cpu().numpy(),
            "data": {k: v.cpu().numpy() for k, v in st["data"].items()},
            "waits": np.asarray(out["waits"]),
        }
        if self.inject and self.T:
            # A tenant mesh: the front door exports the per-lane residue
            # and the aggregate tctl / tstats blocks (nothing was
            # published without a table).
            if tenant_table is not None:
                state.update(tenant_table.export_state(ring["ring"]))
        elif self.inject:
            ic = np.asarray(out["ictl"])
            rr = np.zeros((self.ndev, self.ring_capacity, RING_ROW),
                          np.int32)
            nictl = np.zeros((self.ndev, 8), np.int32)
            for d in range(self.ndev):
                res = ring["ring"][d, int(ic[d, 2]):int(ic[d, 0])]
                rr[d, :len(res)] = res
                nictl[d, 0] = len(res)
                nictl[d, 1] = ic[d, 1]
            state["ring_rows"] = rr
            state["ictl"] = nictl
        return state
