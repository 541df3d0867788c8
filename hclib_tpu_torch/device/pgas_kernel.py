"""One-sided device PGAS on one card: put / active messages / wait-until on
data between mesh devices, inside one launch.

Port of ``hclib_tpu/device/pgas_kernel.py`` ``PGASMegakernel`` (:114):
its constructor (:125-180), its ring kernel (``_kernel`` :182, pallas_call
at :665) and ``run`` (:742). A mesh device is one co-resident CTA
(``parallel.mesh.CtaMesh``); the megakernel's ``data_specs`` buffers
exist on every device with identical shapes (a symmetric heap, stacked
on a leading mesh axis); a channel ``{name: (buffer, rows)}`` is the
static contract a put moves ``rows`` rows under. Bodies reach the
operations through ``ctx.pgas``.

A power-of-two mesh delegates to ``ResidentKernel(steal=False,
channels=..., am_window=..., outbox=..., max_waits=...)``, as JAX's does
(:162-171): there ``ctx.pgas`` also has the atomics and locks. Any other
mesh size runs the ring kernel (``csrc/mesh.cuh`` ``pgas_ring_kernel``,
counter ``pgas_ring``; the plain version ``_plain_pgas_ring``), whose
``ctx.pgas`` has ``put``, ``am`` (at most 6 args, ``out=``), ``wait_until``,
``count``, ``me``, ``ndev`` and ``nchan`` only. A round, in JAX's order
(:579-611): ``sched(quantum)``; the abort word; ``drain_outbox`` (FIFO,
at most ``am_window // 2`` messages a target, a capped head stalls the
queue; TR_XFER when any left); the stat exchange, whose sums every
device reads alike (pending, messages received, outbox backlog, abort,
messages and puts sent; TR_ABORT when an abort was folded); the exit
test ``(pending == 0 & backlog == 0 & sent == received) | abort``; then,
unconditionally, ``drain_receives`` (each channel's count jumps to the
total announced for this device, then the announced messages install
source by source, FIFO within a source: that order fixes their task
rows) and ``scan_waits``.

On the card a device publishes its stat slot (``csrc/mesh.cuh`` RS_*: the
five totals, the messages it sent each target and the puts it sent each
(target, channel)) into the slot of its round's parity, counts itself on
one arrival counter, waits (acquire, bounded) until every device of the
round has, and reads the five totals of every slot, its own column of
messages and its own put counts; a source's messages and puts are read
only after that source's arrival counters reached what it announced. A
device publishes round r + 1 only after it read round r, so two slots a
device suffice. JAX's ring allreduce of the whole O(ndev^2) vector is
the same sums in another order.
"""

from __future__ import annotations

import time
import types
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.resilience import StallError
from .descriptor import TaskGraphBuilder
from .megakernel import C_PENDING, C_ROUNDS, Megakernel, _PlainCore, mesh_slice
from .resident import (
    PS_NWAIT,
    PS_RECV,
    PS_SENT,
    PS_WORDS,
    SPIN_TIMEOUT_S,
    XS_AMS,
    XS_PUTS,
    XS_STAT_WORDS,
    XS_WORDS,
    ResidentKernel,
    _PlainPgas,
    exchange_info,
    park_waits,
    parse_channels,
    ring_stat_words,
    run_mesh_kernel,
)
from .sharded import abort_words, mesh_info, mesh_state
from .tracebuf import HDR, TR_ABORT, TR_WORDS, TR_XFER, Tracer, trace_info

__all__ = ["PGASMegakernel"]


class PGASMegakernel:
    """Per-device resident scheduler + one-sided PGAS over a 1D mesh.

    ``channels`` maps channel name -> (data buffer name, rows per
    message); every put on a channel moves exactly that many leading-axis
    rows. ``chan_id`` gives the table index kernels use. ``am_window`` is
    the per-(source, target) inbox depth; at most ``am_window // 2`` AMs
    per target leave the outbox per round; ``outbox`` bounds the queued
    messages and ``max_waits`` the parked wait-untils of a device.
    """

    def __init__(
        self,
        mk: Megakernel,
        mesh,
        channels: Optional[Dict[str, Tuple[str, int]]] = None,
        am_window: int = 8,
        outbox: int = 64,
        max_waits: int = 64,
    ) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError("PGASMegakernel wants a 1D mesh")
        if am_window < 2:
            raise ValueError("am_window must be >= 2")
        self.mk = mk
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = int(np.prod(mesh.dims))
        self.channels, self.chan_id = parse_channels(mk, channels)
        self.nchan = max(1, len(self.channels))
        self.am_window = int(am_window)
        self.outbox = int(outbox)
        self.max_waits = int(max_waits)
        # Power-of-two meshes run the resident kernel's PGAS-only
        # configuration; the others this module's ring kernel.
        self._resident = None
        if self.ndev & (self.ndev - 1) == 0:
            self._resident = ResidentKernel(
                mk, mesh, steal=False, channels=dict(channels or {}),
                am_window=self.am_window, outbox=self.outbox,
                max_waits=self.max_waits,
            )
        # JAX's stat-vector layout (:171-176): the four sums, the
        # [src * ndev + dst] message counts, the [dst * nchan + chan] put
        # counts.
        self.ST_AM = 4
        self.ST_DATA = 4 + self.ndev * self.ndev
        self.S = self.ST_DATA + self.ndev * self.nchan
        self.timeout_s = SPIN_TIMEOUT_S

    def pstate_words(self, nwait: int) -> List[int]:
        """A device's pstate words at the start of a run: its host waits
        (the ring kernel reads no configuration word)."""
        ps = [0] * PS_WORDS
        ps[PS_NWAIT] = nwait
        return ps

    def _waits(self, waits, builders) -> List[List[Tuple[int, int, int]]]:
        """Host-declared wait-sets per device, checked as JAX's run checks
        them (:772-788)."""
        waits = [list(w) for w in (waits or [])]
        waits += [[] for _ in range(self.ndev - len(waits))]
        for d, wl in enumerate(waits):
            if len(wl) > self.max_waits:
                raise ValueError(f"device {d}: too many waits ({len(wl)})")
            for ch, need, row in wl:
                if not 0 <= ch < len(self.channels):
                    raise ValueError(f"bad channel id {ch}")
                if not 0 <= row < builders[d].num_tasks:
                    raise ValueError(
                        f"device {d}: wait names task {row}, but the "
                        f"partition has {builders[d].num_tasks} tasks")
        return [[(int(c), int(n), int(t)) for c, n, t in w] for w in waits]

    def run(
        self,
        builders: Sequence[TaskGraphBuilder],
        data: Optional[Dict[str, np.ndarray]] = None,
        ivalues: Optional[np.ndarray] = None,
        waits: Optional[Sequence[Sequence[Tuple[int, int, int]]]] = None,
        quantum: int = 64,
        max_rounds: int = 1 << 14,
        abort=None,
    ):
        """Execute all partitions in one launch.

        ``waits[d]`` lists host-declared wait-sets for device d as
        (chan_id, need, task_index) - the named task gains one extra
        dependency satisfied when ``need`` messages have landed on the
        channel. Returns (ivalues[ndev, V], data, info); ``data`` values
        carry a leading device axis (per-device symmetric-heap
        instances). ``abort``: host abort word (truthy or per-device
        flags) - the mesh exits in lockstep with ``info['aborted']``.
        ``info`` has ``rounds``, ``per_device_counts``, ``exchange``
        (messages, puts and stat words sent a device, the launch's time),
        ``trace`` for a traced table and ``tiers`` for a batch-routed
        one.
        """
        if self._resident is not None:
            return self._resident.run(
                builders, data=data, ivalues=ivalues, waits=waits,
                quantum=quantum, max_rounds=max_rounds, abort=abort,
            )
        mk, ndev = self.mk, self.ndev
        waits = self._waits(waits, builders)

        st = mesh_state(mk, ndev, self.mesh.device, builders, data, ivalues,
                        mutate=lambda t, s, ring, c: park_waits(waits, t,
                                                                ring, c))
        abort_arr = abort_words(abort, ndev)
        traced = mk.trace is not None
        t0_ns = time.monotonic_ns()
        if st["tasks"].device.type == "cpu":
            out = _plain_pgas_ring(self, st, abort_arr, quantum, max_rounds,
                                   waits)
        else:
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
                    "home": False, "value_limit": mk.num_values}
            obs = {"cap": mk.trace.capacity, "ckpt": False} if traced \
                else None
            out = run_mesh_kernel(
                "pgas_ring", mk, st, {}, abort_arr, quantum, max_rounds, 1,
                0, (), 1, self.timeout_s, pgas=pgas, steal=False, obs=obs)
        t1_ns = time.monotonic_ns()
        info = mesh_info(st)
        info["rounds"] = int(info["per_device_counts"][0][C_ROUNDS])
        info["exchange"] = exchange_info(out)
        if traced:
            info["trace"] = trace_info(list(out["rings"]), t0_ns, t1_ns,
                                       mk.trace.capacity)
        if mk.batch_specs:
            trows = st["tstats"].cpu().numpy()
            info["tiers"] = [mk.decode_tier_stats(trows[d])
                             for d in range(ndev)]
        info["aborted"] = bool(abort_arr[:, 0].any()) and info["pending"] != 0
        if info["overflow"]:
            raise RuntimeError(
                "pgas kernel overflow: task table, value slots, outbox, or "
                "wait table exceeded - raise the limits or coarsen"
            )
        if info["pending"] != 0 and not info["aborted"]:
            raise StallError(
                f"pgas kernel stalled: {info['pending']} pending after "
                f"{info['executed']} executed ({info['rounds']} rounds) - "
                "a wait-until whose messages never arrive, or max_rounds "
                "too small",
                stats=info,
            )
        return st["ivalues"].cpu().numpy(), st["data"], info


class _PlainRingPgas(_PlainPgas):
    """One device's PGAS state under the ring kernel: the resident
    kernel's outbox, counts, put, am and wait_until (the same meaning),
    with row 6's drain_outbox record and receive drain. ``ns`` is what
    ``ctx.pgas`` is: row 6's operations only."""

    def __init__(self, pk: PGASMegakernel, core: _PlainCore, me: int,
                 data, waits, peers: list):
        super().__init__(pk, core, me, data, waits, peers)
        self.ns = types.SimpleNamespace(
            put=self.put, am=self.am, wait_until=self.wait_until,
            count=self.count, me=me, ndev=self.ndev,
            nchan=len(pk.channels))

    def drain_outbox(self) -> None:
        """drain_outbox (:358): TR_XFER(me, messages sent) when any
        left."""
        n0 = len(self.outq)
        super().drain_outbox()
        if len(self.outq) < n0:
            tr = self.core.tr
            tr.emit(TR_XFER, tr.now(), self.me, n0 - len(self.outq))

    def drain_ring(self, am_exp: List[int], put_exp) -> None:
        """drain_receives (:470): each channel's count jumps to the total
        announced for this device, then the announced messages install
        (install_descriptor) source by source, FIFO within a source."""
        for c in range(self.rk.nchan):
            total = sum(put_exp[s][c] for s in range(self.ndev))
            for s in range(self.ndev):
                self.chan_recv[s][c] = put_exp[s][c]
            self.ps[PS_RECV] += total - self.chan_tot[c]
            self.chan_tot[c] = total
        amw = self.rk.am_window
        for s in range(self.ndev):
            base = self.am_recv[s]
            for i in range(am_exp[s] - base):
                row = self.inbox[s][(base + i) % amw]
                self.core.install_descriptor(lambda w, row=row: row[w])
            self.ps[PS_RECV] += am_exp[s] - base
            self.am_recv[s] = am_exp[s]


def _plain_pgas_ring(pk: PGASMegakernel, st, abort_arr, quantum: int,
                     max_rounds: int, waits) -> dict:
    """The plain version of the ring kernel: every device's round in
    lockstep over the plain cores, in JAX's order (:579-611), each traced
    device's recorder included. Returns the XS rows, the pstate rows, the
    recorder rows (``rings``) and the wall time (``kernel_ms``)."""
    t0 = time.perf_counter()
    mk = pk.mk
    ndev = st["tasks"].shape[0]
    cores = [_PlainCore(mk, mesh_slice(st, d)) for d in range(ndev)]
    cap_tr = mk.trace.capacity if mk.trace is not None else 0
    rings_tr = [[0] * (HDR + TR_WORDS * cap_tr) for _ in range(ndev)]
    pgs: List[_PlainRingPgas] = []
    for d, c in enumerate(cores):
        if cap_tr:
            c.tr = Tracer(rings_tr[d], cap_tr)
        c.stage(True)
        pg = _PlainRingPgas(pk, c, d, st["data"], waits[d], pgs)
        c.pgas = pg.ns
        pgs.append(pg)
    sw = ring_stat_words(ndev, pk.nchan)
    xs = np.zeros((ndev, XS_WORDS), np.int32)
    r, done = 0, False
    while not done and r < max_rounds:
        for c in cores:
            c.sched(quantum)
        for pg in pgs:
            pg.drain_outbox()
        # The stat exchange: every device reads the same sums, and what
        # each source announced to it.
        xs[:, XS_STAT_WORDS] += sw
        pend = sum(c.counts[C_PENDING] for c in cores)
        recv = sum(pg.ps[PS_RECV] for pg in pgs)
        backlog = sum(len(pg.outq) for pg in pgs)
        sent = sum(pg.ps[PS_SENT] for pg in pgs)
        aborted = int((abort_arr[:, 0] != 0).sum()) > 0
        done = (pend == 0 and backlog == 0 and sent == recv) or aborted
        if aborted:
            for c in cores:
                c.tr.emit(TR_ABORT, c.tr.now(), r)
        for v, pg in enumerate(pgs):
            pg.drain_ring([pgs[s].am_sent[v] for s in range(ndev)],
                          [pgs[s].data_sent[v] for s in range(ndev)])
            pg.scan_waits()
        r += 1
    for d, c in enumerate(cores):
        c.counts[C_ROUNDS] = r
        c.write_back()
        xs[d, XS_AMS] = sum(pgs[d].am_sent)
        xs[d, XS_PUTS] = sum(map(sum, pgs[d].data_sent))
    out = {"xstats": xs, "pstate": np.array([pg.ps for pg in pgs], np.int32),
           "kernel_ms": (time.perf_counter() - t0) * 1e3}
    if cap_tr:
        out["rings"] = np.array(rings_tr, np.int32)
    return out
