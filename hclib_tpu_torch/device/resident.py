"""The resident multi-device kernel on one card, steal-only configuration:
one CTA a mesh device runs the scheduler and the XOR-hop steal exchange in
one launch.

Port of ``hclib_tpu/device/resident.py`` ``ResidentKernel`` (:322) with
``steal=True, homed=False`` - the configuration ``ICIStealMegakernel``
delegates to on power-of-two meshes - and ``decode_fault_stats`` (:268).
The kernel (``csrc/mesh.cuh`` ``resident_steal_kernel``, replacing
``_kernel`` :626) runs, a round: the abort word; ``sched(quantum)``; the
fold over the XOR hops in ``hop_order`` (each hop a credited exchange of
the stat vector with ``me ^ (1 << k)``: the recursive-doubling sums of
pending and abort, the partner's backlog raw) and, at each hop, the
demand-driven steal: ``clip((mine - theirs + 1) // 2, 0, W)`` link-free
whitelisted ready rows to a partner whose backlog is under ``min(quantum,
W)``, into that hop's inbox; the mesh exits in lockstep once the folded
pending is 0 or an abort was folded. A mesh device is one co-resident
CTA (``parallel.mesh.CtaMesh``); the plain version
(``_plain_resident``: the same rounds over the plain cores device by
device) is what the CPU tests hold against JAX and the card against.

Stat words: with no active messages, channels, injection or faults, the
stat vector's XOR all-to-all section is all zeros, so the kernel sends
the seven sums and the backlog only (8 words a hop).

Not ported yet, each raising naming ROADMAP A11: homed migration
(``homed=True`` with migratable kinds; value-arg rehydration), the PGAS
channels, active messages, atomics and locks (``channels``), the
injection ring and tenancy (``inject``, ``tenants``, ``inject_rows``,
``tenant_table``), fault injection (``fault_plan``), wait-sets
(``waits``), quiesce and resume (``quiesce``, ``resume_state``), the PGAS-only configuration
(``steal=False``) and a traced or checkpoint-built Megakernel.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..runtime.resilience import StallError
from .descriptor import (
    DESC_WORDS,
    F_CSR_N,
    F_DEP,
    F_FN,
    F_HOME,
    F_OUT,
    F_SUCC0,
    F_SUCC1,
    F_VMASK,
    NO_TASK,
    TaskGraphBuilder,
)
from .megakernel import (
    C_HEAD,
    C_OVERFLOW,
    C_PENDING,
    C_ROUNDS,
    C_TAIL,
    C_VALLOC,
    C_VBASE,
    MAX_HOPS,
    VBLOCK,
    Megakernel,
    _PlainCore,
    decode_overflow,
    mesh_slice,
)
from .sharded import abort_words, mesh_info, mesh_state

__all__ = ["ResidentKernel", "decode_fault_stats", "FS_WORDS",
           "SPIN_TIMEOUT_S", "MESH_MAX_SCAN", "mesh_workspace",
           "export_rows", "import_rows", "run_mesh_kernel",
           "exchange_info"]

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

SF_PEND, SF_ABORT, SX_AM = 0, 5, 7  # the stat sums the fold keeps
STAT_WORDS = 8  # the stat words a hop sends: the sums and the backlog
# The exchange's volume a device (csrc/mesh.cuh XS_*): rows it exported,
# stat words it sent.
XS_ROWS, XS_STAT_WORDS, XS_WORDS = 0, 1, 4
# A spin of the steal kernels that waits longer than this raises: the
# card's protocol never stalls a CTA for seconds on a healthy mesh.
SPIN_TIMEOUT_S = 30.0
MESH_MAX_SCAN = 1024  # csrc/mesh.cuh MAX_SCAN
P_INBOX = 64  # csrc/mesh.cuh: the words of a port before its row inbox
_WAITS = {1: "stat credit", 2: "stat arrival", 3: "row credit",
          4: "row arrival"}


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


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP A11b (the unified resident "
        "kernel's homed migration, PGAS channels, active messages, "
        "injection, faults and quiesce); the port runs the steal-only "
        "configuration (steal=True, homed=False)")


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


def mesh_workspace(ndev: int, nports: int, window: int, dev) -> tuple:
    """The steal kernels' ports (zeroed: counters, stat slabs, inboxes)
    and error row, and the words of one port."""
    port_words = P_INBOX + (window + 1) * DESC_WORDS
    ws = torch.zeros(ndev * nports * port_words, dtype=torch.int32,
                     device=dev)
    err = torch.zeros(8, dtype=torch.int32, device=dev)
    return ws, err, port_words


def run_mesh_kernel(kind: str, mk: Megakernel, st: Dict[str, object],
                    wl, abort_arr: np.ndarray, quantum: int,
                    max_rounds: int, window: int, scan: int,
                    hops: Sequence[int], nports: int,
                    timeout_s: float) -> Dict[str, Any]:
    """Launch steal kernel ``kind`` (``"ici_ring"`` or
    ``"resident_steal"``) over stacked state ``st`` on the card, wait for
    it, and raise if a spin timed out. Returns the fault-stats rows
    (``fstats``), the exchange volume rows (``xstats``) and the launch's
    CUDA-event time (``kernel_ms``)."""
    ndev = st["tasks"].shape[0]
    dev = st["tasks"].device
    if not 0 <= scan <= MESH_MAX_SCAN:
        raise ValueError(f"scan must be 0..{MESH_MAX_SCAN}, got {scan}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    mode, threads, smem = mk.mesh_config(steal_kernel=True)
    h, keep = mk.mesh_host(st, quantum, True)
    ws, err, port_words = mesh_workspace(ndev, nports, window, dev)
    wl_t = torch.zeros(32, dtype=torch.int32, device=dev)
    for f in wl:
        wl_t[f] = 1
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
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    mk.mesh_launch(kind, h, mode, threads, smem, dev)
    t1.record()
    t1.synchronize()
    e = err.cpu().tolist()
    if e[0]:
        raise RuntimeError(
            f"{kind}: device {e[2]} timed out after {timeout_s} s waiting "
            f"for a {_WAITS.get(e[5], e[5])} at round {e[3]}, hop {e[4]}; "
            "the mesh stopped")
    mk.fold_dispatches(keep["dispatch"].sum(0, dtype=torch.int32))
    return {"fstats": fstats.cpu().numpy(), "xstats": xstats.cpu().numpy(),
            "kernel_ms": t0.elapsed_time(t1)}


def exchange_info(out: Dict[str, Any]) -> Dict[str, Any]:
    """A steal kernel's exchange volume (rows exported and stat words
    sent, per device) and its time: the launch's CUDA-event time on the
    card, the plain version's wall time on the CPU."""
    xs = np.asarray(out["xstats"])
    return {"rows": xs[:, XS_ROWS].tolist(),
            "stat_words": xs[:, XS_STAT_WORDS].tolist(),
            "kernel_ms": float(out["kernel_ms"])}


def _plain_resident(mk: Megakernel, st, wl, abort_arr, quantum: int,
                    max_rounds: int, window: int, scan: int,
                    hop_bits: Sequence[int]) -> Dict[str, Any]:
    """The plain version of resident_steal_kernel: every device's round
    in lockstep over the plain cores. Returns the FS and XS rows and the
    wall time (``kernel_ms``)."""
    t0 = time.perf_counter()
    ndev = st["tasks"].shape[0]
    cores = [_PlainCore(mk, mesh_slice(st, d)) for d in range(ndev)]
    for c in cores:
        c.stage(True)
    fs = np.zeros((ndev, FS_WORDS), np.int32)
    fs[:, FS_DEAD_ROUND] = -1
    fs[:, FS_ABORT_ROUND] = -1
    fs[:, FS_QUIESCE_ROUND] = -1
    xs = np.zeros((ndev, XS_WORDS), np.int32)
    starve_below = min(quantum, window)

    def backlog(c):
        return c.counts[C_TAIL] - c.counts[C_HEAD]

    r, done = 0, False
    while not done and r < max_rounds:
        local_abort = [int(abort_arr[d, 0] != 0) for d in range(ndev)]
        for c in cores:
            c.sched(quantum)
        acc = [[c.counts[C_PENDING], 0, 0, 0, 0, local_abort[d], 0]
               for d, c in enumerate(cores)]
        for k in hop_bits:
            snd = [acc[d] + [backlog(c)] for d, c in enumerate(cores)]
            xs[:, XS_STAT_WORDS] += STAT_WORDS
            boxes = []
            for d, c in enumerate(cores):
                rcv = snd[d ^ (1 << k)]
                acc[d] = [a + b for a, b in zip(acc[d], rcv[:SX_AM])]
                peer_b, myb = rcv[SX_AM], backlog(c)
                quota = (min(max((myb - peer_b + 1) // 2, 0), window)
                         if peer_b < starve_below else 0)
                boxes.append(export_rows(c, quota, scan, wl, True, xs[d])
                             if quota > 0 else [])
            for d, c in enumerate(cores):
                import_rows(c, boxes[d ^ (1 << k)])
        for d in range(ndev):
            if acc[d][SF_ABORT] > 0 and fs[d, FS_ABORT_ROUND] < 0:
                fs[d, FS_ABORT_ROUND] = r
        done = acc[0][SF_PEND] == 0 or acc[0][SF_ABORT] > 0
        r += 1
    for c in cores:
        c.counts[C_ROUNDS] = r
        c.write_back()
    return {"fstats": fs, "xstats": xs,
            "kernel_ms": (time.perf_counter() - t0) * 1e3}


class ResidentKernel:
    """One resident scheduler per device of a 1D/2D/3D mesh with
    power-of-two axes (``parallel.mesh.CtaMesh``), in the steal-only
    configuration: ``steal=True, homed=False``, ``migratable_fns`` a
    sequence of kernel-table ids whose link-free ready rows migrate whole.
    Devices are numbered by row-major flattening; the XOR hop bits of a
    multi-axis mesh flip the minor axis first, as in JAX. ``window``
    bounds rows a hop, ``scan`` how far past the ring head the export
    looks (default 2 * window)."""

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
        # What this slice does not run yet.
        if not self.steal:
            raise _later("steal=False (the PGAS-only configuration)")
        if self.homed and self.migratable:
            raise _later("homed=True migration (home-link proxies)")
        if any(self.migratable.values()):
            raise _later("migratable_fns value args (rehydration)")
        if channels:
            raise _later("channels= (one-sided put, AMs, atomics, locks)")
        if inject:
            raise _later("inject=True (the resident injection ring)")
        if tenants is not None and tenants is not False:
            raise _later("tenants= (mesh tenancy)")
        if fault_plan is not None and fault_plan.enabled():
            raise _later("fault_plan= (device fault injection)")
        if mk.trace is not None or mk.checkpoint:
            raise _later("a traced or checkpoint-built Megakernel on the "
                         "mesh (the resident flight recorder and quiesce)")
        self.window = int(window)
        self.scan = int(scan) if scan is not None else 2 * self.window
        self.timeout_s = SPIN_TIMEOUT_S

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
        ``per_device_counts`` and, batch-routed, per-device ``tiers``.
        ``abort`` (truthy, or per-device flags) is folded into the
        termination sums: the mesh exits in lockstep with
        ``info['aborted']`` instead of running the workload out."""
        for name, v in (("waits=", waits), ("inject_rows=", inject_rows),
                        ("quiesce=", quiesce),
                        ("resume_state=", resume_state),
                        ("tenant_table=", tenant_table)):
            if v is not None and v is not False and v != []:
                raise _later(name)
        if builders is None:
            raise ValueError("run() wants builders=")
        mk, ndev = self.mk, self.ndev
        hop_bits = self._hop_bits(hop_order)
        if len(hop_bits) > MAX_HOPS:
            raise ValueError(f"at most {MAX_HOPS} hop bits")
        abort_arr = abort_words(abort, ndev)

        def symmetric_heap(tasks, succ, ring, counts):
            # Host value slots occupy the SAME range on every device, so a
            # migrated task's host-slot F_OUT means the same address
            # everywhere (resident.py bump_waits).
            va = max(int(counts[d][C_VALLOC]) for d in range(ndev))
            for d in range(ndev):
                counts[d][C_VALLOC] = va

        st = mesh_state(mk, ndev, self.mesh.device, builders, data, ivalues,
                        mutate=symmetric_heap)
        wl = frozenset(self.migratable)
        if st["tasks"].device.type == "cpu":
            out = _plain_resident(mk, st, wl, abort_arr, quantum, max_rounds,
                                  self.window, self.scan, hop_bits)
        else:
            out = run_mesh_kernel(
                "resident_steal", mk, st, wl, abort_arr, quantum,
                max_rounds, self.window, self.scan, hop_bits,
                max(len(hop_bits), 1), self.timeout_s)
        fs = out["fstats"]
        info = mesh_info(st)
        info["rounds"] = int(info["per_device_counts"][0][C_ROUNDS])
        info["exchange"] = exchange_info(out)
        fsd = [decode_fault_stats(fs[d]) for d in range(ndev)]
        info["fault_stats"] = fsd
        info["aborted"] = any(f["abort_round"] >= 0 for f in fsd)
        if mk.batch_specs:
            trows = st["tstats"].cpu().numpy()
            info["tiers"] = [mk.decode_tier_stats(trows[d])
                             for d in range(ndev)]
        if info["overflow"]:
            masks = [int(c[C_OVERFLOW]) for c in info["per_device_counts"]]
            agg = 0
            for m in masks:
                agg |= m
            raise RuntimeError(
                f"resident kernel overflow: {decode_overflow(agg)} "
                f"exhausted (per-device masks {masks}); raise capacity or "
                "shrink the steal window"
            )
        if info["pending"] != 0 and not (
            bool(abort_arr[:, 0].any()) or info["aborted"]
        ):
            raise StallError(
                f"resident kernel stalled: {info['pending']} pending after "
                f"{info['executed']} executed ({info['rounds']} rounds) - "
                "max_rounds too small.",
                stats=info,
            )
        return st["ivalues"].cpu().numpy(), st["data"], info
