"""In-kernel work stealing on one card: the whole multi-device run is one
launch, a mesh device being one co-resident CTA.

Port of ``hclib_tpu/device/ici_steal.py`` ``ICIStealMegakernel`` (:91).
Power-of-two meshes delegate to the resident kernel's steal-only
configuration (device/resident.py), as JAX's do (:141-149, :820-827).
Other 1D meshes run the ring kernel (``csrc/mesh.cuh``
``ici_ring_kernel``, replacing ``_kernel`` :278 with ``_make_xfer``
:180), a round: ``sched(quantum)``; the abort word; the ring allreduce of
(pending, backlog, abort) in ``ndev - 1`` hops to the right neighbour,
each credited; then, unless the mesh is done, one exchange at distance
``2^(r mod nh) mod ndev`` (the CTA's own inbox on a one-device ring),
``clip(backlog - total // ndev, 0, window)`` link-free whitelisted rows
off the ring head, credited to the device that targets the inbox next
round. ``_run_ring``, a test hook, runs the ring on any 1D mesh, so the
one-device self-exchange can be held (JAX ran it there before the
delegation existed).

The plain version (``_plain_ring``: the same rounds over the plain cores
device by device) is what the CPU tests hold against JAX's interpret-mode
kernel and the card against. A traced table records on every device (the
core's rounds, TR_XFER :393 and TR_ABORT :432; ``info['trace']``, the
observed instance ``ici_ring_kernel<.., kObs>``, counter
``ici_ring_obs``); the ring reads no quiesce word, as JAX's never reads
``mk.checkpoint``, so a checkpoint-built table runs as an unbuilt one.
The hypercube kernel ``_kernel_hc`` (:460) is not ported: no run reaches
it (pof2 meshes delegate), and it stays listed in ROADMAP B.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np

from ..runtime.resilience import StallError
from .descriptor import TaskGraphBuilder
from .megakernel import (
    C_HEAD,
    C_PENDING,
    C_ROUNDS,
    C_TAIL,
    Megakernel,
    _PlainCore,
    mesh_slice,
)
from .resident import (
    SPIN_TIMEOUT_S,
    XS_STAT_WORDS,
    XS_WORDS,
    ResidentKernel,
    exchange_info,
    export_rows,
    import_rows,
    run_mesh_kernel,
)
from .sharded import abort_words, mesh_info, mesh_state
from .tracebuf import HDR, TR_ABORT, TR_WORDS, TR_XFER, Tracer, trace_info

__all__ = ["ICIStealMegakernel"]


def _plain_ring(mk: Megakernel, st, wl, abort_arr, quantum: int,
                max_rounds: int, window: int, scan: int) -> Dict[str, Any]:
    """The plain version of ici_ring_kernel over stacked state ``st``;
    returns the XS rows, the recorder rows of a traced table (``rings``)
    and the wall time (``kernel_ms``)."""
    t0 = time.perf_counter()
    ndev = st["tasks"].shape[0]
    xs = np.zeros((ndev, XS_WORDS), np.int32)
    cores = [_PlainCore(mk, mesh_slice(st, d)) for d in range(ndev)]
    cap_tr = mk.trace.capacity if mk.trace is not None else 0
    rings = [[0] * (HDR + TR_WORDS * cap_tr) for _ in range(ndev)]
    for d, c in enumerate(cores):
        if cap_tr:
            c.tr = Tracer(rings[d], cap_tr)
        c.stage(True)
    nh = max(1, (ndev - 1).bit_length())
    r, done = 0, False
    while not done and r < max_rounds:
        for c in cores:
            c.sched(quantum)
        # The ring allreduce: every device learns the totals.
        tot_p = sum(c.counts[C_PENDING] for c in cores)
        tot_b = sum(c.counts[C_TAIL] - c.counts[C_HEAD] for c in cores)
        tot_a = sum(int(abort_arr[d, 0] != 0) for d in range(ndev))
        xs[:, XS_STAT_WORDS] += 3 * (ndev - 1)
        done = tot_p == 0 or tot_a > 0
        if tot_a > 0:
            for c in cores:
                c.tr.emit(TR_ABORT, c.tr.now(), r)
        if not done:
            dist = (1 << (r % nh)) % ndev
            boxes = []
            for d, c in enumerate(cores):
                backlog = c.counts[C_TAIL] - c.counts[C_HEAD]
                quota = min(max(backlog - tot_b // ndev, 0), window)
                boxes.append(export_rows(c, quota, scan, wl, False, xs[d]))
                if boxes[d]:
                    c.tr.emit(TR_XFER, c.tr.now(), (d + dist) % ndev,
                              len(boxes[d]))
            for d, c in enumerate(cores):
                import_rows(c, boxes[(d - dist) % ndev])
        r += 1
    for c in cores:
        c.counts[C_ROUNDS] = r
        c.write_back()
    out = {"xstats": xs, "kernel_ms": (time.perf_counter() - t0) * 1e3}
    if cap_tr:
        out["rings"] = np.array(rings, np.int32)
    return out


class ICIStealMegakernel:
    """Runs one resident scheduler+steal kernel per device of a 1D/2D/3D
    mesh (``parallel.mesh.CtaMesh``). ``migratable_fns`` whitelists the
    kernel ids whose successor-free tasks may migrate; ``window`` bounds
    rows per exchange; ``scan`` how far past the ring head the exporter
    looks (default 2 * window). Power-of-two meshes run the resident
    kernel's steal-only configuration; others, 1D only, the ring."""

    def __init__(
        self,
        mk: Megakernel,
        mesh,
        migratable_fns: Iterable[int] = (),
        window: int = 8,
        scan: Optional[int] = None,
        fault_plan=None,
    ) -> None:
        if len(mesh.axis_names) not in (1, 2, 3):
            raise ValueError("ICIStealMegakernel wants a 1D/2D/3D mesh")
        self.mk = mk
        self.mesh = mesh
        self.axes = tuple(mesh.axis_names)
        self.axis = self.axes[0]
        self.dims = tuple(int(d) for d in mesh.dims)
        self.ndev = int(np.prod(self.dims))
        self._pof2 = self.ndev & (self.ndev - 1) == 0
        if len(self.axes) > 1 and not self._pof2:
            raise ValueError("2D/3D meshes need power-of-two device counts")
        self.migratable_fns = frozenset(int(f) for f in migratable_fns)
        self.window = int(window)
        self.scan = int(scan) if scan is not None else 2 * self.window
        self.timeout_s = SPIN_TIMEOUT_S
        self._resident = None
        if self._pof2:
            self._resident = ResidentKernel(
                mk, mesh, steal=True, migratable_fns=self.migratable_fns,
                homed=False, window=self.window, scan=self.scan,
                fault_plan=fault_plan,
            )
        elif fault_plan is not None and fault_plan.enabled():
            raise ValueError(
                "DeviceFaultPlan injection needs a power-of-two mesh (the "
                "resident kernel's credited hypercube exchange); the "
                "non-pof2 ring supports only the abort word"
            )

    def run(
        self,
        builders: Sequence[TaskGraphBuilder],
        data: Optional[Dict[str, Any]] = None,
        ivalues: Optional[np.ndarray] = None,
        quantum: int = 64,
        max_rounds: int = 1 << 14,
        abort=None,
    ):
        """Execute all partitions in one launch; returns (ivalues[ndev, V]
        numpy, data dict of stacked tensors, info). ``abort``: the host
        abort word (truthy or per-device flags) - the mesh exits in
        lockstep one round later with ``info['aborted']``."""
        if self._resident is not None:
            self._resident.timeout_s = self.timeout_s
            iv, data_o, info = self._resident.run(
                builders, data=data, ivalues=ivalues, quantum=quantum,
                max_rounds=max_rounds, abort=abort,
            )
            info["steal_rounds"] = info.pop("rounds")
            return iv, data_o, info
        return self._run_ring(builders, data, ivalues, quantum, max_rounds,
                             abort)

    def _run_ring(
        self,
        builders: Sequence[TaskGraphBuilder],
        data: Optional[Dict[str, Any]] = None,
        ivalues: Optional[np.ndarray] = None,
        quantum: int = 64,
        max_rounds: int = 1 << 14,
        abort=None,
    ):
        """The ring kernel on this 1D mesh, whatever its size: a test hook
        (``run`` takes the ring on non-power-of-two meshes)."""
        if len(self.axes) != 1:
            raise ValueError("the ring runs on a 1D mesh")
        mk, ndev = self.mk, self.ndev
        abort_arr = abort_words(abort, ndev)
        st = mesh_state(mk, ndev, self.mesh.device, builders, data, ivalues)
        t0_ns = time.monotonic_ns()
        if st["tasks"].device.type == "cpu":
            out = _plain_ring(mk, st, self.migratable_fns, abort_arr,
                              quantum, max_rounds, self.window, self.scan)
        else:
            # The ring reads no quiesce word (JAX's never reads
            # mk.checkpoint): only a traced table runs its observed
            # instance.
            out = run_mesh_kernel(
                "ici_ring", mk, st, self.migratable_fns, abort_arr, quantum,
                max_rounds, self.window, self.scan, (), 1, self.timeout_s,
                obs=(None if mk.trace is None else
                     {"cap": mk.trace.capacity, "ckpt": False}))
        t1_ns = time.monotonic_ns()
        info = mesh_info(st)
        if mk.trace is not None:
            info["trace"] = trace_info(list(out["rings"]), t0_ns, t1_ns,
                                       mk.trace.capacity)
        info["exchange"] = exchange_info(out)
        info["steal_rounds"] = int(info["per_device_counts"][0][C_ROUNDS])
        if mk.batch_specs:
            trows = st["tstats"].cpu().numpy()
            info["tiers"] = [mk.decode_tier_stats(trows[d])
                             for d in range(ndev)]
        info["aborted"] = bool(abort_arr[:, 0].any()) and info["pending"] != 0
        if info["overflow"]:
            raise RuntimeError("ici steal: task-table overflow")
        if info["pending"] != 0 and not info["aborted"]:
            raise StallError(
                f"ici steal stalled: {info['pending']} pending after "
                f"{info['executed']} executed ({info['steal_rounds']} rounds)",
                stats=info,
            )
        return st["ivalues"].cpu().numpy(), st["data"], info
