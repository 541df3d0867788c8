"""The sharded megakernel on one card: one resident scheduler per mesh
device, a mesh device being one CTA.

Port of ``hclib_tpu/device/sharded.py``: ``abort_words`` (:67),
``partition_builders`` (:91), the host half of ``execute_partitions``
(:108), ``ShardedMegakernel`` (:190) and ``round_robin_partition``
(:632). JAX runs the megakernel once per device under ``shard_map`` and
combines the devices with XLA collectives; here the devices' states are
stacked on a leading mesh axis on the card and:

- ``steal=False`` is one grid launch (``megakernel.MeshGrid``: block d
  runs the scheduler on device d's slice, csrc/mesh.cuh
  ``mk_grid_kernel``), the global counts a sum over the mesh axis (JAX's
  ``psum``);
- ``steal=True`` is a host loop of rounds, each one grid launch of
  ``quantum`` tasks a device (all value slots staged, lanes spilled at
  exit), then the bulk-synchronous exchange at each hop distance ([1, 2,
  4, ...] or ``hop_order``) as torch ops on the stacked state: the
  head-window export with its compaction and tombstones, the rotation
  (JAX's ``ppermute``) as ``torch.roll`` along the mesh axis, the
  tombstone-first import; until the summed pending is 0 or
  ``max_rounds``. The tier counters are summed over the rounds.

JAX's scatters drop out-of-bounds lanes (``mode="drop"``, index ``cap``
or ``K``) and ``jnp.nonzero(size=K, fill_value=cap)`` pads with ``cap``;
the torch exchange indexes only the lanes JAX keeps, so the stacked state
after every round equals JAX's word for word. On CPU tensors the grid
launch is the plain core device by device (``Megakernel.launch``), which
the CPU tests hold against JAX.

Left out: the program cache (``info["program_cache"]``, ROADMAP A13).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .descriptor import (
    DESC_WORDS,
    F_CSR_N,
    F_DEP,
    F_FN,
    F_SUCC0,
    F_SUCC1,
    NO_TASK,
    TaskGraphBuilder,
)
from .megakernel import (
    C_ALLOC,
    C_EXECUTED,
    C_HEAD,
    C_OVERFLOW,
    C_PENDING,
    C_ROUNDS,
    C_TAIL,
    C_VALLOC,
    TS_WORDS,
    Megakernel,
    MeshGrid,
)
from .state import tensor_of

__all__ = [
    "ShardedMegakernel",
    "round_robin_partition",
    "partition_builders",
    "abort_words",
    "mesh_state",
    "mesh_info",
]


def abort_words(abort, ndev: int) -> np.ndarray:
    """A runner's ``abort=`` argument (None / truthy scalar / per-device
    sequence of flags) as the (ndev, 8) int32 abort-word rows the round
    loops re-read (word 0 of row d is device d's flag)."""
    arr = np.zeros((ndev, 8), np.int32)
    if abort is None:
        return arr
    if isinstance(abort, np.ndarray) and abort.ndim == 0:
        abort = bool(abort)  # 0-d array: a scalar flag, not a sequence
    flags = (
        list(abort)
        if isinstance(abort, (list, tuple, np.ndarray))
        else [abort] * ndev
    )
    if len(flags) != ndev:
        raise ValueError(
            f"abort wants {ndev} per-device flags, got {len(flags)}"
        )
    for d, f in enumerate(flags):
        arr[d, 0] = 1 if f else 0
    return arr


def partition_builders(
    mk: Megakernel, ndev: int, builders: Sequence[TaskGraphBuilder]
):
    """Finalize one builder per device into stacked (tasks, succ, ring,
    counts) arrays - shared by every multi-device runner."""
    if len(builders) != ndev:
        raise ValueError(f"need {ndev} partitions, got {len(builders)}")
    cap, scap = mk.capacity, mk.succ_capacity
    parts = [b.finalize(capacity=cap, succ_capacity=scap) for b in builders]
    return tuple(np.stack([p[i] for p in parts]) for i in range(4))


def mesh_state(mk: Megakernel, ndev: int, device,
               builders: Sequence[TaskGraphBuilder],
               data: Optional[Dict[str, Any]], ivalues, mutate=None,
               state: Optional[Dict[str, Any]] = None
               ) -> Dict[str, object]:
    """The host half of JAX's ``execute_partitions``: partition the
    builders, widen each device's value alloc over its presets, let
    ``mutate(tasks, succ, ring, counts)`` adjust the stacked arrays,
    check the row blocks and the data keys, and stack everything on
    ``device`` (tensors with a leading mesh axis; data buffers per
    device, stacked). ``state`` (a quiesced run's ``info['state']``)
    replaces the partitioning and the widening: its stacked tasks, succ,
    ready, counts and ivalues are staged as they are."""
    if state is not None:
        tasks, succ, ring, counts, ivalues = (
            np.array(state[k], np.int32)
            for k in ("tasks", "succ", "ready", "counts", "ivalues"))
        if tasks.shape[0] != ndev:
            raise ValueError(f"resume_state covers {tasks.shape[0]} "
                             f"devices, this mesh has {ndev}")
    else:
        tasks, succ, ring, counts = partition_builders(mk, ndev, builders)
        if ivalues is None:
            ivalues = np.zeros((ndev, mk.num_values), np.int32)
        else:
            ivalues = np.asarray(ivalues, np.int32)
            for d in range(ndev):
                mk.widen_value_alloc(counts[d], ivalues[d])
    if mutate is not None:
        mutate(tasks, succ, ring, counts)
    for c in counts:
        mk.check_row_values(int(c[C_VALLOC]))
    data = dict(data or {})
    if set(data) != set(mk.data_specs):
        raise ValueError(
            f"data buffers {sorted(data)} != declared {sorted(mk.data_specs)}"
        )
    st = {
        "tasks": tensor_of(tasks, device),
        "succ": tensor_of(succ, device),
        "ready": tensor_of(ring, device),
        "counts": tensor_of(counts, device),
        "ivalues": tensor_of(ivalues, device),
        "data": {
            k: (v.to(device).contiguous() if isinstance(v, torch.Tensor)
                else tensor_of(v, device))
            for k, v in data.items()
        },
    }
    if mk.batch_specs:
        st["tstats"] = torch.zeros(ndev, TS_WORDS, dtype=torch.int32,
                                   device=device)
    return st


def mesh_info(st: Dict[str, object]) -> Dict[str, object]:
    """The global counts of a finished mesh run (JAX's ``psum`` of the
    counts rows) and the per-device rows."""
    counts = st["counts"].cpu().numpy()
    g = counts.sum(0, dtype=np.int32)
    return {
        "executed": int(g[C_EXECUTED]),
        "pending": int(g[C_PENDING]),
        "overflow": bool(g[C_OVERFLOW]),
        "per_device_counts": counts,
    }


def _exchange(tasks: torch.Tensor, ready: torch.Tensor,
              counts: torch.Tensor, dist: int, K: int,
              wl: torch.Tensor) -> None:
    """One hop of sharded.py's exchange (:404-490) at distance ``dist``
    over the stacked state, in place."""
    ndev, cap = ready.shape
    dev = tasks.device
    j = torch.arange(K, device=dev)
    devs = torch.arange(ndev, device=dev)[:, None]
    head, tail = counts[:, C_HEAD].long(), counts[:, C_TAIL].long()
    # ---- export: eligible rows of the head-side window, oldest first,
    # compacted across the whole window; the kept ones back to the head.
    backlog = tail - head
    gavg = torch.div(backlog.sum(), ndev, rounding_mode="floor")
    quota = (backlog - gavg).clamp(0, K)
    scanned = j[None, :] < backlog.clamp(max=K)[:, None]
    cand = ready.gather(1, torch.remainder(head[:, None] + j, cap)).long()
    desc = tasks[devs, cand.clamp(0, cap - 1)]
    fn = desc[..., F_FN].long().clamp(0, wl.shape[0] - 1)
    elig = (scanned & (cand >= 0) & wl[fn]
            & (desc[..., F_SUCC0] == NO_TASK)
            & (desc[..., F_SUCC1] == NO_TASK) & (desc[..., F_CSR_N] == 0))
    rank_e = elig.long().cumsum(1) - 1
    send = elig & (rank_e < quota[:, None])
    nsend = send.long().sum(1)
    sendbuf = torch.zeros(ndev, K, DESC_WORDS, dtype=torch.int32, device=dev)
    si, sj = send.nonzero(as_tuple=True)
    sendbuf[si, rank_e[si, sj]] = desc[si, sj]
    keep = scanned & ~send
    rank_k = keep.long().cumsum(1) - 1
    ki, kj = keep.nonzero(as_tuple=True)
    ready[ki, torch.remainder(head[ki] + nsend[ki] + rank_k[ki, kj], cap)] = \
        cand[ki, kj].int()
    # Tombstone the exported rows: the task now lives on the neighbour.
    tasks[si, cand[si, sj], F_DEP] = -1
    counts[:, C_HEAD] += nsend.int()
    counts[:, C_PENDING] -= nsend.int()
    # ---- the rotation: device (i + dist) % ndev receives from i.
    recvbuf = torch.roll(sendbuf, dist, 0)
    nrecv = torch.roll(nsend, dist, 0)
    # ---- import: tombstoned rows first (ascending), then fresh rows.
    alloc = counts[:, C_ALLOC].long()
    tomb = (tasks[..., F_DEP] == -1) & (
        torch.arange(cap, device=dev)[None, :] < alloc[:, None])
    rank_t = tomb.long().cumsum(1) - 1
    reuse = torch.full((ndev, K), cap, dtype=torch.long, device=dev)
    ti, tj = (tomb & (rank_t < K)).nonzero(as_tuple=True)
    reuse[ti, rank_t[ti, tj]] = tj
    ntomb = tomb.long().sum(1)
    can = torch.minimum(nrecv, ntomb + (cap - alloc))
    nre = torch.minimum(can, ntomb)
    rows = torch.where(j[None, :] < nre[:, None], reuse,
                       alloc[:, None] + j[None, :] - nre[:, None])
    ai, aj = (j[None, :] < can[:, None]).nonzero(as_tuple=True)
    tasks[ai, rows[ai, aj]] = recvbuf[ai, aj]
    ready[ai, torch.remainder(tail[ai] + aj, cap)] = rows[ai, aj].int()
    counts[:, C_ALLOC] += (can - nre).int()
    counts[:, C_TAIL] += can.int()
    counts[:, C_PENDING] += can.int()
    counts[:, C_OVERFLOW] = torch.maximum(counts[:, C_OVERFLOW],
                                          (nrecv > can).int())


class _Clock:
    """Sums the time of named spans: CUDA events on the card (read once,
    at the end), the host's clock on the CPU."""

    def __init__(self, dev) -> None:
        self.cuda = dev.type == "cuda"
        self.spans: Dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            yield
            e.record()
            self.spans.setdefault(name, []).append((s, e))
        else:
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    def totals(self) -> Dict[str, float]:
        """{name + "_ms": total ms} (the card's spans synchronised)."""
        out = {}
        for name, spans in self.spans.items():
            if self.cuda:
                spans[-1][1].synchronize()
                ms = sum(s.elapsed_time(e) for s, e in spans)
            else:
                ms = sum(spans)
            out[name + "_ms"] = float(ms)
        return out


class ShardedMegakernel:
    """Runs one ``Megakernel`` per device of a 1D mesh
    (``parallel.mesh.CtaMesh``: CTAs on the card, or the CPU mesh).

    ``data`` buffers are per device, stacked on a leading mesh axis;
    ``migratable_fns`` lists the kernel-table ids whose successor-free
    ready rows may migrate in the steal rounds.
    """

    def __init__(
        self,
        mk: Megakernel,
        mesh,
        migratable_fns: Iterable[int] = (),
    ) -> None:
        if len(mesh.axis_names) != 1:
            raise ValueError("ShardedMegakernel wants a 1D mesh (queue axis)")
        # The trace ring and the quiesce poll cannot ride this runner (the
        # steal loop re-enters the kernel every round); when they came
        # from the environment the runner builds without them (its own
        # launches only), else it refuses, as JAX's does (:213-262).
        log = logging.getLogger("hclib_tpu_torch.device")
        self._suppress_trace = False
        if mk.trace is not None:
            if getattr(mk, "trace_from_env", False):
                log.warning("ShardedMegakernel cannot trace; ignoring "
                            "HCLIB_TPU_TRACE for this runner's launches")
                self._suppress_trace = True
            else:
                raise ValueError(
                    "ShardedMegakernel does not support the trace ring; "
                    "build the Megakernel with trace=None"
                )
        self._suppress_ckpt = False
        if mk.checkpoint:
            if getattr(mk, "checkpoint_from_env", False):
                log.warning("ShardedMegakernel cannot checkpoint; ignoring "
                            "HCLIB_TPU_CHECKPOINT for this runner's "
                            "launches")
                self._suppress_ckpt = True
            else:
                raise ValueError(
                    "ShardedMegakernel does not support checkpoint "
                    "quiesce; build the Megakernel with checkpoint=False"
                )
        self.mk = mk
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.ndev = int(np.prod(mesh.dims))
        self.migratable_fns = frozenset(int(f) for f in migratable_fns)
        bad = [f for f in self.migratable_fns
               if not 0 <= f < len(mk.kernel_names)]
        if bad:
            raise ValueError(
                f"migratable_fns {sorted(bad)} outside the kernel "
                f"table (0..{len(mk.kernel_names) - 1})"
            )

    @contextlib.contextmanager
    def _maybe_untraced(self):
        """Env-derived trace/checkpoint suppression for this runner's
        launches; the shared Megakernel keeps its options afterwards."""
        saved = self.mk.trace, self.mk.checkpoint
        if self._suppress_trace:
            self.mk.trace = None
        if self._suppress_ckpt:
            self.mk.checkpoint = False
        try:
            yield
        finally:
            self.mk.trace, self.mk.checkpoint = saved

    def partition(self, builders: Sequence[TaskGraphBuilder]):
        """Finalize one builder per device into stacked arrays."""
        return partition_builders(self.mk, self.ndev, builders)

    def _hop_dists(self, hop_order) -> List[int]:
        ndev = self.ndev
        if hop_order is None:
            return [d for d in (1 << k for k in range(16)) if d < ndev]
        hops = [int(d) for d in hop_order]
        if not hops or any(not 1 <= d < ndev for d in hops):
            raise ValueError(
                f"hop_order must be nonempty distances in "
                f"[1, {ndev}), got {hops}"
            )
        return hops

    def run(
        self,
        builders: Sequence[TaskGraphBuilder],
        data: Optional[Dict[str, Any]] = None,
        ivalues: Optional[np.ndarray] = None,
        fuel: int = 1 << 22,
        steal: bool = False,
        quantum: int = 256,
        window: int = 32,
        max_rounds: int = 1 << 16,
        hop_order: Optional[Sequence[int]] = None,
    ):
        """Execute all partitions; returns (ivalues[ndev, V] numpy, data
        dict of stacked tensors, info).

        ``steal=True``: rounds of ``quantum`` tasks a device, then up to
        ``window`` surplus migratable ready rows a hop distance move along
        the mesh ring; ``hop_order`` reorders the hop distances."""
        mk, ndev = self.mk, self.ndev
        hops = self._hop_dists(hop_order) if steal else None
        st = mesh_state(mk, ndev, self.mesh.device, builders, data, ivalues)
        clock = _Clock(st["tasks"].device)
        with self._maybe_untraced():
            grid = MeshGrid(mk, st, quantum if steal else fuel,
                            stage_all_values=steal)
            if not steal:
                grid.launch(clock("kernel"))
                tacc = st.get("tstats")
            else:
                dev = st["tasks"].device
                wl = torch.zeros(max(1, len(mk.kernel_names)),
                                 dtype=torch.bool, device=dev)
                for f in self.migratable_fns:
                    wl[f] = True
                tacc = torch.zeros(ndev, TS_WORDS, dtype=torch.int32,
                                   device=dev) if mk.batch_specs else None
                rounds = 0
                while (rounds < max_rounds
                       and int(st["counts"][:, C_PENDING].sum()) > 0):
                    grid.launch(clock("kernel"))
                    if tacc is not None:
                        tacc += st["tstats"]
                    with clock("exchange"):
                        for dist in hops:
                            _exchange(st["tasks"], st["ready"],
                                      st["counts"], dist, window, wl)
                    rounds += 1
                st["counts"][:, C_ROUNDS] = rounds
            mk.fold_dispatches(grid.dispatch())
        info = mesh_info(st)
        info.update(clock.totals())
        if steal:
            info["steal_rounds"] = int(info["per_device_counts"][0][C_ROUNDS])
        if mk.batch_specs:
            trows = tacc.cpu().numpy()
            info["tiers"] = [mk.decode_tier_stats(trows[d])
                             for d in range(ndev)]
        if info["overflow"]:
            raise RuntimeError("sharded megakernel task-table overflow")
        if info["pending"] != 0:
            raise RuntimeError(
                f"sharded megakernel stalled with {info['pending']} pending "
                f"tasks after {info['executed']} executed (dependency cycle "
                f"or fuel {fuel} exhausted)"
            )
        return st["ivalues"].cpu().numpy(), st["data"], info


def round_robin_partition(
    items: Sequence[Any], ndev: int
) -> List[List[Any]]:
    """Deal independent work items across devices."""
    parts: List[List[Any]] = [[] for _ in range(ndev)]
    for i, it in enumerate(items):
        parts[i % ndev].append(it)
    return parts
