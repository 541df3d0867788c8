"""The persistent scheduler megakernel on an H100: a resident scheduler
loop in one CUDA kernel launch.

Port of the scalar tier of ``hclib_tpu/device/megakernel.py``. The TPU
runs the scheduler as one ``pallas_call`` whose scalar core pops task
descriptors off an SMEM ready ring and ``lax.switch``-es on ``F_FN`` over
a table of Pallas bodies. Here it is one CUDA kernel (``csrc/
megakernel.cu``) launched as ONE block: thread 0 runs the serial
scheduler (pop, dispatch, complete) exactly as the TPU's scalar core does,
so the pop order - and with it ``executed``, ``allocated`` and the whole
final task table - equals the JAX package's word for word; the tile bodies
use the whole block between two barriers.

What differs from the JAX class:

- The kernel table is fixed. CUDA cannot take Python closures, so
  ``Megakernel(kernels=[...])`` takes NAMES from the table compiled into
  the ``.cu`` (``BODIES``); a task's ``F_FN`` still indexes the instance's
  own list, so graphs and task tables are the JAX package's. Each body's
  static parameters (UTS seed/q_millis/m_children/max_depth, Cholesky
  tile/factor_base/nt) go in as kernel arguments (``params=``).
- Scheduler state lives in device memory and is updated IN PLACE (the
  task table, ready ring, counts and value tensors passed in are the
  outputs), the counterpart of JAX's ``input_output_aliases``.
- On a CPU tensor the same scheduler runs as plain Python
  (``_PlainCore``) over the same seven bodies; that is what the CPU tests
  and the card-side comparisons hold the kernel against.

Left out of this slice (each raises ``NotImplementedError`` naming its
ROADMAP entry): the batch tier, the vector tier, trace, checkpoint /
quiesce / ``resume``, priority buckets, lane ages, ``install_descriptor``
/ ``headroom``, the hclint ``verify`` hook and the program cache.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..runtime.resilience import StallError
from .descriptor import (
    DESC_WORDS,
    F_A0,
    F_CSR_N,
    F_CSR_OFF,
    F_DEP,
    F_FN,
    F_OUT,
    F_SUCC0,
    F_SUCC1,
    NO_TASK,
    TaskGraphBuilder,
)
from .state import resolve_device, tensor_of

__all__ = [
    "KernelContext", "Megakernel", "VBLOCK", "BODIES", "decode_overflow",
    "fault_mix",
]


def _i32(x):
    """Wrap a (Python or int64 array) integer to int32."""
    return ((x + 0x80000000) % 0x100000000) - 0x80000000


def fault_mix(seed: int, site: int, r, k: int, g):
    """Deterministic per-mille hash of (seed, site, round, hop, device),
    bit-identical to ``hclib_tpu.device.megakernel.fault_mix``: int32
    multiplies wrap and ``>>`` is arithmetic. ``r``/``g`` are Python ints
    or integer numpy arrays (computed in 64 bits, wrapped to 32)."""
    if isinstance(r, np.ndarray):
        r = r.astype(np.int64)
    if isinstance(g, np.ndarray):
        g = g.astype(np.int64)
    const = (k * 40503 + site * 2654435761 + seed * 2246822519) & 0x7FFFFFFF
    x = _i32(_i32(r * -1640531527) + _i32(g * 69069) + const)
    x = x ^ (x >> 13)
    x = _i32(x * 1274126177)
    x = x ^ (x >> 16)
    return (x & 0x7FFFFFFF) % 1000


def decode_overflow(mask: int) -> str:
    """Human-readable exhaustion sources from a C_OVERFLOW bitmask."""
    names = [
        (OVF_ROWS, "task-table rows"),
        (OVF_VALUES, "value slots"),
        (OVF_ENGINE, "vector-tier lane stacks/step budget"),
        (OVF_OUTBOX, "AM outbox"),
        (OVF_WAITS, "wait table"),
        (OVF_LOCKQ, "lock FIFO"),
        (OVF_PROMISE, "promise-wait spin budget"),
    ]
    hit = [n for bit, n in names if mask & bit]
    return " + ".join(hit) if hit else f"unknown (mask {mask})"


# Value slots come in blocks of this many words (row-owned blocks).
VBLOCK = 4

OVF_ROWS = 1
OVF_VALUES = 2
OVF_ENGINE = 4
OVF_OUTBOX = 8
OVF_WAITS = 16
OVF_LOCKQ = 32
OVF_PROMISE = 64

# counts[] slots
C_HEAD = 0
C_TAIL = 1
C_ALLOC = 2
C_PENDING = 3
C_VALLOC = 4
C_EXECUTED = 5
C_OVERFLOW = 6
C_ROUNDS = 7
C_VBASE = 7

# The kernel table compiled into csrc/megakernel.cu; the index is the
# body id of its ``switch``.
BODIES = ("fib", "sum", "uts_node", "potrf", "trsmcol", "updrow", "trsm")
TILE_BODIES = ("potrf", "trsmcol", "updrow", "trsm")
# Static body parameters, in the order of the kernel's meta words 0..6.
PARAMS = ("seed", "q_millis", "m_children", "max_depth", "tile",
          "factor_base", "nt")
META_FN_OF_BODY = 8   # meta[8 + body] = this table's F_FN of body, or -1
META_BODY_OF_FN = 16  # meta[16 + fn] = body id of F_FN fn, or -1
THREADS = 256         # block size when the table holds a tile body

# JAX constructor arguments this slice leaves out -> ROADMAP entry.
_LATER_ARGS = {
    "route": "batch tier (BatchSpec/BatchContext, rows 1g/1h) and "
             "vector tier (row 1i)",
    "auto_route": "vector tier (row 1i)",
    "trace": "single-device observability (tracebuf, row 1o)",
    "checkpoint": "single-device checkpoint / quiesce (row 1o)",
    "quiesce_stride": "single-device checkpoint / quiesce (row 1o)",
    "lane_max_age": "batch tier (rows 1g/1h)",
    "priority_buckets": "frontier and priority buckets (row 1l)",
    "verify": "hclint recording hook for CUDA bodies",
}


class KernelContext:
    """What a plain body sees of the scheduler (the JAX ``KernelContext``
    operations this slice's bodies use). The CUDA bodies do the same
    through the device functions of ``csrc/megakernel.cu``."""

    __slots__ = ("idx", "_c")

    def __init__(self, core: "_PlainCore", idx: int) -> None:
        self.idx = idx
        self._c = core

    @property
    def data(self):
        return self._c.data

    @property
    def params(self):
        return self._c.params

    def arg(self, i: int) -> int:
        return self._c.tasks[self.idx * DESC_WORDS + F_A0 + i]

    def set_arg(self, idx: int, i: int, v: int) -> None:
        self._c.tasks[idx * DESC_WORDS + F_A0 + i] = _i32(v)

    @property
    def out_slot(self) -> int:
        return self._c.tasks[self.idx * DESC_WORDS + F_OUT]

    def value(self, slot: int) -> int:
        return self._c.ivalues[slot]

    def set_value(self, slot: int, v: int) -> None:
        self._c.ivalues[slot] = _i32(v)

    def set_out(self, v: int) -> None:
        self.set_value(self.out_slot, v)

    def row_values(self, idx: int) -> int:
        return self._c.counts[C_VBASE] + idx * VBLOCK

    def push_ready(self, t: int) -> None:
        self._c.push_ready(t)

    def fn_id(self, name: str) -> int:
        """F_FN of body ``name`` in this megakernel's table."""
        return self._c.fn_of[name]

    def take_continuation(self, new_idx: int) -> None:
        t = self._c.tasks
        a, b = new_idx * DESC_WORDS, self.idx * DESC_WORDS
        t[a + F_SUCC0] = t[b + F_SUCC0]
        t[a + F_SUCC1] = t[b + F_SUCC1]
        t[a + F_CSR_OFF] = t[b + F_CSR_OFF]
        t[a + F_CSR_N] = t[b + F_CSR_N]
        t[b + F_SUCC0] = NO_TASK
        t[b + F_SUCC1] = NO_TASK
        t[b + F_CSR_N] = 0

    def spawn(self, fn: int, args: Sequence[int] = (), dep_count: int = 0,
              succ0: int = NO_TASK, succ1: int = NO_TASK, out: int = 0,
              nargs: Optional[int] = None) -> int:
        """Allocate + enqueue a task row (free stack first, then the bump
        cursor; on table overflow the row index clamps to capacity-1, the
        task is dropped and OVF_ROWS is set - the host raises after the
        run). Returns the row index."""
        if nargs is None:
            nargs = 6
        if len(args) > nargs:
            raise ValueError(f"{len(args)} args exceed declared nargs={nargs}")
        c = self._c
        cnt, free, cap, t = c.counts, c.free, c.capacity, c.tasks
        nfree = free[0]
        use_free = nfree > 0
        a_new = cnt[C_ALLOC]
        ok = use_free or a_new < cap
        a = free[max(nfree, 1)] if use_free else min(a_new, cap - 1)
        if use_free:
            free[0] = nfree - 1
        elif a_new < cap:
            cnt[C_ALLOC] = a_new + 1
        if ok:
            cnt[C_PENDING] += 1
            r = a * DESC_WORDS
            t[r + F_FN] = fn
            t[r + F_DEP] = dep_count
            t[r + F_SUCC0] = succ0
            t[r + F_SUCC1] = succ1
            t[r + F_CSR_N] = 0
            for i in range(nargs):
                t[r + F_A0 + i] = _i32(args[i]) if i < len(args) else 0
            t[r + F_OUT] = out
            if dep_count == 0:
                c.push_ready(a)
        else:
            cnt[C_OVERFLOW] |= OVF_ROWS
        return a


class _PlainCore:
    """The plain version of the CUDA scheduler: the same stage / sched /
    complete over Python lists made from the state tensors (written back
    at exit)."""

    def __init__(self, mk: "Megakernel", st: Dict[str, object]) -> None:
        self.capacity = mk.capacity
        self.num_values = mk.num_values
        self.params = mk.params
        self.fn_of = mk.fn_of
        self.bodies = [mk._plain[n] for n in mk.kernel_names]
        self.body_ids = [BODIES.index(n) for n in mk.kernel_names]
        self.st = st
        self.tasks_in = st["tasks"].flatten().tolist()
        self.ready_in = st["ready"].tolist()
        self.counts_in = st["counts"].tolist()
        self.ivalues_in = st["ivalues"].tolist()
        self.succ = st["succ"].tolist()
        self.tasks = list(self.tasks_in)
        self.ready = list(self.ready_in)
        self.counts = list(self.counts_in)
        self.ivalues = list(self.ivalues_in)
        self.data = st["data"]
        self.free = [0] * (self.capacity + 1)
        self.dispatch = [0] * 8

    def stage(self, stage_all_values: bool) -> None:
        cin, free, cap = self.counts_in, self.free, self.capacity
        free[0] = 0
        self.counts[:] = cin
        self.counts[C_VBASE] = cin[C_VALLOC]
        for i in range(cin[C_ALLOC]):
            r = i * DESC_WORDS
            self.tasks[r:r + DESC_WORDS] = self.tasks_in[r:r + DESC_WORDS]
            if self.tasks_in[r + F_DEP] == -1:
                free[0] += 1
                free[free[0]] = i
        nready = cap if cin[C_HEAD] < 0 else min(cin[C_TAIL], cap)
        self.ready[:nready] = self.ready_in[:nready]
        nval = self.num_values if stage_all_values else cin[C_VALLOC]
        self.ivalues[:nval] = self.ivalues_in[:nval]

    def push_ready(self, t: int) -> None:
        tail = self.counts[C_TAIL]
        self.ready[tail % self.capacity] = t
        self.counts[C_TAIL] = tail + 1

    def complete(self, idx: int) -> None:
        t, c = self.tasks, self.counts
        r = idx * DESC_WORDS
        for s in (t[r + F_SUCC0], t[r + F_SUCC1]):
            self._dec(s)
        off = t[r + F_CSR_OFF]
        for i in range(t[r + F_CSR_N]):
            self._dec(self.succ[off + i])
        c[C_PENDING] -= 1
        c[C_EXECUTED] += 1
        t[r + F_DEP] = -1
        self.free[0] += 1
        self.free[self.free[0]] = idx

    def _dec(self, s: int) -> None:
        if s != NO_TASK:
            d = self.tasks[s * DESC_WORDS + F_DEP] - 1
            self.tasks[s * DESC_WORDS + F_DEP] = d
            if d == 0:
                self.push_ready(s)

    def sched(self, fuel: int) -> None:
        c, ready, cap = self.counts, self.ready, self.capacity
        nfn = len(self.bodies)
        e0 = c[C_EXECUTED]
        while c[C_PENDING] > 0 and c[C_EXECUTED] - e0 < fuel:
            tail = c[C_TAIL]
            if c[C_HEAD] >= tail:
                break
            idx = ready[(tail - 1) % cap]
            c[C_TAIL] = tail - 1
            # lax.switch clamps an out-of-range index; so does the kernel.
            fn = min(max(self.tasks[idx * DESC_WORDS + F_FN], 0), nfn - 1)
            self.dispatch[self.body_ids[fn]] += 1
            self.bodies[fn](KernelContext(self, idx))
            self.complete(idx)

    def run(self, fuel: int, reps: int, stage_all_values: bool) -> None:
        total = 0
        for _ in range(reps):
            self.stage(stage_all_values)
            self.sched(fuel)
            total += self.counts[C_EXECUTED]
        self.counts[C_EXECUTED] = _i32(total)
        st = self.st
        st["tasks"].copy_(torch.tensor(self.tasks, dtype=torch.int32)
                          .view(self.capacity, DESC_WORDS))
        st["ready"].copy_(torch.tensor(self.ready, dtype=torch.int32))
        st["counts"].copy_(torch.tensor(self.counts, dtype=torch.int32))
        st["ivalues"].copy_(torch.tensor(self.ivalues, dtype=torch.int32))


def _plain_bodies() -> Dict[str, object]:
    # The bodies live with their workloads, as in the JAX package.
    from .cholesky import potrf_body, trsm_body, trsmcol_body, updrow_body
    from .workloads import fib_body, sum_body, uts_node_body

    return {
        "fib": fib_body, "sum": sum_body, "uts_node": uts_node_body,
        "potrf": potrf_body, "trsmcol": trsmcol_body, "updrow": updrow_body,
        "trsm": trsm_body,
    }


class Megakernel:
    """Builds and runs the single-block scheduler kernel over a task DAG.

    ``kernels`` is the ordered kernel table: names from ``BODIES``; a
    task's F_FN indexes it. ``data_specs`` maps buffer names to
    ``(shape, dtype)``; ``params`` gives the bodies' static parameters
    (``PARAMS``). Runs on ``device`` (default ``"cuda"``; ``"cpu"`` runs
    the plain version).
    """

    def __init__(
        self,
        kernels: Sequence[str],
        data_specs: Optional[Dict[str, tuple]] = None,
        capacity: int = 4096,
        num_values: int = 4096,
        succ_capacity: int = 4096,
        uses_row_values: bool = False,
        params: Optional[Dict[str, int]] = None,
        device="cuda",
        **later,
    ) -> None:
        for name, value in later.items():
            if name not in _LATER_ARGS:
                raise TypeError(f"unexpected argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"Megakernel({name}=...) is not ported yet: "
                    f"{_LATER_ARGS[name]} in ROADMAP.md"
                )
        names = list(kernels)
        for n in names:
            if n not in BODIES:
                raise ValueError(
                    f"unknown kernel {n!r}: the table compiled into "
                    f"csrc/megakernel.cu holds {BODIES}"
                )
        if not names:
            raise ValueError("empty kernel table")
        self.kernel_names = names
        self.fn_of = {n: i for i, n in enumerate(names)}
        self.params = {p: 0 for p in PARAMS}
        for p, v in (params or {}).items():
            if p not in self.params:
                raise ValueError(f"unknown body parameter {p!r}")
            self.params[p] = int(v)
        self.data_specs = dict(data_specs or {})
        self.capacity = capacity
        self.num_values = num_values
        self.succ_capacity = succ_capacity
        self.uses_row_values = uses_row_values
        self.device = resolve_device(device)
        self.tile_bodies = [n for n in names if n in TILE_BODIES]
        if self.tile_bodies and set(self.data_specs) != {
            "tiles", "linvsp", "lsp"
        }:
            raise ValueError(
                "tile bodies need data buffers tiles/linvsp/lsp"
            )
        meta = [0] * (META_BODY_OF_FN + len(names))
        for i, p in enumerate(PARAMS):
            meta[i] = self.params[p]
        for b, n in enumerate(BODIES):
            meta[META_FN_OF_BODY + b] = self.fn_of.get(n, -1)
        for fn, n in enumerate(names):
            meta[META_BODY_OF_FN + fn] = BODIES.index(n)
        self._meta = meta
        self._plain = _plain_bodies()

    # -- host entry --

    @staticmethod
    def widen_value_alloc(counts_row, ivalues_row) -> None:
        """Widen counts_row[C_VALLOC] over the highest nonzero preset in
        ivalues_row (in place)."""
        nz = np.flatnonzero(np.asarray(ivalues_row))
        if len(nz):
            counts_row[C_VALLOC] = max(counts_row[C_VALLOC], int(nz[-1]) + 1)

    def check_row_values(self, value_alloc: int) -> None:
        """For uses_row_values kernels: every row's block must fit."""
        if not self.uses_row_values:
            return
        need = value_alloc + VBLOCK * self.capacity
        if need > self.num_values:
            raise ValueError(
                f"row-owned value blocks need num_values >= value_alloc"
                f"({value_alloc}) + VBLOCK*capacity({VBLOCK * self.capacity})"
                f" = {need}, got {self.num_values}; shrink out slots/presets "
                "or grow num_values"
            )

    def _check_data(self, data: Dict[str, torch.Tensor]) -> None:
        if set(data) != set(self.data_specs):
            raise ValueError(
                f"data buffers {sorted(data)} != declared "
                f"{sorted(self.data_specs)}"
            )
        for k, (shape, dtype) in self.data_specs.items():
            t = data[k]
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise ValueError(
                    f"data[{k!r}] is {tuple(t.shape)} {t.dtype}, declared "
                    f"{tuple(shape)} {dtype}"
                )

    def state(self, builder: TaskGraphBuilder, data=None, ivalues=None):
        """The staged state of ``builder``'s graph as tensors on this
        megakernel's device (what ``launch`` takes)."""
        tasks, succ, ring, counts = builder.finalize(
            capacity=self.capacity, succ_capacity=self.succ_capacity
        )
        if ivalues is None:
            ivalues = np.zeros(self.num_values, dtype=np.int32)
        else:
            counts = counts.copy()
            self.widen_value_alloc(counts, ivalues)
        self.check_row_values(int(counts[C_VALLOC]))
        dev = self.device
        return {
            "tasks": tensor_of(tasks, dev),
            "succ": tensor_of(succ, dev),
            "ready": tensor_of(ring, dev),
            "counts": tensor_of(counts, dev),
            "ivalues": tensor_of(np.asarray(ivalues, np.int32), dev),
            "data": {
                k: v.to(dev) if isinstance(v, torch.Tensor)
                else tensor_of(v, dev)
                for k, v in dict(data or {}).items()
            },
        }

    def launch(self, st: Dict[str, object], fuel: int = 1 << 22,
               reps: int = 1, stage_all_values: bool = False) -> torch.Tensor:
        """Run the scheduler over state ``st`` IN PLACE (its task table,
        ready ring, counts, value slots and data buffers are the outputs).
        ``reps`` > 1 re-stages the input state and re-runs the graph, with
        C_EXECUTED accumulated across reps. Returns the per-body dispatch
        counts (int32[8] by body id, on the state's device; not synced).

        On CUDA tensors this launches the kernel (and raises if the launch
        fails); on CPU tensors it runs the plain version."""
        self._check_data(st["data"])
        tasks = st["tasks"]
        if tasks.device.type == "cpu":
            core = _PlainCore(self, st)
            core.run(int(fuel), int(reps), stage_all_values)
            return torch.tensor(core.dispatch, dtype=torch.int32)
        return self._launch_cuda(st, int(fuel), int(reps), stage_all_values)

    def _launch_cuda(self, st, fuel, reps, stage_all_values) -> torch.Tensor:
        dev = st["tasks"].device
        cap, nv = self.capacity, self.num_values
        want = {
            "tasks": ((cap, DESC_WORDS), torch.int32),
            "succ": ((self.succ_capacity,), torch.int32),
            "ready": ((cap,), torch.int32),
            "counts": ((8,), torch.int32),
            "ivalues": ((nv,), torch.int32),
        }
        for k, (shape, dtype) in want.items():
            t = st[k]
            if (tuple(t.shape) != shape or t.dtype != dtype
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(
                    f"state[{k!r}] must be a contiguous {shape} {dtype} "
                    f"tensor on {dev}"
                )
        for t in st["data"].values():
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"data buffers must be contiguous on {dev}")
        # reps > 1 re-stages from the inputs: keep them apart.
        ins = {k: (st[k].clone() if reps > 1 else st[k])
               for k in ("tasks", "ready", "counts", "ivalues")}
        free = torch.empty(cap + 1, dtype=torch.int32, device=dev)
        dispatch = torch.zeros(8, dtype=torch.int32, device=dev)
        meta = torch.tensor(self._meta, dtype=torch.int32, device=dev)
        data = st["data"]
        ptr = lambda k: data[k].data_ptr() if k in data else None  # noqa: E731
        work = None
        threads, smem = 32, 0
        if self.tile_bodies:
            ts = self.params["tile"]
            work = torch.empty(ts * ts, dtype=torch.float32, device=dev)
            threads = THREADS
            if "potrf" in self.tile_bodies:
                smem = potrf_smem_bytes(self.params["factor_base"])
        lib = _build.library("megakernel")
        fn = lib.hclib_mk_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p
        ]
        err = fn(
            st["tasks"].data_ptr(), ins["tasks"].data_ptr(),
            st["succ"].data_ptr(),
            st["ready"].data_ptr(), ins["ready"].data_ptr(),
            st["counts"].data_ptr(), ins["counts"].data_ptr(),
            st["ivalues"].data_ptr(), ins["ivalues"].data_ptr(),
            free.data_ptr(), meta.data_ptr(), dispatch.data_ptr(),
            ptr("tiles"), ptr("linvsp"), ptr("lsp"),
            work.data_ptr() if work is not None else None,
            len(self.kernel_names), cap, nv, min(fuel, 0x7FFFFFFF), reps,
            int(bool(stage_all_values)), threads, smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "megakernel")
        _build.LAUNCHES["megakernel"] += 1
        return dispatch

    def fold_dispatches(self, dispatch: torch.Tensor) -> Dict[str, int]:
        """Per-body dispatch counts of a ``launch`` by name. For a launch
        on the card, each tile body's dispatches are its launches inside
        the megakernel and are added to ``_build.LAUNCHES``."""
        n = dispatch.tolist()
        out = {b: n[i] for i, b in enumerate(BODIES) if b in self.fn_of}
        if dispatch.device.type == "cuda":
            for b in self.tile_bodies:
                _build.LAUNCHES[b] += out[b]
        return out

    def run(self, builder: TaskGraphBuilder, data=None, ivalues=None,
            fuel: int = 1 << 22):
        """Execute the task graph to completion; returns
        (ivalues numpy array, data dict of tensors, info dict)."""
        st = self.state(builder, data, ivalues)
        dispatch = self.launch(st, fuel)
        counts_np = st["counts"].cpu().numpy()
        ivalues_np = st["ivalues"].cpu().numpy()
        info = {
            "executed": int(counts_np[C_EXECUTED]),
            "pending": int(counts_np[C_PENDING]),
            "allocated": int(counts_np[C_ALLOC]),
            "value_alloc": int(counts_np[C_VALLOC]),
            "overflow": bool(counts_np[C_OVERFLOW]),
            "dispatch": self.fold_dispatches(dispatch),
            "device": str(st["tasks"].device),
        }
        if info["overflow"]:
            raise RuntimeError(
                f"megakernel overflow: "
                f"{decode_overflow(int(counts_np[C_OVERFLOW]))} exhausted "
                f"(capacity={self.capacity}, num_values={self.num_values}); "
                "raise the limits, coarsen tasks, or audit frees"
            )
        if info["pending"] != 0:
            raise StallError(
                f"megakernel stalled with {info['pending']} pending tasks "
                f"after {info['executed']} executed (dependency cycle or fuel "
                f"{fuel} exhausted)",
                stats=info,
            )
        return ivalues_np, st["data"], info


def potrf_smem_bytes(factor_base: int) -> int:
    """Dynamic shared memory of the POTRF body: the diagonal block and its
    inverse, each factor_base x (factor_base + 1) f32."""
    return 2 * factor_base * (factor_base + 1) * 4
