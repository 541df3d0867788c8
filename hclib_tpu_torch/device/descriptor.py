"""Task-descriptor ABI and host-side task-graph builder.

The port's own copy of ``hclib_tpu/device/descriptor.py`` (word for word
below this paragraph): the port imports nothing of the JAX package, and
``finalize()`` must return the same numpy arrays so both packages can be
fed identical state. The words above ``DESC_WORDS`` describe JAX-side
injection rings; the port keeps them so the ABI tables stay identical.

A task is a fixed row of 16 int32 words - the device replacement for the
reference's heap task struct + promise waiter lists (inc/hclib-task.h:32-44,
inc/hclib-promise.h:76-90). Dependencies are inverted relative to the
reference: instead of tasks registering on promises, each task carries a
*dependency counter* and every task lists its *successors*; completing a task
decrements each successor's counter and pushes those that reach zero onto the
ready ring. (The reference's one-at-a-time registration walk exists to avoid
locks on the waiter list; on-device, the scheduler loop is single-threaded
per core, so plain counters are the natural design.)

Word layout (all int32):

    0  F_FN       kernel-table index (what to run)
    1  F_DEP      remaining unsatisfied dependencies (runnable at 0)
    2  F_SUCC0    inline successor task index, or NO_TASK
    3  F_SUCC1    inline successor task index, or NO_TASK
    4  F_CSR_OFF  offset into the successor-CSR array (extra successors)
    5  F_CSR_N    number of CSR successors
    6..11 F_A0+i  six argument words (meaning defined by the kernel)
    12 F_OUT      output value slot (index into the int32 value buffer)
    13 F_HOME     home device (flat mesh index) of a migrated task, or -1.
                  A row with F_HOME >= 0 is a *traveling copy*: a proxy row
                  F_HROW still exists on device F_HOME holding the real
                  successor links, and completing this copy forwards its
                  out-slot value home via a remote-completion active message
                  (device/resident.py) - the TPU re-design of the reference
                  thief taking dependency-bearing tasks out of a victim's
                  deque (src/hclib-deque.c:75-106), where shared memory made
                  links location-transparent.
    14 F_HROW     proxy row index on device F_HOME (valid iff F_HOME >= 0)
    15 F_VMASK    bitmask of arg words carrying *dereferenced values* (a
                  migrated task's value-slot args are resolved at export and
                  rehydrated into local slots at install)

Static DAGs (Cholesky, Smith-Waterman) are built host-side with
``TaskGraphBuilder``; dynamic tasks (fib, UTS) are allocated on-device by
kernels via ``KernelContext.spawn``.

Injection-ring row extension (multi-tenant ingress, device/tenants.py):
ring rows are padded to 256 words (``RING_ROW``, device/inject.py) so any
row offset DMA-aligns, and the pad words directly above the descriptor
ABI carry *transport metadata* the scheduler never copies
(``install_descriptor`` reads exactly ``DESC_WORDS`` words):

    16 TEN_ID      tenant lane index of an injected row (0 = default lane)
    17 TEN_EXPIRED nonzero = the row's admission deadline passed while it
                   sat on the ring; the in-kernel tenant poll drops it
                   (counted, a ``TenantExpired`` record) instead of
                   installing it
    18 TEN_DEADLINE_MS  the row's REMAINING admission-deadline budget in
                   milliseconds (0 = no deadline), stamped by the host at
                   checkpoint export and re-armed against the resuming
                   clock - deadlines survive a cut as remaining budget,
                   never as stale wall-clock instants. Host-only: the
                   device poll never reads it.
    19 TEN_TOKEN   submit token of a tracked request (0 = fire-and-forget
                   row, no completion published). Stamped at admission by
                   the tenant front door when egress is enabled
                   (device/egress.py): the egress-enabled inject poll
                   records it per installed row and the retirement-time
                   mailbox publish carries it back to the host, where it
                   keys the ``Future`` ledger (``FutureTable``).
    20 TEN_ADMIT_ROUND  admit-round stamp of the request, in the stream's
                   cumulative scheduler-round timebase (device/telemetry
                   .py): the host pump stamps the round gauge it last saw
                   echoed (``TenantTable.set_admit_round``), the
                   telemetry-enabled install path copies it into the
                   per-row stamp table, and retirement folds
                   ``retire - admit`` into the on-device latency
                   histogram. 0 = unstamped (telemetry off, or the
                   stream's first entry). A nonzero stamp is PRESERVED by
                   the pump on re-publication, so residue re-published
                   after a checkpoint cut keeps its original admission
                   round (the round gauge itself rides the echoed
                   telemetry block across the cut).

Because the words ride the row itself, tenant identity - a residue
row's remaining deadline budget, and its submit token - survives every
path a row can travel: checkpoint residue export, ``reshard``'s
round-robin re-deal, and resume re-publication (which is what lets
futures re-attach across a cut via their resume tokens).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "DESC_WORDS",
    "NO_TASK",
    "F_FN",
    "F_DEP",
    "F_SUCC0",
    "F_SUCC1",
    "F_CSR_OFF",
    "F_CSR_N",
    "F_A0",
    "F_OUT",
    "F_HOME",
    "F_HROW",
    "F_VMASK",
    "RING_ROW",
    "TEN_ID",
    "TEN_EXPIRED",
    "TEN_DEADLINE_MS",
    "TEN_TOKEN",
    "TEN_ADMIT_ROUND",
    "TaskGraphBuilder",
]

DESC_WORDS = 16
NO_TASK = -1

F_FN = 0
F_DEP = 1
F_SUCC0 = 2
F_SUCC1 = 3
F_CSR_OFF = 4
F_CSR_N = 5
F_A0 = 6  # args occupy words 6..11
F_OUT = 12
F_HOME = 13
F_HROW = 14
F_VMASK = 15
NUM_ARGS = 6

# Injection-ring row width: descriptors padded to 1024 B so any row
# offset is a legal dynamic DMA offset (Mosaic wants coarse alignment).
# Canonical home of the constant device/inject.py and device/resident.py
# share (both re-export it for their callers).
RING_ROW = 256

# Ring-row transport metadata (words beyond DESC_WORDS; see module
# docstring). Valid only on RING_ROW-padded injection rows - task-table
# rows are DESC_WORDS wide and never carry them.
TEN_ID = 16
TEN_EXPIRED = 17
TEN_DEADLINE_MS = 18
TEN_TOKEN = 19
TEN_ADMIT_ROUND = 20


class TaskGraphBuilder:
    """Builds the host-side arrays for a static task DAG.

    ``add(fn, args, deps=[...])`` returns the new task's index; ``deps`` are
    indices of tasks that must complete first (the builder fills dep counters
    and successor lists - inline first, CSR overflow after).
    """

    def __init__(self) -> None:
        self._rows: List[List[int]] = []
        self._succs: List[List[int]] = []  # successor indices per task
        self._reserved_values = 0

    def add(
        self,
        fn: int,
        args: Sequence[int] = (),
        deps: Sequence[int] = (),
        out: int = 0,
    ) -> int:
        if len(args) > NUM_ARGS:
            raise ValueError(f"at most {NUM_ARGS} args per task, got {len(args)}")
        idx = len(self._rows)
        row = [0] * DESC_WORDS
        row[F_FN] = int(fn)
        row[F_DEP] = len(deps)
        row[F_SUCC0] = NO_TASK
        row[F_SUCC1] = NO_TASK
        row[F_HOME] = NO_TASK  # local task (no migration home-link)
        for i, a in enumerate(args):
            row[F_A0 + i] = int(a)
        row[F_OUT] = int(out)
        self._rows.append(row)
        self._succs.append([])
        for d in deps:
            self._succs[d].append(idx)
        return idx

    @property
    def num_tasks(self) -> int:
        return len(self._rows)

    def reserve_values(self, n: int) -> None:
        """Declare slots [0, n) as host-owned: they are staged into the
        kernel (even if preset to zero) and the device allocator/row blocks
        start above them. Out slots already reserve themselves; use this for
        input-only or deliberately-zero slots."""
        self._reserved_values = max(self._reserved_values, int(n))

    def finalize(self, capacity: Optional[int] = None, succ_capacity: Optional[int] = None):
        """Returns (tasks, succ_csr, ready, counts0) numpy arrays sized to
        ``capacity`` tasks (extra rows are free slots for on-device spawns).

        counts0 = [head, tail, alloc, pending, value_alloc, 0, 0, 0].
        """
        n = len(self._rows)
        capacity = capacity or max(64, n)
        if n > capacity:
            raise ValueError(f"{n} tasks exceed capacity {capacity}")
        tasks = np.zeros((capacity, DESC_WORDS), dtype=np.int32)
        csr: List[int] = []
        for idx, row in enumerate(self._rows):
            succ = self._succs[idx]
            r = list(row)
            if len(succ) > 0:
                r[F_SUCC0] = succ[0]
            if len(succ) > 1:
                r[F_SUCC1] = succ[1]
            extra = succ[2:]
            r[F_CSR_OFF] = len(csr)
            r[F_CSR_N] = len(extra)
            csr.extend(extra)
            tasks[idx] = r
        succ_capacity = succ_capacity or max(64, len(csr))
        if len(csr) > succ_capacity:
            raise ValueError("successor CSR overflow")
        succ_arr = np.full(succ_capacity, NO_TASK, dtype=np.int32)
        if csr:
            succ_arr[: len(csr)] = csr
        # Ready ring: initially-runnable tasks in index order.
        ready0 = [i for i, row in enumerate(self._rows) if row[F_DEP] == 0]
        ring = np.full(capacity, NO_TASK, dtype=np.int32)
        ring[: len(ready0)] = ready0
        counts = np.zeros(8, dtype=np.int32)
        counts[0] = 0  # head
        counts[1] = len(ready0)  # tail
        counts[2] = n  # alloc cursor (next free descriptor row)
        counts[3] = n  # pending (tasks not yet executed)
        # Start on-device value allocation past every host-assigned out slot
        # (and any reserve_values declaration) so alloc_values/row blocks
        # never alias a host slot.
        counts[4] = max(
            1 + max((row[F_OUT] for row in self._rows), default=-1),
            self._reserved_values,
        )
        return tasks, succ_arr, ring, counts
