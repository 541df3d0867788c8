"""The persistent scheduler megakernel on an H100: a resident scheduler
loop in one CUDA kernel launch.

Port of the scalar tier, the batched same-kind dispatch tier (with its
lane-age firing policy and priority-bucket rings) and the vector
(subtree) tier of ``hclib_tpu/device/megakernel.py``, with the forasync
tier's tile bodies, the graph-frontier and branch-and-bound bodies and
the dynamic-graph UPDATE (splice) and QUERY bodies.
The TPU runs
the scheduler as one ``pallas_call`` whose scalar core pops task
descriptors off an SMEM ready ring and ``lax.switch``-es on ``F_FN`` over
a table of Pallas bodies.
Here it is one CUDA kernel (``csrc/megakernel.cu``) launched as ONE
block: thread 0 runs the serial scheduler (pop, route, fire, dispatch,
complete) exactly as the TPU's scalar core does, so the pop order - and
with it ``executed``, ``allocated``, the whole final task table and the
tier counters - equals the JAX package's word for word; the tile bodies
use the whole block between two barriers.

What differs from the JAX class:

- CUDA cannot take Python closures, so ``Megakernel(kernels=[...])``
  takes NAMES from the table compiled into the ``.cu`` (``BODIES``) and
  user-defined bodies as ``(name, fn, cuda)``: ``fn`` is the Python body
  the plain core runs (JAX's ``(name, fn)``), ``cuda`` the CUDA
  statements a card-bound table compiles into a small library of its own
  (``csrc/user.cuh``, ``user_library``; body ids after the built-in
  ones, ``MAX_BODIES`` in all), with ``alloc_values`` / ``free_values``
  on both; a task's ``F_FN`` still indexes the instance's own list, so
  graphs and task tables are the JAX package's. Each body's
  static parameters (UTS seed/q_millis/m_children/max_depth, Cholesky
  tile/factor_base/nt, Smith-Waterman nt_j/chunk) go in as kernel
  arguments (``params=``).
- ``route={name: BatchSpec(width, prefetch, priority)}`` routes a kind
  through the batch tier to the batched body compiled for that name
  (``BATCH_BODIES``), not to a Python body; ``priority`` is a named rule
  with integer parameters (``PRIORITY_RULES``), not a traced callable.
- The vector tier: a kernel-table entry ``(name, VectorTaskSpec)`` or
  ``route={name: VectorTaskSpec}`` (``auto_route=`` is an alias) runs a
  popped descriptor's whole subtree on the CUDA subtree engine of the
  spec's compiled family (``VECTOR_BODIES``: ``vfib``, ``vnqueens``),
  JAX's ``_wrap_vector_spec`` bridge included (seed from the 6 arg words,
  ``root_contrib`` for a leaf seed, the out accumulator to ``F_OUT``, the
  expanded nodes to ``C_EXECUTED``, ``OVF_ENGINE`` on overflow).
- The tile bodies (``add_tile`` and the forasync families ``fa_stencil``
  and ``fa_map``, scalar and batched, ``csrc/forasync.cuh``) run one slab
  pipeline whose geometry the table carries as data: ``slabs=(loads,
  stores)`` (``forasync_tier.Slab``) becomes the slab words at
  ``META_SLAB``, which the CUDA bodies and the plain ones both read.
- Scheduler state lives in device memory and is updated IN PLACE (the
  task table, ready ring, counts, value and tier-counter tensors passed in
  are the outputs), the counterpart of JAX's ``input_output_aliases``.
- On a CPU tensor the same scheduler runs as plain Python
  (``_PlainCore``) over the plain bodies; that is what the CPU tests and
  the card-side comparisons hold the kernel against.

``lane_max_age`` and ``priority_buckets`` (and their environment
variables ``HCLIB_TPU_LANE_MAX_AGE`` / ``HCLIB_TPU_PRIORITY_BUCKETS``)
act as in JAX, and so do the flight recorder (``trace=``,
``HCLIB_TPU_TRACE``; ``info['trace']``, device/tracebuf.py) and the
quiesce protocol (``checkpoint=``, ``quiesce_stride=``,
``HCLIB_TPU_CHECKPOINT`` / ``HCLIB_TPU_QUIESCE_STRIDE``; ``run(quiesce=)``
returns ``info['state']`` at a round boundary and ``resume(state)``
continues it, runtime/checkpoint.py bundles it). On the card both run in
the observed instances of ``mk_kernel`` (``kObs``); a build with neither
launches the instance without them. The core's ``install_descriptor`` /
``headroom`` and its three seams (``complete_hook`` at the top of
``complete``, ``fire_hook`` at each dispatch site, ``round_hook`` right
after a round's trace tick) are what the streaming front door
(device/inject.py) embeds the scheduler with. Left out (``verify`` raises
``NotImplementedError`` naming its ROADMAP entry): the hclint ``verify``
hook and the program cache. On the card, the age and bucket policies run in the
scheduler instance that holds the frontier, knapsack, fib, UTS and
Cholesky bodies; a table that also holds SW, vector or tile bodies
refuses them there (the plain core runs every combination).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import re
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..runtime.env import env_bool, env_int, env_raw
from ..runtime.resilience import StallError
from .descriptor import (
    DESC_WORDS,
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
    NO_TASK,
    TaskGraphBuilder,
)
from .state import numpy_of, resolve_device, tensor_of
from .tracebuf import (
    TR_CKPT,
    TR_FIRE_AGE,
    TR_FIRE_BATCH,
    TR_FIRE_BUCKET,
    TR_FIRE_SCALAR,
    TR_PREFETCH_DRAIN,
    TR_PREFETCH_ISSUE,
    TR_QUIESCE,
    TR_ROUND_BEGIN,
    TR_ROUND_END,
    TR_SPILL,
    NullTracer,
    TraceRing,
    Tracer,
    bucket_occupancy,
    lane_partial_age,
    trace_info,
)
from .vector_engine import VECTOR_BODIES, VectorTaskSpec, make_subtree_runner

__all__ = [
    "KernelContext", "BatchContext", "BatchSpec", "Megakernel", "VBLOCK",
    "BODIES", "BATCH_BODIES", "decode_overflow", "fault_mix", "BK_MAX",
    "PRIORITY_RULES", "bucket_of", "QC_FLAG", "QC_AFTER", "QS_QUIESCED",
    "QS_AT", "QS_POLLS", "MeshHost", "MeshGrid", "MESH_KINDS", "mesh_slice",
    "mesh_coresident",
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

# The quiesce protocol's words (checkpoint builds): qctl, the 8 words the
# host uploads at entry, and qstat, the 8 the launch writes back.
QC_FLAG = 0    # nonzero = quiesce requested
QC_AFTER = 1   # honor the flag only once this many tasks ran this rep
QS_QUIESCED = 0  # 1 = the round loop observed the quiesce word
QS_AT = 1        # tasks executed since entry at observation
QS_POLLS = 2     # scheduling rounds ticked (the quiesce_stride counter)

# Batch-tier statistics (the tstats row a batch-routed megakernel writes,
# JAX's layout; decoded as info['tiers']). Reset at every stage, so with
# reps > 1 they describe the last rep.
TS_BATCH_ROUNDS = 0   # batch rounds fired
TS_BATCH_TASKS = 1    # descriptors dispatched through batch bodies
TS_SCALAR_ROUNDS = 2  # descriptors dispatched through the switch
TS_ROUTED = 3         # ring pops diverted into a per-kind lane
TS_PREFETCH = 4       # descriptors whose operands came from a prefetch
TS_FULL_ROUNDS = 5    # batch rounds at full width
TS_SPILLED = 6        # lane entries spilled back to the ring at exit
TS_OFFERED = 7        # batch slots offered (sum of widths over fired rounds)
TS_AGE_FIRES = 8      # starved-lane fires that jumped a busy ring
TS_MAX_AGE = 9        # the largest lane age reached (lane_max_age on)
TS_BUCKET_FIRES = 10  # batch rounds fired from a nonzero bucket ring
TS_INVERSIONS = 11    # starved fires while a lower bucket held entries
TS_WORDS = 12

# Priority-bucket tier: ``priority_buckets=B`` (2..BK_MAX) makes every
# routed kind's lane B bucket rings (lane rows ``kind * B + bucket``),
# popped lowest-non-empty-first at ring-drain time. The bucket is a pure
# function of the descriptor's own arg words (the spec's named rule).
BK_MAX = 8

# Per-lane scheduler state words (the lstate rows): the lane's cursors
# plus the cross-round prefetch handshake.
LS_HEAD = 0     # pop cursor (monotonic for FIFO lanes)
LS_TAIL = 1     # push cursor
LS_PF_BASE = 2  # head-at-issue + 1 of the outstanding prefetch (0 = none)
LS_PF_N = 3     # descriptors the outstanding prefetch covers
LS_PF_BUF = 4   # operand-buffer half the prefetch was written into
LS_AGE = 5      # rounds the row held entries without firing
LS_WORDS = 8

# The kernel table compiled into csrc/megakernel.cu; the index is the
# body id of its ``switch``. New bodies are appended, never renumbered.
BODIES = ("fib", "sum", "uts_node", "potrf", "trsmcol", "updrow", "trsm",
          "sw_tile", "sw_wave", "fib_batch", "uts_node_batch",
          "updrow_batch", "sw_wave_batch", "vfib", "vnqueens", "add_tile",
          "fa_stencil", "fa_map", "fa_stencil_batch", "fa_map_batch",
          "fr_bfs", "fr_sssp", "fr_pagerank", "fr_bfs_batch",
          "fr_sssp_batch", "fr_pagerank_batch", "bnb_node", "bnb_node_batch",
          "dg_update", "dg_update_batch", "dg_query", "dg_query_batch")
# Kernel name -> the batched body a BatchSpec routes it to.
BATCH_BODIES = {"fib": "fib_batch", "uts_node": "uts_node_batch",
                "updrow": "updrow_batch", "sw_wave": "sw_wave_batch",
                "fa_stencil": "fa_stencil_batch", "fa_map": "fa_map_batch",
                "fr_bfs": "fr_bfs_batch", "fr_sssp": "fr_sssp_batch",
                "fr_pagerank": "fr_pagerank_batch",
                "bnb_node": "bnb_node_batch", "dg_update": "dg_update_batch",
                "dg_query": "dg_query_batch"}
# Batched bodies with a drain (the only ones that may take prefetch=True).
DRAIN_BODIES = ("sw_wave_batch", "fa_stencil_batch", "fa_map_batch",
                "fr_bfs_batch", "fr_sssp_batch", "fr_pagerank_batch")
# The graph-frontier EXPAND bodies (csrc/frontier.cuh) and the knapsack
# NODE bodies: they run only in the scheduler instance with the lane-age
# and bucket policies (megakernel.cu kMode 4, and 5 for dyngraph tables).
FRONTIER_BODIES = ("fr_bfs", "fr_sssp", "fr_pagerank", "fr_bfs_batch",
                   "fr_sssp_batch", "fr_pagerank_batch")
# The dynamic-graph UPDATE (splice) and QUERY bodies (csrc/frontier.cuh),
# which run beside a frontier kind's EXPAND bodies in the same instance.
DYNGRAPH_BODIES = ("dg_update", "dg_update_batch", "dg_query",
                   "dg_query_batch")
POLICY_BODIES = FRONTIER_BODIES + ("bnb_node", "bnb_node_batch") + \
    DYNGRAPH_BODIES
# The tile bodies (csrc/forasync.cuh): one slab pipeline, load slabs ->
# per-family arithmetic -> store slab, whose geometry the table carries
# as slab words (``slabs=``). Body -> its family's (load slabs, shape
# rule of load to store, dtype).
TILE_BODIES = {
    "add_tile": ("add_tile", 2, "same", torch.float32),
    "fa_stencil": ("fa_stencil", 1, "halo", torch.int32),
    "fa_stencil_batch": ("fa_stencil", 1, "halo", torch.int32),
    "fa_map": ("fa_map", 1, "same", torch.int32),
    "fa_map_batch": ("fa_map", 1, "same", torch.int32),
}
# Kinds with no scalar body (JAX's _batch_stub): they run only routed.
ROUTED_ONLY = ("sw_wave",)
# The built-in bodies a user-body library (csrc/user.cuh) runs beside the
# user bodies: the thread-0 bodies of mk_kernel's lean and lanes instances.
USER_LIB_BUILTINS = ("fib", "sum", "uts_node", "fib_batch",
                     "uts_node_batch")
# Bodies whose dispatches are kernel launches, and the _build.LAUNCHES
# counter each is folded into (the two vector families share the engine's).
COUNTED = {b: b for b in ("potrf", "trsmcol", "updrow", "trsm", "sw_tile",
                          "fib_batch", "uts_node_batch", "updrow_batch",
                          "sw_wave_batch", *TILE_BODIES)}
COUNTED.update({b: "vector" for b in VECTOR_BODIES})
COUNTED.update({b: "fr_expand_batch" if b.endswith("_batch") else
                "fr_expand" for b in FRONTIER_BODIES})
COUNTED.update({"bnb_node": "bnb_node", "bnb_node_batch": "bnb_node",
                "dg_update": "dg_splice", "dg_update_batch": "dg_splice_batch",
                "dg_query": "dg_query", "dg_query_batch": "dg_query"})
# In a table with the dynamic-graph layout (the ``dyn`` parameter) the
# EXPAND bodies run the clamped, spare-aware form: their dispatches count
# here instead.
DYN_EXPAND_COUNTER = "dg_expand"
# Data families: the bodies that read them and their buffers, in the
# order the kernel's data pointers take (then optional ones).
DATA_FAMILIES = {
    "cholesky": (("potrf", "trsmcol", "updrow", "trsm", "updrow_batch"),
                 ("tiles", "linvsp", "lsp"), ()),
    "sw": (("sw_tile", "sw_wave", "sw_wave_batch"),
           ("aseq", "bseq", "bot", "right"), ("htiles",)),
    "arrayadd": (("add_tile",), ("a", "b", "c"), ()),
    "fa_stencil": (("fa_stencil", "fa_stencil_batch"), ("gin", "gout"), ()),
    "fa_map": (("fa_map", "fa_map_batch"), ("vin", "vout"), ()),
    "frontier": (FRONTIER_BODIES, ("indices",), ("weights",)),
    "dyngraph": (DYNGRAPH_BODIES, ("indices",), ("weights",)),
}
MAX_DATA = 8
# Static body parameters, in the order of the kernel's meta words. The
# dynamic-graph layout: ``dyn`` (1 = the EXPAND bodies clamp to the live
# edges and spawn static then spare blocks), the first spare row
# ``spare_base``, ``spare`` rows a vertex, and the value-slot bases of the
# static block counts and of the applied-update flags.
PARAMS = ("seed", "q_millis", "m_children", "max_depth", "tile",
          "factor_base", "nt", "nt_j", "chunk", "st_base", "nblocks", "reps",
          "n", "cap", "spare_base", "spare", "bcs_base", "flag_base", "dyn")
# The meta layout (csrc/layout.cuh, the same names): one body count,
# MAX_BODIES, fixes where every section starts. Body ids: the built-in
# bodies take [0, len(BODIES)), a table's user bodies the ids after them.
MAX_PARAMS = 32
MAX_BODIES = 64
MAX_FNS = 32
META_FN_OF_BODY = MAX_PARAMS  # meta[.. + body] = F_FN of body, or -1
META_BODY_OF_FN = META_FN_OF_BODY + MAX_BODIES  # [.. + fn] = body of fn
META_BATCH = META_BODY_OF_FN + MAX_FNS  # [.. + 4*li ..] = fid, width,
                                        # prefetch, body
# meta[META_VEC + VEC_WORDS*fn ..] = a vector F_FN's rows, cols, stack
# depth, min_idle_div and family parameter.
VEC_WORDS = 8
META_VEC = META_BATCH + 4 * MAX_FNS
# meta[META_SLAB ..] = the tile body's slab words: a header (load slabs,
# store slabs, int32 words of one slot's load slabs in shared memory),
# then per slab, loads first: its buffer (data_specs index), the
# buffer's leading stride, rows, cols, the shared-memory row pitch and
# offset within a slot (loads), and its start element in the buffer as
# an affine form of the 4 arg words: c0*a0 + c1*a1 + c2*a2 + c3*a3 + k.
META_SLAB = META_VEC + VEC_WORDS * MAX_FNS
SLAB_HDR = 4
SLAB_WORDS = 12
SL_BUF, SL_LD, SL_ROWS, SL_COLS, SL_PITCH, SL_SOFF, SL_C0, SL_K = (
    0, 1, 2, 3, 4, 5, 6, 10)
# meta[META_PRIO + PRIO_WORDS*kind ..] = the routed kind's priority rule
# (bucketed tables only): rule id (PRIORITY_RULES order, 0 = none), the
# arg word it reads, and two integer parameters.
MAX_SLAB_WORDS = 64
META_PRIO = META_SLAB + MAX_SLAB_WORDS
PRIO_WORDS = 4
# Dynamic shared memory a tile table may take: the 232,448 bytes a block
# can use less 16 KB kept for mk_kernel's static shared memory.
TILE_SMEM_LIMIT = 232448 - 16384
NDISPATCH = MAX_BODIES  # per-body dispatch counters, user bodies too
MAX_WIDTH = 8         # slot rows of a batch round
SW_T = 128            # Smith-Waterman tile edge
MAX_SW_SLOTS = 16     # tile slots of one sw_wave_batch round (width*chunk)
THREADS = 256         # block size when the table holds a tile, SW or
                      # vector body
EBLOCK = 128          # a frontier edge block (frontier.py EBLOCK)

# JAX constructor arguments this port leaves out -> ROADMAP entry.
_LATER_ARGS = {
    "verify": "hclint recording hook for CUDA bodies (ROADMAP A13)",
}

# Named priority rules (a spec's ``priority=(name, word, *params)``),
# each a pure function of arg word ``word`` of the routed descriptor,
# clipped by the scheduler into [0, priority_buckets). Their order is the
# rule id in the meta words (megakernel.cu PR_*). Parameters:
#   ("div", word, d)                   arg // d (floor), d >= 1
#   ("band", word, reps)               #k in 1..BK_MAX-1 with
#                                      arg >= reps * 2**k
#   ("linear_desc", word, total, nbk)  ((total - arg) * nbk) // (total+1)
#                                      in wrapping int32 arithmetic
#   ("const", word, c)                 c, whatever the arg (a kind pinned
#                                      to one bucket; the word is unread)
PRIORITY_RULES = {"div": 1, "band": 2, "linear_desc": 3, "const": 4}
_RULE_PARAMS = {"div": 1, "band": 1, "linear_desc": 2, "const": 1}


def _check_rule(rule) -> tuple:
    if callable(rule):
        raise NotImplementedError(
            "a priority callable runs Python on the host; the card's "
            f"scheduler takes a named rule {sorted(PRIORITY_RULES)}: "
            "user-defined bodies and rules are ROADMAP A4")
    if not (isinstance(rule, tuple) and rule and isinstance(rule[0], str)):
        raise ValueError(
            "priority must be a named rule (name, word, *params) with name "
            f"in {sorted(PRIORITY_RULES)}, got {rule!r}")
    name = rule[0]
    if name not in PRIORITY_RULES:
        raise NotImplementedError(
            f"unknown priority rule {name!r}: the card's scheduler knows "
            f"{sorted(PRIORITY_RULES)}; user-defined rules are ROADMAP A4")
    if len(rule) != 2 + _RULE_PARAMS[name] or not all(
            isinstance(x, (int, np.integer)) for x in rule[1:]):
        raise ValueError(f"priority rule {name!r} takes (word, "
                         f"{_RULE_PARAMS[name]} int parameter(s)), got "
                         f"{rule[1:]!r}")
    word, *p = (int(x) for x in rule[1:])
    if not 0 <= word < 6:
        raise ValueError(f"priority rule reads arg word {word}; 0..5 exist")
    ok = {"div": p[0] >= 1,
          "band": 1 <= p[0] and p[0] << (BK_MAX - 1) < 1 << 31,
          "linear_desc": 0 <= p[0] < (1 << 31) - 1 and 1 <= p[-1],
          "const": -(1 << 31) <= p[0] < 1 << 31}[name]
    if not ok:
        raise ValueError(f"priority rule {rule!r}: parameter out of range")
    return (name, word, *p)


def bucket_of(rule, args: Sequence[int], nbk: int) -> int:
    """The bucket of a descriptor with arg words ``args`` under a named
    rule, clipped into [0, nbk) (the plain core's routing, and the host
    spelling the card's ``bucket_of`` in csrc/megakernel.cu mirrors).
    ``rule`` None is bucket 0."""
    if rule is None:
        return 0
    name, word, *p = rule
    x = int(args[word])
    if name == "div":
        b = x // p[0]
    elif name == "band":
        b = sum(x >= p[0] << k for k in range(1, BK_MAX))
    elif name == "const":
        b = p[0]
    else:
        b = _i32(_i32(p[0] - x) * p[1]) // (p[0] + 1)
    return min(max(b, 0), nbk - 1)


class BatchSpec:
    """The batched-dispatch form of one kernel-table entry (JAX's
    ``BatchSpec`` less its Python body): a kind routed through it is never
    dispatched through the switch. The scheduler diverts its ready
    descriptors into a per-kind lane and, each batch round, pops up to
    ``width`` of them into ONE call of the batched body compiled for that
    kernel name (``BATCH_BODIES``). Non-prefetch lanes pop LIFO (the
    newest ``take`` as one block), ``prefetch=True`` lanes FIFO with the
    cross-round double-buffer protocol; only a body with a drain
    (``DRAIN_BODIES``) may take it. ``priority`` (a named rule,
    ``PRIORITY_RULES``) picks the descriptor's bucket ring when the
    megakernel is built with ``priority_buckets``; bucket rings pop FIFO
    and never prefetch, so a bucketed table refuses ``prefetch=True``."""

    def __init__(self, width: int = 8, prefetch: bool = False,
                 priority=None) -> None:
        if width < 1:
            raise ValueError(f"batch width must be >= 1, got {width}")
        if width > MAX_WIDTH:
            raise ValueError(
                f"batch width {width} exceeds the {MAX_WIDTH} slot rows a "
                "batch round publishes (csrc/megakernel.cu)"
            )
        self.width = int(width)
        self.prefetch = bool(prefetch)
        self.priority = None if priority is None else _check_rule(priority)


class KernelContext:
    """What a plain body sees of the scheduler (the JAX ``KernelContext``
    operations the ported bodies use). The CUDA bodies do the same
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

    @property
    def core(self) -> "_PlainCore":
        return self._c

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

    def alloc_values(self, k: int) -> int:
        """Reserve k consecutive value slots; the base slot (JAX's
        ``KernelContext.alloc_values``). k <= VBLOCK takes one VBLOCK-word
        block, a recycled one (``free_values``) first, else the bump
        cursor; a larger k bumps exactly k slots and is never recycled.
        Exhaustion sets OVF_VALUES and returns a clamped base (the host
        raises after the run). The block stack is emptied at every stage,
        so a re-entered launch (a sharded steal round) reuses no block
        freed before it; the bump cursor keeps its high-water mark."""
        c = self._c
        if c.uses_row_values:
            raise ValueError(
                "alloc_values cannot be mixed with row_values "
                "(uses_row_values=True): the bump region overlaps the "
                "row-owned blocks")
        cnt, nv, vfree = c.counts, c.value_limit, c.vfree
        if k > VBLOCK:
            base = cnt[C_VALLOC]
            if base + k <= nv:
                cnt[C_VALLOC] = base + k
                return base
            cnt[C_OVERFLOW] |= OVF_VALUES
            return max(nv - k, 0)
        nfree = vfree[0]
        b_new = cnt[C_VALLOC]
        if nfree > 0:
            vfree[0] = nfree - 1
            return vfree[nfree]
        if b_new + VBLOCK <= nv:
            cnt[C_VALLOC] = b_new + VBLOCK
            return b_new
        cnt[C_OVERFLOW] |= OVF_VALUES
        return max(nv - VBLOCK, 0)

    def free_values(self, base: int) -> None:
        """Return the VBLOCK-word block at ``base`` to the free stack
        (JAX's ``KernelContext.free_values``); more frees than blocks
        exist clamp inside the stack and set OVF_VALUES."""
        c = self._c
        vcap = c.value_limit // VBLOCK
        nf = c.vfree[0] + 1
        nfc = min(nf, vcap)
        c.vfree[0] = nfc
        if nf <= vcap:
            c.vfree[nfc] = base
        else:
            c.counts[C_OVERFLOW] |= OVF_VALUES

    @property
    def pgas(self):
        """The resident kernel's PGAS operations (``put``, ``am``,
        ``wait_until``, ``count``, ``me``, ``ndev``, ``nchan``; JAX's
        ``ctx.pgas``), under a ResidentKernel or PGASMegakernel run with
        channels only."""
        if self._c.pgas is None:
            raise AttributeError(
                "ctx.pgas exists only under the resident kernel's PGAS "
                "configuration (ResidentKernel(channels=...) or "
                "PGASMegakernel)")
        return self._c.pgas

    def push_ready(self, t: int) -> None:
        self._c.push_ready(t)

    def fn_id(self, name: str) -> int:
        """F_FN of body ``name`` in this megakernel's table."""
        return self._c.fn_of[name]

    def add_executed(self, n: int) -> None:
        c = self._c.counts
        c[C_EXECUTED] = _i32(c[C_EXECUTED] + n)

    def flag_overflow(self) -> None:
        self._c.counts[C_OVERFLOW] |= OVF_ENGINE

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
        if self._c.tracks_home:
            # A migrated copy's continuation inherits the home link:
            # whoever ends the chain forwards the result to the home proxy
            # (device/resident.py's remote-completion protocol).
            t[a + F_HOME] = t[b + F_HOME]
            t[a + F_HROW] = t[b + F_HROW]
            t[b + F_HOME] = NO_TASK

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
            if c.tracks_home:
                # A recycled row may carry a stale home link from a
                # migrated occupant; a fresh spawn is a local task.
                t[r + F_HOME] = NO_TASK
            if dep_count == 0:
                c.push_ready(a)
        else:
            cnt[C_OVERFLOW] |= OVF_ROWS
        return a


class BatchContext:
    """What a plain batched body sees of one batch round (JAX's
    ``BatchContext``): slots ``[0, count)`` are live, slot ``s``'s row is
    ``idx(s)``; ``prefetched`` slots had their operands loaded last round
    into half ``buf``; the body loads the next batch's first
    ``prefetch_count`` descriptors (``next_idx``) into the other half."""

    __slots__ = ("_c", "_li", "_head", "count", "width", "prefetched",
                 "buf", "prefetch_count")

    def __init__(self, core: "_PlainCore", li: int, head: int, count: int,
                 width: int, prefetched: int, buf: int,
                 prefetch_count: int) -> None:
        self._c = core
        self._li = li
        self._head = head
        self.count = count
        self.width = width
        self.prefetched = prefetched
        self.buf = buf
        self.prefetch_count = prefetch_count

    def _row(self, pos: int) -> int:
        row = self._c.lanes[self._li][max(pos, 0) % self._c.capacity]
        return min(max(row, 0), self._c.capacity - 1)

    def idx(self, s: int) -> int:
        return self._row(self._head + min(s, self.count - 1))

    def live(self, s: int) -> bool:
        return s < self.count

    def arg(self, s: int, i: int) -> int:
        return self._c.tasks[self.idx(s) * DESC_WORDS + F_A0 + i]

    def slot_ctx(self, s: int) -> KernelContext:
        return KernelContext(self._c, self.idx(s))

    def next_idx(self, s: int) -> int:
        return self._row(self._head + self.count
                         + min(s, self.prefetch_count - 1))

    def next_arg(self, s: int, i: int) -> int:
        return self._c.tasks[self.next_idx(s) * DESC_WORDS + F_A0 + i]

    @property
    def data(self):
        return self._c.data

    @property
    def params(self):
        return self._c.params

    @property
    def scratch(self) -> dict:
        return self._c.scratch

    @property
    def core(self) -> "_PlainCore":
        return self._c

    def value(self, slot: int) -> int:
        return self._c.ivalues[slot]

    def set_value(self, slot: int, v: int) -> None:
        self._c.ivalues[slot] = _i32(v)

    def add_executed(self, n: int) -> None:
        c = self._c.counts
        c[C_EXECUTED] = _i32(c[C_EXECUTED] + n)


class _PlainCore:
    """The plain version of the CUDA scheduler: the same stage / sched /
    complete over Python lists made from the state tensors (written back
    at exit), the batch tier, the flight recorder and the quiesce poll
    included."""

    def __init__(self, mk: "Megakernel", st: Dict[str, object]) -> None:
        self.capacity = mk.capacity
        self.num_values = mk.num_values
        self.params = mk.params
        self.fn_of = mk.fn_of
        self.bodies = mk._fn_plain
        self.body_ids = [mk.body_id(n) for n in mk.fn_bodies]
        # (fid, spec, batched body id, plain body, plain drain)
        self.specs = [
            (fid, spec, mk.body_id(b), mk._plain[b],
             mk._plain.get(b + "_drain"))
            for fid, spec, b in mk.batch_specs
        ]
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
        # The tile bodies' view: the slab words and the buffers in
        # data_specs order (the slab words' buffer indices).
        self.slab_words = mk.slab_words
        self.buffers = [st["data"][k] for k in mk.data_specs]
        self.free = [0] * (self.capacity + 1)
        # The value-block free stack (alloc_values / free_values): [0]
        # the count, then the block bases; emptied at every stage.
        self.vfree = [0] * (self.num_values // VBLOCK + 1)
        self.uses_row_values = mk.uses_row_values
        # The resident kernel's home-link tracking (spawn and
        # take_continuation keep F_HOME / F_HROW) and the value limit
        # alloc_values / free_values stay below (the resident kernel
        # reserves the top of the value buffer for migrated results).
        self.tracks_home = mk.tracks_home
        self.value_limit = self.num_values
        # The resident kernel's PGAS ops (KernelContext.pgas), or None.
        self.pgas = None
        self.dispatch = [0] * NDISPATCH
        # Lane rows: nbk bucket rings per routed kind (row kind*nbk + bk).
        self.nbk = mk.nbk
        self.max_age = mk.lane_max_age
        nrows = len(self.specs) * self.nbk
        self.lanes = [[0] * self.capacity for _ in range(nrows)]
        self.lstate = [[0] * LS_WORDS for _ in range(nrows)]
        self.tstats = [0] * TS_WORDS
        self.scratch: dict = {}
        # The recorder over the ring row, and the quiesce words.
        self.ring = st["trace"].tolist() if "trace" in st else None
        self.tr = Tracer(self.ring, mk.trace.capacity) \
            if self.ring is not None else NullTracer()
        self.qctl = st["qctl"].tolist() if "qctl" in st else None
        self.qstride = mk.quiesce_stride
        self.qbuf = [0] * 8
        self.qstat = [0] * 8
        # _make_core's seams (None: unused): complete_hook(idx) at the top
        # of complete(), fire_hook(idx) at each dispatch site before the
        # body, round_hook() right after each round's trace tick.
        self.complete_hook = None
        self.fire_hook = None
        self.round_hook = None

    def poll(self, since: int) -> bool:
        """megakernel.py quiesce_hook: re-read qctl every ``qstride``
        rounds (round 0 always), count the round, and report a quiesce
        once QC_AFTER tasks ran this rep; the first observation records
        TR_QUIESCE."""
        qs = self.qstat
        cnt = qs[QS_POLLS]
        qs[QS_POLLS] = cnt + 1
        if self.qstride <= 1 or cnt % self.qstride == 0:
            self.qbuf[:] = self.qctl
        q = self.qbuf[QC_FLAG] != 0 and since >= self.qbuf[QC_AFTER]
        if q and qs[QS_QUIESCED] == 0:
            qs[QS_QUIESCED] = 1
            qs[QS_AT] = since
            self.tr.emit(TR_QUIESCE, self.tr.now(), since)
        return q

    def stage(self, stage_all_values: bool) -> None:
        cin, free, cap = self.counts_in, self.free, self.capacity
        free[0] = 0
        self.vfree[0] = 0
        self.tr.reset()
        for row in self.lstate:
            row[:] = [0] * LS_WORDS
        self.tstats[:] = [0] * TS_WORDS
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
        if self.complete_hook is not None:
            self.complete_hook(idx)
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

    def install_descriptor(self, read_word) -> int:
        """megakernel.py install_descriptor: adopt one externally produced
        descriptor row (an injected stream row) through the row path
        spawns use - free stack first, then the bump cursor, OVF_ROWS
        when neither has a row - copy its 16 words from ``read_word(w)``,
        count it pending and push it ready only at F_DEP == 0. Returns
        the row (clamped to capacity - 1 on overflow)."""
        c, free, cap = self.counts, self.free, self.capacity
        nf = free[0]
        use_free = nf > 0
        a = c[C_ALLOC]
        ok = use_free or a < cap
        row = free[max(nf, 1)] if use_free else min(a, cap - 1)
        if use_free:
            free[0] = nf - 1
        elif a < cap:
            c[C_ALLOC] = a + 1
        if ok:
            r = row * DESC_WORDS
            for w in range(DESC_WORDS):
                self.tasks[r + w] = read_word(w)
            c[C_PENDING] += 1
            if self.tasks[r + F_DEP] == 0:
                self.push_ready(row)
        else:
            c[C_OVERFLOW] |= OVF_ROWS
        return row

    def headroom(self) -> int:
        """Task-table rows free for external rows right now: the free
        stack plus the unbumped tail of the table."""
        return self.free[0] + (self.capacity - self.counts[C_ALLOC])

    def step(self, idx: int) -> None:
        # lax.switch clamps an out-of-range index; so does the kernel.
        fn = min(max(self.tasks[idx * DESC_WORDS + F_FN], 0),
                 len(self.bodies) - 1)
        self.dispatch[self.body_ids[fn]] += 1
        self.bodies[fn](KernelContext(self, idx))
        self.complete(idx)

    def batch_round(self, row: int, e0: int, fuel: int, rt: int) -> None:
        """megakernel.py batch_round: fire one batch off lane row ``row``
        (a kind's bucket ring); LIFO pops for non-prefetch specs, FIFO
        for bucket rings and for prefetch specs, with the prefetch
        handshake for the latter. Records the fire (and the prefetch
        announce) at round ``rt`` before the body runs."""
        fid, spec, body_id, body, _ = self.specs[row // self.nbk]
        ls, lane, cap, ts = self.lstate[row], self.lanes[row], \
            self.capacity, self.tstats
        B = spec.width
        head, tail = ls[LS_HEAD], ls[LS_TAIL]
        avail = tail - head
        take = min(avail, B)
        fifo = spec.prefetch or self.nbk > 1
        base = head if fifo else tail - take
        pre = min(ls[LS_PF_N], take) if ls[LS_PF_BASE] == head + 1 else 0
        buf = ls[LS_PF_BUF]
        nxt = 0
        if spec.prefetch and (avail - take) > 0 and (
                self.counts[C_EXECUTED] - e0 + take < fuel):
            nxt = min(avail - take, B)
        self.tr.emit(TR_FIRE_BATCH, rt, (fid << 16) | take, pre)
        if spec.prefetch and nxt > 0:
            self.tr.emit(TR_PREFETCH_ISSUE, rt, fid, nxt)
        self.dispatch[body_id] += 1
        body(BatchContext(self, row, base, take, B, pre, buf, nxt))
        for s in range(take):
            if self.fire_hook is not None:
                self.fire_hook(lane[(base + s) % cap])
            self.complete(lane[(base + s) % cap])
        if fifo:
            ls[LS_HEAD] = head + take
            if spec.prefetch:
                ls[LS_PF_BASE] = head + take + 1 if nxt > 0 else 0
                ls[LS_PF_N] = nxt
                ls[LS_PF_BUF] = 1 - buf
        else:
            ls[LS_TAIL] = base
        ts[TS_BATCH_ROUNDS] += 1
        ts[TS_BATCH_TASKS] += take
        ts[TS_OFFERED] += B
        ts[TS_PREFETCH] += pre
        ts[TS_FULL_ROUNDS] += int(take == B)

    def _select(self, avails, ring_work: bool):
        """The row this round fires and whether the starved pass chose
        it, or (None, False). The starved pass (lane_max_age on): the
        first kind, in F_FN order, with a row aged >= lane_max_age, its
        lowest such bucket; it jumps a busy ring. Then ring-drain-first:
        with the ring empty, the lowest non-empty bucket over all kinds,
        ties to the lower F_FN."""
        nbk, nk = self.nbk, len(self.specs)
        if self.max_age:
            for r in range(nk * nbk):
                if avails[r] > 0 and self.lstate[r][LS_AGE] >= self.max_age:
                    return r, True
        if not ring_work:
            for bk in range(nbk):
                for li in range(nk):
                    if avails[li * nbk + bk] > 0:
                        return li * nbk + bk, False
        return None, False

    def sched(self, fuel: int) -> None:
        c, ready, cap, tr = self.counts, self.ready, self.capacity, self.tr
        e0 = c[C_EXECUTED]
        ts, nbk = self.tstats, self.nbk
        tr.emit(TR_ROUND_BEGIN, tr.tick(), c[C_TAIL] - c[C_HEAD],
                c[C_PENDING])
        while c[C_PENDING] > 0 and c[C_EXECUTED] - e0 < fuel:
            head, tail = c[C_HEAD], c[C_TAIL]
            ring_work = head < tail
            # The round index of this round's records; then the quiesce
            # poll, which stops the round before it fires or pops.
            rt = tr.tick()
            if self.round_hook is not None:
                self.round_hook()
            qz = self.qctl is not None and self.poll(c[C_EXECUTED] - e0)
            avails = [ls[LS_TAIL] - ls[LS_HEAD] for ls in self.lstate]
            lane_work = any(a > 0 for a in avails)
            # One dispatch a round: a batch off the selected row, or a
            # ring pop.
            row, starved = (None, False) if qz else \
                self._select(avails, ring_work)
            if row is not None:
                bk = row % nbk
                fid, spec = self.specs[row // nbk][:2]
                take = min(avails[row], spec.width)
                if starved and ring_work:
                    tr.emit(TR_FIRE_AGE, rt, (fid << 16) | take,
                            self.lstate[row][LS_AGE])
                    ts[TS_AGE_FIRES] += 1
                if starved and nbk > 1 and any(
                        a > 0 and r % nbk < bk for r, a in enumerate(avails)):
                    ts[TS_INVERSIONS] += 1
                if nbk > 1:
                    tr.emit(TR_FIRE_BUCKET, rt, (bk << 16) | take, fid)
                if bk > 0:
                    ts[TS_BUCKET_FIRES] += 1
                self.batch_round(row, e0, fuel, rt)
            elif ring_work and not qz:
                idx = ready[(tail - 1) % cap]
                c[C_TAIL] = tail - 1
                # Pop-time routing: a routed kind goes to its lane (its
                # bucket ring under the priority tier).
                r = idx * DESC_WORDS
                fn = self.tasks[r + F_FN]
                for li, (fid, spec, _, _, _) in enumerate(self.specs):
                    if fn == fid:
                        bk = 0 if nbk == 1 else bucket_of(
                            spec.priority,
                            self.tasks[r + F_A0:r + F_A0 + 6], nbk)
                        ls = self.lstate[li * nbk + bk]
                        self.lanes[li * nbk + bk][ls[LS_TAIL] % cap] = idx
                        ls[LS_TAIL] += 1
                        ts[TS_ROUTED] += 1
                        break
                else:
                    tr.emit(TR_FIRE_SCALAR, rt, fn, idx)
                    if self.fire_hook is not None:
                        self.fire_hook(idx)
                    self.step(idx)
                    ts[TS_SCALAR_ROUNDS] += 1
            if self.max_age:
                # The starved-round clocks, after dispatch (a quiesced
                # round's too): a row that holds entries and did not fire
                # ages by one, the others reset.
                for i, ls in enumerate(self.lstate):
                    age = 0 if i == row or ls[LS_TAIL] == ls[LS_HEAD] \
                        else ls[LS_AGE] + 1
                    ls[LS_AGE] = age
                    ts[TS_MAX_AGE] = max(ts[TS_MAX_AGE], age)
            if qz or not (ring_work or lane_work):
                break
        # Exit with unrun lane entries: retire an in-flight prefetch,
        # then spill the entries to the ring HEAD (the cold end), row by
        # row, each recorded at the round cursor.
        rt_x = tr.now()
        for li in range(len(self.lstate)):
            fid, spec, _, _, drain = self.specs[li // nbk]
            ls, lane = self.lstate[li], self.lanes[li]
            h, t = ls[LS_HEAD], ls[LS_TAIL]
            if spec.prefetch:
                pre = ls[LS_PF_N] if ls[LS_PF_BASE] == h + 1 else 0
                if pre > 0:
                    tr.emit(TR_PREFETCH_DRAIN, rt_x, fid, pre)
                    drain(BatchContext(self, li, h, pre, spec.width, pre,
                                       ls[LS_PF_BUF], 0))
            head0 = c[C_HEAD]
            for s in range(t - h):
                ready[(head0 - 1 - s) % cap] = lane[(h + s) % cap]
            c[C_HEAD] = head0 - (t - h)
            if t > h:
                tr.emit(TR_SPILL, rt_x, fid, t - h)
            ls[LS_HEAD] = t
            ls[LS_PF_BASE] = 0
            ts[TS_SPILLED] += t - h
        tr.emit(TR_ROUND_END, tr.tick(), c[C_EXECUTED] - e0, c[C_PENDING])

    def run(self, fuel: int, reps: int, stage_all_values: bool) -> None:
        total = 0
        for _ in range(reps):
            self.stage(stage_all_values)
            self.sched(fuel)
            total += self.counts[C_EXECUTED]
        self.counts[C_EXECUTED] = _i32(total)
        c = self.counts
        if self.qstat[QS_QUIESCED]:
            # The state-export record of a quiesced launch.
            self.tr.emit(TR_CKPT, self.tr.now(), c[C_PENDING],
                         c[C_TAIL] - c[C_HEAD])
        self.write_back()

    def write_back(self) -> None:
        """Copy the working state back into the state tensors."""
        st = self.st
        st["tasks"].copy_(torch.tensor(self.tasks, dtype=torch.int32)
                          .view(self.capacity, DESC_WORDS))
        st["ready"].copy_(torch.tensor(self.ready, dtype=torch.int32))
        st["counts"].copy_(torch.tensor(self.counts, dtype=torch.int32))
        st["ivalues"].copy_(torch.tensor(self.ivalues, dtype=torch.int32))
        if "tstats" in st:
            st["tstats"].copy_(torch.tensor(self.tstats, dtype=torch.int32))
        if self.ring is not None:
            st["trace"].copy_(torch.tensor(self.ring, dtype=torch.int32))
        if self.qctl is not None:
            st["qstat"].copy_(torch.tensor(self.qstat, dtype=torch.int32))


def _plain_bodies() -> Dict[str, object]:
    # The bodies live with their workloads, as in the JAX package.
    from .cholesky import (potrf_body, trsm_body, trsmcol_body,
                           updrow_batch_body, updrow_body)
    from .smithwaterman import (sw_tile_body, sw_wave_batch_body,
                                sw_wave_batch_drain)
    from .bnb import bnb_node_batch_body, bnb_node_body
    from .dyngraph import plain_dyngraph_bodies
    from .forasync_tier import plain_tile_bodies
    from .frontier import plain_frontier_bodies
    from .workloads import (fib_batch_body, fib_body, sum_body,
                            uts_node_batch_body, uts_node_body)

    return {
        **plain_tile_bodies(), **plain_frontier_bodies(),
        **plain_dyngraph_bodies(),
        "bnb_node": bnb_node_body, "bnb_node_batch": bnb_node_batch_body,
        "fib": fib_body, "sum": sum_body, "uts_node": uts_node_body,
        "potrf": potrf_body, "trsmcol": trsmcol_body, "updrow": updrow_body,
        "trsm": trsm_body, "sw_tile": sw_tile_body,
        "sw_wave": lambda ctx: None,  # JAX's _batch_stub: never dispatched
        "fib_batch": fib_batch_body, "uts_node_batch": uts_node_batch_body,
        "updrow_batch": updrow_batch_body, "sw_wave_batch": sw_wave_batch_body,
        "sw_wave_batch_drain": sw_wave_batch_drain,
    }


def _vector_body(spec: VectorTaskSpec):
    """JAX's ``_wrap_vector_spec`` as a plain body: popping a task of this
    F_FN runs its whole subtree (the plain runner); the seed comes from the
    6 arg words, a leaf seed adds ``root_contrib``, the out accumulator
    lands in F_OUT, the expanded nodes are credited to C_EXECUTED and an
    overflow sets OVF_ENGINE."""
    runner = make_subtree_runner(spec)

    def body(ctx: KernelContext) -> None:
        args = tuple(ctx.arg(i) for i in range(6))
        seed_frame, seed_count = spec.seed(args)
        nodes, accs, over = runner(seed_frame, seed_count)
        if spec.root_contrib is not None and seed_count == 0:
            rc = spec.root_contrib(args)
            accs = {k: v + rc.get(k, 0) for k, v in accs.items()}
        if spec.out_acc is not None:
            ctx.set_out(accs[spec.out_acc])
        ctx.add_executed(nodes)
        if over:
            ctx.flag_overflow()

    return body


class Megakernel:
    """Builds and runs the single-block scheduler kernel over a task DAG.

    ``kernels`` is the ordered kernel table: names from ``BODIES``,
    ``(name, VectorTaskSpec)`` entries of the vector tier, or user bodies
    ``(name, fn[, cuda])`` (a card-bound table needs ``cuda`` for each:
    its statements over ``ctx``, csrc/user.cuh's ``Ctx``); a task's F_FN
    indexes it. ``route`` (alias ``auto_route``) maps kernel names to
    ``BatchSpec``s (the batch tier) or ``VectorTaskSpec``s (the vector
    tier). ``data_specs`` maps buffer names to ``(shape,
    dtype)`` in the order ``DATA_FAMILIES`` gives them; ``params`` gives
    the bodies' static parameters (``PARAMS``); ``slabs`` the windows a
    tile body (``TILE_BODIES``) loads and stores. ``lane_max_age`` and
    ``priority_buckets`` arm the batch tier's age-triggered firing policy
    and its bucket rings as in JAX (unset: ``HCLIB_TPU_LANE_MAX_AGE`` /
    ``HCLIB_TPU_PRIORITY_BUCKETS``). ``trace`` (a record capacity, True
    for the default, or a ``TraceRing``) adds the flight recorder;
    ``checkpoint=True`` the quiesce poll, every ``quiesce_stride`` rounds
    (unset: ``HCLIB_TPU_TRACE``, ``HCLIB_TPU_CHECKPOINT``,
    ``HCLIB_TPU_QUIESCE_STRIDE``). Runs on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the plain version).
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
        route: Optional[Dict[str, object]] = None,
        auto_route: Optional[Dict[str, VectorTaskSpec]] = None,
        slabs: Optional[tuple] = None,
        device="cuda",
        trace=None,
        checkpoint: Optional[bool] = None,
        quiesce_stride: Optional[int] = None,
        lane_max_age: Optional[int] = None,
        priority_buckets: Optional[int] = None,
        verify: Optional[bool] = None,
    ) -> None:
        # The build variables, read where JAX reads them (megakernel.py
        # :852-929) and with its semantics.
        if verify:
            raise NotImplementedError(
                f"Megakernel(verify=...) is not ported yet: "
                f"{_LATER_ARGS['verify']} in ROADMAP.md")
        # Tracing or checkpointing that came from the environment is
        # marked, so a runner that cannot trace or quiesce (the sharded
        # runner) builds without it instead of failing (as in JAX).
        self.trace_from_env = False
        if trace is None:
            env = env_raw("HCLIB_TPU_TRACE", "")
            if env and env != "0":
                try:
                    n = int(env)
                except ValueError:
                    n = 1
                if n > 0:
                    trace = True if n == 1 else n
                    self.trace_from_env = True
        self.trace = TraceRing.of(trace)
        self.checkpoint_from_env = False
        if checkpoint is None:
            checkpoint = env_bool("HCLIB_TPU_CHECKPOINT")
            self.checkpoint_from_env = checkpoint
        self.checkpoint = bool(checkpoint)
        # Without checkpointing the stride changes nothing (as in JAX).
        if quiesce_stride is None:
            quiesce_stride = env_int("HCLIB_TPU_QUIESCE_STRIDE", None,
                                     malformed=1)
        self.quiesce_stride = max(1, int(quiesce_stride or 1))
        if lane_max_age is None:
            lane_max_age = env_int("HCLIB_TPU_LANE_MAX_AGE", None)
        lane_max_age = int(lane_max_age or 0)
        if lane_max_age < 0:
            raise ValueError(
                f"lane_max_age must be >= 0 (0 = off), got {lane_max_age}")
        self.lane_max_age = lane_max_age
        if priority_buckets is None:
            priority_buckets = env_int("HCLIB_TPU_PRIORITY_BUCKETS", None)
        priority_buckets = int(priority_buckets or 0)
        if priority_buckets and not 2 <= priority_buckets <= BK_MAX:
            raise ValueError(
                f"priority_buckets must be 0 (off) or 2..{BK_MAX} "
                f"(the static bucket-ring set), got {priority_buckets}")
        self.priority_buckets = priority_buckets
        names, table_specs, user = [], {}, []
        scalar = tuple(b for b in BODIES if b not in BATCH_BODIES.values()
                       and b not in VECTOR_BODIES)
        for k in kernels:
            if isinstance(k, str):
                if k not in scalar:
                    raise ValueError(
                        f"unknown kernel {k!r}: the table compiled into "
                        f"csrc/megakernel.cu holds {scalar}, the vector "
                        f"families {VECTOR_BODIES} as (name, VectorTaskSpec)"
                        ", and user bodies as (name, fn[, cuda])"
                    )
                names.append(k)
            elif len(k) == 2 and isinstance(k[1], VectorTaskSpec):
                table_specs[k[0]] = k[1]
                names.append(k[0])
            elif len(k) in (2, 3) and callable(k[1]):
                cuda = k[2] if len(k) == 3 else None
                if cuda is not None and not isinstance(cuda, str):
                    raise ValueError(f"kernel {k[0]!r}: the CUDA source of a "
                                     "user body is a string")
                user.append((k[0], k[1], cuda))
                names.append(k[0])
            else:
                raise ValueError(
                    f"kernel {k!r}: a table entry is a name, (name, "
                    "VectorTaskSpec) or a user body (name, fn[, cuda])")
        if not names:
            raise ValueError("empty kernel table")
        if len(names) > MAX_FNS:
            raise ValueError(f"at most {MAX_FNS} kernels, got {len(names)}")
        if len(set(names)) != len(names):
            raise ValueError(f"kernel names repeat in the table: {names}")
        if len(user) > MAX_BODIES - len(BODIES):
            raise ValueError(
                f"at most {MAX_BODIES - len(BODIES)} user bodies (body ids "
                f"{len(BODIES)}..{MAX_BODIES - 1}), got {len(user)}")
        # User bodies: (name, plain callable, CUDA statements or None),
        # body id len(BODIES) + their index here.
        self.user_bodies = user
        self._user_ids = {n: len(BODIES) + i for i, (n, _, _) in
                          enumerate(user)}
        self.kernel_names = names
        self.fn_of = {n: i for i, n in enumerate(names)}
        self.route = dict(route or {})
        self.route.update(auto_route or {})
        self._check_route()
        # (F_FN, spec, batched body name), in F_FN order: the lowest F_FN
        # fires first among eligible lanes.
        self.batch_specs = sorted(
            (self.fn_of[n], s, BATCH_BODIES[n]) for n, s in self.route.items()
            if isinstance(s, BatchSpec)
        )
        # Bucket rings a routed kind's lane holds (1: the bucket-free tier).
        self.nbk = priority_buckets if (
            self.batch_specs and priority_buckets) else 1
        # F_FN -> the VectorTaskSpec its descriptors run as a subtree.
        table_specs.update((n, s) for n, s in self.route.items()
                           if isinstance(s, VectorTaskSpec))
        self.vector_specs = {self.fn_of[n]: s for n, s in table_specs.items()}
        for spec in self.vector_specs.values():
            spec.check_compiled()
        # The body each F_FN dispatches to.
        self.fn_bodies = [
            self.vector_specs[f].name if f in self.vector_specs else n
            for f, n in enumerate(names)
        ]
        self.params = {p: 0 for p in PARAMS}
        for p, v in (params or {}).items():
            if p not in self.params:
                raise ValueError(f"unknown body parameter {p!r}")
            self.params[p] = int(v)
        if set(self.fn_bodies) & set(DYNGRAPH_BODIES) and \
                not self.params["dyn"]:
            raise ValueError(
                "the dynamic-graph bodies need the dynamic layout (params "
                "dyn=1, spare_base, spare, bcs_base, flag_base): build the "
                "table with dyngraph.make_dyngraph_megakernel")
        self.data_specs = dict(data_specs or {})
        self.capacity = capacity
        self.num_values = num_values
        self.succ_capacity = succ_capacity
        self.uses_row_values = uses_row_values
        # Set by a ResidentKernel with homed migration (JAX's
        # Megakernel.tracks_home): the plain core's spawn and
        # take_continuation then keep the descriptor's home-link words.
        # On the card only the resident kernel's homed configuration
        # keeps them (csrc/mesh.cuh HomeSched).
        self.tracks_home = False
        if self.user_bodies and torch.device(device).type == "cuda":
            self._check_user_card(slabs)
        self.device = resolve_device(device)
        # Every body this table can dispatch: the kernels' bodies, then the
        # batched bodies of the routed kinds.
        self.body_names = list(dict.fromkeys(self.fn_bodies)) + [
            b for _, _, b in self.batch_specs]
        self._check_data_family()
        self.tile_bodies = [b for b in self.body_names
                            if b in DATA_FAMILIES["cholesky"][0]]
        self.sw_bodies = [b for b in self.body_names
                          if b in DATA_FAMILIES["sw"][0]]
        self.slab_body = next((b for b in self.body_names
                               if b in TILE_BODIES), None)
        self.slab_words = self._encode_slabs(slabs)
        self.sw_slots = 0
        if "sw_wave_batch" in self.body_names:
            self.sw_slots = self.route["sw_wave"].width * self.params["chunk"]
            if not 1 <= self.sw_slots <= MAX_SW_SLOTS:
                raise ValueError(
                    f"sw_wave_batch sweeps width*chunk = {self.sw_slots} "
                    f"tile slots a round; it must be 1..{MAX_SW_SLOTS}"
                )
        meta = [0] * (META_PRIO + PRIO_WORDS * len(self.batch_specs)
                      if self.nbk > 1 else
                      META_SLAB + len(self.slab_words) if self.slab_words
                      else META_VEC + VEC_WORDS * len(names)
                      if self.vector_specs else
                      META_BATCH + 4 * len(self.batch_specs))
        for i, p in enumerate(PARAMS):
            meta[i] = self.params[p]
        meta[META_FN_OF_BODY:META_FN_OF_BODY + MAX_BODIES] = [-1] * MAX_BODIES
        for b, n in enumerate(BODIES):
            if n not in self._user_ids:
                meta[META_FN_OF_BODY + b] = self.fn_of.get(n, -1)
        for n, b in self._user_ids.items():
            meta[META_FN_OF_BODY + b] = self.fn_of[n]
        for fn, n in enumerate(self.fn_bodies):
            meta[META_BODY_OF_FN + fn] = self.body_id(n)
        for li, (fid, spec, b) in enumerate(self.batch_specs):
            meta[META_BATCH + 4 * li:META_BATCH + 4 * li + 4] = [
                fid, spec.width, int(spec.prefetch), BODIES.index(b)]
        for fn, spec in self.vector_specs.items():
            o = META_VEC + VEC_WORDS * fn
            meta[o:o + 5] = [*spec.lanes, spec.stack_depth,
                             spec.min_idle_div, spec.param]
        meta[META_SLAB:META_SLAB + len(self.slab_words)] = self.slab_words
        if self.nbk > 1:
            for li, (_, spec, _) in enumerate(self.batch_specs):
                if spec.priority is not None:
                    name, word, *p = spec.priority
                    o = META_PRIO + PRIO_WORDS * li
                    meta[o:o + 2 + len(p)] = [PRIORITY_RULES[name], word, *p]
        self._meta = meta
        self._plain = _plain_bodies()
        user_fn = {n: fn for n, fn, _ in self.user_bodies}
        self._fn_plain = [
            _vector_body(self.vector_specs[f]) if f in self.vector_specs
            else user_fn[n] if n in user_fn
            else self._plain[n] for f, n in enumerate(names)
        ]
        self._user_libs: Dict[Tuple[int, bool], object] = {}
        self._last_info: Optional[dict] = None

    def body_id(self, name: str) -> int:
        """The body id of ``name`` in this table: a user body's (after
        the built-in ones), else its index in ``BODIES``."""
        uid = self._user_ids.get(name)
        return uid if uid is not None else BODIES.index(name)

    def _check_user_card(self, slabs) -> None:
        """A card-bound table with user bodies: every user body brings its
        CUDA source (no Python body runs on the host), and the table holds
        only what a user-body library runs (csrc/user.cuh): user bodies
        and the built-in thread-0 bodies fib, sum and uts_node, scalar or
        batch-routed."""
        no_cuda = [n for n, _, cuda in self.user_bodies if cuda is None]
        if no_cuda:
            raise ValueError(
                f"user bodies {no_cuda} have no CUDA source: a card-bound "
                "table runs each user body's CUDA statements (kernels="
                "[(name, fn, cuda)]); pass device='cpu' to run the Python "
                "bodies on the plain core")
        other = sorted(set(self.fn_bodies) - set(self._user_ids)
                       - set(USER_LIB_BUILTINS))
        if (other or self.vector_specs or slabs is not None
                or self.lane_max_age or self.priority_buckets
                or any(s.prefetch for _, s, _ in self.batch_specs)):
            raise NotImplementedError(
                "a card-bound table with user bodies holds user bodies and "
                f"the built-in bodies {USER_LIB_BUILTINS} (scalar or "
                "batch-routed), with no vector, tile, SW or graph body, "
                "lane policy or prefetch"
                + (f" (this one holds {other})" if other else "")
                + ": those user-body uses are ROADMAP A4; run it with "
                "device='cpu'")

    def user_source(self, pgas: Optional[bool] = None,
                    home: bool = False, inject: bool = False,
                    fault: bool = False, obs: bool = False) -> str:
        """The CUDA source of this table's user-body library
        (csrc/user.cuh, then each user body's statements as
        ``user_body_<k>(Ctx& ctx)`` and the switch over them; none for a
        table of built-in bodies alone). ``pgas`` picks the variant (the
        resident kernel's PGAS configurations, or the scheduler, the ring
        and the resident kernel steal-only); None: the PGAS variant iff a
        body names ``ctx.pgas``. ``home``: the resident kernel's
        migrating configuration (``HCLIB_USER_PGAS 2``). ``inject``: the
        resident kernel's injecting instances of that variant
        (``HCLIB_USER_INJECT 1``) instead; ``fault``: its instances with
        the fault layer (``HCLIB_USER_FAULT 1``) instead; ``obs``: the
        observed instances, with the recorder and the quiesce word
        (``HCLIB_USER_OBS 1``), instead of the unobserved ones."""
        if pgas is None:
            pgas = self.uses_pgas_text()
        lines = [f"#define HCLIB_USER_LANES {int(bool(self.batch_specs))}",
                 f"#define HCLIB_USER_PGAS {_user_variant(pgas, home)}"]
        if inject:
            lines.append("#define HCLIB_USER_INJECT 1")
        if fault:
            lines.append("#define HCLIB_USER_FAULT 1")
        if obs:
            lines.append("#define HCLIB_USER_OBS 1")
        lines += ['#include "user.cuh"', "", "namespace {", ""]
        for k, (name, _, cuda) in enumerate(self.user_bodies):
            lines += [f"// {name}",
                      f"__device__ void user_body_{k}(Ctx& ctx) {{", cuda,
                      "}", ""]
        lines += ["__device__ void user_body(int k, Ctx& ctx) {",
                  "  switch (k) {"]
        lines += [f"    case {k}:\n      user_body_{k}(ctx);\n      break;"
                  for k in range(len(self.user_bodies))]
        lines += ["    default:\n      break;", "  }", "}", "",
                  "}  // namespace", ""]
        return "\n".join(lines)

    def user_library(self, pgas: bool = False, home: bool = False,
                     inject: bool = False, fault: bool = False,
                     obs: bool = False):
        """This table's user-body library of variant ``pgas`` (or
        ``home``; ``inject``: its injecting instances, ``fault``: its
        instances with the fault layer, ``obs``: its observed instances),
        built on first use (``_build.user_library``)."""
        key = (_user_variant(pgas, home), bool(inject), bool(fault),
               bool(obs))
        if key not in self._user_libs:
            self._user_libs[key] = _build.user_library(
                self.user_source(bool(pgas), home, bool(inject),
                                 bool(fault), bool(obs)))
        return self._user_libs[key]

    def uses_pgas_text(self) -> bool:
        """Whether a user body's CUDA source names ``ctx.pgas``."""
        return any(cuda and re.search(r"\bctx\s*\.\s*pgas\b", cuda)
                   for _, _, cuda in self.user_bodies)

    def _check_route(self) -> None:
        unknown = set(self.route) - set(self.kernel_names)
        if unknown:
            raise ValueError(
                f"route/auto_route names unknown kernels: {sorted(unknown)}"
            )
        not_specs = [n for n, s in self.route.items()
                     if not isinstance(s, (BatchSpec, VectorTaskSpec))]
        if not_specs:
            raise ValueError(
                f"route values must be VectorTaskSpecs or BatchSpecs; "
                f"{sorted(not_specs)} are not"
            )
        routed_user = sorted(set(self.route) & set(self._user_ids))
        if routed_user:
            raise NotImplementedError(
                f"route= on user bodies {routed_user}: batch and vector "
                "routes of user bodies are ROADMAP A4 (their scalar "
                "dispatch runs)")
        batched = {n: s for n, s in self.route.items()
                   if isinstance(s, BatchSpec)}
        no_batch = [n for n in batched if n not in BATCH_BODIES]
        if no_batch:
            raise ValueError(
                f"route names kernels with no batched body: "
                f"{sorted(no_batch)}; the table compiled into "
                f"csrc/megakernel.cu batches {sorted(BATCH_BODIES)}"
            )
        for n, spec in batched.items():
            if spec.prefetch and self.priority_buckets:
                raise ValueError(
                    f"prefetch=True on {n!r} with priority_buckets="
                    f"{self.priority_buckets}: bucket rings pop FIFO and "
                    "never prefetch (the next ring to fire is chosen at "
                    "fire time, and the operand halves would be shared "
                    "across rings); pass prefetch=False")
            if spec.prefetch and BATCH_BODIES[n] not in DRAIN_BODIES:
                raise ValueError(
                    f"prefetch=True requires a drain: the batched body "
                    f"{BATCH_BODIES[n]!r} of {n!r} has none (bodies with a "
                    f"drain: {DRAIN_BODIES})"
                )
        unrouted = [n for n in ROUTED_ONLY
                    if n in self.kernel_names and n not in batched]
        if unrouted:
            raise ValueError(
                f"{unrouted} run only batch-routed: pass route="
                "{name: BatchSpec(...)}"
            )

    def _encode_slabs(self, slabs) -> list:
        """The slab words (see META_SLAB) of the table's tile body from
        ``slabs = (loads, stores)``: windows of ``data_specs`` buffers
        with a start per buffer dimension (an int, or the affine form
        ``(c0, c1, c2, c3, k)`` of the arg words) and a shape of rank 1
        or 2 on the buffer's trailing dimensions (leading ones picked).
        Checks the window against its family's shape rule and the
        shared memory the body's operand slots take."""
        if slabs is None:
            if self.slab_body:
                raise ValueError(f"tile body {self.slab_body!r} needs "
                                 "slabs=(loads, stores)")
            return []
        if not self.slab_body:
            raise ValueError("slabs= given to a table with no tile body "
                             f"(tile bodies: {sorted(TILE_BODIES)})")
        family, nload, rule, dtype = TILE_BODIES[self.slab_body]
        loads, stores = (list(x) for x in slabs)
        if len(loads) != nload or len(stores) != 1:
            raise ValueError(f"{family} takes {nload} load slab(s) and one "
                             f"store slab, got {len(loads)} and "
                             f"{len(stores)}")
        names = list(self.data_specs)
        words, soff = [len(loads), len(stores), 0, 0], 0
        for k, s in enumerate(loads + stores):
            if s.data not in self.data_specs:
                raise ValueError(f"slab {s.name!r} targets undeclared "
                                 f"buffer {s.data!r}")
            shape, dt = self.data_specs[s.data]
            shape = tuple(int(x) for x in shape)
            if dt != dtype:
                raise ValueError(f"{family} slabs move {dtype} buffers; "
                                 f"{s.data!r} is {dt}")
            if math.prod(shape) >= 1 << 31:
                raise ValueError(f"buffer {s.data!r} {shape} exceeds 2^31 "
                                 "elements (slab starts are int32)")
            if not 1 <= len(s.shape) <= min(2, len(shape)) or len(
                    s.start) != len(shape):
                raise ValueError(
                    f"slab {s.name!r}: a window of rank 1 or 2 on the "
                    f"trailing dimensions of {s.data!r} {shape}, with one "
                    f"start per dimension (got shape {s.shape}, "
                    f"{len(s.start)} starts)")
            strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
            coef = [0] * 5
            for st, stride in zip(s.start, strides):
                aff = (0, 0, 0, 0, st) if isinstance(st, int) else st
                coef = [c + a * stride for c, a in zip(coef, aff)]
            rows = s.shape[0] if len(s.shape) == 2 else 1
            cols = s.shape[-1]
            pitch = -(-cols // 4) * 4  # 16-byte rows in shared memory
            load = k < len(loads)
            words += [names.index(s.data), shape[-1], rows, cols,
                      pitch if load else 0, soff if load else 0, *coef, 0]
            soff += rows * pitch if load else 0
        words[2] = soff
        if len(words) > MAX_SLAB_WORDS:
            raise ValueError(f"{len(loads) + len(stores)} slabs take "
                             f"{len(words)} slab words, above "
                             f"{MAX_SLAB_WORDS}")
        want = tuple(x + 2 for x in stores[0].shape) if rule == "halo" \
            else stores[0].shape
        if any(tuple(s.shape) != tuple(want) for s in loads):
            raise ValueError(
                f"{family}: load slabs must be {want} for a {stores[0].shape}"
                f" store slab, got {[tuple(s.shape) for s in loads]}")
        need = 4 * soff * self._slab_slots()
        if need > TILE_SMEM_LIMIT:
            raise ValueError(
                f"{self.slab_body}'s operand slabs take {need} bytes of "
                f"shared memory ({self._slab_slots()} slots of {4 * soff}),"
                f" above the {TILE_SMEM_LIMIT} a block gives them: shrink "
                "the tile or the batch width")
        return words

    def _slab_slots(self) -> int:
        """Operand slots of the tile body: one, or two halves of
        ``width`` for a batched body."""
        spec = self.route.get(TILE_BODIES[self.slab_body][0])
        return 2 * spec.width if isinstance(spec, BatchSpec) else 1

    def _check_data_family(self) -> None:
        fams = [f for f, (bodies, _, _) in DATA_FAMILIES.items()
                if set(bodies) & set(self.body_names)]
        # The frontier and dynamic-graph bodies share their buffers.
        if len({DATA_FAMILIES[f][1:] for f in fams}) > 1:
            raise ValueError(f"one table holds bodies of one data family, "
                             f"got {fams}")
        if not fams:
            return
        _, need, optional = DATA_FAMILIES[fams[0]]
        names = list(self.data_specs)
        if names[:len(need)] != list(need) or not set(
                names[len(need):]) <= set(optional) or len(
                names) > MAX_DATA:
            raise ValueError(
                f"{fams[0]} bodies need data buffers {list(need)} in this "
                f"order (optional: {list(optional)}), got {names}"
            )

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
        st = {
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
        if self.batch_specs:
            st["tstats"] = torch.zeros(TS_WORDS, dtype=torch.int32,
                                       device=dev)
        self._observed_rows(st, dev)
        return st

    def _observed_rows(self, st: Dict[str, object], dev) -> None:
        """Add a traced build's ring row and a checkpoint build's qctl and
        qstat rows to ``st`` where missing, so that ``launch`` only writes
        them: the kernel writes the ring's header and qstat whole at exit,
        and ``st["qctl_host"]`` holds the qctl words last uploaded."""
        if self.trace is not None and "trace" not in st:
            st["trace"] = self.trace.row(dev)
        if self.checkpoint and "qctl" not in st:
            st["qctl"] = torch.zeros(8, dtype=torch.int32, device=dev)
            st["qctl_host"] = np.zeros(8, np.int32)
            st["qstat"] = torch.zeros(8, dtype=torch.int32, device=dev)

    @staticmethod
    def quiesce_words(quiesce) -> np.ndarray:
        """A ``quiesce=`` argument as the 8-word qctl row: None/False =
        off (zeros), True = quiesce at the first round boundary, an int k
        = quiesce once >= k tasks have executed this rep (a batch round
        may overshoot by width-1, as fuel does)."""
        q = np.zeros(8, np.int32)
        if quiesce is None or quiesce is False:
            return q
        q[QC_FLAG] = 1
        if quiesce is not True:
            q[QC_AFTER] = int(quiesce)
        return q

    def launch(self, st: Dict[str, object], fuel: int = 1 << 22,
               reps: int = 1, stage_all_values: bool = False,
               quiesce=None) -> torch.Tensor:
        """Run the scheduler over state ``st`` IN PLACE (its task table,
        ready ring, counts, value slots, data buffers and, for a routed
        table, ``st["tstats"]`` - added if missing - are the outputs).
        ``reps`` > 1 re-stages the input state and re-runs the graph, with
        C_EXECUTED accumulated across reps. A traced build writes its ring
        to ``st["trace"]``; a checkpoint build uploads ``quiesce``
        (``quiesce_words``) to ``st["qctl"]`` when it differs from the
        words there and writes ``st["qstat"]`` (rows ``state`` allocates).
        Returns the per-body dispatch counts (int32[NDISPATCH] by body id,
        on the state's device; not synced).

        On CUDA tensors this launches the kernel (and raises if the launch
        fails); on CPU tensors it runs the plain version."""
        self._check_data(st["data"])
        tasks = st["tasks"]
        if quiesce is False:  # falsy boolean plumbing = off
            quiesce = None
        if quiesce is not None and not self.checkpoint:
            raise ValueError(
                "quiesce= needs Megakernel(checkpoint=True): the quiesce "
                "word is compiled into the round loop only then")
        if self.batch_specs and "tstats" not in st:
            st["tstats"] = torch.zeros(TS_WORDS, dtype=torch.int32,
                                       device=tasks.device)
        self._observed_rows(st, tasks.device)
        if self.checkpoint:
            words = self.quiesce_words(quiesce)
            if not np.array_equal(words, st["qctl_host"]):
                st["qctl"].copy_(torch.from_numpy(words))
                st["qctl_host"] = words
        if tasks.device.type == "cpu":
            core = _PlainCore(self, st)
            core.run(int(fuel), int(reps), stage_all_values)
            return torch.tensor(core.dispatch, dtype=torch.int32)
        return self._launch_cuda(st, int(fuel), int(reps), stage_all_values)

    def _smem_bytes(self) -> int:
        smem = 0
        fr = [b for b in self.body_names if b in FRONTIER_BODIES]
        if fr:
            # The EXPAND bodies' edge slabs: a block row and its weight
            # row a slot, one slot or two halves of width slots.
            spec = self.route.get(next(n for n in self.kernel_names
                                       if n in FRONTIER_BODIES))
            slots = 2 * spec.width if isinstance(spec, BatchSpec) else 1
            smem = 4 * EBLOCK * slots * 2
        if self.slab_words:
            smem = 4 * self.slab_words[2] * self._slab_slots()
        if "potrf" in self.tile_bodies:
            smem = potrf_smem_bytes(self.params["factor_base"])
        if self.sw_slots:
            smem = max(smem, sw_smem_bytes(self.sw_slots))
        return smem

    def _launch_user(self, st, fuel, reps, stage_all_values) -> torch.Tensor:
        """A table with user bodies on the card: its library's scheduler
        (``mk_user_kernel``) on the state as a one-device mesh."""
        if reps != 1:
            raise ValueError("a table with user bodies runs one rep a "
                             "launch on the card (reps=1)")
        if self.trace is not None or self.checkpoint:
            # The resident kernel and the ring record and quiesce a user
            # table on the card; its one-device scheduler does not.
            raise NotImplementedError(
                "a traced or checkpoint-built table with user bodies runs "
                "on the card under ResidentKernel or ICIStealMegakernel; "
                "its one-device scheduler (mk_user_kernel) has no recorder "
                "or quiesce poll: ROADMAP A4; run it with device='cpu'")
        mst = {k: st[k].unsqueeze(0) for k in ("tasks", "succ", "ready",
                                                "counts", "ivalues",
                                                "tstats") if k in st}
        mst["data"] = {k: v.unsqueeze(0) for k, v in st["data"].items()}
        h, keep = self.mesh_host(mst, fuel, stage_all_values)
        self.mesh_launch("mesh_round", h, *self.mesh_config(),
                         st["tasks"].device)
        return keep["dispatch"][0]

    def _launch_cuda(self, st, fuel, reps, stage_all_values) -> torch.Tensor:
        if self.user_bodies:
            return self._launch_user(st, fuel, reps, stage_all_values)
        dev = st["tasks"].device
        cap, nv = self.capacity, self.num_values
        want = {
            "tasks": ((cap, DESC_WORDS), torch.int32),
            "succ": ((self.succ_capacity,), torch.int32),
            "ready": ((cap,), torch.int32),
            "counts": ((8,), torch.int32),
            "ivalues": ((nv,), torch.int32),
        }
        if self.batch_specs:
            want["tstats"] = ((TS_WORDS,), torch.int32)
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
        dispatch = torch.zeros(NDISPATCH, dtype=torch.int32, device=dev)
        meta = torch.tensor(self._meta, dtype=torch.int32, device=dev)
        nbatch = len(self.batch_specs)
        nrows = nbatch * self.nbk
        lanes = torch.empty(max(nrows, 1) * cap, dtype=torch.int32,
                            device=dev)
        lstate = torch.zeros(max(nrows, 1) * LS_WORDS, dtype=torch.int32,
                             device=dev)
        tstats = st["tstats"] if nbatch else None
        data = st["data"]
        ptrs = (ctypes.c_void_p * MAX_DATA)(
            *[data[k].data_ptr() for k in self.data_specs])
        work = vstack = None
        threads = 32
        if (self.tile_bodies or self.sw_bodies or self.vector_specs
                or self.slab_words):
            threads = THREADS
        if self.tile_bodies:
            ts = self.params["tile"]
            work = torch.empty(ts * ts, dtype=torch.float32, device=dev)
        if self.vector_specs:
            # The lane stacks of the subtree engine, [slot][word][lane]
            # (too large for shared memory at full width).
            vstack = torch.empty(max(
                s.stack_depth * (s.frame_words + 2) * s.lanes[0] * s.lanes[1]
                for s in self.vector_specs.values()), dtype=torch.int32,
                device=dev)
        # The kernel's instances (megakernel.cu kMode): without lane, SW
        # and vector code for tables that need none of them; with lane
        # and SW code; with the vector engine too; with lanes and the
        # tile bodies; with lanes, the age and bucket policies and the
        # frontier and knapsack bodies; those under the dynamic-graph
        # layout.
        policy = nbatch and (self.lane_max_age or self.nbk > 1)
        if policy or set(self.body_names) & set(POLICY_BODIES):
            if self.slab_words or self.vector_specs or self.sw_bodies:
                raise NotImplementedError(
                    "lane_max_age / priority_buckets on the card run in the "
                    "scheduler instance with the frontier, knapsack, fib, "
                    "UTS and Cholesky bodies; this table also holds "
                    f"{self.slab_body or self.sw_bodies or 'vector'} "
                    "bodies (run it on the CPU, or without the policies)")
            mode = 5 if self.params["dyn"] else 4
        else:
            mode = 3 if self.slab_words else 2 if self.vector_specs else \
                int(bool(nbatch or self.sw_bodies))
        ring = st.get("trace")
        qctl, qstat = st.get("qctl"), st.get("qstat")
        lib = _build.library("megakernel")
        fn = lib.hclib_mk_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 15 + [
            ctypes.c_void_p
        ]
        err = fn(
            st["tasks"].data_ptr(), ins["tasks"].data_ptr(),
            st["succ"].data_ptr(),
            st["ready"].data_ptr(), ins["ready"].data_ptr(),
            st["counts"].data_ptr(), ins["counts"].data_ptr(),
            st["ivalues"].data_ptr(), ins["ivalues"].data_ptr(),
            free.data_ptr(), meta.data_ptr(), dispatch.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p),
            work.data_ptr() if work is not None else None,
            lanes.data_ptr(), lstate.data_ptr(),
            tstats.data_ptr() if tstats is not None else None,
            vstack.data_ptr() if vstack is not None else None,
            ring.data_ptr() if ring is not None else None,
            qctl.data_ptr() if qctl is not None else None,
            qstat.data_ptr() if qstat is not None else None,
            self.trace.capacity if ring is not None else 0,
            self.quiesce_stride,
            len(self.kernel_names), nbatch, nrows, self.nbk,
            self.lane_max_age if mode >= 4 else 0, cap, nv,
            min(fuel, 0x7FFFFFFF),
            reps, int(bool(stage_all_values)), mode, threads,
            self._smem_bytes(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "megakernel")
        _build.LAUNCHES["megakernel"] += 1
        if ring is not None or qctl is not None:
            # The launch ran an observed instance: the recorder and poll.
            _build.LAUNCHES["tracebuf"] += 1
        return dispatch

    # -- the grid launch over a mesh (csrc/mesh.cuh) --

    def mesh_config(self, steal_kernel: bool = False):
        """(instance, threads, smem) of a launch over a mesh on the card:
        ``mk_grid_kernel`` (the sharded runner) runs ``mk_kernel``'s lean
        or lanes instance a block; the steal kernels (ring, resident) run
        the thread-0 bodies of those instances (fib, sum, UTS node and
        their batched forms) on one thread a CTA. Other tables raise: the
        plain versions run every table."""
        if self.user_bodies:
            # A user-body library: its scheduler and steal kernels run on
            # thread 0 of one-thread CTAs (the table was checked at
            # construction).
            return int(bool(self.batch_specs)), 1, 0
        policy = self.batch_specs and (self.lane_max_age or self.nbk > 1)
        if (self.vector_specs or self.slab_words or policy
                or set(self.body_names) & set(POLICY_BODIES)
                or any(s.prefetch for _, s, _ in self.batch_specs)):
            raise NotImplementedError(
                "the mesh launches on the card hold mk_kernel's lean and "
                "lanes instances (no vector, tile, frontier, knapsack or "
                "dynamic-graph body, no lane policy, no prefetch): ROADMAP "
                "A11b/A11c; run this table on the CPU mesh")
        mode = int(bool(self.batch_specs or self.sw_bodies))
        if steal_kernel:
            allowed = {"fib", "sum", "uts_node", "fib_batch",
                       "uts_node_batch"}
            other = sorted(set(self.body_names) - allowed)
            if other:
                raise NotImplementedError(
                    f"the steal kernels on the card run the fib, sum and "
                    f"UTS node bodies (scalar and batched), not {other}: "
                    "ROADMAP A11b; run this table on the CPU mesh")
            return mode, 1, 0
        threads = THREADS if (self.tile_bodies or self.sw_bodies) else 32
        return mode, threads, self._smem_bytes()

    def mesh_host(self, mst: Dict[str, object], fuel: int,
                  stage_all_values: bool):
        """The ``MeshHost`` of stacked state ``mst`` (every tensor with a
        leading mesh axis, on the card) and the per-device scratch it
        points at; returns (host, keep), ``keep`` holding the scratch
        tensors alive for the launch."""
        tasks = mst["tasks"]
        ndev, dev = tasks.shape[0], tasks.device
        cap, nv = self.capacity, self.num_values
        want = {
            "tasks": (ndev, cap, DESC_WORDS), "succ": (ndev, self.succ_capacity),
            "ready": (ndev, cap), "counts": (ndev, 8), "ivalues": (ndev, nv),
        }
        if self.batch_specs:
            want["tstats"] = (ndev, TS_WORDS)
        for k, shape in want.items():
            t = mst[k]
            if (tuple(t.shape) != shape or t.dtype != torch.int32
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"mesh state[{k!r}] must be a contiguous "
                                 f"{shape} int32 tensor on {dev}")
        nrows = len(self.batch_specs) * self.nbk
        keep = {
            "free": torch.empty(ndev, cap + 1, dtype=torch.int32, device=dev),
            "dispatch": torch.zeros(ndev, NDISPATCH, dtype=torch.int32,
                                    device=dev),
            "meta": torch.tensor(self._meta, dtype=torch.int32, device=dev),
            "lanes": torch.empty(ndev, max(nrows, 1) * cap,
                                 dtype=torch.int32, device=dev),
            "lstate": torch.zeros(ndev, max(nrows, 1) * LS_WORDS,
                                  dtype=torch.int32, device=dev),
        }
        if self.tile_bodies:
            ts = self.params["tile"]
            keep["work"] = torch.empty(ndev, ts * ts, dtype=torch.float32,
                                       device=dev)
        # The value-block stacks of a user library's kernels (a table of
        # built-in bodies alone runs the PGAS and migrating
        # configurations from one too).
        keep["vfree"] = torch.zeros(ndev, nv // VBLOCK + 1,
                                    dtype=torch.int32, device=dev)
        h = MeshHost()
        for k, src in (("tasks", mst), ("succ", mst), ("ready", mst),
                       ("counts", mst), ("ivalues", mst), ("tstats", mst),
                       ("dispatch", keep), ("lanes", keep), ("lstate", keep),
                       ("work", keep)):
            t = src.get(k)
            if t is not None:
                setattr(h, k, t.data_ptr())
                setattr(h, "s_" + k, t[0].numel())
        h.freestk, h.s_freestk = keep["free"].data_ptr(), cap + 1
        h.meta = keep["meta"].data_ptr()
        h.vfree, h.s_vfree = keep["vfree"].data_ptr(), nv // VBLOCK + 1
        for i, k in enumerate(self.data_specs):
            t = mst["data"][k]
            if t.shape[0] != ndev or t.device != dev or not t.is_contiguous():
                raise ValueError(f"mesh data[{k!r}] must be contiguous on "
                                 f"{dev} with a leading mesh axis of {ndev}")
            h.data[i] = t.data_ptr()
            h.s_data[i] = t[0].numel() * t.element_size()
        h.nfn, h.nbatch, h.nrows = len(self.kernel_names), len(
            self.batch_specs), nrows
        h.cap, h.num_values, h.ndev = cap, nv, ndev
        h.fuel = min(int(fuel), 0x7FFFFFFF)
        h.stage_all_values = int(bool(stage_all_values))
        return h, keep

    def mesh_launch(self, kind: str, host: "MeshHost", mode: int,
                    threads: int, smem: int, dev, pgas: bool = False,
                    steal: bool = True, home: bool = False,
                    inject: bool = False, fault: bool = False,
                    obs: bool = False) -> None:
        """Launch ``kind`` (``"mesh_round"``, ``"ici_ring"``,
        ``"resident_steal"`` or ``"pgas_ring"``, PGASMegakernel's ring
        kernel, counted as ``pgas_ring`` observed or not and refused with
        a ValueError past the co-resident limit; ``pgas``: the resident
        kernel's PGAS
        configuration, with ``steal`` or without; ``home``: its migrating
        configuration; ``inject``: the resident kernel's injecting
        instance of that configuration; ``fault``: its instance with the
        fault layer, ``resident_kernel<.., kFault>``; ``obs``: the observed
        instance of the ring or the resident kernel, ``kObs``, with the
        recorder and the quiesce word) over ``host``'s mesh; raises if
        the launch fails, or if a steal kernel's mesh has more devices
        than the card holds CTAs at once (``mesh_coresident``). A table
        with user bodies, and any table under the PGAS or migrating
        configuration or injecting, launches its own library's
        kernels."""
        k = USER_MESH_KINDS.index(kind)
        if k:
            limit = self.coresident(kind, mode, pgas, steal, home, inject,
                                    fault, obs)
            if host.ndev > limit:
                raise (ValueError if kind == "pgas_ring" else RuntimeError)(
                    f"{kind}: a mesh of {host.ndev} devices needs that many "
                    f"co-resident CTAs; this card holds {limit} at once "
                    "(one CTA an SM, cooperative launch): use a mesh of at "
                    f"most {limit}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        if self.user_bodies or pgas or inject:
            if self.uses_pgas_text() and not pgas:
                raise ValueError(
                    "a user body names ctx.pgas, which exists only under "
                    "the resident kernel's PGAS configuration "
                    "(ResidentKernel(channels=...) or PGASMegakernel)")
            lib = self.user_library(pgas, home, inject, fault, obs)
            fn = lib.hclib_user_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(MeshHost)] + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            err = fn(ctypes.byref(host), k, mode, int(steal),
                     _user_variant(pgas, home), stream)
        else:
            lib = _build.library("megakernel")
            fn = lib.hclib_mesh_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(MeshHost)] + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            err = fn(ctypes.byref(host), k,
                     mode + 2 * bool(fault) + 4 * bool(obs), threads, smem,
                     stream)
        counter = ("pgas_ring" if kind == "pgas_ring"
                   else "resident_obs" if obs and k == 2
                   else "ici_ring_obs" if obs
                   else "resident_fault" if fault
                   else "resident_inject" if inject
                   else "resident_homed" if home
                   else "resident_pgas" if pgas
                   else "mk_user" if self.user_bodies and k == 0 else kind)
        _build.check(lib, err, counter)
        _build.LAUNCHES[counter] += 1

    def coresident(self, kind: str, mode: int, pgas: bool = False,
                   steal: bool = True, home: bool = False,
                   inject: bool = False, fault: bool = False,
                   obs: bool = False) -> int:
        """The most CTAs of steal kernel ``kind`` (instance ``mode``; the
        resident kernel's PGAS configuration with ``pgas``, its migrating
        one with ``home``, their injecting instances with ``inject``,
        their instances with the fault layer with ``fault``) this card
        holds at once, from this table's library."""
        if not (self.user_bodies or pgas or inject):
            return mesh_coresident(kind,
                                   mode + 2 * bool(fault) + 4 * bool(obs))
        lib = self.user_library(pgas, home, inject, fault, obs)
        fn = lib.hclib_user_coresident
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        out = ctypes.c_int(0)
        _build.check(lib,
                     fn(USER_MESH_KINDS.index(kind), mode, int(steal),
                        _user_variant(pgas, home), ctypes.byref(out)),
                     f"{kind} occupancy")
        return out.value

    def fold_dispatches(self, dispatch: torch.Tensor) -> Dict[str, int]:
        """Per-body dispatch counts of a ``launch`` by name (a batched
        body counts one per fired batch). For a launch on the card, each
        tile, SW, batched or vector body's dispatches are its launches
        inside the megakernel and are added to ``_build.LAUNCHES``."""
        n = dispatch.tolist()
        out = {b: n[self.body_id(b)] for b in self.body_names}
        if dispatch.device.type == "cuda":
            for b in self.body_names:
                if b in COUNTED and b not in self._user_ids:
                    _build.LAUNCHES[self.counter_of(b)] += out[b]
        return out

    def counter_of(self, body: str) -> str:
        """The ``_build.LAUNCHES`` counter a dispatch of ``body`` counts
        in (``COUNTED``; the EXPAND bodies of a dynamic-graph table count
        as ``DYN_EXPAND_COUNTER``)."""
        if self.params["dyn"] and body in FRONTIER_BODIES:
            return DYN_EXPAND_COUNTER
        return COUNTED[body]

    def decode_tier_stats(self, tstats) -> Dict[str, object]:
        """The TS_WORDS counter row as the per-tier stats dict
        (``info['tiers']``), keys and values as JAX decodes them."""
        t = [int(x) for x in np.asarray(tstats)]
        rounds, tasks, offered = (t[TS_BATCH_ROUNDS], t[TS_BATCH_TASKS],
                                  t[TS_OFFERED])
        return {
            "batch_rounds": rounds,
            "batch_tasks": tasks,
            "batch_occupancy": tasks / offered if offered else 0.0,
            "batch_width": max(s.width for _, s, _ in self.batch_specs),
            "full_rounds": t[TS_FULL_ROUNDS],
            "scalar_tasks": t[TS_SCALAR_ROUNDS],
            "routed": t[TS_ROUTED],
            "prefetch_hits": t[TS_PREFETCH],
            "spilled": t[TS_SPILLED],
            "age_fires": t[TS_AGE_FIRES],
            "max_starved_age": t[TS_MAX_AGE],
            "bucket_fires": t[TS_BUCKET_FIRES],
            "bucket_inversions": t[TS_INVERSIONS],
        }

    def stats_dict(self) -> Dict[str, object]:
        """Stats of the most recent ``run()`` (tier counters included
        when batch-routed); {} before any run."""
        return dict(self._last_info or {})

    def run(self, builder: TaskGraphBuilder, data=None, ivalues=None,
            fuel: int = 1 << 22, quiesce=None):
        """Execute the task graph to completion; returns (ivalues numpy
        array, data dict of tensors, info dict). ``quiesce`` (checkpoint
        builds; see ``quiesce_words``) stops the scheduler at a round
        boundary: the run returns ``info['quiesced'] = True`` and
        ``info['state']`` (numpy copies of the live scheduler state, data
        included; feed it to ``resume`` or
        ``runtime.checkpoint.snapshot_megakernel``) instead of raising
        StallError on the pending remainder."""
        st = self.state(builder, data, ivalues)
        return self._execute(st, fuel, quiesce, stage_all_values=False)

    def resume(self, state: Dict[str, object], fuel: int = 1 << 22,
               quiesce=None):
        """Re-enter mid-graph from a quiesced run's ``info['state']`` (or a
        restored ``CheckpointBundle``'s) and continue; a resumed run may
        be quiesced again. Stages ALL value slots and rebuilds the row
        free stack from the completion tombstones, into fresh tensors on
        this megakernel's device."""
        data = dict(state.get("data") or {})
        if set(data) != set(self.data_specs):
            raise ValueError(
                f"state data buffers {sorted(data)} != declared "
                f"{sorted(self.data_specs)}")
        dev = self.device
        st = {k: tensor_of(np.asarray(state[k], np.int32), dev)
              for k in ("tasks", "succ", "ready", "counts", "ivalues")}
        st["data"] = {
            k: v.to(dev).clone() if isinstance(v, torch.Tensor)
            else tensor_of(v, dev) for k, v in data.items()}
        return self._execute(st, fuel, quiesce, stage_all_values=True)

    def _execute(self, st, fuel, quiesce, stage_all_values: bool):
        dev = st["tasks"].device
        cuda = dev.type == "cuda"
        # A traced run's epoch brackets the launch (tracebuf.trace_info):
        # the host clock before it and after the card has finished it.
        traced = self.trace is not None
        if traced and cuda:
            torch.cuda.synchronize(dev)
        t0_ns = time.monotonic_ns() if traced else 0
        dispatch = self.launch(st, fuel, stage_all_values=stage_all_values,
                               quiesce=quiesce)
        if traced and cuda:
            torch.cuda.synchronize(dev)
        t1_ns = time.monotonic_ns() if traced else 0
        counts_np = st["counts"].cpu().numpy()
        ivalues_np = st["ivalues"].cpu().numpy()
        info = {
            "executed": int(counts_np[C_EXECUTED]),
            "pending": int(counts_np[C_PENDING]),
            "allocated": int(counts_np[C_ALLOC]),
            "value_alloc": int(counts_np[C_VALLOC]),
            "overflow": bool(counts_np[C_OVERFLOW]),
            "dispatch": self.fold_dispatches(dispatch),
            "device": str(dev),
        }
        if self.batch_specs:
            info["tiers"] = self.decode_tier_stats(st["tstats"].cpu())
        quiesced = False
        if self.checkpoint:
            qstat = st["qstat"].cpu().numpy()
            quiesced = bool(qstat[QS_QUIESCED])
            info["quiesced"] = quiesced
            if quiesced:
                info["quiesce"] = {"executed_at": int(qstat[QS_AT])}
        if self.trace is not None:
            info["trace"] = trace_info([st["trace"].cpu().numpy()], t0_ns,
                                       t1_ns, self.trace.capacity)
            if "tiers" in info:
                info["tiers"].update(self.tier_gauges(info["trace"]))
        if quiesced:
            info["state"] = {
                "tasks": numpy_of(st["tasks"]),
                "succ": numpy_of(st["succ"]),
                "ready": numpy_of(st["ready"]),
                "counts": counts_np.copy(),
                "ivalues": ivalues_np.copy(),
                "data": {k: numpy_of(v) for k, v in st["data"].items()},
            }
        self._last_info = info
        if info["overflow"]:
            raise RuntimeError(
                f"megakernel overflow: "
                f"{decode_overflow(int(counts_np[C_OVERFLOW]))} exhausted "
                f"(capacity={self.capacity}, num_values={self.num_values}); "
                "raise the limits, coarsen tasks, or audit frees"
            )
        if info["pending"] != 0 and not quiesced:
            raise StallError(
                f"megakernel stalled with {info['pending']} pending tasks "
                f"after {info['executed']} executed (dependency cycle or fuel "
                f"{fuel} exhausted)",
                stats=info,
            )
        return ivalues_np, st["data"], info

    def tier_gauges(self, trace) -> Dict[str, object]:
        """The trace-derived tier gauges JAX adds to ``info['tiers']`` of
        a traced run: the longest partial-fire streak per lane
        (``lane_partial_ages`` by F_FN, and their max) and, with bucket
        rings, the per-bucket occupancy."""
        widths = {fid: spec.width for fid, spec, _ in self.batch_specs}
        ages = lane_partial_age(trace, widths)
        out = {"lane_partial_ages": ages,
               "lane_partial_age": max(ages.values(), default=0)}
        if self.priority_buckets:
            out["bucket_occupancy"] = bucket_occupancy(
                trace, widths, self.priority_buckets)
        return out


def potrf_smem_bytes(factor_base: int) -> int:
    """Dynamic shared memory of the POTRF body: the diagonal block and its
    inverse, each factor_base x (factor_base + 1) f32."""
    return 2 * factor_base * (factor_base + 1) * 4


def sw_smem_bytes(slots: int) -> int:
    """Dynamic shared memory of sw_wave_batch: two operand halves of
    ``slots`` tile slots, each slot's a, b, top and left rows (SW_T int32
    each) and the 16-byte chunk that holds its corner."""
    return 2 * slots * (4 * SW_T + 4) * 4


MESH_KINDS = ("mesh_round", "ici_ring", "resident_steal")
# The kinds a user library launches (csrc/user.cuh): those, and
# PGASMegakernel's ring kernel.
USER_MESH_KINDS = MESH_KINDS + ("pgas_ring",)
MAX_HOPS = 16
_MESH_FIELDS = (
    "tasks", "succ", "ready", "counts", "ivalues", "freestk", "dispatch",
    "lanes", "lstate", "tstats", "work", "meta",
    "s_tasks", "s_succ", "s_ready", "s_counts", "s_ivalues", "s_freestk",
    "s_dispatch", "s_lanes", "s_lstate", "s_tstats", "s_work",
)
_MESH_TAIL = (
    "nfn", "nbatch", "nrows", "cap", "num_values", "fuel",
    "stage_all_values", "ndev", "abort", "ws", "err", "wl", "fstats",
    "xstats", "quantum", "max_rounds", "window", "scan", "nhops", "port_words",
    "timeout_ns",
)
MAX_CHANS = 8  # csrc/mesh.cuh: channels of a PGAS configuration
PG_SECTIONS = 15  # csrc/mesh.cuh PG_*: the sections of a PGAS workspace
_PGAS_FIELDS = ("vfree", "s_vfree", "pg", "s_pg", "nchan", "amw", "outq",
                "maxw", "stat_words", "p_inbox")
# The injecting instances: each device's ring, ictl and tctl rows, the
# ring's rows a device, the tenant lanes and a lane region's rows.
_INJECT_FIELDS = ("iring", "ictl", "tctl", "ring_rows", "ntenants",
                  "region")
# The instances with the fault layer: the plan's words and each device's
# fault workspace.
_FAULT_FIELDS = ("fplan", "fws")
# The observed instances: the recorder rings, their capacity, and whether
# the resident kernel's quiesce word is compiled in.
_OBS_FIELDS = ("ring", "tr_cap", "ckpt")


class MeshHost(ctypes.Structure):
    """csrc/mesh.cuh ``MeshHost``: device 0's slice of every stacked state
    tensor with its per-device stride (in words; data buffers in bytes),
    the table's sizes, the steal protocol's words, and (user-body
    libraries) the value-block stacks and the PGAS configuration's
    workspace and channels; the injecting instances' ring; the fault
    layer's plan and workspace). Every field
    is 64 bits (pointers too), so both sides lay it out alike."""

    _fields_ = (
        [(n, ctypes.c_int64) for n in _MESH_FIELDS]
        + [("data", ctypes.c_int64 * MAX_DATA),
           ("s_data", ctypes.c_int64 * MAX_DATA)]
        + [(n, ctypes.c_int64) for n in _MESH_TAIL]
        + [("hops", ctypes.c_int64 * MAX_HOPS)]
        + [(n, ctypes.c_int64) for n in _PGAS_FIELDS]
        + [(n, ctypes.c_int64 * MAX_CHANS) for n in
           ("chan_buf", "chan_rows", "chan_nrows", "chan_row_bytes")]
        + [("pg_off", ctypes.c_int64 * PG_SECTIONS)]
        + [(n, ctypes.c_int64) for n in _INJECT_FIELDS]
        + [(n, ctypes.c_int64) for n in _FAULT_FIELDS]
        + [(n, ctypes.c_int64) for n in _OBS_FIELDS]
    )


class MeshGrid:
    """The scheduler run on every mesh device of stacked state ``mst`` IN
    PLACE, launch after launch (sharded.py's shard_map entry, once a round
    in the steal loop): on the card one ``mk_grid_kernel`` launch, block d
    on device d's slice; on the CPU the plain core device by device. The
    host struct and the per-device scratch are built once; each launch
    clears only the lane cursors, which the plain core starts afresh."""

    def __init__(self, mk: "Megakernel", mst: Dict[str, object],
                 fuel: int = 1 << 22, stage_all_values: bool = False):
        tasks = mst["tasks"]
        mk._check_data({k: v[0] for k, v in mst["data"].items()})
        if mk.batch_specs and "tstats" not in mst:
            mst["tstats"] = torch.zeros(tasks.shape[0], TS_WORDS,
                                        dtype=torch.int32,
                                        device=tasks.device)
        self.mk, self.mst, self.dev = mk, mst, tasks.device
        self.fuel, self.stage_all_values = fuel, stage_all_values
        if self.dev.type == "cpu":
            self.total = torch.zeros(NDISPATCH, dtype=torch.int32)
        else:
            self.config = mk.mesh_config()
            self.host, self.keep = mk.mesh_host(mst, fuel, stage_all_values)

    def launch(self, span=None) -> None:
        """One launch; ``span``, a context manager, brackets the launch
        call alone."""
        span = span or contextlib.nullcontext()
        if self.dev.type == "cpu":
            with span:
                for d in range(self.mst["tasks"].shape[0]):
                    self.total += self.mk.launch(
                        mesh_slice(self.mst, d), self.fuel,
                        stage_all_values=self.stage_all_values)
            return
        self.keep["lstate"].zero_()
        with span:
            self.mk.mesh_launch("mesh_round", self.host, *self.config,
                                self.dev)

    def dispatch(self) -> torch.Tensor:
        """The dispatch counts summed over the devices and the launches
        (int32[NDISPATCH])."""
        if self.dev.type == "cpu":
            return self.total
        return self.keep["dispatch"].sum(0, dtype=torch.int32)


def _user_variant(pgas: bool, home: bool) -> int:
    """A user library's variant (csrc/user.cuh ``HCLIB_USER_PGAS``): 0
    the scheduler, the ring and the resident kernel steal-only, 1 its
    PGAS configurations, 2 its migrating configuration."""
    return 2 if home else int(bool(pgas))


def mesh_slice(mst: Dict[str, object], d: int) -> Dict[str, object]:
    """Mesh device ``d``'s state of stacked state ``mst``: views, so the
    plain core's write-back lands in the stacked tensors."""
    out = {k: mst[k][d] for k in ("tasks", "succ", "ready", "counts",
                                  "ivalues", "tstats") if k in mst}
    out["data"] = {k: v[d] for k, v in mst["data"].items()}
    return out


def mesh_coresident(kind: str, mode: int) -> int:
    """The most CTAs of steal kernel ``kind`` (instance ``mode``: bit 0
    lanes, bit 1 the resident kernel's fault layer, bit 2 observed) this
    card holds at once, one an SM at most (csrc/mesh.cuh
    ``hclib_mesh_coresident``: the occupancy API's count, capped at the SM
    count; 0 without cooperative launch)."""
    lib = _build.library("megakernel")
    fn = lib.hclib_mesh_coresident
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    _build.check(lib, fn(MESH_KINDS.index(kind), mode, ctypes.byref(out)),
                 f"{kind} occupancy")
    return out.value
