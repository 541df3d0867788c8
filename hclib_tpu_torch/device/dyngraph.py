"""Dynamic-graph tier on the card: a mutable blocked-CSR adjacency that
takes edge inserts while BFS / SSSP / PageRank run over it, on the
scheduler megakernel (port of ``hclib_tpu/device/dyngraph.py``, single
device).

**The mutable adjacency.** ``DynGraph`` pre-allocates ``spare`` edge
blocks per vertex behind the static rows of the same ``indices`` /
``weights`` buffers: vertex ``v``'s spares are rows ``[spare_base +
v*spare, spare_base + (v+1)*spare)``, a pure function of (v, ordinal).
The append cursor is the vertex's live block count in the vertex table;
every block is full but the tail, so the splice target and position
follow from ``(deg, blk_count)``.

**The kinds.** ``UPDATE(u, v, w, uid)`` (``dg_update``) splices edge
``u -> v`` into u's chain in place: one lane of the tail row, or, when
the tail is full, a fresh spare row written whole; it then folds the
vertex table, the ``uid``-indexed applied flag (a repeated uid does
nothing) and the counters, and relaxes the new edge with u's current
label (BFS / SSSP; PageRank splices are mass-neutral). A full tail with
no spare ordinal left drops the splice and flags the engine overflow,
so the run raises. ``QUERY(v)`` (``dg_query``) publishes v's label
through the descriptor's out slot. The traversal's EXPANDs are the
frontier tier's bodies run under the dynamic layout (the ``dyn``
parameter): the live-edge count is clamped to the vertex table
(``frontier._eff_cnt``) and an improving relax spawns the static blocks,
then the spare ones (``frontier._spawn_blocks``). BFS / SSSP labels are
monotone min-folds, so the fixpoint equals a from-scratch traversal of
the mutated graph (``host_dyngraph``) whatever the interleaving.

What differs from the JAX module:

- The bodies are compiled (``csrc/frontier.cuh`` ``dg_splice``,
  ``dg_query``, the clamp and spare-aware spawner of ``fr_expand`` /
  ``fr_expand_round``); the plain versions here read the layout from the
  megakernel's parameters (``spare_base``, ``spare``, ``bcs_base``,
  ``flag_base``, ``dyn``) and find the traversal family as the body of
  F_FN 0, as the card does. ``SpliceKernel`` / ``QueryKernel`` name those
  bodies and hold their plain spellings.
- The UPDATE and QUERY lanes are pinned to their buckets by the named
  rule ``("const", word, c)`` in place of JAX's constant lambdas.
- The data buffers are written in place and, as in JAX (where they are
  aliased HBM buffers), not re-staged by ``reps > 1``: a second rep
  re-stages the vertex table and applied flags, so every splice lands
  again on the same lane with the same word.
- ``placement=`` / ``mesh=`` / ``quantum=`` / ``window=`` /
  ``hop_order=`` raise naming ROADMAP A11 and ``reshard_dyngraph``
  naming A11; ``serve_dyngraph`` runs the scalar arm on the streaming
  front door (device/inject.py), its refusal of ``width`` as JAX's;
  ``trace=`` / ``checkpoint=`` go to the Megakernel (the ``_dyngraph``
  stamp rides a checkpoint bundle's meta, runtime/checkpoint.py); the
  schedule-independence certificate (``si_claim``) is kept as the
  attribute only (A13).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.env import env_int, env_set
from .descriptor import TaskGraphBuilder
from .frontier import (EBLOCK, FR_EXPAND, INF, V_EDGES, V_RELAX, VT_BASE,
                       FrontierKernel, Graph, _RELAX, _bucket_rule,
                       _pr_seed_rank, _pr_split, _spawn_blocks, bfs_kernel,
                       default_delta, host_bfs, host_pagerank_push,
                       host_sssp, pagerank_kernel, seed_frontier, sssp_kernel)
from .megakernel import (BODIES, BatchContext, BatchSpec, KernelContext,
                         Megakernel, _i32)

__all__ = [
    "DG_UPDATE", "DG_QUERY", "V_UPDATES", "V_FREE", "V_DROPPED", "V_QUERIES",
    "DynGraph", "DynFrontierKernel", "SpliceKernel", "QueryKernel",
    "make_dyngraph_megakernel", "run_dyngraph", "reshard_dyngraph",
    "serve_dyngraph", "host_dyngraph", "host_incremental",
    "host_incremental_pagerank", "dyngraph_state", "fk_data",
]

# Kernel-table ids: EXPAND keeps the frontier tier's id 0 (its relax
# spawns F_FN 0), the service kinds follow.
DG_UPDATE = 1
DG_QUERY = 2

# Value-slot counters beyond the frontier tier's V_EDGES / V_RELAX.
V_UPDATES = 2  # splices applied (once per uid)
V_FREE = 3     # spare blocks in use
V_DROPPED = 4  # splices dropped on spare exhaustion (overflow-flagged)
V_QUERIES = 5  # QUERY descriptors served


def _env_spare_blocks() -> int:
    s = env_int("HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS", 2)
    if s < 1:
        raise ValueError(f"HCLIB_TPU_DYNGRAPH_SPARE_BLOCKS={s} must be >= 1")
    return int(s)


def _env_update_priority() -> int:
    return int(env_int("HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY", 0))


class DynGraph(Graph):
    """Blocked-CSR adjacency with per-vertex spare blocks and a registered
    update stream (the JAX package's ``DynGraph``, copied). The static
    arrays stay immutable host-side; updates ride as descriptors and
    mutate the device copy in the kernel, and the host mirror
    (``updates``) feeds the references."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 weights: Optional[np.ndarray] = None, *,
                 spare_blocks: Optional[int] = None,
                 upd_cap: int = 256) -> None:
        super().__init__(n, src, dst, weights)
        spare = (_env_spare_blocks() if spare_blocks is None
                 else int(spare_blocks))
        if spare < 0:
            # 0 is a legal degenerate build: every splice that needs a new
            # block drops, overflow-flagged.
            raise ValueError(f"spare_blocks must be >= 0, got {spare}")
        self.spare = spare
        self.spare_base = self.nblocks  # static rows end here
        self.static_nblocks = self.nblocks
        self.nblocks = self.spare_base + self.n * spare
        self.indices = np.concatenate(
            [self.indices, np.full((self.n * spare, EBLOCK), -1, np.int32)])
        self.weights = np.concatenate(
            [self.weights, np.zeros((self.n * spare, EBLOCK), np.int32)])
        self.upd_cap = int(upd_cap)
        if self.upd_cap < 1:
            raise ValueError(f"upd_cap must be >= 1, got {upd_cap}")
        self.updates: List[Tuple[int, int, int]] = []

    # -- value-slot layout (counters | vt | static counts | flags | state)

    @property
    def bcs_base(self) -> int:
        """Static block counts, one word per vertex: the boundary between
        static rows and spare ordinals."""
        return VT_BASE + 3 * self.n

    @property
    def flag_base(self) -> int:
        """Applied-update flags, one word per uid."""
        return self.bcs_base + self.n

    @property
    def st_base(self) -> int:
        return self.flag_base + self.upd_cap

    def preset_values(self, num_values: int, state0: int) -> np.ndarray:
        iv = super().preset_values(num_values, state0)
        iv[self.bcs_base:self.bcs_base + self.n] = self.blk_count
        return iv

    # -- the update stream

    def add_update(self, u: int, v: int, w: int = 1) -> int:
        """Register edge insert ``u -> v`` (weight ``w``); returns its uid."""
        u, v, w = int(u), int(v), int(w)
        if not (0 <= u < self.n and 0 <= v < self.n):
            raise ValueError(
                f"update endpoints ({u}, {v}) out of range [0, {self.n})")
        if w < 0:
            raise ValueError(f"update weight must be >= 0, got {w}")
        uid = len(self.updates)
        if uid >= self.upd_cap:
            raise ValueError(
                f"update stream exceeds upd_cap={self.upd_cap}: size the "
                "applied-flag region up (DynGraph(upd_cap=))")
        self.updates.append((u, v, w))
        return uid

    def _kept(self, ups) -> Tuple[List[Tuple[int, int, int]], int]:
        """The updates the device applies (a full tail with no spare
        ordinal left drops) and the spare blocks they take."""
        deg = self.deg.astype(np.int64).copy()
        bc = self.blk_count.astype(np.int64).copy()
        kept, used = [], 0
        for u, v, w in ups:
            if deg[u] == bc[u] * EBLOCK:  # tail full: needs a new block
                if bc[u] - int(self.blk_count[u]) >= self.spare:
                    continue  # dropped on the device, consumes nothing
                bc[u] += 1
                used += 1
            deg[u] += 1
            kept.append((u, v, w))
        return kept, used

    def spare_needed(self) -> int:
        """Spare blocks the registered stream consumes (the host mirror of
        the device's V_FREE; drops excluded)."""
        return self._kept(self.updates)[1]

    def mutated(self, count: Optional[int] = None) -> Graph:
        """The static edges plus the first ``count`` updates (all by
        default) that the device applies, as a static ``Graph``: the
        from-scratch reference arm."""
        ups = self.updates if count is None else self.updates[:count]
        kept, _ = self._kept(ups)
        src0 = np.repeat(np.arange(self.n), self.deg)
        dst0 = np.concatenate(self.adj) if self.m else np.zeros(0, np.int64)
        w0 = np.concatenate(self.adj_w) if self.m else np.zeros(0, np.int64)
        src = np.concatenate([src0, np.asarray([u for u, _, _ in kept])])
        dst = np.concatenate([dst0, np.asarray([v for _, v, _ in kept])])
        ww = np.concatenate([w0, np.asarray([w for _, _, w in kept])])
        return Graph(self.n, src.astype(np.int64), dst.astype(np.int64),
                     ww.astype(np.int64))


# --------------------------------------------- the plain UPDATE and QUERY


def _row(ctx: KernelContext, blk: int) -> int:
    """A block row clamped into the table (a DMA's row index is)."""
    return min(max(blk, 0), ctx.params["nblocks"] - 1)


def _splice(ctx: KernelContext, u: int, v: int, w: int, uid: int) -> None:
    """``SpliceKernel._splice`` (dyngraph.py:399): the idempotent tail
    append of edge u -> v, the ledger folds after the row write, then the
    relax of the new edge with u's current label (BFS / SSSP)."""
    p = ctx.params
    vt = VT_BASE + 3 * u
    bs, bc, deg = ctx.value(vt), ctx.value(vt + 1), ctx.value(vt + 2)
    bcs = ctx.value(p["bcs_base"] + u)
    applied = ctx.value(p["flag_base"] + uid)
    need_new = deg == _i32(bc * EBLOCK)  # tail full (or no blocks yet)
    used = _i32(bc - bcs)                # spare ordinals in use
    overflow = need_new and used >= p["spare"]
    if applied != 0:
        return
    if overflow:
        ctx.flag_overflow()
        ctx.set_value(V_DROPPED, ctx.value(V_DROPPED) + 1)
        return
    nb = _i32(p["spare_base"] + u * p["spare"] + used)
    idx, wgt = ctx.data["indices"], ctx.data.get("weights")
    if need_new:
        # The fresh spare row, written whole: the append cursor owns it.
        r = _row(ctx, nb)
        idx[r] = -1
        idx[r, 0] = v
        if wgt is not None:
            wgt[r] = 0
            wgt[r, 0] = w
    else:
        # Lane ``pos`` of the tail row: the static tail while it has
        # slack, else the newest spare ordinal.
        r = _row(ctx, _i32(bs + bc - 1) if bc <= bcs else _i32(nb - 1))
        pos = _i32(deg - max(bc - 1, 0) * EBLOCK)
        if 0 <= pos < EBLOCK:
            idx[r, pos] = v
            if wgt is not None:
                wgt[r, pos] = w
    ctx.set_value(vt + 1, bc + 1 if need_new else bc)
    ctx.set_value(vt + 2, deg + 1)
    ctx.set_value(p["flag_base"] + uid, 1)
    ctx.set_value(V_FREE, ctx.value(V_FREE) + int(need_new))
    ctx.set_value(V_UPDATES, ctx.value(V_UPDATES) + 1)
    family = BODIES[ctx.core.body_ids[FR_EXPAND]]
    if family != "fr_pagerank":
        _RELAX[family](ctx, v, w, ctx.value(p["st_base"] + u))


def _query(ctx: KernelContext) -> None:
    """``QueryKernel._query`` (dyngraph.py:533): count the query, publish
    the vertex's current label to the out slot."""
    v = ctx.arg(0)
    ctx.set_value(V_QUERIES, ctx.value(V_QUERIES) + 1)
    ctx.set_out(ctx.value(ctx.params["st_base"] + v))


def _update_body(ctx: KernelContext) -> None:
    _splice(ctx, *(ctx.arg(i) for i in range(4)))


def _update_batch_body(ctx: BatchContext) -> None:
    # Slot by slot: slot b sees the folds of slots < b, so same-vertex
    # updates of one round serialize in slot order.
    for s in range(ctx.count):
        _update_body(ctx.slot_ctx(s))


def _query_batch_body(ctx: BatchContext) -> None:
    for s in range(ctx.count):
        _query(ctx.slot_ctx(s))


def plain_dyngraph_bodies() -> Dict[str, object]:
    """The plain UPDATE and QUERY bodies by body name."""
    return {"dg_update": _update_body, "dg_update_batch": _update_batch_body,
            "dg_query": _query, "dg_query_batch": _query_batch_body}


# ------------------------------------------------------------ the kernels


def _dyn_spawn(graph: DynGraph):
    """The spare-aware block spawner of ``graph``: static rows ``[bs, bs +
    min(bc, bcs))`` then spare ordinals ``[0, bc - min(bc, bcs))``. Its
    ``layout`` words select that form of ``fr_spawn_blocks`` on the card
    and of the plain ``frontier._spawn_blocks``."""
    def spawn(ctx: KernelContext, u: int, carry: int) -> None:
        _spawn_blocks(ctx, u, carry)

    spawn.layout = {"dyn": 1, "spare_base": graph.spare_base,
                    "spare": graph.spare, "bcs_base": graph.bcs_base}
    return spawn


class DynFrontierKernel(FrontierKernel):
    """A frontier kernel bound to a mutable adjacency: its spawner's
    layout words make the EXPAND bodies clamp their live-edge count to the
    vertex table (``frontier._eff_cnt``) and spawn through the spare-aware
    form of ``frontier._spawn_blocks``."""

    def __init__(self, name: str, weighted: bool, state0: int,
                 graph: DynGraph, reps: Optional[int] = None) -> None:
        super().__init__(name, weighted, state0, reps=reps,
                         spawn=_dyn_spawn(graph))
        self.graph = graph


def _dyn_frontier_kernel(kind: str, graph: DynGraph,
                         reps: int = 64) -> DynFrontierKernel:
    """The traversal family over a mutable adjacency: the static tier's
    relax with the spare-aware spawner."""
    spawn = _dyn_spawn(graph)
    if kind == "bfs":
        base = bfs_kernel(spawn=spawn)
    elif kind == "sssp":
        base = sssp_kernel(spawn=spawn)
    elif kind == "pagerank":
        base = pagerank_kernel(reps=reps, spawn=spawn)
    else:
        raise ValueError(
            f"unknown dyngraph kind {kind!r} (bfs|sssp|pagerank)")
    return DynFrontierKernel(base.name, base.weighted, base.state0, graph,
                             reps=base.reps)


class SpliceKernel:
    """The UPDATE kind: ``dg_update`` / ``dg_update_batch``, compiled in
    csrc/frontier.cuh (``dg_splice``); the plain spellings below are what
    the CPU path runs. No lane of a dyngraph build prefetches: a
    prefetched slab could race the write-back of the same row."""

    body, batch = "dg_update", "dg_update_batch"

    def __init__(self, fk: DynFrontierKernel) -> None:
        self.fk = fk
        self.graph = fk.graph

    scalar_kernel = staticmethod(_update_body)
    batch_body = staticmethod(_update_batch_body)


class QueryKernel:
    """The QUERY kind: ``dg_query`` / ``dg_query_batch``. Mid-run queries
    read the tentative label; a query that retires after the traversal
    drained reads the fixpoint."""

    body, batch = "dg_query", "dg_query_batch"

    def __init__(self, fk: DynFrontierKernel) -> None:
        self.fk = fk

    scalar_kernel = staticmethod(_query)
    batch_body = staticmethod(_query_batch_body)


# ------------------------------------------------------------ megakernel


def make_dyngraph_megakernel(
    kind: str,
    graph: DynGraph,
    *,
    width: int = 8,
    capacity: int = 512,
    num_values: Optional[int] = None,
    trace=None,
    checkpoint: Optional[bool] = None,
    lane_max_age: Optional[int] = None,
    priority_buckets: Optional[int] = None,
    delta: Optional[int] = None,
    update_priority: Optional[int] = None,
    reps: int = 64,
    device="cuda",
) -> Megakernel:
    """Build the dynamic-graph megakernel: the traversal's EXPAND plus
    the UPDATE and QUERY kinds. ``width=0`` is the all-scalar arm;
    ``width>0`` routes every kind through its own batch lane, with the
    prefetch off. ``priority_buckets=B`` pins UPDATEs to bucket
    ``update_priority`` (default 0, HCLIB_TPU_DYNGRAPH_UPDATE_PRIORITY;
    clipped into [0, B)), QUERYs to the lowest class, and EXPANDs keep the
    traversal's own bucket rule."""
    if kind not in ("bfs", "sssp", "pagerank"):
        raise ValueError(
            f"unknown dyngraph kind {kind!r} (bfs|sssp|pagerank)")
    if not isinstance(graph, DynGraph):
        raise TypeError(
            "make_dyngraph_megakernel needs a DynGraph (the static Graph "
            "has no spare rows to splice into)")
    fk = _dyn_frontier_kernel(kind, graph, reps=reps)
    if num_values is None:
        num_values = graph.num_value_slots + 16
    if priority_buckets is None:
        priority_buckets = env_int("HCLIB_TPU_PRIORITY_BUCKETS", None)
    priority_buckets = int(priority_buckets or 0)
    if priority_buckets and not width:
        raise ValueError(
            "priority_buckets needs the batched arm (width > 0): the "
            "bucket rings layer over the per-kind batch lanes")
    if update_priority is None:
        update_priority = _env_update_priority()
    update_priority = int(update_priority)
    if priority_buckets:
        update_priority = max(0, min(update_priority, priority_buckets - 1))
    query_priority = max(0, priority_buckets - 1)
    if delta is None:
        delta = default_delta(graph)
    kernels = [fk.name, SpliceKernel.body, QueryKernel.body]
    if width:
        route = {
            fk.name: BatchSpec(width=width, prefetch=False,
                               priority=_bucket_rule(fk.name, delta,
                                                     fk.reps or 64)),
            SpliceKernel.body: BatchSpec(width=width, prefetch=False,
                                         priority=("const", 0,
                                                   update_priority)),
            QueryKernel.body: BatchSpec(width=width, prefetch=False,
                                        priority=("const", 0,
                                                  query_priority)),
        }
        if lane_max_age is None:
            if env_set("HCLIB_TPU_LANE_MAX_AGE"):
                lane_max_age = None  # the variable wins: Megakernel reads it
            elif priority_buckets:
                lane_max_age = 2 * capacity  # the starvation backstop
            else:
                lane_max_age = 4 * width
    else:
        route = None
        lane_max_age = 0 if lane_max_age is None else lane_max_age
    fk.st_base = graph.st_base
    mk = Megakernel(
        kernels=kernels,
        route=route,
        data_specs=fk.data_specs(graph),
        capacity=capacity,
        num_values=num_values,
        succ_capacity=8,
        params={"st_base": graph.st_base, "nblocks": graph.nblocks,
                "reps": fk.reps or 0, "flag_base": graph.flag_base,
                **fk.layout},
        trace=trace,
        checkpoint=checkpoint,
        lane_max_age=lane_max_age,
        priority_buckets=priority_buckets,
        device=device,
    )
    mk._frontier_layout = (fk.name, graph.n, graph.nblocks, graph.st_base)
    # The dyngraph layout stamp (plain ints, as JAX's).
    mk._dyngraph = {
        "kind": kind, "n": graph.n, "spare": graph.spare,
        "spare_base": graph.spare_base, "total_blocks": graph.nblocks,
        "bcs_base": graph.bcs_base, "flag_base": graph.flag_base,
        "upd_cap": graph.upd_cap, "st_base": graph.st_base,
        "weighted": bool(fk.weighted), "update_kind": DG_UPDATE,
        "query_kind": DG_QUERY, "update_priority": update_priority,
        "buckets": priority_buckets, "reps": int(fk.reps or 0),
    }
    mk.si_claim = ("dyngraph", kind, fk.reps, priority_buckets, None)
    return mk


def _bind_updates(mk: Megakernel, graph: DynGraph) -> None:
    """Stamp the registered update stream into the claim and the layout
    stamp."""
    tag, kind, reps, buckets, _ = mk.si_claim
    mk.si_claim = (tag, kind, reps, buckets, tuple(graph.updates))
    mk._dyngraph["updates"] = [[int(u), int(v), int(w)]
                               for u, v, w in graph.updates]


# ------------------------------------------------------------ host twins


def host_dyngraph(kind: str, graph: DynGraph, src: int = 0, *,
                  m0: int = 1 << 14, reps: int = 64) -> np.ndarray:
    """The from-scratch host reference on the mutated graph."""
    g = graph.mutated()
    if kind == "bfs":
        return host_bfs(g, src)
    if kind == "sssp":
        return host_sssp(g, src)
    if kind == "pagerank":
        return host_pagerank_push(g, m0=m0, reps=reps)[0]
    raise ValueError(f"unknown dyngraph kind {kind!r}")


def host_incremental(kind: str, graph: DynGraph, src: int = 0, *,
                     order: Optional[Sequence[int]] = None) -> np.ndarray:
    """The incremental host twin (bfs/sssp): the seed expansion and the
    update stream as one op pool processed in ``order`` (a permutation of
    the initial ops; spawned re-expansions append), each update splicing
    then relaxing with u's current label, as the device does."""
    if kind not in ("bfs", "sssp"):
        raise ValueError(
            "host_incremental models the label-correcting kinds "
            f"(bfs|sssp), got {kind!r}")
    n = graph.n
    adj = [[(int(t), int(w)) for t, w in zip(graph.adj[v], graph.adj_w[v])]
           for v in range(n)]
    deg = graph.deg.astype(np.int64).copy()
    bc = graph.blk_count.astype(np.int64).copy()
    dist = np.full(n, INF, np.int64)
    dist[int(src)] = 0
    ops: List[Tuple] = [("expand", int(src))]
    ops += [("update", u, v, w) for (u, v, w) in graph.updates]
    if order is None:
        order = range(len(ops))
    pending = [ops[i] for i in order]
    if len(pending) != len(ops):
        raise ValueError("order must be a permutation of the op pool")

    def relax(u, v, w):
        nd = dist[u] + (1 if kind == "bfs" else w)
        if dist[u] < INF and nd < dist[v]:
            dist[v] = nd
            pending.append(("expand", v))

    while pending:
        op = pending.pop(0)
        if op[0] == "expand":
            v = op[1]
            for t, w in list(adj[v]):
                relax(v, t, w)
        else:
            _, u, v, w = op
            if deg[u] == bc[u] * EBLOCK:  # tail full
                if bc[u] - int(graph.blk_count[u]) >= graph.spare:
                    continue  # dropped, as the device drops it
                bc[u] += 1
            deg[u] += 1
            adj[u].append((v, w))
            relax(u, v, w)
    return dist.astype(np.int32)


def host_incremental_pagerank(graph: DynGraph, *, m0: int = 1 << 14,
                              reps: int = 64,
                              order: Optional[Sequence[int]] = None
                              ) -> Tuple[np.ndarray, int]:
    """The incremental PageRank twin: deliveries and splices interleave
    in ``order``; splices are mass-neutral, so ``rank.sum() == n * m0``
    for every order. Returns (rank, deliveries)."""
    n = graph.n
    adj = [[int(t) for t in graph.adj[v]] for v in range(n)]
    deg = graph.deg.astype(np.int64).copy()
    bc = graph.blk_count.astype(np.int64).copy()
    rank = np.zeros(n, np.int64)
    ops: List[Tuple] = []
    for v in range(n):
        d = int(deg[v])
        qc = _pr_split(m0, d)
        if m0 >= reps and qc > 0 and d > 0:
            rank[v] = m0 - d * qc
            for u in adj[v]:
                ops.append(("deliver", int(u), qc))
        else:
            rank[v] = m0
    ops += [("update", u, v, w) for (u, v, w) in graph.updates]
    if order is None:
        order = range(len(ops))
    pending = [ops[i] for i in order]
    if len(pending) != len(ops):
        raise ValueError("order must be a permutation of the op pool")
    deliveries = 0
    while pending:
        op = pending.pop(0)
        if op[0] == "update":
            _, u, v, w = op
            if deg[u] == bc[u] * EBLOCK:
                if bc[u] - int(graph.blk_count[u]) >= graph.spare:
                    continue
                bc[u] += 1
            deg[u] += 1
            adj[u].append(int(v))
            continue
        _, u, q = op
        deliveries += 1
        d = int(deg[u])
        qc = _pr_split(q, d)
        if q >= reps and qc > 0 and d > 0:
            rank[u] += q - d * qc
            for t in list(adj[u]):
                pending.append(("deliver", int(t), qc))
        else:
            rank[u] += q
    return rank, deliveries


# ---------------------------------------------------------------- runner


def _seed_builders(graph: DynGraph, kind: str, src: int, m0: int, reps: int,
                   queries: Sequence[int],
                   num_values: int) -> TaskGraphBuilder:
    """The one device's builder: the traversal seeds, the update stream
    (uid order), then the queries with out slots above the state
    region."""
    b = TaskGraphBuilder()
    b.reserve_values(graph.num_value_slots)
    for args in seed_frontier(None, graph, kind, src=src, m0=m0, reps=reps):
        b.add(FR_EXPAND, args=list(args))
    for uid, (u, v, w) in enumerate(graph.updates):
        b.add(DG_UPDATE, args=[u, v, w, uid])
    qbase = graph.st_base + graph.n
    for qi, v in enumerate(queries):
        slot = qbase + qi
        if slot >= num_values:
            raise ValueError(
                f"query {qi} wants out slot {slot} >= num_values "
                f"{num_values}: raise num_values")
        b.add(DG_QUERY, args=[int(v)], out=slot)
    return b


def fk_data(graph: DynGraph, mk: Megakernel) -> Dict[str, np.ndarray]:
    """The device data buffers (static rows + pristine spare rows)."""
    d = {"indices": graph.indices}
    if mk._dyngraph["weighted"]:
        d["weights"] = graph.weights
    return d


def dyngraph_state(kind: str, graph: DynGraph, mk: Megakernel,
                   src: int = 0, queries: Sequence[int] = (),
                   m0: int = 1 << 14, reps: int = 64):
    """What ``run_dyngraph`` hands ``mk.run``: the seeded builder, the
    preset value row (vertex table, static block counts, the state with
    the source at 0 or the ranks the host seeding retained) and the edge
    data (numpy; ``mk.state`` copies it, so each staging starts from the
    pristine spare rows)."""
    st = graph.st_base
    iv = graph.preset_values(mk.num_values,
                             INF if kind in ("bfs", "sssp") else 0)
    if kind in ("bfs", "sssp"):
        iv[st + int(src)] = 0
    else:
        iv[st:st + graph.n] = _pr_seed_rank(graph, m0, reps).astype(np.int32)
    b = _seed_builders(graph, kind, src, m0, reps, queries, mk.num_values)
    return b, iv, fk_data(graph, mk)


def run_dyngraph(
    kind: str,
    graph: DynGraph,
    src: int = 0,
    *,
    updates: Optional[Sequence[Tuple[int, ...]]] = None,
    queries: Sequence[int] = (),
    width: int = 8,
    m0: int = 1 << 14,
    reps: int = 64,
    capacity: int = 512,
    trace=None,
    checkpoint: Optional[bool] = None,
    fuel: Optional[int] = None,
    lane_max_age: Optional[int] = None,
    priority_buckets: Optional[int] = None,
    delta: Optional[int] = None,
    update_priority: Optional[int] = None,
    mk: Optional[Megakernel] = None,
    placement=None,
    mesh=None,
    quantum=None,
    window=None,
    hop_order=None,
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """One traversal and update storm to the fixpoint on one device.
    ``updates`` (``(u, v[, w])`` tuples) register on the graph and ride as
    UPDATE descriptors. Returns ``(result, info)``: the fixpoint on the
    mutated graph (equal to ``host_dyngraph`` for bfs/sssp; the mass of
    ``host_incremental_pagerank`` for pagerank), with ``info`` carrying
    ``edges`` / ``relaxations`` / ``updates_applied`` / ``spare_in_use`` /
    ``dropped`` / ``queries`` and the per-query out values
    (``query_values``); ``trace`` / ``checkpoint`` build the Megakernel
    with the flight recorder / the quiesce poll."""
    multi = {"placement": placement, "mesh": mesh, "quantum": quantum,
             "window": window, "hop_order": hop_order}
    given = sorted(k for k, v in multi.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"run_dyngraph({', '.join(given)}=...): the mesh path (update "
            "broadcast, the steal exchange) is ROADMAP A11; the port runs "
            "one device")
    for up in updates or ():
        graph.add_update(*up[:3])
    if mk is None:
        mk = make_dyngraph_megakernel(
            kind, graph, width=width, capacity=capacity, trace=trace,
            checkpoint=checkpoint, lane_max_age=lane_max_age,
            priority_buckets=priority_buckets, delta=delta,
            update_priority=update_priority, reps=reps, device=device)
    else:
        dg = getattr(mk, "_dyngraph", None)
        if dg is None or dg["n"] != graph.n or dg["kind"] != kind or (
                dg["st_base"] != graph.st_base):
            raise ValueError(
                "prebuilt megakernel is not bound to this dyngraph layout "
                f"(stamp {dg}): build one per (kind, graph) via "
                "make_dyngraph_megakernel")
    _bind_updates(mk, graph)
    b, iv, data = dyngraph_state(kind, graph, mk, src, queries, m0, reps)
    iv_o, _, info = mk.run(b, data=data, ivalues=iv,
                           fuel=1 << 22 if fuel is None else fuel)
    rows = np.asarray(iv_o, np.int64)
    st = graph.st_base
    states = rows[st:st + graph.n]
    result = states.astype(np.int32) if kind in ("bfs", "sssp") else states
    flags = rows[graph.flag_base:graph.flag_base + graph.upd_cap]
    info["edges"] = int(rows[V_EDGES])
    info["relaxations"] = int(rows[V_RELAX])
    info["updates_applied"] = int((flags != 0).sum())
    info["spare_in_use"] = int(rows[V_FREE])
    info["dropped"] = int(rows[V_DROPPED])
    info["queries"] = int(rows[V_QUERIES])
    qbase = st + graph.n
    info["query_values"] = [int(rows[qbase + qi])
                            for qi in range(len(queries))]
    return result, info


def serve_dyngraph(
    kind: str,
    graph: DynGraph,
    src: int = 0,
    *,
    updates: Sequence[Tuple[int, ...]] = (),
    queries: Sequence[int] = (),
    update_tenant: str = "updates",
    query_tenant: str = "queries",
    width: int = 0,
    m0: int = 1 << 14,
    reps: int = 64,
    capacity: int = 512,
    num_values: Optional[int] = None,
    trace=None,
    checkpoint: Optional[bool] = None,
    lane_max_age: Optional[int] = None,
    priority_buckets: Optional[int] = None,
    delta: Optional[int] = None,
    update_priority: Optional[int] = None,
    ring_capacity: int = 64,
    egress_depth: int = 64,
    quantum: int = 1 << 10,
    max_rounds: int = 256,
    result_timeout_s: float = 30.0,
    device="cuda",
    entry_log: Optional[list] = None,
) -> Tuple[np.ndarray, Dict]:
    """Serve one resident adjacency to two tenants through the streaming
    front door (device/inject.py): an ``updates`` lane and a ``queries``
    lane submit UPDATE / QUERY descriptors against the SAME running
    traversal, each submission's ``Admission.future`` resolving to its
    row's out-slot value (a query's label: tentative while the traversal
    races, exact once it drained). The scalar arm only (``width`` != 0
    raises, as in JAX: the stream embeds no batch lanes). Returns
    ``(result, info)`` shaped like ``run_dyngraph`` plus
    ``info['query_results']`` (future-resolved values),
    ``info['serve_stats']`` (lane and egress ledgers) and
    ``info['splice_trace']`` (one host TR_SPLICE record); the port adds
    ``info['entries']`` (the stream's entry count) and
    ``info['allocated']`` (the most table rows held). ``num_values``
    (default ``make_dyngraph_megakernel``'s: 16 slots past the state)
    bounds the queries, whose out slots follow the state. ``entry_log``
    (a list) records each entry's echoed control block and puts the
    final state in ``info['final_state']``
    (``StreamingMegakernel.entry_log``), so two runs compare word for
    word."""
    from .egress import EgressSpec
    from .inject import StreamingMegakernel
    from .tenants import TenantSpec, TenantTable
    from .tracebuf import TR_SPLICE, host_trace_info

    if width:
        raise ValueError(
            "serve_dyngraph runs the scalar arm (width=0): the stream "
            "front door's core embedding carries no batch-lane scratch; "
            "bucketed/batched service rides the mesh path (ROADMAP A11)")
    for up in updates or ():
        graph.add_update(*up)
    mk = make_dyngraph_megakernel(
        kind, graph, width=width, capacity=capacity, num_values=num_values,
        trace=trace, checkpoint=checkpoint, lane_max_age=lane_max_age,
        priority_buckets=priority_buckets, delta=delta,
        update_priority=update_priority, reps=reps, device=device)
    _bind_updates(mk, graph)
    region = -(-int(ring_capacity) // 16) * 8  # two lanes over the ring
    # Each lane's host backlog holds its whole stream: every submission
    # lands before the run (TenantSpec's default 1,024 rows a lane
    # would reject a longer stream; shorter ones see JAX's lanes).
    table = TenantTable(
        [TenantSpec(update_tenant,
                    queue_capacity=max(1024, len(graph.updates))),
         TenantSpec(query_tenant, queue_capacity=max(1024, len(queries)))],
        max(8, region), egress=EgressSpec(depth=egress_depth))
    sm = StreamingMegakernel(mk, ring_capacity=ring_capacity, tenants=table)
    sm.entry_log = entry_log
    st = graph.st_base
    iv = graph.preset_values(mk.num_values,
                             INF if kind in ("bfs", "sssp") else 0)
    if kind in ("bfs", "sssp"):
        iv[st + int(src)] = 0
    else:
        iv[st:st + graph.n] = _pr_seed_rank(graph, m0, reps).astype(np.int32)
    seed = TaskGraphBuilder()
    seed.reserve_values(graph.num_value_slots)
    for args in seed_frontier(None, graph, kind, src=src, m0=m0, reps=reps):
        seed.add(FR_EXPAND, args=list(args))
    upd_futs = []
    for uid, (u, v, w) in enumerate(graph.updates):
        adm = sm.submit(update_tenant, DG_UPDATE, args=[u, v, w, uid])
        if not adm.accepted:
            raise RuntimeError(
                f"update lane rejected uid {uid}: {adm.reason!r}")
        upd_futs.append(adm.future)
    qbase = st + graph.n
    q_futs = []
    for qi, v in enumerate(queries):
        slot = qbase + qi
        if slot >= mk.num_values:
            raise ValueError(
                f"query {qi} wants out slot {slot} >= num_values "
                f"{mk.num_values}: raise num_values")
        adm = sm.submit(query_tenant, DG_QUERY, args=[int(v)], out=slot)
        if not adm.accepted:
            raise RuntimeError(
                f"query lane rejected query {qi}: {adm.reason!r}")
        q_futs.append(adm.future)
    sm.close()
    t0 = time.monotonic_ns()
    iv_o, info = sm.run_stream(seed, ivalues=iv, data=dict(fk_data(graph, mk)),
                               quantum=quantum, max_rounds=max_rounds)
    t1 = time.monotonic_ns()
    rows = np.asarray(iv_o, np.int64)
    states = rows[st:st + graph.n]
    result = states.astype(np.int32) if kind in ("bfs", "sssp") else states
    flags = rows[graph.flag_base:graph.flag_base + graph.upd_cap]
    info["edges"] = int(rows[V_EDGES])
    info["relaxations"] = int(rows[V_RELAX])
    info["updates_applied"] = int((flags != 0).sum())
    info["spare_in_use"] = int(rows[V_FREE])
    info["dropped"] = int(rows[V_DROPPED])
    info["queries"] = int(rows[V_QUERIES])
    info["query_values"] = [int(rows[qbase + qi])
                            for qi in range(len(queries))]
    info["update_futures"] = upd_futs
    info["query_futures"] = q_futs
    info["query_results"] = [int(f.result(timeout=result_timeout_s))
                             for f in q_futs]
    for f in upd_futs:
        f.result(timeout=result_timeout_s)
    info["serve_stats"] = sm.stats_dict()
    info["entries"] = sm.timing["entries"]
    applied, dropped = info["updates_applied"], info["dropped"]
    info["splice_trace"] = host_trace_info(
        [[TR_SPLICE, 0, (applied << 16) | dropped, info["spare_in_use"]]],
        t0, max(t1, t0 + 1))
    if entry_log is not None:
        info["final_state"] = sm.final_state
    return result, info


def reshard_dyngraph(bundle, ndev_new: int):
    """Re-home a quiesced dyngraph bundle onto another device count: it
    needs the mesh runners and checkpoint bundles (ROADMAP A11)."""
    raise NotImplementedError(
        "reshard_dyngraph re-homes a mesh checkpoint bundle; the mesh "
        "runners and reshard are ROADMAP A11")
