"""Graph-analytics frontier tier on the card: BFS / SSSP / PageRank over a
blocked-CSR adjacency, run by the scheduler megakernel (port of
``hclib_tpu/device/frontier.py``, single device).

An adjacency in device memory is traversed by ``EXPAND(v, blk, carry,
cnt)`` descriptors, one per 128-edge block of a vertex: expand block
``blk`` (``cnt`` live edges) of vertex ``v``, propagating ``carry`` (the
tentative distance of ``v`` for BFS/SSSP, the residual mass delivered to
``v`` for PageRank). Every EXPAND of one traversal is the same kind, so
a frontier groups onto ONE batch lane and fires ``width`` blocks a round
with the cross-round edge-slab prefetch; ``width=0`` is the scalar
dispatch arm. BFS and SSSP are label-correcting (an improving relax
re-spawns the target's blocks), PageRank pushes integer fixed-point mass
(``q - deg * q_child`` retained, ``q_child = (13/16 * q) // deg``
forwarded along every out-edge until ``q < reps``). The distances and
ranks are the fixpoint whatever the pop order, which is what lets the
batched, aged and bucketed arms all equal the host references.

What differs from the JAX module:

- The EXPAND bodies are compiled (``csrc/frontier.cuh``): a
  ``FrontierKernel`` names a family (``fr_bfs``, ``fr_sssp``,
  ``fr_pagerank``) and carries that family's plain relax for the CPU
  path. The bodies read the graph layout from the megakernel's
  parameters (``st_base``, ``nblocks``, ``reps``).
- ``priority_buckets`` rides a named rule (``("div", 2, delta)`` for
  BFS/SSSP, ``("band", 2, reps)`` for PageRank), the spelling of JAX's
  ``_bucket_fn`` that the card's scheduler reads.
- ``spawn=`` takes the default block spawner or dyngraph's spare-aware
  one (``dyngraph._dyn_spawn``), each compiled into ``fr_spawn_blocks``:
  a spawner carries the layout parameters (``layout``) that select the
  dynamic-graph form of the EXPAND bodies (``dyn``: the live-edge clamp
  ``_eff_cnt`` and the static-then-spare spawn order); any other callable
  raises naming A4. ``placement=`` / ``mesh=`` / ``runner=`` /
  ``quantum=`` / ``window=`` / ``hop_order=`` (the multi-device runners)
  raise naming A11. ``trace=`` / ``checkpoint=`` go to the Megakernel (a
  traced run's ``info['tiers']`` carries the partial-age and, bucketed,
  the bucket-occupancy gauges).
- ``si_claim`` is kept as the attribute only: the certification
  (hclint) waits for ROADMAP A13.
"""

from __future__ import annotations

import ctypes
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..runtime.env import env_int, env_set
from .descriptor import TaskGraphBuilder
from .megakernel import (BK_MAX, EBLOCK, MAX_DATA, BatchContext,
                         BatchSpec, KernelContext, Megakernel, _i32,
                         _PlainCore)

__all__ = [
    "EBLOCK", "INF", "FR_EXPAND", "Graph", "FrontierKernel", "bfs_kernel",
    "sssp_kernel", "pagerank_kernel", "make_frontier_megakernel",
    "run_frontier", "seed_frontier", "host_bfs", "host_sssp",
    "host_pagerank_push", "host_pagerank", "priority_bucket",
    "default_delta", "PR_NUM", "PR_DEN", "expand_rounds", "frontier_state",
]

# Unreached distance sentinel (INF + any edge weight stays positive).
INF = 0x3FFFFFFF

# The EXPAND kernel's table index (frontier tables are single-kind).
FR_EXPAND = 0

# PageRank damping as an exact int32 rational: alpha = 13/16.
PR_NUM = 13
PR_DEN = 16

# Value-slot layout: two counters, then the vertex table (3 words per
# vertex: block start / block count / out-degree), then per-vertex state.
V_EDGES = 0   # traversed edges (the TEPS numerator)
V_RELAX = 1   # improving relaxations / PR deliveries
VT_BASE = 8

# PageRank residual-magnitude bands grow by this factor per bucket.
PR_BAND = 2


class Graph:
    """Host-side blocked-CSR adjacency: dense int32 arrays shaped for the
    device tier plus python adjacency for the host reference arms (the
    JAX package's ``Graph``, copied)."""

    def __init__(
        self,
        n: int,
        src: np.ndarray,
        dst: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> None:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape:
            raise ValueError("src/dst must be the same length")
        if len(src) and (
            src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n
        ):
            raise ValueError(f"edge endpoints out of range [0, {n})")
        self.n = int(n)
        self.m = int(len(src))
        w = (
            np.asarray(weights, np.int64)
            if weights is not None
            else np.ones(self.m, np.int64)
        )
        if w.shape != src.shape:
            raise ValueError("weights must match the edge count")
        if len(w) and w.min() < 0:
            raise ValueError("weights must be >= 0")
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        self.deg = np.bincount(src, minlength=n).astype(np.int32)
        self.blk_count = ((self.deg + EBLOCK - 1) // EBLOCK).astype(np.int32)
        self.blk_start = np.zeros(n, np.int32)
        if n > 1:
            self.blk_start[1:] = np.cumsum(self.blk_count)[:-1].astype(
                np.int32
            )
        self.nblocks = max(1, int(self.blk_count.sum()))
        self.indices = np.full((self.nblocks, EBLOCK), -1, np.int32)
        self.weights = np.zeros((self.nblocks, EBLOCK), np.int32)
        splits = np.searchsorted(src, np.arange(n + 1))
        self.adj: List[np.ndarray] = []
        self.adj_w: List[np.ndarray] = []
        for v in range(n):
            lo, hi = int(splits[v]), int(splits[v + 1])
            self.adj.append(dst[lo:hi].astype(np.int32))
            self.adj_w.append(w[lo:hi].astype(np.int32))
            d = hi - lo
            b0 = int(self.blk_start[v])
            flat = self.indices[b0:b0 + int(self.blk_count[v])].reshape(-1)
            flat[:d] = dst[lo:hi]
            wflat = self.weights[b0:b0 + int(self.blk_count[v])].reshape(-1)
            wflat[:d] = w[lo:hi]

    def block_cnt(self, v: int, i: int) -> int:
        """Live edges in block ``i`` of vertex ``v`` (the descriptor's
        ``cnt`` arg): full blocks then the ragged tail."""
        return int(min(EBLOCK, int(self.deg[v]) - i * EBLOCK))

    @property
    def st_base(self) -> int:
        return VT_BASE + 3 * self.n

    @property
    def num_value_slots(self) -> int:
        """Host-preset slots: counters + vertex table + per-vertex state."""
        return self.st_base + self.n

    def preset_values(self, num_values: int, state0: int) -> np.ndarray:
        """The host ivalues row: vertex table filled, per-vertex state
        initialized to ``state0`` (INF for distances, 0 for ranks)."""
        if num_values < self.num_value_slots:
            raise ValueError(
                f"graph wants num_values >= {self.num_value_slots}, "
                f"got {num_values}"
            )
        iv = np.zeros(num_values, np.int32)
        vt = np.stack(
            [self.blk_start, self.blk_count, self.deg], axis=1
        ).reshape(-1)
        iv[VT_BASE:VT_BASE + 3 * self.n] = vt
        iv[self.st_base:self.st_base + self.n] = state0
        return iv


# ------------------------------------------------ the plain EXPAND bodies


def _spawn_blocks(ctx: KernelContext, u: int, carry: int) -> None:
    """Spawn one EXPAND per adjacency block of vertex ``u`` (JAX's
    ``_spawn_blocks``; ``fr_spawn_blocks`` in csrc/frontier.cuh). Under the
    dynamic-graph layout (parameter ``dyn``) it is JAX's ``_dyn_spawn``
    (dyngraph.py:306): the static rows ``[bs, bs + min(bc, bcs))``, then
    the vertex's spare ordinals ``[0, bc - min(bc, bcs))``, each block's
    live count from ``deg`` as the static spawner derives it."""
    vt = VT_BASE + 3 * u
    bs, bc, deg = ctx.value(vt), ctx.value(vt + 1), ctx.value(vt + 2)
    p = ctx.params
    bcs = ctx.value(p["bcs_base"] + u) if p["dyn"] else bc
    ns = min(bc, bcs)
    for i in range(ns):
        cnt = min(max(deg - i * EBLOCK, 0), EBLOCK)
        ctx.spawn(FR_EXPAND, [u, bs + i, carry, cnt], nargs=4)
    for j in range(bc - ns):
        cnt = min(max(_i32(deg - (bcs + j) * EBLOCK), 0), EBLOCK)
        ctx.spawn(FR_EXPAND, [u, _i32(p["spare_base"] + u * p["spare"] + j),
                              carry, cnt], nargs=4)


def _eff_cnt(ctx: KernelContext, v: int, blk: int, cnt: int) -> int:
    """The live-edge count an EXPAND relaxes: the descriptor's ``cnt``,
    clamped under the dynamic-graph layout to the edges the vertex table
    shows live in block ``blk`` (JAX's ``DynFrontierKernel._eff_cnt``,
    dyngraph.py:291; a spare row's ordinal continues after the static
    block count)."""
    p = ctx.params
    if not p["dyn"]:
        return cnt
    vt = VT_BASE + 3 * v
    bs, deg = ctx.value(vt), ctx.value(vt + 2)
    if blk >= p["spare_base"]:
        ordinal = _i32(ctx.value(p["bcs_base"] + v)
                       + _i32(blk - p["spare_base"] - v * p["spare"]))
    else:
        ordinal = _i32(blk - bs)
    live = min(max(_i32(deg - ordinal * EBLOCK), 0), EBLOCK)
    return min(cnt, live)


def _pr_split(q, deg):
    """Child mass of a PageRank delivery ``q`` at a vertex of out-degree
    ``deg`` (int fixed point; host seeding and the exact host twin)."""
    return (int(q) * PR_NUM // PR_DEN) // max(int(deg), 1)


def _relax_bfs(ctx, u, w, carry) -> None:
    nd = _i32(carry + 1)
    st = ctx.params["st_base"] + u
    if nd < ctx.value(st):
        ctx.set_value(st, nd)
        ctx.set_value(V_RELAX, ctx.value(V_RELAX) + 1)
        _spawn_blocks(ctx, u, nd)


def _relax_sssp(ctx, u, w, carry) -> None:
    nd = _i32(carry + w)
    st = ctx.params["st_base"] + u
    if nd < ctx.value(st):
        ctx.set_value(st, nd)
        ctx.set_value(V_RELAX, ctx.value(V_RELAX) + 1)
        _spawn_blocks(ctx, u, nd)


def _relax_pagerank(ctx, u, w, q) -> None:
    deg = ctx.value(VT_BASE + 3 * u + 2)
    qc = _i32(q * PR_NUM) // PR_DEN // max(deg, 1)  # int32, as traced
    expand = q >= ctx.params["reps"] and qc > 0 and deg > 0
    retained = _i32(q - _i32(deg * qc)) if expand else q
    st = ctx.params["st_base"] + u
    ctx.set_value(st, ctx.value(st) + retained)
    ctx.set_value(V_RELAX, ctx.value(V_RELAX) + 1)
    if expand:
        _spawn_blocks(ctx, u, qc)


_RELAX = {"fr_bfs": _relax_bfs, "fr_sssp": _relax_sssp,
          "fr_pagerank": _relax_pagerank}


def _expand(family: str, ctx: KernelContext) -> None:
    """One EXPAND (JAX's ``_relax_block`` over the loaded slab): count
    ``cnt`` (clamped by ``_eff_cnt``) into V_EDGES, then relax the live
    edges in edge order. The block index is clamped into the table as a
    DMA's slice start is; the loop reads at most one block row."""
    v, blk, carry, cnt = (ctx.arg(i) for i in range(4))
    cnt = _eff_cnt(ctx, v, blk, cnt)
    blk = min(max(blk, 0), ctx.params["nblocks"] - 1)
    ctx.set_value(V_EDGES, ctx.value(V_EDGES) + cnt)
    n = min(max(cnt, 0), EBLOCK)
    idx = ctx.data["indices"][blk, :n].tolist()
    wgt = ctx.data["weights"][blk, :n].tolist() if family == "fr_sssp" \
        else [0] * n
    relax = _RELAX[family]
    for u, w in zip(idx, wgt):
        relax(ctx, u, w, carry)


def plain_frontier_bodies() -> Dict[str, Callable]:
    """The plain EXPAND bodies by body name: scalar, batched (slot by
    slot in slot order, each slot seeing the writes of those before it)
    and the batched bodies' drain (nothing is in flight on the CPU)."""
    out: Dict[str, Callable] = {}
    for fam in _RELAX:
        def scalar(ctx: KernelContext, fam=fam) -> None:
            _expand(fam, ctx)

        def batch(ctx: BatchContext, fam=fam) -> None:
            for s in range(ctx.count):
                _expand(fam, ctx.slot_ctx(s))

        out[fam] = scalar
        out[fam + "_batch"] = batch
        out[fam + "_batch_drain"] = lambda ctx: None
    return out


# ----------------------------------------------------- the three kernels


class FrontierKernel:
    """One traversal family: the compiled EXPAND family it names, whether
    it reads edge weights, the initial per-vertex state, and (PageRank)
    the fold threshold ``reps``. ``make_frontier_megakernel`` binds it to
    one graph layout (``st_base``)."""

    def __init__(self, name: str, weighted: bool, state0: int,
                 reps: Optional[int] = None,
                 spawn: Callable = _spawn_blocks) -> None:
        if name not in _RELAX:
            raise NotImplementedError(
                f"frontier family {name!r} is not compiled (the card "
                f"holds {sorted(_RELAX)}); user-defined bodies are "
                "ROADMAP A4")
        self.name = name
        self.weighted = bool(weighted)
        self.state0 = int(state0)
        self.reps = reps
        self.st_base: Optional[int] = None
        # The spawner's layout parameters: {} for the static block
        # spawner, the dynamic-graph words for the spare-aware one.
        self.layout = _spawn_layout(spawn)

    def data_specs(self, graph: Graph) -> Dict[str, tuple]:
        specs = {"indices": ((graph.nblocks, EBLOCK), torch.int32)}
        if self.weighted:
            specs["weights"] = ((graph.nblocks, EBLOCK), torch.int32)
        return specs


# The layout words a spare-aware spawner carries (megakernel.py PARAMS).
DYN_LAYOUT = ("dyn", "spare_base", "spare", "bcs_base")


def _spawn_layout(spawn) -> Dict[str, int]:
    """The layout parameters of a spawner: {} for the static block
    spawner, the ``DYN_LAYOUT`` words of dyngraph's spare-aware one (its
    ``layout`` attribute). Both are compiled (``fr_spawn_blocks``); any
    other callable would run Python on the host."""
    if spawn is _spawn_blocks:
        return {}
    layout = getattr(spawn, "layout", None)
    if isinstance(layout, dict) and set(layout) == set(DYN_LAYOUT) \
            and layout["dyn"] == 1:
        return dict(layout)
    raise NotImplementedError(
        "a frontier kernel spawns through the compiled block spawner or "
        "dyngraph's spare-aware one (dyngraph._dyn_spawn); user-defined "
        "spawners are ROADMAP A4")


def bfs_kernel(spawn: Callable = _spawn_blocks) -> FrontierKernel:
    """Level-style BFS as monotone label correction: carry is dist[v] at
    spawn; an improving hop re-spawns the target's blocks."""
    return FrontierKernel("fr_bfs", weighted=False, state0=INF, spawn=spawn)


def sssp_kernel(spawn: Callable = _spawn_blocks) -> FrontierKernel:
    """SSSP (nonnegative int weights): the same monotone relaxation with
    ``carry + w``; with ``priority_buckets`` the build runs delta-stepping
    (bucket = dist // delta, lowest first)."""
    return FrontierKernel("fr_sssp", weighted=True, state0=INF, spawn=spawn)


def pagerank_kernel(reps: int = 64,
                    spawn: Callable = _spawn_blocks) -> FrontierKernel:
    """Push-style PageRank on integer fixed-point mass; ``q < reps`` (or a
    zero child, or a dangling target) folds the delivery into rank[u]."""
    reps = int(reps)
    if reps < 1:
        raise ValueError(f"pagerank reps must be >= 1, got {reps}")
    return FrontierKernel("fr_pagerank", weighted=False, state0=0, reps=reps,
                          spawn=spawn)


# ------------------------------------------------------------ host side

_KINDS: Dict[str, Callable[..., FrontierKernel]] = {
    "bfs": bfs_kernel,
    "sssp": sssp_kernel,
    "pagerank": pagerank_kernel,
}


def priority_bucket(kind: str, carry: int, *, delta: int = 1,
                    reps: int = 64) -> int:
    """Host spelling of the priority-bucket functions the device routing
    runs: dist // delta (bfs/sssp) or the residual-magnitude band
    (pagerank). The scheduler clips into [0, priority_buckets)."""
    if kind in ("bfs", "sssp", "fr_bfs", "fr_sssp"):
        return int(carry) // max(1, int(delta))
    b = 0
    for k in range(1, BK_MAX):
        b += int(carry) >= int(reps) * (PR_BAND ** k)
    return b


def _bucket_rule(name: str, delta: int, reps: int) -> tuple:
    """The named-rule twin of ``priority_bucket`` for one frontier kind
    (the descriptor's carry is arg word 2)."""
    if name in ("fr_bfs", "fr_sssp"):
        return ("div", 2, max(1, int(delta)))
    return ("band", 2, int(reps))


def default_delta(graph: Graph) -> int:
    """Default delta-stepping bucket width: max edge weight over the
    bucket-ring count (>= 1)."""
    w = int(graph.weights.max()) if graph.m else 1
    return max(1, w // BK_MAX)


def seed_frontier(
    builder: Optional[TaskGraphBuilder],
    graph: Graph,
    kind: str,
    src: int = 0,
    m0: int = 1 << 14,
    reps: int = 64,
) -> List[Tuple[int, ...]]:
    """Host seeding (mirrors the device relax exactly). BFS/SSSP: one
    EXPAND per block of ``src``. PageRank: every vertex receives ``m0``
    host-side; survivors seed their blocks. Returns the seeded arg
    tuples (and adds them to ``builder`` when given)."""
    seeds: List[Tuple[int, ...]] = []
    if kind in ("bfs", "sssp"):
        v = int(src)
        if not 0 <= v < graph.n:
            raise ValueError(f"source {v} out of range [0, {graph.n})")
        for i in range(int(graph.blk_count[v])):
            seeds.append(
                (v, int(graph.blk_start[v]) + i, 0, graph.block_cnt(v, i))
            )
    elif kind == "pagerank":
        for v in range(graph.n):
            deg = int(graph.deg[v])
            qc = _pr_split(m0, deg)
            if m0 >= reps and qc > 0 and deg > 0:
                for i in range(int(graph.blk_count[v])):
                    seeds.append((v, int(graph.blk_start[v]) + i, qc,
                                  graph.block_cnt(v, i)))
    else:
        raise ValueError(f"unknown frontier kind {kind!r} (bfs|sssp|pagerank)")
    if builder is not None:
        for args in seeds:
            builder.add(FR_EXPAND, args=list(args))
    return seeds


def _pr_seed_rank(graph: Graph, m0: int, reps: int) -> np.ndarray:
    """Rank retained by the host-side seed deliveries."""
    rank = np.zeros(graph.n, np.int64)
    for v in range(graph.n):
        deg = int(graph.deg[v])
        qc = _pr_split(m0, deg)
        if m0 >= reps and qc > 0 and deg > 0:
            rank[v] = m0 - deg * qc
        else:
            rank[v] = m0
    return rank


def host_bfs(graph: Graph, src: int = 0) -> np.ndarray:
    """Exact hop distances (frontier BFS; INF where unreached)."""
    dist = np.full(graph.n, INF, np.int64)
    dist[src] = 0
    frontier = [int(src)]
    while frontier:
        nxt: List[int] = []
        for v in frontier:
            nd = dist[v] + 1
            for u in graph.adj[v]:
                if nd < dist[u]:
                    dist[u] = nd
                    nxt.append(int(u))
        frontier = nxt
    return dist.astype(np.int32)


def host_sssp(graph: Graph, src: int = 0) -> np.ndarray:
    """Exact shortest paths (Dijkstra; nonnegative int weights)."""
    dist = np.full(graph.n, INF, np.int64)
    dist[src] = 0
    heap: List[Tuple[int, int]] = [(0, int(src))]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for u, w in zip(graph.adj[v], graph.adj_w[v]):
            nd = d + int(w)
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, int(u)))
    return dist.astype(np.int32)


def host_pagerank_push(
    graph: Graph, m0: int = 1 << 14, reps: int = 64
) -> Tuple[np.ndarray, int]:
    """Exact integer twin of the device push (same split, same fold
    rule, any processing order). Returns (rank, deliveries)."""
    rank = _pr_seed_rank(graph, m0, reps)
    queue: List[Tuple[int, int]] = []
    for v in range(graph.n):
        deg = int(graph.deg[v])
        qc = _pr_split(m0, deg)
        if m0 >= reps and qc > 0 and deg > 0:
            for u in graph.adj[v]:
                queue.append((int(u), qc))
    deliveries = 0
    while queue:
        u, q = queue.pop()
        deliveries += 1
        deg = int(graph.deg[u])
        qc = _pr_split(q, deg)
        if q >= reps and qc > 0 and deg > 0:
            rank[u] += q - deg * qc
            for t in graph.adj[u]:
                queue.append((int(t), qc))
        else:
            rank[u] += q
    return rank.astype(np.int64), deliveries


def host_pagerank(
    graph: Graph,
    alpha: float = PR_NUM / PR_DEN,
    iters: int = 80,
    m0: float = 1.0,
) -> np.ndarray:
    """Float PageRank series the push approximates (dangling vertices
    absorb fully, the push's fold rule), ``m0`` seed mass per vertex."""
    m = np.full(graph.n, float(m0))
    rank = np.zeros(graph.n)
    deg = graph.deg.astype(np.float64)
    for _ in range(iters):
        keep = np.where(deg > 0, (1.0 - alpha) * m, m)
        rank += keep
        push = np.where(deg > 0, alpha * m / np.maximum(deg, 1), 0.0)
        m2 = np.zeros(graph.n)
        for v in range(graph.n):
            if push[v] > 0:
                np.add.at(m2, graph.adj[v], push[v])
        m = m2
    return rank + m


# ------------------------------------------------------------ megakernel


def _default_lane_max_age(width: int) -> Optional[int]:
    """Frontier builds default the age trigger ON at 4x the lane width;
    HCLIB_TPU_LANE_MAX_AGE (resolved by Megakernel) wins when set."""
    if env_set("HCLIB_TPU_LANE_MAX_AGE"):
        return None
    return 4 * width


def make_frontier_megakernel(
    fk: FrontierKernel,
    graph: Graph,
    *,
    width: int = 8,
    prefetch: bool = True,
    capacity: int = 512,
    num_values: Optional[int] = None,
    trace=None,
    checkpoint: Optional[bool] = None,
    lane_max_age: Optional[int] = None,
    priority_buckets: Optional[int] = None,
    delta: Optional[int] = None,
    device="cuda",
) -> Megakernel:
    """Build a traversal's megakernel. ``width=0`` is the scalar-dispatch
    arm; ``width>0`` routes EXPAND through the batch lanes with the
    edge-slab prefetch and the age-triggered firing policy
    (``lane_max_age``: default 4*width, 2*capacity when bucketed, 0
    disables). ``priority_buckets=B`` (batched builds only) arms the
    bucket rings: bucket = dist // ``delta`` for BFS/SSSP, the residual
    band for PageRank; a bucketed build runs without the prefetch."""
    if num_values is None:
        num_values = graph.num_value_slots + 8
    if priority_buckets is None:
        priority_buckets = env_int("HCLIB_TPU_PRIORITY_BUCKETS", None)
    priority_buckets = int(priority_buckets or 0)
    if priority_buckets and not width:
        raise ValueError(
            "priority_buckets needs the batched arm (width > 0): the "
            "bucket rings layer over the per-kind batch lanes"
        )
    if delta is None:
        delta = default_delta(graph)
    if width:
        prefetch = bool(prefetch) and not priority_buckets
        route = {fk.name: BatchSpec(
            width=width, prefetch=prefetch,
            priority=_bucket_rule(fk.name, delta, fk.reps or 64))}
        if lane_max_age is None:
            if priority_buckets:
                # The drain-period backstop: at 4*width the guard fires
                # all through long routing drains and breaks bucket order.
                lane_max_age = (None if env_set("HCLIB_TPU_LANE_MAX_AGE")
                                else 2 * capacity)
            else:
                lane_max_age = _default_lane_max_age(width)
    else:
        route = None
        lane_max_age = 0 if lane_max_age is None else lane_max_age
    if fk.st_base is not None and fk.st_base != graph.st_base:
        raise ValueError(
            "FrontierKernel is already bound to a different graph layout "
            f"(st_base {fk.st_base} vs {graph.st_base}): build a fresh "
            "kernel per graph"
        )
    fk.st_base = graph.st_base
    mk = Megakernel(
        kernels=[fk.name],
        route=route,
        data_specs=fk.data_specs(graph),
        capacity=capacity,
        num_values=num_values,
        succ_capacity=8,
        params={"st_base": graph.st_base, "nblocks": graph.nblocks,
                "reps": fk.reps or 0, **fk.layout},
        trace=trace,
        checkpoint=checkpoint,
        lane_max_age=lane_max_age,
        priority_buckets=priority_buckets,
        device=device,
    )
    mk._frontier_layout = (fk.name, graph.n, graph.nblocks, graph.st_base)
    kind = fk.name[3:]
    mk.si_claim = (("frontier", kind, fk.reps, priority_buckets, delta)
                   if priority_buckets else ("frontier", kind, fk.reps))
    return mk


def frontier_state(kind: str, graph: Graph, mk: Megakernel, src: int = 0,
                   m0: int = 1 << 14, reps: int = 64):
    """What ``run_frontier`` hands ``mk.run``: the seeded builder, the
    preset value row (the vertex table; the state INF with the source at
    0, or the ranks the host seeding retained) and the edge data."""
    st = graph.st_base
    iv = graph.preset_values(mk.num_values, 0 if kind == "pagerank" else INF)
    if kind == "pagerank":
        iv[st:st + graph.n] = _pr_seed_rank(graph, m0, reps).astype(np.int32)
    else:
        iv[st + int(src)] = 0
    b = TaskGraphBuilder()
    b.reserve_values(graph.num_value_slots)
    seed_frontier(b, graph, kind, src=src, m0=m0, reps=reps)
    data = {"indices": graph.indices}
    if kind == "sssp":
        data["weights"] = graph.weights
    return b, iv, data


def run_frontier(
    kind: str,
    graph: Graph,
    src: int = 0,
    *,
    width: int = 8,
    prefetch: bool = True,
    m0: int = 1 << 14,
    reps: int = 64,
    capacity: int = 512,
    trace=None,
    checkpoint=None,
    fuel: Optional[int] = None,
    lane_max_age: Optional[int] = None,
    priority_buckets: Optional[int] = None,
    delta: Optional[int] = None,
    mk: Optional[Megakernel] = None,
    placement=None,
    mesh=None,
    runner=None,
    quantum=None,
    window=None,
    hop_order=None,
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """Run one traversal to completion on one device; returns ``(result,
    info)``: the distance array (bfs/sssp, int32, INF = unreached) or the
    fixed-point rank array (pagerank, int64, ``m0`` mass units per vertex
    seeded). ``info`` gains ``edges`` (TEPS numerator) and
    ``relaxations``; ``trace`` / ``checkpoint`` build the Megakernel with
    the flight recorder / the quiesce poll."""
    multi = {"placement": placement, "mesh": mesh, "runner": runner,
             "quantum": quantum, "window": window, "hop_order": hop_order}
    given = sorted(k for k, v in multi.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"run_frontier({', '.join(given)}=...): the multi-device "
            "runners (placement seeding, the steal exchange) are ROADMAP "
            "A11; the port runs one device")
    if kind not in _KINDS:
        raise ValueError(f"unknown frontier kind {kind!r} (bfs|sssp|pagerank)")
    fk = _KINDS[kind](reps=reps) if kind == "pagerank" else _KINDS[kind]()
    if mk is None:
        mk = make_frontier_megakernel(
            fk, graph, width=width, prefetch=prefetch, capacity=capacity,
            trace=trace, checkpoint=checkpoint, lane_max_age=lane_max_age,
            priority_buckets=priority_buckets, delta=delta, device=device,
        )
    else:
        expect = (fk.name, graph.n, graph.nblocks, graph.st_base)
        bound = getattr(mk, "_frontier_layout", None)
        if bound != expect:
            raise ValueError(
                f"prebuilt megakernel is bound to frontier layout "
                f"{bound}, but this run wants {expect} "
                "(kind, n, nblocks, st_base): build one megakernel per "
                "(kind, graph) via make_frontier_megakernel"
            )
        fk.st_base = graph.st_base
    b, iv, data = frontier_state(kind, graph, mk, src, m0=m0, reps=reps)
    iv_o, _, info = mk.run(b, data=data, ivalues=iv,
                           fuel=1 << 22 if fuel is None else fuel)
    rows = np.asarray(iv_o, np.int64)
    st = graph.st_base
    states = rows[st:st + graph.n]
    result = states.astype(np.int32) if kind in ("bfs", "sssp") else states
    info["edges"] = int(rows[V_EDGES])
    info["relaxations"] = int(rows[V_RELAX])
    return result, info


def expand_rounds(mk: Megakernel, st: Dict[str, object], rows) -> None:
    """Run the EXPAND descriptors at task rows ``rows`` of state ``st``
    through ``mk``'s static frontier body directly, without the
    scheduler, in place: rounds of the table's batch width in row order with its
    prefetch protocol (one row a round for a scalar table). Relaxes write
    the value slots; spawned EXPANDs go to the ready ring and are not
    run. On CUDA tensors this launches the body's standalone entry
    (``csrc/megakernel.cu`` ``fr_entry``); on CPU tensors it runs the
    plain body row by row (a batched round relaxes its slots in slot
    order, so the two agree word for word)."""
    body = mk.kernel_names[0]
    if body not in _RELAX:
        raise ValueError("expand_rounds needs a frontier table")
    if mk.params["dyn"]:
        raise ValueError("expand_rounds runs a static frontier table, not "
                         "one with the dynamic-graph layout")
    mk._check_data(st["data"])
    rows = [int(r) for r in rows]
    width, prefetch = 1, False
    if mk.batch_specs:
        width, prefetch = (mk.batch_specs[0][1].width,
                           mk.batch_specs[0][1].prefetch)
    if st["tasks"].device.type == "cpu":
        core = _PlainCore(mk, st)
        core.free[0] = 0
        for r in rows:
            _expand(body, KernelContext(core, r))
        core.write_back()
        return
    dev = st["tasks"].device
    free = torch.zeros(mk.capacity + 1, dtype=torch.int32, device=dev)
    meta = torch.tensor(mk._meta, dtype=torch.int32, device=dev)
    rows_d = torch.tensor(rows, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * MAX_DATA)(
        *[st["data"][k].data_ptr() for k in mk.data_specs])
    lib = _build.library("megakernel")
    fn = lib.hclib_fr_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    err = fn(st["tasks"].data_ptr(), st["ready"].data_ptr(),
             st["counts"].data_ptr(), st["ivalues"].data_ptr(),
             free.data_ptr(), meta.data_ptr(),
             ctypes.cast(ptrs, ctypes.c_void_p), rows_d.data_ptr(),
             len(rows), width if mk.batch_specs else 0, int(prefetch),
             mk.capacity, mk._smem_bytes(), 32,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fr_entry")
    _build.LAUNCHES[mk.counter_of(body + "_batch" if mk.batch_specs
                                  else body)] += 1

