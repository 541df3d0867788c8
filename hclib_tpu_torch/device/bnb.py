"""Branch-and-bound 0/1 knapsack on the priority-bucket tier (port of
``hclib_tpu/device/bnb.py``).

One descriptor kind, ``NODE(level, value, weight, bound)``: ``level``
items are decided, ``value``/``weight`` are the committed totals and
``bound = value + suffix_value[level]`` the optimistic completion,
computed at spawn. A popped node re-checks its bound against the current
incumbent (value slot ``V_BEST``), prunes, or branches skip/take; a leaf
folds into the incumbent by a monotone max, so the proven optimum is the
same under every pop order while the node count is not: best-first
retirement (``priority_buckets``, bucket 0 = highest bound) prunes what
an unordered run explores.

The NODE body is compiled (``bnb_node`` / ``bnb_node_batch`` in
``csrc/megakernel.cu``, on thread 0 like ``fib``); it reads the item
count and capacity from the megakernel's parameters (``n``, ``cap``) and
the suffix, value and weight tables from the value slots. The bucket
rule is the named rule ``("linear_desc", 3, total, B)``, JAX's
``((total - bound) * B) // (total + 1)``.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from ..runtime.env import env_int, env_set
from .descriptor import TaskGraphBuilder
from .megakernel import BatchContext, BatchSpec, KernelContext, Megakernel

__all__ = [
    "BB_NODE", "V_BEST", "V_PRUNED", "V_LEAVES", "make_knapsack",
    "host_knapsack_opt", "host_bnb", "bnb_bucket", "make_bnb_megakernel",
    "run_bnb", "bnb_state",
]

# The one kernel-table entry (single-kind family, like the frontier).
BB_NODE = 0

# Value-slot layout: three counters, then the host-preset tables.
V_BEST = 0    # incumbent (monotone max; the proven optimum at drain)
V_PRUNED = 1  # nodes cut by the bound test (schedule-dependent count)
V_LEAVES = 2  # complete assignments folded into the incumbent
BB_TAB = 8    # suffix-value sums [n+1], then values [n], then weights [n]


class Knapsack:
    """One seeded 0/1-knapsack instance: int item values/weights, a
    weight capacity, and the suffix-value table the bound uses."""

    def __init__(self, values, weights, cap: int) -> None:
        self.values = np.asarray(values, np.int64)
        self.weights = np.asarray(weights, np.int64)
        if self.values.shape != self.weights.shape or self.values.ndim != 1:
            raise ValueError("values/weights must be equal-length 1D")
        if len(self.values) and (
            self.values.min() < 0 or self.weights.min() <= 0
        ):
            raise ValueError("values must be >= 0 and weights > 0")
        self.n = int(len(self.values))
        self.cap = int(cap)
        self.suffix = np.zeros(self.n + 1, np.int64)
        self.suffix[:-1] = np.cumsum(self.values[::-1])[::-1]
        self.total = int(self.suffix[0])

    @property
    def num_value_slots(self) -> int:
        return BB_TAB + (self.n + 1) + 2 * self.n

    def preset_values(self, num_values: int) -> np.ndarray:
        if num_values < self.num_value_slots:
            raise ValueError(
                f"knapsack wants num_values >= {self.num_value_slots}, "
                f"got {num_values}"
            )
        iv = np.zeros(num_values, np.int32)
        iv[BB_TAB:BB_TAB + self.n + 1] = self.suffix
        v0 = BB_TAB + self.n + 1
        iv[v0:v0 + self.n] = self.values
        iv[v0 + self.n:v0 + 2 * self.n] = self.weights
        return iv


def make_knapsack(n: int, seed: int = 0,
                  cap_frac: float = 0.5) -> Knapsack:
    """Seeded instance: values 1..100, weights 1..50, capacity =
    ``cap_frac`` of the total weight (the JAX package's generator)."""
    if n < 1:
        raise ValueError(f"knapsack n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    values = rng.integers(1, 101, n)
    weights = rng.integers(1, 51, n)
    return Knapsack(values, weights, int(cap_frac * weights.sum()))


def host_knapsack_opt(kp: Knapsack) -> int:
    """The exact optimum by the classic weight-indexed DP (no bounds, no
    search order)."""
    dp = np.zeros(kp.cap + 1, np.int64)
    for v, w in zip(kp.values, kp.weights):
        w = int(w)
        if w <= kp.cap:
            dp[w:] = np.maximum(dp[w:], dp[:-w or None] + v)
    return int(dp.max())


def bnb_bucket(kp: Knapsack, bound: int, buckets: int) -> int:
    """Host spelling of the best-first priority: bucket 0 = highest
    optimistic bound, spread linearly over [0, total]."""
    return ((kp.total - int(bound)) * int(buckets)) // (kp.total + 1)


def host_bnb(kp: Knapsack, best_first: bool = False) -> Dict[str, int]:
    """Host worklist model of the device search (same bound, same branch
    rule): {best, executed, pruned, leaves}; max-bound-first or FIFO."""
    best, executed, pruned, leaves = 0, 0, 0, 0
    if best_first:
        wl = [(-kp.total, 0, 0, 0, kp.total)]
    else:
        wl = deque([(0, 0, 0, 0, kp.total)])
    while wl:
        if best_first:
            _, level, value, weight, bound = heapq.heappop(wl)
        else:
            _, level, value, weight, bound = wl.popleft()
        executed += 1
        if bound <= best:
            pruned += 1
            continue
        if level == kp.n:
            leaves += 1
            best = max(best, value)
            continue
        sfx = int(kp.suffix[level + 1])
        v_i, w_i = int(kp.values[level]), int(kp.weights[level])
        children = [(level + 1, value, weight, value + sfx)]
        if weight + w_i <= kp.cap:
            children.append(
                (level + 1, value + v_i, weight + w_i, value + v_i + sfx))
        for c in children:
            if best_first:
                heapq.heappush(wl, (-c[3],) + c)
            else:
                wl.append((0,) + c)
    return {"best": best, "executed": executed, "pruned": pruned,
            "leaves": leaves}


# ----------------------------------------------------------- device tier


def bnb_node_body(ctx: KernelContext) -> None:
    """The plain NODE body (JAX's ``_node_kernel``): prune against the
    incumbent, fold a leaf, or spawn the skip child and, if it fits, the
    take child."""
    n, cap = ctx.params["n"], ctx.params["cap"]
    v0 = BB_TAB + n + 1
    level, value, weight, bound = (ctx.arg(i) for i in range(4))
    best = ctx.value(V_BEST)
    if bound <= best:
        ctx.set_value(V_PRUNED, ctx.value(V_PRUNED) + 1)
    elif level == n:
        ctx.set_value(V_BEST, max(best, value))
        ctx.set_value(V_LEAVES, ctx.value(V_LEAVES) + 1)
    elif level < n:
        sfx = ctx.value(BB_TAB + 1 + level)
        v_i = ctx.value(v0 + level)
        w_i = ctx.value(v0 + n + level)
        ctx.spawn(BB_NODE, [level + 1, value, weight, value + sfx], nargs=4)
        if weight + w_i <= cap:
            ctx.spawn(BB_NODE, [level + 1, value + v_i, weight + w_i,
                                value + v_i + sfx], nargs=4)


def bnb_node_batch_body(ctx: BatchContext) -> None:
    """``batch_of``-shaped: the NODE body on each live slot in order."""
    for s in range(ctx.count):
        bnb_node_body(ctx.slot_ctx(s))


def make_bnb_megakernel(
    kp: Knapsack,
    *,
    width: int = 4,
    priority_buckets: Optional[int] = None,
    capacity: int = 1024,
    num_values: Optional[int] = None,
    trace=None,
    lane_max_age: Optional[int] = None,
    device="cuda",
) -> Megakernel:
    """Build the search megakernel. ``width=0`` is scalar dispatch;
    ``width>0`` batches NODE expansion slot by slot (LIFO lane);
    ``priority_buckets=B`` arms best-first retirement, with the age guard
    at 2*capacity (4*width unbucketed)."""
    if num_values is None:
        num_values = kp.num_value_slots + 8
    if priority_buckets is None:
        priority_buckets = env_int("HCLIB_TPU_PRIORITY_BUCKETS", None)
    priority_buckets = int(priority_buckets or 0)
    if width:
        nbk = priority_buckets
        route = {"bnb_node": BatchSpec(
            width=width,
            priority=("linear_desc", 3, kp.total, nbk) if nbk else None)}
        if lane_max_age is None and not env_set("HCLIB_TPU_LANE_MAX_AGE"):
            lane_max_age = 2 * capacity if nbk else 4 * width
    else:
        if priority_buckets:
            raise ValueError(
                "priority_buckets needs the batched arm (width > 0)")
        route = None
        lane_max_age = 0 if lane_max_age is None else lane_max_age
    mk = Megakernel(
        kernels=["bnb_node"],
        route=route,
        capacity=capacity,
        num_values=num_values,
        succ_capacity=8,
        params={"n": kp.n, "cap": kp.cap},
        trace=trace,
        lane_max_age=lane_max_age,
        priority_buckets=priority_buckets,
        device=device,
    )
    mk._bnb_instance = kp
    mk.si_claim = (
        "bnb", tuple(map(int, kp.values)), tuple(map(int, kp.weights)),
        kp.cap, priority_buckets,
    )
    return mk


def bnb_state(kp: Knapsack, mk: Megakernel):
    """What ``run_bnb`` hands ``mk.run``: the root NODE and the preset
    value row (the suffix, value and weight tables)."""
    b = TaskGraphBuilder()
    b.reserve_values(kp.num_value_slots)
    b.add(BB_NODE, args=[0, 0, 0, kp.total])
    return b, kp.preset_values(mk.num_values)


def run_bnb(
    kp: Knapsack,
    *,
    width: int = 4,
    priority_buckets: Optional[int] = None,
    capacity: int = 1024,
    trace=None,
    fuel: Optional[int] = None,
    mk: Optional[Megakernel] = None,
    device="cuda",
) -> Tuple[int, Dict]:
    """Run the search to the proven optimum; returns ``(best, info)`` with
    ``info['pruned']`` / ``info['leaves']`` beside the scheduler counters
    (``executed`` is the expanded-node count the priority arm shrinks)."""
    if mk is None:
        mk = make_bnb_megakernel(
            kp, width=width, priority_buckets=priority_buckets,
            capacity=capacity, trace=trace, device=device,
        )
    elif getattr(mk, "_bnb_instance", None) is not kp:
        raise ValueError(
            "prebuilt bnb megakernel is bound to a different knapsack "
            "instance (its tables and bounds are in its parameters): "
            "build one per instance via make_bnb_megakernel"
        )
    b, iv = bnb_state(kp, mk)
    iv_o, _, info = mk.run(
        b, ivalues=iv, fuel=1 << 22 if fuel is None else fuel
    )
    info["pruned"] = int(iv_o[V_PRUNED])
    info["leaves"] = int(iv_o[V_LEAVES])
    return int(iv_o[V_BEST]), info
