"""The lockstep UTS engine in PyTorch (port of ``hclib_tpu/device/uts_vec.py``):
the plain version of the fused CUDA engine (``device/uts_fused.py``).

Thousands of lanes each run an independent DFS, every per-node operation
elementwise over (rows, 128) lane planes, with the JAX engine's semantics
word for word:

- SHA-1 (the UTS splittable RNG) hashes the current child of every lane
  at once (``ops/sha1.py``; words held as int64).
- Each lane's DFS stack is a tuple of (state, next-child, count, depth)
  planes, one per level, read and written by selects on the per-lane
  stack pointer. Tail-call scheduling: a frame expanding its last
  non-leaf child is replaced by that child, a last leaf child pops at
  once, so every active step expands a node.
- A shared root queue balances the lanes: the host seeds subtree roots at
  one BFS depth d0 (``_host_seed``, LPT order); once ``min_idle`` lanes
  are starved (or nothing is left to claim) the starved lanes take the
  next roots in flat lane order by a prefix sum over the starved mask.
- Child counts are exact: the host finds the integer thresholds t_k and
  a lane counts #(r >= t_k) with integer compares, from one
  depth-independent list (FIXED) or a per-depth table (LINEAR, CYCLIC,
  EXPDEC), 0 beyond the table.

JAX's ``while_loop``s become Python loops (one host read of the starved
count per step, as the loop condition needs it), and the traced
``next_root`` / ``steps`` scalars become Python ints. The results -- the
per-lane ``nodes`` / ``leaves`` / ``maxd`` planes and the lockstep
``steps`` -- equal ``hclib_tpu.device.uts_vec._uts_dfs``'s for the same
staged roots. ``stage_roots`` is the staging of ``uts_vec`` (padding and
table selection), shared with the CUDA engine.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..models.uts import (
    CYCLIC, FIXED, LINEAR, MAX_CHILDREN, UTSParams, _branching,
)
from ..ops.sha1 import sha1_block_np, sha1_child, sha1_child_np
from .state import resolve_device

__all__ = [
    "uts_vec", "child_thresholds", "child_threshold_table", "depth_cap",
    "inrow_threshold_table", "padded_threshold_table", "MAX_CHILDREN",
    "PAD_QUANTUM", "LANES", "NLANES", "make_count_children",
    "make_dfs_step", "make_refill", "apply_claim", "make_traversal",
    "stage_roots", "Staged",
]

LANES = (8, 128)
NLANES = LANES[0] * LANES[1]
# Root arrays are padded to a multiple of this (as in the JAX engine, where
# trees with different root counts then share one compiled engine).
PAD_QUANTUM = 4096


def _thresholds_for_b(b_i: float) -> List[int]:
    """Integer thresholds for the geometric child count at branching b_i:
    count(r) = #{k : r >= t_k}. Exact w.r.t. the f64 scalar formula."""
    if b_i <= 0.0:
        return []
    p = 1.0 / (1.0 + b_i)
    logq = math.log(1.0 - p)

    def count_of(r: int) -> int:
        u = r / 2147483648.0
        if u >= 1.0:
            return MAX_CHILDREN
        return min(MAX_CHILDREN, int(math.floor(math.log(1.0 - u) / logq)))

    ts: List[int] = []
    rmax = (1 << 31) - 1
    for k in range(1, MAX_CHILDREN + 1):
        if count_of(rmax) < k:
            break  # k unreachable for any r
        lo, hi = 0, rmax  # invariant: count(hi) >= k
        while lo < hi:
            mid = (lo + hi) // 2
            if count_of(mid) >= k:
                hi = mid
            else:
                lo = mid + 1
        ts.append(lo)
    return ts


def child_thresholds(b0: float) -> np.ndarray:
    """Depth-independent thresholds (the GEO/FIXED fast path)."""
    return np.asarray(_thresholds_for_b(b0), dtype=np.int32)


def depth_cap(params: UTSParams) -> Optional[int]:
    """Smallest depth bound that covers every node the shape can produce
    (node depths strictly below it), or None when the shape is unbounded
    (EXPDEC: the caller chooses a cap, validated against the observed max
    depth)."""
    if params.shape == FIXED:
        return params.gen_mx + 1
    if params.shape == LINEAR:
        return params.gen_mx + 1  # b_i <= 0 at depth >= gen_mx
    if params.shape == CYCLIC:
        return 5 * params.gen_mx + 2  # b_i = 0 beyond 5*gen_mx
    return None


def child_threshold_table(params: UTSParams, max_depth: int) -> np.ndarray:
    """Per-depth threshold table for the depth-varying shapes: row d holds
    the thresholds for a node AT depth d, -1 padding marks child ordinals
    unreachable at that depth. Rows cover d in [0, max_depth]."""
    rows = [
        _thresholds_for_b(_branching(params, d))
        for d in range(max_depth + 1)
    ]
    K = max((len(r) for r in rows), default=0) or 1
    table = np.full((max_depth + 1, K), -1, dtype=np.int32)
    for d, r in enumerate(rows):
        table[d, : len(r)] = r
    return table


def inrow_threshold_table(thresholds, cols: int) -> np.ndarray:
    """A per-depth table transposed to one ``cols``-wide row per child
    ordinal, -1 padded: the layout of the JAX fused engine's in-row
    gather, ported with the other table functions and held to JAX's in
    the tests. The card reads the row-major table."""
    tab_np = np.asarray(thresholds, dtype=np.int32)  # (D+1, K)
    D = tab_np.shape[0] - 1
    if D + 1 >= cols:
        # STRICTLY below cols: the in-row count clips depth to cols - 1
        # and relies on that column being -1 padding.
        raise NotImplementedError(
            f"in-row table gather needs depth cap + 1 < {cols} "
            f"lane columns, got {D + 1}"
        )
    padded = np.full((tab_np.shape[1], cols), -1, np.int32)
    padded[:, : D + 1] = tab_np.T
    return padded


def padded_threshold_table(
    params: UTSParams,
    cap: int,
    max_rows: Optional[int] = None,
    min_cols: Optional[int] = None,
) -> np.ndarray:
    """child_threshold_table padded to a common shape: rows (depths) up to
    a multiple of 16, columns (child ordinals) to the next multiple of 16
    (capped at MAX_CHILDREN), -1 filled. ``max_rows`` caps the row
    round-up when the real cap still fits under it; ``min_cols`` widens the
    ordinal padding (capped at MAX_CHILDREN)."""
    t = child_threshold_table(params, cap)
    rows = -(-(cap + 1) // 16) * 16
    if max_rows is not None and rows > max_rows >= cap + 1:
        rows = max_rows
    cols = min(MAX_CHILDREN, -(-t.shape[1] // 16) * 16)
    if min_cols is not None:
        cols = min(MAX_CHILDREN, max(cols, int(min_cols)))
    out = np.full((rows, max(cols, t.shape[1])), -1, np.int32)
    out[: t.shape[0], : t.shape[1]] = t
    return out


# ------------------------------------------------------------ the engine


def _level_select(stack, masks):
    """Read a per-lane level of a tuple-of-planes stack (0 where sp < 0)."""
    out = torch.zeros_like(stack[0])
    for plane, m in zip(stack, masks):
        out = torch.where(m, plane, out)
    return out


def _level_store(stack, masks, value):
    """Write ``value`` at the per-lane level of ``masks``; a new tuple."""
    return tuple(torch.where(m, value, plane) for plane, m in zip(stack, masks))


def make_count_children(thresholds, gen_mx: int, table=None):
    """Exact geometric child count of (r, depth) planes. ``thresholds`` is
    a flat tuple (depth-independent FIXED shape, guarded by ``gen_mx``) or
    None: the per-depth ``table`` ((D+1, K) int32 tensor, -1 padded) then
    gives a row by each lane's depth, and 0 beyond the table. (The JAX
    function's in-row table form exists for Mosaic's gathers only.)"""
    if thresholds is None:
        D = table.shape[0] - 1

        def count_children_rows(r, depth):
            rows = table[depth.clamp(0, D).long()]  # (*lanes, K)
            cnt = ((rows >= 0) & (r[..., None] >= rows)).sum(
                -1, dtype=torch.int32)
            # Beyond the table the count is 0, NOT the last row's: a depth
            # bound that cuts a live region then ends the traversal and
            # the caller's maxd >= cap check fails loudly.
            return torch.where(depth <= D, cnt, 0)

        return count_children_rows
    thr = None

    def count_children(r, depth):
        nonlocal thr
        if thr is None or thr.device != r.device:
            thr = torch.tensor(thresholds, dtype=torch.int32, device=r.device)
        cnt = (r[..., None] >= thr).sum(-1, dtype=torch.int32)
        return torch.where(depth < gen_mx, cnt, 0)

    return count_children


def make_dfs_step(S: int, thresholds, gen_mx: int, table=None):
    """One lockstep DFS expansion step over all lanes:
    (sp, nodes, leaves, maxd, st, ch, cn, dp) -> same tuple. ``st`` is a
    tuple of S levels, each a list of 5 int64 word planes."""
    count_children = make_count_children(thresholds, gen_mx, table)

    def step(sp, nodes, leaves, maxd, st, ch, cn, dp):
        active = sp >= 0
        at = [sp == L for L in range(S)]
        child = _level_select(ch, at)
        count = _level_select(cn, at)
        depth = _level_select(dp, at)
        state = [_level_select(tuple(st[L][i] for L in range(S)), at)
                 for i in range(5)]
        expand = active & (child < count)
        cstate = sha1_child(state, child)
        r = (cstate[4] & 0x7FFFFFFF).to(torch.int32)
        cdepth = depth + 1
        ccount = count_children(r, cdepth)
        is_leaf = ccount == 0
        nodes = nodes + expand.to(torch.int32)
        leaves = leaves + (expand & is_leaf).to(torch.int32)
        maxd = torch.maximum(maxd, torch.where(expand, cdepth, 0))
        # Tail-call scheduling keeps every frame expandable (child < count):
        #  - last+leaf child: the frame is done, pop now;
        #  - last+non-leaf child: the child replaces the parent frame;
        #  - otherwise: bump the cursor; push non-leaf children.
        last = expand & (child + 1 >= count)
        push = expand & ~is_leaf & ~last
        tail = expand & ~is_leaf & last
        pop = (expand & is_leaf & last) | (active & ~expand)
        bump = expand & ~last
        ch = _level_store(ch, [m & bump for m in at], child + 1)
        # One store pass for both push (at sp+1) and tail-replace (at sp).
        spp = sp + 1
        lvl = torch.where(push, spp, sp)
        newf = push | tail
        put = [newf & (lvl == L) for L in range(S)]
        st = tuple(
            [torch.where(put[L], cstate[i], st[L][i]) for i in range(5)]
            for L in range(S)
        )
        ch = _level_store(ch, put, torch.zeros_like(child))
        cn = _level_store(cn, put, ccount)
        dp = _level_store(dp, put, cdepth)
        sp = torch.where(push, spp, torch.where(pop, sp - 1, sp))
        return sp, nodes, leaves, maxd, st, ch, cn, dp

    return step


def apply_claim(claim, rst, rcn, d0, sp, st0, ch0, cn0, dp0):
    """Install gathered roots into level 0 of claiming lanes."""
    st0 = [torch.where(claim, rst[i], st0[i]) for i in range(5)]
    ch0 = torch.where(claim, 0, ch0)
    cn0 = torch.where(claim, rcn, cn0)
    dp0 = torch.where(claim, d0, dp0)
    sp = torch.where(claim, 0, sp)
    return sp, st0, ch0, cn0, dp0


def make_refill(lanes: tuple, d0: int):
    """Shared-root-queue claim: starved lanes (sp < 0) take the next
    contiguous unclaimed roots by prefix-sum rank in flat lane order.
    Returns refill(roots_state, roots_count, R, sp, next_root, st0, ch0,
    cn0, dp0) -> (sp, next_root, st0, ch0, cn0, dp0); ``next_root`` is a
    Python int."""
    nlanes = lanes[0] * lanes[1]

    def refill(roots_state, roots_count, R, sp, next_root, st0, ch0, cn0,
               dp0):
        done = sp < 0
        rank = torch.cumsum(done.reshape(-1).to(torch.int32), 0,
                            dtype=torch.int32).reshape(lanes)
        avail = R - next_root
        claim = done & (rank <= avail)
        # Claims are contiguous [next_root, next_root + nclaim): gather
        # within an nlanes-wide window (the arrays are padded past it).
        idx = (rank - 1).clamp(0, nlanes - 1).reshape(-1).long() + next_root
        rst = [roots_state[i][idx].reshape(lanes) for i in range(5)]
        rcn = roots_count[idx].reshape(lanes)
        sp, st0, ch0, cn0, dp0 = apply_claim(
            claim, rst, rcn, d0, sp, st0, ch0, cn0, dp0
        )
        next_root = next_root + min(int(done.sum()), avail)
        return sp, next_root, st0, ch0, cn0, dp0

    return refill


def make_traversal(S: int, lanes: tuple, thresholds, gen_mx: int,
                   min_idle: int, max_steps: int, refill: Callable, R: int,
                   device, table=None):
    """The traversal loop: outer loop = refill + a refill-free inner
    expansion loop until ``min_idle`` lanes are starved (or nothing is left
    to claim). Returns run() -> (sp, next_root, nodes, leaves, maxd,
    steps)."""
    step = make_dfs_step(S, thresholds, gen_mx, table)
    nlanes = lanes[0] * lanes[1]

    def run():
        zeros = torch.zeros(lanes, dtype=torch.int32, device=device)
        wzeros = torch.zeros(lanes, dtype=torch.int64, device=device)
        st = tuple([wzeros] * 5 for _ in range(S))
        ch = (zeros,) * S
        cn = (zeros,) * S
        dp = (zeros,) * S
        sp = torch.full(lanes, -1, dtype=torch.int32, device=device)
        nodes = leaves = maxd = zeros
        next_root, steps = 0, 0
        ndone = nlanes
        while (ndone < nlanes or next_root < R) and steps < max_steps:
            sp, next_root, st0, ch0, cn0, dp0 = refill(
                sp, next_root, st[0], ch[0], cn[0], dp[0]
            )
            st = (st0,) + st[1:]
            ch = (ch0,) + ch[1:]
            cn = (cn0,) + cn[1:]
            dp = (dp0,) + dp[1:]
            avail = R - next_root
            while True:
                ndone = int((sp < 0).sum())
                if not (ndone < nlanes
                        and (ndone < min_idle or avail <= 0)
                        and steps < max_steps):
                    break
                sp, nodes, leaves, maxd, st, ch, cn, dp = step(
                    sp, nodes, leaves, maxd, st, ch, cn, dp
                )
                steps += 1
        return sp, next_root, nodes, leaves, maxd, steps

    return run


def _uts_dfs(
    roots_state: torch.Tensor,  # (5, P) int64 - subtree roots at depth d0
    roots_count: torch.Tensor,  # (P,) int32 - exact child counts (>= 1)
    tab: torch.Tensor,  # (D+1, K) int32 threshold table ((1, 1) for FIXED)
    gen_mx: int,  # FIXED-shape depth guard (unused on the table path)
    d0: int,  # BFS depth of the roots
    nroots: int,  # REAL root count R (arrays are padded to P >= R + nlanes)
    stack_size: int,
    thresholds,  # ints (FIXED fast path) or None (table)
    max_steps: int,
    lanes: tuple,
    min_idle_div: int = 8,
):
    """The engine over staged roots: (nodes, leaves, maxd) per-lane int32
    planes, the lockstep step count and whether work was left over."""
    nlanes = lanes[0] * lanes[1]
    # Refill threshold: the expansion loop runs refill-free until this many
    # lanes are idle; then every starved lane claims at once.
    refill_min_idle = max(64, nlanes // min_idle_div)
    refill_fn = make_refill(lanes, d0)

    def refill(sp, next_root, st0, ch0, cn0, dp0):
        return refill_fn(roots_state, roots_count, nroots, sp, next_root,
                         st0, ch0, cn0, dp0)

    run = make_traversal(
        stack_size, lanes, thresholds, gen_mx, refill_min_idle, max_steps,
        refill, nroots, roots_count.device,
        table=tab if thresholds is None else None,
    )
    sp, next_root, nodes, leaves, maxd, steps = run()
    unfinished = bool((sp >= 0).any()) or next_root < nroots
    return nodes, leaves, maxd, steps, unfinished


# ------------------------------------------------------------- host side


def _host_seed(params: UTSParams, target_roots: int):
    """Vectorized BFS of the tree top with numpy SHA-1 over whole levels.

    Returns (host_nodes, host_leaves, host_maxd, d0, roots_state (5,R) u32,
    roots_count (R,) i32); the arrays are None when the host consumed the
    whole tree. Roots all sit at depth d0 and have count >= 1; leaf
    frontier nodes are counted host-side."""
    def counts_of(state5, depth: int) -> np.ndarray:
        ts = np.asarray(
            _thresholds_for_b(_branching(params, depth)), np.int32
        )
        if ts.size == 0:
            return np.zeros(state5[0].shape, np.int32)
        r = (state5[4] & np.uint32(0x7FFFFFFF)).astype(np.int32)
        return (r[:, None] >= ts[None, :]).sum(axis=1, dtype=np.int32)

    # Root state: SHA1(16 zero bytes || BE32(seed)) per the UTS spec.
    seed_words = [np.zeros(1, np.uint32) for _ in range(4)]
    seed_words.append(np.full(1, params.root_seed, np.uint32))
    w16 = seed_words + [
        np.full(1, 0x80000000, np.uint32),
        *[np.zeros(1, np.uint32) for _ in range(9)],
        np.full(1, 20 * 8, np.uint32),
    ]
    state5 = list(sha1_block_np(w16))

    host_nodes = 0
    host_leaves = 0
    host_maxd = 0
    depth = 0
    while True:
        n = state5[0].shape[0]
        counts = counts_of(state5, depth)
        host_nodes += n
        host_maxd = max(host_maxd, depth) if n else host_maxd
        nonleaf = counts > 0
        host_leaves += int((~nonleaf).sum())
        total = int(counts.sum())
        if total == 0:
            return host_nodes, host_leaves, host_maxd, depth, None, None
        if n >= target_roots:
            # Hand the non-leaf frontier to the device in LPT order (biggest
            # child counts first), so large subtrees are claimed early.
            rs = [s[nonleaf] for s in state5]
            rc = counts[nonleaf]
            order = np.argsort(-rc, kind="stable")
            rs = [s[order] for s in rs]
            rc = rc[order]
            return (
                host_nodes, host_leaves, host_maxd, depth,
                np.stack(rs).astype(np.uint32), rc.astype(np.int32),
            )
        # Expand the whole level at once.
        parent = np.repeat(np.arange(n), counts)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        rank = (np.arange(total) - starts[parent]).astype(np.uint32)
        state5 = list(sha1_child_np([s[parent] for s in state5], rank))
        depth += 1


@dataclass
class Staged:
    """Seeded roots staged for an engine (``uts_vec.py:672-719`` of the
    JAX package): padded numpy arrays plus the engine's static choices."""

    pstate: np.ndarray  # (5, P) uint32, P >= R + nlanes
    pcount: np.ndarray  # (P,) int32
    tab: np.ndarray  # (D+1, K) int32 table, or (1, 1) zeros for FIXED
    gen_mx: int
    d0: int
    nroots: int
    stack_size: int
    thresholds: Optional[Tuple[int, ...]]
    cap: int  # depth cap of the table / stack sizing
    bounded: bool  # whether reaching ``cap`` must raise

    def engine_args(self, device, max_steps: int, lanes: tuple):
        """(args, kw) of ``_uts_dfs`` and of the kernel's wrapper
        ``uts_fused.uts_dfs``, with the arrays on ``device``."""
        args = (
            torch.from_numpy(self.pstate.astype(np.int64)).to(device),
            torch.from_numpy(self.pcount).to(device),
            torch.from_numpy(self.tab).to(device),
            self.gen_mx, self.d0, self.nroots,
        )
        kw = dict(stack_size=self.stack_size, thresholds=self.thresholds,
                  max_steps=max_steps, lanes=tuple(lanes))
        return args, kw


def stage_roots(params: UTSParams, d0: int, roots_state: np.ndarray,
                roots_count: np.ndarray, lanes: tuple = LANES,
                depth_bound: Optional[int] = None,
                stack_pad: Optional[int] = None,
                table_cols: Optional[int] = None) -> Staged:
    """Pad ``_host_seed``'s roots and pick the threshold form and stack
    height, exactly as the JAX ``uts_vec`` does."""
    nlanes = lanes[0] * lanes[1]
    R = int(roots_count.shape[0])
    # P >= R + nlanes: the claim window never runs off the end.
    padn = -(-(R + nlanes) // PAD_QUANTUM) * PAD_QUANTUM
    pstate = np.zeros((5, padn), np.uint32)
    pstate[:, :R] = roots_state
    pcount = np.zeros(padn, np.int32)
    pcount[:R] = roots_count
    derived = depth_cap(params)
    if derived is None:  # EXPDEC: caller-chosen bound, validated later
        cap = depth_bound if depth_bound is not None else 8 * params.gen_mx
        bounded = True
    elif depth_bound is not None and depth_bound < derived:
        # An explicit bound below the shape's own cap shrinks the stack
        # for known-shallow trees, with the same loud validation.
        cap = depth_bound
        bounded = True
    else:
        cap = derived
        bounded = False
    if params.shape == FIXED and not bounded:
        thr = tuple(int(t) for t in child_thresholds(params.b0))
        stack_size = max(1, params.gen_mx - d0)
        tabnp = np.zeros((1, 1), np.int32)
    else:
        thr = None
        tabnp = padded_threshold_table(params, cap, min_cols=table_cols)
        # Pushed frames hold non-leaf nodes only; where the cap is exact
        # the deepest non-leaf sits at cap-2, so the tight height is
        # cap-1-d0.
        stack_size = max(1, (cap - d0) if bounded else (cap - 1 - d0))
    if stack_pad is not None:
        stack_size = max(stack_size, int(stack_pad))
    return Staged(pstate, pcount, tabnp, params.gen_mx, d0, R, stack_size,
                  thr, cap, bounded)


def resolve_timing_reps(timing_reps, on_card: bool) -> int:
    """3 timed executions on the card (after a warm-up), one elsewhere
    (a CPU run is deterministic and its callers need the counts)."""
    if timing_reps is not None:
        return max(1, int(timing_reps))
    return 3 if on_card else 1


def timed_best(run, reps: int, warm: bool):
    """(outputs, device nodes, best seconds) over ``reps`` executions of
    ``run``, after one untimed warm-up if ``warm``; the int64 sum of the
    per-lane node plane, read back to the host, ends each timed
    execution."""
    if warm:
        int(run()[0].sum(dtype=torch.int64))
    dt = None
    dev_nodes = 0
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = run()
        dev_nodes = int(outs[0].sum(dtype=torch.int64))
        d = time.perf_counter() - t0
        dt = d if dt is None else min(dt, d)
    return outs, dev_nodes, dt


def seed_result(params: UTSParams, target_roots: int):
    """Run ``_host_seed``; returns (seed tuple, the result dict's seed
    fields, and the whole result when the host consumed the tree)."""
    t_seed = time.perf_counter()
    seed = _host_seed(params, target_roots)
    host_nodes, host_leaves, host_maxd, _, _, roots_count = seed
    result = {
        "host_seed_nodes": host_nodes,
        "roots": 0 if roots_count is None else int(roots_count.shape[0]),
        "seed_seconds": time.perf_counter() - t_seed,
    }
    if roots_count is None:
        result.update(nodes=host_nodes, leaves=host_leaves,
                      max_depth=host_maxd, steps=0)
    return seed, result


def finish_result(result: dict, seed, sg: Staged, outs, dev_nodes: int,
                  dt: float, nlanes: int, name: str, max_steps: int) -> dict:
    """Check an engine's run (steps left over, depth bound) and fill the
    result dict with int64 totals of its per-lane planes."""
    host_nodes, host_leaves, host_maxd = seed[:3]
    _, leaves, maxd, steps, unfinished = outs
    if unfinished:
        raise RuntimeError(f"{name} ran out of steps ({max_steps})")
    dmax = int(maxd.max())
    if sg.bounded and dmax >= sg.cap:
        raise RuntimeError(
            f"tree reached the depth bound ({sg.cap}): counts beyond it are "
            "truncated - rerun with a larger depth_bound"
        )
    result.update(
        nodes=host_nodes + dev_nodes,
        leaves=host_leaves + int(leaves.sum(dtype=torch.int64)),
        max_depth=max(host_maxd, dmax),
        steps=int(steps),
        device_nodes=dev_nodes,
        device_seconds=dt,
        nodes_per_sec=dev_nodes / dt if dt > 0 else float("inf"),
        lane_efficiency=dev_nodes / (int(steps) * nlanes) if steps else 0.0,
    )
    return result


def uts_vec(
    params: UTSParams,
    target_roots: int = 16 * NLANES,
    max_steps: Optional[int] = None,
    device="cuda",
    lanes: Tuple[int, int] = LANES,
    min_idle_div: int = 8,
    depth_bound: Optional[int] = None,
    stack_pad: Optional[int] = None,
    timing_reps: Optional[int] = None,
    table_cols: Optional[int] = None,
) -> dict:
    """Run UTS with the lockstep engine on ``device``; returns counts and
    timing as the JAX ``uts_vec`` does.

    The host BFS-expands the tree top until >= target_roots frontier nodes
    (counting that part itself), then the lanes traverse the subtrees,
    claiming roots from the shared queue as they drain. EXPDEC (whose
    branching never reaches zero) uses ``depth_bound`` (default
    8*gen_mx) and raises if the tree reaches it."""
    dev = resolve_device(device)
    seed, result = seed_result(params, target_roots)
    if seed[5] is None:
        return result
    if max_steps is None:
        max_steps = (1 << 31) - 1
    sg = stage_roots(params, seed[3], seed[4], seed[5], lanes, depth_bound,
                     stack_pad, table_cols)
    args, kw = sg.engine_args(dev, max_steps, lanes)
    outs, dev_nodes, dt = timed_best(
        lambda: _uts_dfs(*args, min_idle_div=min_idle_div, **kw),
        resolve_timing_reps(timing_reps, dev.type == "cuda"),
        warm=dev.type == "cuda",
    )
    return finish_result(result, seed, sg, outs, dev_nodes, dt,
                         lanes[0] * lanes[1], "uts_vec", max_steps)
