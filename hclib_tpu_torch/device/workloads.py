"""Task bodies of the benchmark workloads: fib and the seeded UTS tree,
scalar and batched (port of ``hclib_tpu/device/workloads.py``).

The bodies below are the plain versions; the kernel runs the same code as
``fib_body`` / ``sum_body`` / ``uts_node_body`` and the batched
``fib_batch`` / ``uts_node_batch`` in ``csrc/megakernel.cu``.
``batch_width`` routes FIB (SUM stays scalar) or the UTS node through the
batch tier, as ``batch_of`` does in JAX: one batch round runs the scalar
body on each live slot's row in slot order, bit-identical to scalar
dispatch. ``device_vfib`` and ``device_nqueens`` run one seed descriptor
whose whole subtree goes through the vector tier (``vector_engine.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .descriptor import TaskGraphBuilder
from .megakernel import (VBLOCK, BatchContext, BatchSpec, KernelContext,
                         Megakernel, fault_mix)
from .vector_engine import fib_spec, nqueens_spec

__all__ = [
    "FIB", "SUM", "UTS_NODE", "device_fib", "make_fib_megakernel",
    "make_uts_megakernel", "device_uts_mk", "fib_body", "sum_body",
    "uts_node_body", "fib_batch_body", "uts_node_batch_body", "batch_of",
    "VFIB", "make_vfib_megakernel", "device_vfib", "VNQUEENS",
    "device_nqueens",
]


def batch_of(name: str, width: int = 8) -> Dict[str, BatchSpec]:
    """The route of JAX's ``batch_of(scalar_kernel, width)``: kind
    ``name`` through the batch tier, whose batched body runs the scalar
    body once per live slot (``fib_batch`` / ``uts_node_batch``)."""
    return {name: BatchSpec(width=width)}


def _per_slot(body, ctx: BatchContext) -> None:
    for s in range(ctx.count):
        body(ctx.slot_ctx(s))


# ------------------------------------------------------------------- fib

FIB = 0
SUM = 1


def fib_body(ctx: KernelContext) -> None:
    n = ctx.arg(0)
    if n < 2:
        ctx.set_out(n)
        return
    # SUM is this task's continuation: it inherits our successors and
    # produces our output slot; the children write into the value block
    # owned by SUM's row. Spawn order (SUM, FIB(n-1), FIB(n-2)) is the
    # JAX body's, which the pop order and the task table follow.
    sum_idx = ctx.spawn(ctx.fn_id("sum"), dep_count=2, out=ctx.out_slot,
                        nargs=0)
    ctx.take_continuation(sum_idx)
    base = ctx.row_values(sum_idx)
    ctx.set_arg(sum_idx, 0, base)
    ctx.set_arg(sum_idx, 1, base + 1)
    ctx.spawn(ctx.fn_id("fib"), [n - 1], succ0=sum_idx, out=base, nargs=1)
    ctx.spawn(ctx.fn_id("fib"), [n - 2], succ0=sum_idx, out=base + 1,
              nargs=1)


def sum_body(ctx: KernelContext) -> None:
    ctx.set_out(ctx.value(ctx.arg(0)) + ctx.value(ctx.arg(1)))


def fib_batch_body(ctx: BatchContext) -> None:
    _per_slot(fib_body, ctx)


def make_fib_megakernel(
    capacity: int = 768,
    num_values: Optional[int] = None,
    batch_width: Optional[int] = None,
    device="cuda",
) -> Megakernel:
    need = VBLOCK * capacity + 16  # 16 host slots for presets/outputs
    if num_values is None:
        num_values = need
    elif num_values < need:
        raise ValueError(
            f"fib uses row-owned value blocks: num_values must be >= "
            f"VBLOCK*capacity+16 = {need}, got {num_values}"
        )
    return Megakernel(
        kernels=["fib", "sum"],
        capacity=capacity,
        num_values=num_values,
        succ_capacity=64,
        uses_row_values=True,
        route=batch_of("fib", batch_width) if batch_width else None,
        device=device,
    )


def device_fib(
    n: int,
    capacity: int = 768,
    num_values: Optional[int] = None,
    batch_width: Optional[int] = None,
    device="cuda",
) -> Tuple[int, dict]:
    """Compute fib(n) inside the megakernel by dynamic task spawning."""
    mk = make_fib_megakernel(capacity, num_values=num_values,
                             batch_width=batch_width, device=device)
    b = TaskGraphBuilder()
    b.add(FIB, args=[n], out=0)
    ivalues, _, info = mk.run(b)
    return int(ivalues[0]), info


# ------------------------------------------------------- fib, vector tier

VFIB = 0


def make_vfib_megakernel(
    max_n: int = 32,
    lanes: Tuple[int, int] = (8, 128),
    device="cuda",
    capacity: int = 64,
) -> Megakernel:
    """fib on the vector tier: one seed descriptor in the scalar table,
    its subtree expanded across lanes (the tree lives in per-lane stacks,
    not in descriptor rows, so far larger fibs fit)."""
    return Megakernel(
        kernels=[("vfib", fib_spec(max_n=max_n, lanes=lanes))],
        capacity=capacity,
        num_values=16,
        succ_capacity=8,
        device=device,
    )


def device_vfib(
    n: int,
    lanes: Tuple[int, int] = (8, 128),
    device="cuda",
) -> Tuple[int, dict]:
    """fib(n) through the vector tier; info['executed'] counts the whole
    recursion tree (2*fib(n+1) - 1 tasks)."""
    mk = make_vfib_megakernel(max_n=n + 2, lanes=lanes, device=device)
    b = TaskGraphBuilder()
    b.add(VFIB, args=[n], out=0)
    ivalues, _, info = mk.run(b)
    return int(ivalues[0]), info


# ------------------------------------------------------ UTS, scalar tier

UTS_NODE = 0


def uts_node_body(ctx: KernelContext) -> None:
    """Count this node into slot 0; spawn child c iff
    fault_mix(seed, c, node_id, 0, depth) < q_millis (every child at the
    root), up to max_depth."""
    p = ctx.params
    ctx.set_value(0, ctx.value(0) + 1)
    node_id = ctx.arg(0)
    depth = ctx.arg(1)
    if depth >= p["max_depth"]:
        return
    for c in range(p["m_children"]):
        h = fault_mix(p["seed"], c, node_id, 0, depth)
        if depth == 0 or h < p["q_millis"]:
            ctx.spawn(ctx.fn_id("uts_node"),
                      [node_id * 31 + (7 * c + 1) + depth, depth + 1],
                      nargs=2)


def uts_node_batch_body(ctx: BatchContext) -> None:
    _per_slot(uts_node_body, ctx)


def make_uts_megakernel(
    seed: int = 19,
    q_millis: int = 440,
    m_children: int = 4,
    max_depth: int = 12,
    capacity: int = 1024,
    batch_width: Optional[int] = None,
    device="cuda",
    **later,
) -> Megakernel:
    """Seeded unbalanced-tree search (see the JAX docstring); the tree is
    a pure function of the seed."""
    return Megakernel(
        kernels=["uts_node"],
        capacity=capacity,
        num_values=16,
        succ_capacity=8,
        params={"seed": seed, "q_millis": q_millis,
                "m_children": m_children, "max_depth": max_depth},
        route=batch_of("uts_node", batch_width) if batch_width else None,
        device=device,
        **later,
    )


def device_uts_mk(
    seed: int = 19,
    mk: Optional[Megakernel] = None,
    device="cuda",
    **mk_kw,
) -> Tuple[int, dict]:
    """Run the seeded UTS tree to completion; returns (nodes, info)."""
    if mk is None:
        mk = make_uts_megakernel(seed=seed, device=device, **mk_kw)
    b = TaskGraphBuilder()
    b.add(UTS_NODE, args=[1, 0])
    ivalues, _, info = mk.run(b)
    return int(ivalues[0]), info


# --------------------------------------------------- n-queens, vector tier

VNQUEENS = 0


def device_nqueens(
    n: int,
    lanes: Tuple[int, int] = (8, 128),
    device="cuda",
) -> Tuple[int, dict]:
    """n-queens solutions through the vector tier; info['executed'] counts
    the safe partial placements (the search tree) plus the seed task."""
    mk = Megakernel(
        kernels=[("vnqueens", nqueens_spec(n, lanes=lanes))],
        capacity=64,
        num_values=16,
        succ_capacity=8,
        device=device,
    )
    b = TaskGraphBuilder()
    b.add(VNQUEENS, args=[0], out=0)
    ivalues, _, info = mk.run(b)
    return int(ivalues[0]), info
