"""Task bodies of the benchmark workloads: fib and the seeded UTS tree,
scalar and batched, the forasync tile loops and arrayadd (port of
``hclib_tpu/device/workloads.py``).

The bodies below are the plain versions; the kernel runs the same code as
``fib_body`` / ``sum_body`` / ``uts_node_body`` and the batched
``fib_batch`` / ``uts_node_batch`` in ``csrc/megakernel.cu``.
``batch_width`` routes FIB (SUM stays scalar) or the UTS node through the
batch tier, as ``batch_of`` does in JAX: one batch round runs the scalar
body on each live slot's row in slot order, bit-identical to scalar
dispatch. ``device_vfib`` and ``device_nqueens`` run one seed descriptor
whose whole subtree goes through the vector tier (``vector_engine.py``).
``stencil_loop`` and ``map_loop`` are the forasync tier's two int32
loops (``forasync_tier.py``), with their numpy references and data
factories copied from the JAX package (same inputs from the same seed);
``device_arrayadd`` runs one ``add_tile`` task per (8, 128) f32 block.
``rmat_edges`` is the frontier tier's seeded R-MAT edge factory, copied
word for word so both packages draw the same graph from the same seed.
The host-runtime bodies ``stencil_body`` / ``map_body`` wait for the
host runtime (ROADMAP A13).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .descriptor import TaskGraphBuilder
from .megakernel import (VBLOCK, BatchContext, BatchSpec, KernelContext,
                         Megakernel, fault_mix)
from .vector_engine import fib_spec, nqueens_spec

__all__ = [
    "FIB", "SUM", "UTS_NODE", "device_fib", "make_fib_megakernel",
    "make_uts_megakernel", "device_uts_mk", "fib_body", "sum_body",
    "uts_node_body", "fib_batch_body", "uts_node_batch_body", "batch_of",
    "VFIB", "make_vfib_megakernel", "device_vfib", "VNQUEENS",
    "device_nqueens", "MAP_MUL", "MAP_ADD", "stencil_loop",
    "stencil_reference", "stencil_data", "map_loop", "map_reference",
    "map_data", "ADD_TILE", "make_arrayadd_megakernel", "device_arrayadd",
    "rmat_edges",
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
    trace=None,
    batch_width: Optional[int] = None,
    checkpoint: Optional[bool] = None,
    device="cuda",
    quiesce_stride: Optional[int] = None,
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
        trace=trace,
        checkpoint=checkpoint,
        quiesce_stride=quiesce_stride,
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
    trace=None,
    checkpoint: Optional[bool] = None,
    quiesce_stride: Optional[int] = None,
    batch_width: Optional[int] = None,
    device="cuda",
    **later,
) -> Megakernel:
    """Seeded unbalanced-tree search (see the JAX docstring); the tree is
    a pure function of the seed. ``trace`` / ``checkpoint`` /
    ``quiesce_stride`` are the Megakernel's (the traversal is what the
    checkpoint tests quiesce mid-tree)."""
    return Megakernel(
        kernels=["uts_node"],
        capacity=capacity,
        num_values=16,
        succ_capacity=8,
        params={"seed": seed, "q_millis": q_millis,
                "m_children": m_children, "max_depth": max_depth},
        route=batch_of("uts_node", batch_width) if batch_width else None,
        trace=trace,
        checkpoint=checkpoint,
        quiesce_stride=quiesce_stride,
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


# --------------------------------------- forasync tile loops (device tier)
#
# The two acceptance workloads of the forasync device tier
# (forasync_tier.py): a 2D Jacobi-style 5-point stencil and a map-style
# batched-apply loop. Both are int32, so the scalar and batched arms are
# bit-identical (no float summation-order caveats); inputs are bounded so
# no arithmetic wraps.

MAP_MUL = 3
MAP_ADD = 7


def stencil_loop(H: int, W: int, th: int = 8, tw: int = 128):
    """2D Jacobi-style stencil over an (H, W) interior held in (H+2, W+2)
    halo-padded int32 grids ``gin`` -> ``gout``:

        gout[i, j] = gin[i, j] + gin[i-1, j] + gin[i+1, j]
                   + gin[i, j-1] + gin[i, j+1]      (padded coordinates)

    Returns ``(tile_kernel, bounds, tile)`` for the forasync entry
    points. Each (th, tw) tile's operand slab is the (th+2, tw+2) window
    around it: interior row i lives at padded row i+1, so the slab around
    interior rows [lo0, lo0+th) is padded rows [lo0, lo0+th+2), and the
    store window starts at (lo0+1, lo1+1)."""
    from .forasync_tier import Slab, TileKernel, affine

    pad = ((H + 2, W + 2), torch.int32)
    lo0, lo1 = affine(0, 1), affine(0, 0, 1)
    tk = TileKernel(
        loads=[Slab("vin", "gin", (lo0, lo1), (th + 2, tw + 2))],
        stores=[Slab("vout", "gout", (affine(0, 1, const=1),
                                      affine(0, 0, 1, const=1)), (th, tw))],
        data_specs={"gin": pad, "gout": pad},
        name="fa_stencil",
    )
    return tk, [H, W], [th, tw]


def stencil_reference(gin: np.ndarray) -> np.ndarray:
    """Vectorized numpy oracle (padded in -> padded out, halo zero)."""
    out = np.zeros_like(gin)
    out[1:-1, 1:-1] = (
        gin[1:-1, 1:-1] + gin[:-2, 1:-1] + gin[2:, 1:-1]
        + gin[1:-1, :-2] + gin[1:-1, 2:]
    )
    return out


def stencil_data(H: int, W: int, seed: int = 0):
    """Padded (gin, gout) int32 grids; values bounded so the 5-point sum
    never wraps."""
    rng = np.random.default_rng(seed)
    gin = np.zeros((H + 2, W + 2), np.int32)
    gin[1:-1, 1:-1] = rng.integers(0, 1 << 20, size=(H, W), dtype=np.int32)
    return gin, np.zeros_like(gin)


def map_loop(T: int, th: int = 8, tw: int = 128):
    """Map-style batched-apply loop (the batched-inference shape): block
    t of the (T, th, tw) int32 input maps elementwise through
    ``x * MAP_MUL + MAP_ADD`` into the output block. The 1D loop runs
    over all T*th*tw elements with one (th*tw)-element tile per block,
    so the flat tile index IS the block index."""
    from .forasync_tier import Slab, TileKernel, affine

    spec = ((T, th, tw), torch.int32)
    block = (affine(1), 0, 0)
    tk = TileKernel(
        loads=[Slab("vin", "vin", block, (th, tw))],
        stores=[Slab("vout", "vout", block, (th, tw))],
        data_specs={"vin": spec, "vout": spec},
        name="fa_map",
    )
    return tk, [T * th * tw], [th * tw]


def map_reference(vin: np.ndarray) -> np.ndarray:
    return (vin * MAP_MUL + MAP_ADD).astype(np.int32)


def map_data(T: int, th: int = 8, tw: int = 128, seed: int = 0):
    rng = np.random.default_rng(seed)
    vin = rng.integers(0, 1 << 20, size=(T, th, tw), dtype=np.int32)
    return vin, np.zeros_like(vin)


# --------------------------------------------------------------- arrayadd

ADD_TILE = 0
_TILE = (8, 128)  # the f32 tile of the JAX body


def make_arrayadd_megakernel(ntiles: int, device="cuda") -> Megakernel:
    """The scalar table of arrayadd: ``add_tile`` tasks, arg0 the block
    index t of the (ntiles, 8, 128) f32 buffers a, b, c; each loads
    a[t] and b[t] and stores c[t] = a[t] + b[t]."""
    from .forasync_tier import Slab, affine

    spec = ((ntiles,) + _TILE, torch.float32)
    block = (affine(1), 0, 0)
    return Megakernel(
        kernels=["add_tile"],
        data_specs={"a": spec, "b": spec, "c": spec},
        slabs=([Slab("va", "a", block, _TILE), Slab("vb", "b", block, _TILE)],
               [Slab("vc", "c", block, _TILE)]),
        capacity=max(64, ntiles),
        num_values=8,
        succ_capacity=8,
        device=device,
    )


def device_arrayadd(ntiles: int = 16, device="cuda"):
    """c = a + b over (ntiles, 8, 128) f32 blocks, one tile task per
    block; a and b are ``default_rng(0)`` standard normals, as in JAX.
    Returns (a, b, c, info): a and b numpy, c a tensor on the device."""
    shape = (ntiles,) + _TILE
    mk = make_arrayadd_megakernel(ntiles, device=device)
    b = TaskGraphBuilder()
    for t in range(ntiles):
        b.add(ADD_TILE, args=[t])
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape).astype(np.float32)
    bb = rng.standard_normal(shape).astype(np.float32)
    c = np.zeros(shape, dtype=np.float32)
    _, data, info = mk.run(b, data={"a": a, "b": bb, "c": c})
    return a, bb, data["c"], info


# ------------------------------------------------- R-MAT graph generator


def rmat_edges(
    scale: int,
    efactor: int = 8,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    max_weight: int = 16,
):
    """Seeded R-MAT-style edge list over ``N = 2**scale`` vertices with
    ``efactor * N`` samples (self-loops dropped, duplicates merged, so
    the returned edge count is a bit lower). Returns ``(n, src, dst,
    weights)`` int32 arrays - weights uniform in [1, max_weight], for
    the SSSP arm. Pure function of the arguments (one seeded
    Generator), so every arm rebuilds the identical graph."""
    if scale < 1:
        raise ValueError(f"rmat scale must be >= 1, got {scale}")
    n = 1 << scale
    ne = int(efactor) * n
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, np.int64)
    dst = np.zeros(ne, np.int64)
    d = 1.0 - a - b - c
    if d <= 0:
        raise ValueError(f"rmat quadrants must leave d > 0, got {d}")
    for _ in range(scale):
        sb = rng.random(ne) >= (a + b)  # src bit: lower half vs upper
        pd = np.where(sb, d / (c + d), b / (a + b))
        db = rng.random(ne) < pd
        src = (src << 1) | sb
        dst = (dst << 1) | db
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    src = (key // n).astype(np.int32)
    dst = (key % n).astype(np.int32)
    w = rng.integers(1, max_weight + 1, size=len(src)).astype(np.int32)
    return n, src, dst, w
