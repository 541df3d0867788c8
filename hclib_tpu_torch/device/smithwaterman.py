"""Smith-Waterman wavefront inside the megakernel (port of
``hclib_tpu/device/smithwaterman.py``).

Tile tasks on the 2D DDF grid of the reference workload. Every engine
runs the same tile DP: rows top to bottom, and in each row the
left-to-right dependency H[i,j] = max(0, cand[i,j], H[i,j-1] - G) solved
exactly as a max-plus prefix scan, H = max(0, cummax(cand + j*G) - j*G),
with the row's left boundary entering as an extra candidate at column 0.
Inter-tile boundaries travel through their own buffers: ``bot`` (a tile's
last row), ``right`` (its last column) and the corner, lane T-1 of the
diagonal neighbour's ``right``. The best score accumulates in
``ivalues[0]``.

Three engines, each returning ``(score, H or None, info)``:

- ``device_sw``: one tile a task on the 3-neighbour DAG, scalar body
  ``sw_tile``.
- ``device_sw_wave``: wave-chunk tasks (up to ``WAVE_R`` tiles of one
  anti-diagonal, args [w, lo, cnt]) chained wave to wave, batch-routed to
  ``sw_wave_batch`` with the cross-round prefetch and its drain
  (``WAVE_B`` descriptors a round).
- ``device_sw_batched``: the per-tile DAG as the chunk=1 case of the wave
  body, grouped by the scheduler's lane.

The plain versions below (``sw_rows_plain`` and the bodies) run the DP as
a torch row loop over stacked (S, T) planes with ``torch.cummax``; the
kernel is ``sw_tile_dp`` in ``csrc/megakernel.cu``.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.smithwaterman import GAP, MATCH, MISMATCH
from .descriptor import TaskGraphBuilder
from .megakernel import BatchContext, BatchSpec, KernelContext, Megakernel

__all__ = [
    "T", "WAVE_R", "WAVE_B", "WAVE_FN", "TILE_FN", "device_sw",
    "make_sw_megakernel", "device_sw_wave", "make_sw_wave_megakernel",
    "build_sw_wave_graph", "sw_wave_buffers", "device_sw_batched",
    "make_sw_batched_megakernel", "build_sw_tile_graph", "build_sw_graph",
    "sw_rows_plain",
]

T = 128
TILE_FN = 0
WAVE_R = 8  # tile slots per wave-chunk descriptor
WAVE_FN = 0
WAVE_B = 2  # chunk descriptors per batch round (16 tile slots)

_I32 = torch.int32


# ------------------------------------------------------------ plain DP


def sw_rows_plain(a, b, top, left, corner, with_h: bool):
    """The tile DP over S stacked tiles: ``a``/``b`` (S, T) characters,
    ``top`` (S, T) the row above, ``left`` (S, T) the column to the left,
    ``corner`` (S,) the diagonal corner. Returns (last row (S, T), last
    column (S, T), H (S, T, T) or None, each tile's max (S,))."""
    S = a.shape[0]
    lane = torch.arange(T, dtype=_I32)
    match = torch.tensor(MATCH, dtype=_I32)
    mismatch = torch.tensor(MISMATCH, dtype=_I32)
    h = top.clone()
    rout = torch.zeros((S, T), dtype=_I32)
    hs = torch.empty((S, T, T), dtype=_I32) if with_h else None
    mx = torch.zeros((S, T), dtype=_I32)
    for i in range(T):
        prev_left = corner if i == 0 else left[:, i - 1]
        sub = torch.where(b == a[:, i:i + 1], match, mismatch)
        diag = torch.cat([prev_left[:, None], h[:, :-1]], dim=1)
        cand = torch.maximum(diag + sub, h - GAP)
        cand[:, 0] = torch.maximum(cand[:, 0], left[:, i] - GAP)
        h = torch.clamp_min(torch.cummax(cand + lane, dim=1).values - lane, 0)
        if with_h:
            hs[:, i] = h
        rout[:, i] = h[:, T - 1]
        mx = torch.maximum(mx, h)
    return h, rout, hs, mx.amax(dim=1)


def _operands(d, ti: int, tj: int):
    """One tile's (a, b, top, left, corner-row) rows from the buffers."""
    z = torch.zeros(T, dtype=_I32)
    return (d["aseq"][ti, 0], d["bseq"][tj, 0],
            d["bot"][ti - 1, tj, 0] if ti > 0 else z,
            d["right"][ti, tj - 1, 0] if tj > 0 else z,
            d["right"][ti - 1, tj - 1, 0] if ti > 0 and tj > 0 else z)


def _publish(ctx, ti: int, tj: int, last, rcol, h, m) -> None:
    d = ctx.data
    d["bot"][ti, tj, 0] = last
    d["right"][ti, tj, 0] = rcol
    if h is not None:
        d["htiles"][ti, tj] = h
    ctx.set_value(0, max(ctx.value(0), int(m)))


def sw_tile_body(ctx: KernelContext) -> None:
    """Plain ``sw_tile``: tile (arg0, arg1)."""
    ti, tj = ctx.arg(0), ctx.arg(1)
    a, b, top, left, corn = _operands(ctx.data, ti, tj)
    last, rcol, h, m = sw_rows_plain(a[None], b[None], top[None], left[None],
                                     corn[T - 1:], "htiles" in ctx.data)
    _publish(ctx, ti, tj, last[0], rcol[0], None if h is None else h[0],
             m[0])


_PARTS = ("a", "b", "top", "left", "corn")


def _load_chunk(ctx: BatchContext, half, b: int, w: int, lo: int,
                cnt: int) -> None:
    """Descriptor ``b``'s tiles (lo+s, w-lo-s), s < cnt, into its slots of
    operand half ``half``; its slots past cnt are zeroed."""
    chunk = ctx.params["chunk"]
    for s in range(chunk):
        slot = b * chunk + s
        if s < cnt:
            for part, row in zip(_PARTS, _operands(ctx.data, lo + s,
                                                   w - lo - s)):
                half[part][slot] = row
        else:
            _zero_slot(half, slot)


def _zero_slot(half, slot: int) -> None:
    """Dead slot: zero planes, and b = -1 so no character matches."""
    for part in _PARTS:
        half[part][slot] = 0
    half["b"][slot] = -1


def sw_wave_batch_body(ctx: BatchContext) -> None:
    """Plain ``sw_wave_batch``: descriptors [w, lo, cnt] with the
    cross-round prefetch protocol of JAX's ``_sw_wave_batch_kernel``."""
    chunk, width = ctx.params["chunk"], ctx.width
    halves = ctx.scratch.get("sw")
    if halves is None:
        halves = ctx.scratch["sw"] = [
            {p: torch.zeros((width * chunk, T), dtype=_I32) for p in _PARTS}
            for _ in range(2)
        ]
    cur = halves[ctx.buf]
    # Load what last round's prefetch did not cover; zero dead slots.
    for b in range(width):
        if not ctx.live(b):
            for s in range(chunk):
                _zero_slot(cur, b * chunk + s)
        elif b >= ctx.prefetched:
            _load_chunk(ctx, cur, b, *(ctx.arg(b, i) for i in range(3)))
    # The next batch's operands into the other half.
    for b in range(ctx.prefetch_count):
        _load_chunk(ctx, halves[1 - ctx.buf], b,
                    *(ctx.next_arg(b, i) for i in range(3)))
    with_h = "htiles" in ctx.data
    last, rcol, h, m = sw_rows_plain(cur["a"], cur["b"], cur["top"],
                                     cur["left"], cur["corn"][:, T - 1],
                                     with_h)
    for b in range(ctx.count):
        w, lo, cnt = (ctx.arg(b, i) for i in range(3))
        for s in range(min(cnt, chunk)):
            slot = b * chunk + s
            _publish(ctx, lo + s, w - lo - s, last[slot], rcol[slot],
                     h[slot] if with_h else None, m[slot])
        # A descriptor counts as cnt tiles, so 'executed' counts tiles.
        ctx.add_executed(cnt - 1)


def sw_wave_batch_drain(ctx: BatchContext) -> None:
    """Plain drain: the plain loads are done when issued, so nothing is in
    flight (the kernel waits its prefetch copies here)."""


# ------------------------------------------------------------ the graphs


def build_sw_wave_graph(nt_i: int, nt_j: int,
                        chunk: int = WAVE_R) -> TaskGraphBuilder:
    """Wave-chunk task DAG: up to ``chunk`` tiles of one anti-diagonal per
    task, consecutive anti-diagonals chained by dependencies."""
    builder = TaskGraphBuilder()
    prev_wave: list = []
    for w in range(nt_i + nt_j - 1):
        lo = max(0, w - (nt_j - 1))
        hi = min(nt_i - 1, w)
        this_wave = []
        for base in range(lo, hi + 1, chunk):
            cnt = min(chunk, hi + 1 - base)
            this_wave.append(
                builder.add(WAVE_FN, args=[w, base, cnt], deps=prev_wave)
            )
        prev_wave = this_wave
    return builder


def _tile_graph(nt_i: int, nt_j: int, fn: int, args) -> TaskGraphBuilder:
    builder = TaskGraphBuilder()
    ids: dict = {}
    for ti in range(nt_i):
        for tj in range(nt_j):
            deps = [
                ids[key]
                for key in ((ti - 1, tj), (ti, tj - 1), (ti - 1, tj - 1))
                if key in ids
            ]
            ids[(ti, tj)] = builder.add(fn, args=args(ti, tj), deps=deps)
    return builder


def build_sw_graph(nt_i: int, nt_j: int) -> TaskGraphBuilder:
    """The per-tile DAG of ``device_sw``: descriptors [ti, tj] for the
    scalar ``sw_tile`` body."""
    return _tile_graph(nt_i, nt_j, TILE_FN, lambda ti, tj: [ti, tj])


def build_sw_tile_graph(nt_i: int, nt_j: int) -> TaskGraphBuilder:
    """Per-tile DAG with the 3-neighbour dependencies; descriptors carry
    [w, lo, 1] so the wave body runs them as its chunk=1 case."""
    return _tile_graph(nt_i, nt_j, WAVE_FN, lambda ti, tj: [ti + tj, ti, 1])


def sw_wave_buffers(a: np.ndarray, b: np.ndarray) -> dict:
    """Host data buffers (without the optional H matrix): sequences in
    row-tile layout + the boundary channels (numpy, as JAX's)."""
    nt_i, nt_j = len(a) // T, len(b) // T
    i32 = np.int32
    return {
        "aseq": np.asarray(a, i32).reshape(nt_i, 1, T),
        "bseq": np.asarray(b, i32).reshape(nt_j, 1, T),
        "bot": np.zeros((nt_i, nt_j, 1, T), i32),
        "right": np.zeros((nt_i, nt_j, 1, T), i32),
    }


def _data_specs(nt_i: int, nt_j: int, with_h: bool) -> dict:
    specs = {
        "aseq": ((nt_i, 1, T), _I32),
        "bseq": ((nt_j, 1, T), _I32),
        "bot": ((nt_i, nt_j, 1, T), _I32),
        "right": ((nt_i, nt_j, 1, T), _I32),
    }
    if with_h:
        specs["htiles"] = ((nt_i, nt_j, T, T), _I32)
    return specs


# -------------------------------------------------------- the megakernels


def _sw_batch_megakernel(nt_i: int, nt_j: int, with_h: bool, chunk: int,
                         width: int, capacity: int, succ_capacity: int,
                         device, checkpoint=None, trace=None) -> Megakernel:
    return Megakernel(
        kernels=["sw_wave"],
        route={"sw_wave": BatchSpec(width, prefetch=True)},
        data_specs=_data_specs(nt_i, nt_j, with_h),
        capacity=capacity,
        num_values=8,
        succ_capacity=succ_capacity,
        params={"nt_j": nt_j, "chunk": chunk},
        device=device,
        checkpoint=checkpoint,
        trace=trace,
    )


def make_sw_wave_megakernel(nt_i: int, nt_j: int, with_h: bool = True,
                            chunk: int = WAVE_R, width: int = WAVE_B,
                            device="cuda", checkpoint: Optional[bool] = None,
                            trace=None) -> Megakernel:
    nwaves = nt_i + nt_j - 1
    chunks = [
        -(-min(w + 1, nt_i, nt_j, nt_i + nt_j - 1 - w) // chunk)
        for w in range(nwaves)
    ]
    # Every wave-w chunk lists ALL wave-(w+1) chunks as successors (2
    # inline, the rest in the CSR).
    csr_words = sum(
        chunks[w] * max(0, chunks[w + 1] - 2) for w in range(nwaves - 1)
    )
    return _sw_batch_megakernel(
        nt_i, nt_j, with_h, chunk, width, capacity=max(64, sum(chunks)),
        succ_capacity=max(64, csr_words), device=device,
        checkpoint=checkpoint, trace=trace,
    )


def make_sw_batched_megakernel(nt_i: int, nt_j: int, with_h: bool = True,
                               width: int = WAVE_R,
                               device="cuda") -> Megakernel:
    """The per-tile graph through the wave body at chunk=1, ``width``
    tiles a round."""
    ntasks = nt_i * nt_j
    return _sw_batch_megakernel(
        nt_i, nt_j, with_h, chunk=1, width=width, capacity=max(64, ntasks),
        succ_capacity=max(64, 3 * ntasks), device=device,
    )


def make_sw_megakernel(nt_i: int, nt_j: int, with_h: bool = True,
                       device="cuda") -> Megakernel:
    return Megakernel(
        kernels=["sw_tile"],
        data_specs=_data_specs(nt_i, nt_j, with_h),
        capacity=max(64, nt_i * nt_j),
        num_values=8,
        succ_capacity=max(64, 3 * nt_i * nt_j),
        params={"nt_j": nt_j},
        device=device,
    )


def _grid(a, b) -> Tuple[int, int]:
    n, m = len(a), len(b)
    if n % T or m % T:
        raise ValueError(f"sequence lengths must be multiples of {T}")
    return n // T, m // T


def _run(mk: Megakernel, builder, a, b):
    nt_i, nt_j = _grid(a, b)
    data = sw_wave_buffers(a, b)
    if "htiles" in mk.data_specs:
        data["htiles"] = np.zeros((nt_i, nt_j, T, T), np.int32)
    t0 = time.perf_counter()
    ivalues, out, info = mk.run(builder, data=data)  # reads back: syncs
    dt = time.perf_counter() - t0
    n, m = len(a), len(b)
    h = (out["htiles"].transpose(1, 2).reshape(n, m)
         if "htiles" in out else None)
    info = dict(info)
    info["seconds"] = dt
    info["cells_per_sec"] = n * m / dt
    return int(ivalues[0]), h, info


def device_sw(a: np.ndarray, b: np.ndarray, mk: Optional[Megakernel] = None,
              with_h: bool = True, device="cuda"):
    """Tiled SW, one tile a task; returns (best score, H[1:, 1:] as a
    tensor on the run's device or None, info)."""
    nt_i, nt_j = _grid(a, b)
    if mk is None:
        mk = make_sw_megakernel(nt_i, nt_j, with_h=with_h, device=device)
    return _run(mk, build_sw_graph(nt_i, nt_j), a, b)


def device_sw_wave(a: np.ndarray, b: np.ndarray,
                   mk: Optional[Megakernel] = None, with_h: bool = True,
                   device="cuda"):
    """Tiled SW, one wave chunk (up to WAVE_R tiles of an anti-diagonal) a
    task, anti-diagonals chained; same results as ``device_sw``."""
    nt_i, nt_j = _grid(a, b)
    if mk is None:
        mk = make_sw_wave_megakernel(nt_i, nt_j, with_h=with_h,
                                     device=device)
    # The graph's chunk is the megakernel's (its slot layout).
    return _run(mk, build_sw_wave_graph(nt_i, nt_j, mk.params["chunk"]), a, b)


def device_sw_batched(a: np.ndarray, b: np.ndarray,
                      mk: Optional[Megakernel] = None, with_h: bool = True,
                      width: int = WAVE_R, device="cuda"):
    """Tiled SW, one tile a task on the 3-neighbour DAG, up to ``width``
    ready tiles a round through the wave body; same results as
    ``device_sw``, ``info['tiers']`` holds the lane counters."""
    nt_i, nt_j = _grid(a, b)
    if mk is None:
        mk = make_sw_batched_megakernel(nt_i, nt_j, with_h=with_h,
                                        width=width, device=device)
    return _run(mk, build_sw_tile_graph(nt_i, nt_j), a, b)
