"""forasync device tier: tile loops lowered onto the batch-lane dispatcher
(port of ``hclib_tpu/device/forasync_tier.py``).

Every tile of a FLAT 1-3-D iteration space becomes one task descriptor
with args ``[flat, lo0, lo1, lo2]``, and because all tiles of one loop
share one body, a tile IS a same-kind batch: ``width=0`` dispatches one
tile a scalar round (the bit-identity reference arm); ``width>0`` routes
the kind through the batch lanes, whose rounds run up to ``width`` tiles
with the cross-round double-buffered operand prefetch (the default:
width 8, ``prefetch=True``).

A ``TileKernel`` is a slab pipeline: its load slabs (windows of named
data buffers placed by the tile's args), its family's arithmetic, and its
store slab. What differs from the JAX class:

- CUDA cannot take the JAX ``compute`` closure, so a ``TileKernel`` names
  a compiled tile family (``TILE_FAMILIES``: the 5-point stencil and the
  map loop of ``workloads.py``), whose arithmetic is compiled into
  ``csrc/forasync.cuh`` and whose plain torch compute runs on the CPU. A
  family that is not compiled raises ``NotImplementedError`` (user-defined
  CUDA bodies are ROADMAP A4).
- JAX's ``Slab.index`` lambdas cannot cross to the card either, so a
  ``Slab`` states its window as data: one start per buffer dimension,
  each a constant or an affine form of the 4 arg words (``affine``), and
  a static shape of rank 1 or 2 on the buffer's trailing dimensions. The
  megakernel carries these as slab words, which the CUDA pipeline and the
  plain one below both read.
- Data buffers are updated in place (a tensor already on the run's
  device is written; numpy inputs are copied in), as JAX's interpret
  mode aliases them: an output's untouched cells keep their input values.
- ``placement=`` / ``mesh=`` (``place_tiles``, ``MeshPlacement``, the
  steal exchange) raise ``NotImplementedError``: the multi-device runners
  are ROADMAP A11. Tiles stay on one device here.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..runtime.env import env_int
from .descriptor import TaskGraphBuilder
from .megakernel import (BATCH_BODIES, MAX_DATA, SL_BUF, SL_C0, SL_COLS,
                         SL_K, SL_LD, SL_ROWS, SLAB_HDR, SLAB_WORDS,
                         TILE_BODIES, BatchSpec, Megakernel)
from .workloads import MAP_ADD, MAP_MUL

__all__ = [
    "FA_TILE", "TILE_FAMILIES", "affine", "Slab", "TileKernel", "tile_grid",
    "tile_args", "tile_arg_table", "seed_tiles", "check_windows",
    "make_forasync_megakernel", "run_forasync_device", "tile_rounds",
    "plain_tile_bodies",
]

# The tile kernel's table index: the tier builds single-kind megakernels
# (one loop body per kernel), so the id is fixed.
FA_TILE = 0


# ------------------------------------------------------------- tiling math


def tile_grid(
    bounds: Sequence, tile: Sequence
) -> Tuple[List[Tuple[int, int]], List[int], List[int], int]:
    """Normalize (bounds, tile) into (dims, tile_dims, tile_counts,
    total) with the EXACT-DIVISION constraint the device tier needs:
    slab shapes are static per kernel, so a ragged last tile (which the
    host tier handles by clamping) is refused with a sizing hint."""
    dims: List[Tuple[int, int]] = []
    for b in bounds:
        if isinstance(b, int):
            dims.append((0, b))
        else:
            lo, hi = b
            dims.append((int(lo), int(hi)))
    if not 1 <= len(dims) <= 3:
        raise ValueError("forasync supports 1-3 dimensions")
    if isinstance(tile, int):
        tile_dims = [tile] * len(dims)
    else:
        tile_dims = [int(t) for t in tile]
    if len(tile_dims) != len(dims):
        raise ValueError("tile rank must match loop rank")
    counts = []
    for (lo, hi), t in zip(dims, tile_dims):
        n = hi - lo
        if t < 1 or n < 1:
            raise ValueError(f"empty dimension or tile: {(lo, hi)} / {t}")
        if n % t:
            raise ValueError(
                f"device forasync tiles must divide the bounds exactly "
                f"(dimension {(lo, hi)} is {n} long, tile {t}): pad the "
                "iteration space or pick a dividing tile"
            )
        counts.append(n // t)
    return dims, tile_dims, counts, math.prod(counts)


def tile_args(
    dims: Sequence[Tuple[int, int]],
    tile_dims: Sequence[int],
    counts: Sequence[int],
    flat: int,
) -> List[int]:
    """Descriptor args of flat tile ``flat``: ``[flat, lo0, lo1, lo2]``
    (trailing los zero below rank 3) - the lo corner in LOOP coordinates;
    slab starts add their own data-layout offsets."""
    idx = []
    rem = flat
    for c in reversed(list(counts)):
        idx.append(rem % c)
        rem //= c
    idx.reverse()
    los = [lo + i * t for (lo, _), t, i in zip(dims, tile_dims, idx)]
    return [flat] + los + [0] * (3 - len(los))


def seed_tiles(
    builder: TaskGraphBuilder,
    bounds: Sequence,
    tile: Sequence,
    fn: int = FA_TILE,
) -> int:
    """Add one descriptor per flat tile (flat order); returns the total."""
    dims, tile_dims, counts, total = tile_grid(bounds, tile)
    for flat in range(total):
        builder.add(fn, args=tile_args(dims, tile_dims, counts, flat))
    return total


def tile_arg_table(bounds, tile) -> np.ndarray:
    """Every tile's ``tile_args`` as an (total, 4) int64 array, in flat
    order."""
    dims, tile_dims, counts, total = tile_grid(bounds, tile)
    flat = np.arange(total, dtype=np.int64)
    out = np.zeros((total, 4), np.int64)
    out[:, 0] = flat
    for d, ix in enumerate(np.unravel_index(flat, counts)):
        out[:, 1 + d] = dims[d][0] + ix * tile_dims[d]
    return out


# ---------------------------------------------------------- slab pipeline


def affine(*coeffs: int, const: int = 0) -> Tuple[int, ...]:
    """The start ``c0*a0 + c1*a1 + c2*a2 + c3*a3 + const`` over a tile's
    4 arg words (the forasync tier's ``flat, lo0, lo1, lo2``), e.g.
    ``affine(0, 1, const=1)`` for ``lo0 + 1``."""
    if len(coeffs) > 4:
        raise ValueError(f"a tile has 4 arg words, got {len(coeffs)} "
                         "coefficients")
    return tuple(int(c) for c in coeffs) + (0,) * (4 - len(coeffs)) + (
        int(const),)


class Slab:
    """One operand (or output) window of a named data buffer: ``start``
    gives, per buffer dimension, the window's first index (an int or an
    ``affine`` form of the args); ``shape`` is the window on the buffer's
    trailing ``len(shape)`` (1 or 2) dimensions, the leading ones picked
    at their start (JAX's scalar indexers)."""

    def __init__(self, name: str, data: str, start: Sequence,
                 shape: Tuple[int, ...]) -> None:
        self.name = name
        self.data = data
        self.start = tuple(int(s) if isinstance(s, (int, np.integer))
                           else tuple(int(x) for x in s) for s in start)
        self.shape = tuple(int(s) for s in shape)


def _stencil(ins):
    v = ins[0]
    return v[1:-1, 1:-1] + v[:-2, 1:-1] + v[2:, 1:-1] + v[1:-1, :-2] + v[
        1:-1, 2:]


def _map(ins):
    return ins[0] * MAP_MUL + MAP_ADD


def _add(ins):
    return ins[0] + ins[1]


# Family -> the plain compute (load slabs -> the store slab, each a
# (rows, cols) plane); csrc/forasync.cuh tile_value is the kernel's.
TILE_COMPUTE = {"add_tile": _add, "fa_stencil": _stencil, "fa_map": _map}
# The families a forasync TileKernel may name.
TILE_FAMILIES = ("fa_stencil", "fa_map")


class TileKernel:
    """The device body of a forasync tile loop: its load and store slabs
    over the buffers of ``data_specs`` (name -> (shape, torch dtype)) and
    the compiled family ``name`` (``TILE_FAMILIES``), which fixes the
    arithmetic. Output buffers must be written disjointly across tiles
    (the same contract batch bodies always carry)."""

    def __init__(
        self,
        loads: Sequence[Slab],
        stores: Sequence[Slab],
        data_specs: Dict[str, tuple],
        name: str = "fa_tile",
    ) -> None:
        names = [s.name for s in list(loads) + list(stores)]
        if len(set(names)) != len(names):
            raise ValueError(f"slab names must be unique: {names}")
        for s in list(loads) + list(stores):
            if s.data not in data_specs:
                raise ValueError(
                    f"slab {s.name!r} targets undeclared buffer {s.data!r}"
                )
        if name not in TILE_FAMILIES:
            raise NotImplementedError(
                f"tile family {name!r} has no compiled CUDA body (compiled: "
                f"{TILE_FAMILIES}): user-defined CUDA bodies are ROADMAP A4"
            )
        self.loads = list(loads)
        self.stores = list(stores)
        self.data_specs = dict(data_specs)
        self.name = name
        self.out_names = sorted({s.data for s in self.stores})


def check_windows(tk: TileKernel, bounds: Sequence, tile: Sequence) -> None:
    """Every slab of every tile of the loop lies inside its buffer (the
    kernel does not check its addresses); raises ``ValueError``."""
    args = tile_arg_table(bounds, tile)
    for s in tk.loads + tk.stores:
        shape = tuple(tk.data_specs[s.data][0])
        ext = (1,) * (len(shape) - len(s.shape)) + s.shape
        for d, (st, size, e) in enumerate(zip(s.start, shape, ext)):
            aff = (0, 0, 0, 0, st) if isinstance(st, int) else st
            at = args @ np.asarray(aff[:4], np.int64) + aff[4]
            if at.min() < 0 or at.max() + e > size:
                raise ValueError(
                    f"slab {s.name!r} leaves buffer {s.data!r} {shape} "
                    f"along dimension {d}: starts {int(at.min())}.."
                    f"{int(at.max())}, extent {e}")


# -- the plain pipeline (the CPU path), over the same slab words --


def _slab(words, k: int):
    o = SLAB_HDR + SLAB_WORDS * k
    return words[o:o + SLAB_WORDS]


def _window(core, w, a) -> torch.Tensor:
    """Slab ``w``'s window for args ``a``: a (rows, cols) view."""
    flat = core.buffers[w[SL_BUF]].view(-1)
    off = w[SL_K] + sum(c * x for c, x in zip(w[SL_C0:SL_C0 + 4], a))
    return flat.as_strided((w[SL_ROWS], w[SL_COLS]), (w[SL_LD], 1),
                           flat.storage_offset() + off)


def _loads(core, a) -> list:
    """The tile's load slabs, copied (what its DMA puts in VMEM)."""
    words = core.slab_words
    return [_window(core, _slab(words, k), a).clone()
            for k in range(words[0])]


def _store(core, a, out: torch.Tensor) -> None:
    words = core.slab_words
    _window(core, _slab(words, words[0]), a).copy_(out)


def _scalar_body(compute):
    """``scalar_kernel``: load every slab, compute, store."""

    def body(ctx) -> None:
        a = [ctx.arg(i) for i in range(4)]
        _store(ctx.core, a, compute(_loads(ctx.core, a)))

    return body


def _batch_body(compute):
    """``batch_body``'s five phases over plain halves: the slots the last
    round's prefetch did not cover load into half ``buf``; the next
    batch's first ``prefetch_count`` tiles load into the other half (so a
    prefetched slot computes on what was loaded a round earlier); every
    live slot computes; one store wave."""

    def body(ctx) -> None:
        core = ctx.core
        halves = ctx.scratch.setdefault("fa", ({}, {}))
        cur, nxt = halves[ctx.buf], halves[1 - ctx.buf]
        args = [[ctx.arg(b, i) for i in range(4)] for b in range(ctx.count)]
        for b in range(ctx.prefetched, ctx.count):
            cur[b] = _loads(core, args[b])
        for b in range(ctx.prefetch_count):
            nxt[b] = _loads(core, [ctx.next_arg(b, i) for i in range(4)])
        outs = [compute(cur[b]) for b in range(ctx.count)]
        for b, out in enumerate(outs):
            _store(core, args[b], out)

    return body


def _drain(ctx) -> None:
    """``batch_drain``: the plain loads are done when issued, so nothing
    is in flight (the kernel waits its prefetch copies at exit)."""


def plain_tile_bodies() -> Dict[str, object]:
    """The plain tile bodies by body name (megakernel ``BODIES``)."""
    out = {"add_tile": _scalar_body(_add)}
    for fam in TILE_FAMILIES:
        out[fam] = _scalar_body(TILE_COMPUTE[fam])
        out[BATCH_BODIES[fam]] = _batch_body(TILE_COMPUTE[fam])
        out[BATCH_BODIES[fam] + "_drain"] = _drain
    return out


# ------------------------------------------------------------ megakernel


def make_forasync_megakernel(
    tk: TileKernel,
    *,
    width: int = 0,
    prefetch: bool = True,
    capacity: int = 256,
    trace=None,
    checkpoint: Optional[bool] = None,
    quiesce_stride: Optional[int] = None,
    device="cuda",
    **later,
) -> Megakernel:
    """Build the loop's megakernel. ``width=0`` is the scalar-dispatch
    arm (one tile per round - the bit-identity reference); ``width>0``
    routes the tile kind through the batch lanes, with the
    double-buffered operand prefetch on by default. ``trace`` /
    ``checkpoint`` / ``quiesce_stride`` are the Megakernel's; ``later``
    takes JAX's ``verify``, which the port's ``Megakernel`` refuses
    (ROADMAP A13)."""
    route = ({tk.name: BatchSpec(width=width, prefetch=prefetch)}
             if width else None)
    return Megakernel(
        kernels=[tk.name],
        route=route,
        data_specs=tk.data_specs,
        slabs=(tk.loads, tk.stores),
        capacity=capacity,
        num_values=16,
        succ_capacity=8,
        trace=trace,
        checkpoint=checkpoint,
        quiesce_stride=quiesce_stride,
        device=device,
        **later,
    )


def _default_width() -> int:
    """Batch width when the caller leaves it unset: 8, overridable
    process-wide with HCLIB_TPU_FORASYNC_WIDTH (>= 1; malformed values
    raise - a typo must not silently change the dispatch tier)."""
    w = env_int("HCLIB_TPU_FORASYNC_WIDTH", 8)
    if w < 1:
        raise ValueError(
            f"HCLIB_TPU_FORASYNC_WIDTH must be >= 1, got {w!r}"
        )
    return w


def run_forasync_device(
    tk: TileKernel,
    bounds: Sequence,
    tile: Sequence,
    data: Dict[str, object],
    *,
    width: Optional[int] = None,
    prefetch: bool = True,
    placement=None,
    mesh=None,
    capacity: Optional[int] = None,
    fuel: int = 1 << 22,
    mk: Optional[Megakernel] = None,
    trace=None,
    device="cuda",
) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Run one forasync tile loop on the device tier to completion;
    returns ``(data_out, info)`` (the data buffers as tensors on the
    run's device; ``info['trace']`` with ``trace``). Single device only:
    ``placement`` / ``mesh`` raise."""
    if placement is not None or mesh is not None:
        raise NotImplementedError(
            "forasync placement=/mesh= (place_tiles, MeshPlacement and the "
            "steal exchange) is not ported yet: the multi-device runners "
            "are ROADMAP A11"
        )
    w = _default_width() if width is None else int(width)
    _, _, _, total = tile_grid(bounds, tile)
    check_windows(tk, bounds, tile)
    if mk is not None:
        # A prebuilt kernel OWNS the dispatch configuration: the caller's
        # width must agree, so a benchmark arm can never believe it
        # measured the batch tier while running a scalar build (or vice
        # versa) - the results would still be bit-identical, hiding the
        # swap.
        mk_width = mk.batch_specs[0][1].width if mk.batch_specs else 0
        if width is not None and int(width) != mk_width:
            raise ValueError(
                f"width={width} disagrees with the prebuilt megakernel "
                f"(its tile kind is "
                f"{f'batch-routed at width {mk_width}' if mk_width else 'scalar-dispatched'})"
            )
        kernel = mk
    else:
        kernel = make_forasync_megakernel(
            tk, width=w, prefetch=prefetch,
            capacity=capacity or max(64, total + 8), trace=trace,
            device=device,
        )
    b = TaskGraphBuilder()
    seed_tiles(b, bounds, tile)
    _, data_out, info = kernel.run(b, data=dict(data), fuel=fuel)
    return data_out, info


def tile_rounds(mk: Megakernel, args, data: Dict[str, torch.Tensor]) -> None:
    """Run the tiles ``args`` ((n, 4) arg words, array or tensor)
    through ``mk``'s tile body directly, without the scheduler, in place
    on ``data``: rounds of the table's batch width in order with its
    prefetch protocol (one tile a round for a scalar table). On CUDA
    tensors this launches the body's standalone entry
    (``csrc/megakernel.cu`` ``tile_entry``); on CPU tensors it runs the
    plain body tile by tile."""
    if not mk.slab_words:
        raise ValueError("tile_rounds needs a table with a tile body")
    mk._check_data(data)
    args = torch.as_tensor(args, dtype=torch.int32).reshape(-1, 4)
    width, prefetch = 1, False
    if mk.batch_specs:
        width, prefetch = (mk.batch_specs[0][1].width,
                           mk.batch_specs[0][1].prefetch)
    family = TILE_BODIES[mk.slab_body][0]
    buf0 = next(iter(data.values()))
    if buf0.device.type == "cpu":
        core = SimpleNamespace(slab_words=mk.slab_words,
                               buffers=[data[k] for k in mk.data_specs])
        for a in args.tolist():
            _store(core, a, TILE_COMPUTE[family](_loads(core, a)))
        return
    dev = buf0.device
    for t in data.values():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"data buffers must be contiguous on {dev}")
    meta = torch.tensor(mk._meta, dtype=torch.int32, device=dev)
    args_d = args.to(dev).contiguous()
    ptrs = (ctypes.c_void_p * MAX_DATA)(
        *[data[k].data_ptr() for k in mk.data_specs])
    op = ("add_tile", "fa_stencil", "fa_map").index(family)
    lib = _build.library("megakernel")
    fn = lib.hclib_tile_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(meta.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p),
             args_d.data_ptr(), len(args), width, int(prefetch), op,
             mk._smem_bytes(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "tile_entry")
    body = mk.batch_specs[0][2] if mk.batch_specs else mk.slab_body
    _build.LAUNCHES[body] += 1

