"""Tiled Cholesky inside the megakernel (port of
``hclib_tpu/device/cholesky.py``): a static DDF DAG of tile tasks.

- POTRF(k): L_kk and inv(L_kk); L back to tiles[k,k] (upper zeroed), the
  inverse stored split bf16 hi/lo in linvsp[k].
- TRSM(i,k): one tile A_ik <- A_ik inv(L_kk)^T, stored f32 and split
  into lsp[i,k] (the unfused graph, ``fused_trsm=False``).
- TRSMCOL(k): the column stream of TRSM(i,k) for i > k (the fused graph).
- UPDROW(i,k): A_ij -= L_ik L_jk^T for j in (k, i], operands from lsp.
- UPDROW batched (``batch_updrow=True``, the default, as in JAX): the
  batch tier pops up to ``UPD_B`` ready row tasks a round into one call
  of ``updrow_batch``, which runs UPDROW on each live slot in slot order.
  Rows of one step write disjoint tiles, so the factor is bit-identical
  to the scalar-dispatch run (``batch_updrow=False``).

``potrf`` / ``trsm`` / ``trsmcol`` / ``updrow`` / ``updrow_batch`` launch
the standalone CUDA entry of a body on CUDA tensors (counted in
``_build.LAUNCHES``) and run the plain version on CPU tensors; the
``*_plain`` functions are those plain versions (device-agnostic torch).
Inside the megakernel the same device functions run fused
(``csrc/megakernel.cu``).
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..ops.tiles import factor_and_inv, mm_nt, mm_nt_rsplit, split_bf16, unsplit
from .descriptor import TaskGraphBuilder
from .megakernel import (BatchContext, BatchSpec, KernelContext, Megakernel,
                         potrf_smem_bytes)
from .state import resolve_device

__all__ = [
    "device_cholesky", "build_cholesky_graph", "make_cholesky_megakernel",
    "cholesky_buffers", "potrf", "trsm", "trsmcol", "updrow", "potrf_plain",
    "trsm_plain", "trsmcol_plain", "updrow_plain", "updrow_batch",
    "updrow_batch_plain", "UPD_B",
]

T = 128  # default tile edge

POTRF = 0
TRSM = 1
UPDROW = 2
TRSMCOL = 3

MAX_FACTOR_BASE = 128  # diagonal block + inverse in shared memory

UPD_B = 4  # row tasks per batched trailing-update round


# ------------------------------------------------------------ plain bodies


def potrf_plain(tiles: torch.Tensor, linvsp: torch.Tensor, k: int,
                factor_base: int) -> None:
    ts = tiles.shape[-1]
    l, inv = factor_and_inv(tiles[k, k], ts, base=factor_base)
    tiles[k, k] = l
    linvsp[k, 0], linvsp[k, 1] = split_bf16(inv)


def trsm_plain(tiles: torch.Tensor, linvsp: torch.Tensor, lsp: torch.Tensor,
               i: int, k: int) -> None:
    s = mm_nt_rsplit(tiles[i, k], linvsp[k, 0], linvsp[k, 1])
    tiles[i, k] = s
    lsp[i, k, 0], lsp[i, k, 1] = split_bf16(s)


def trsmcol_plain(tiles: torch.Tensor, linvsp: torch.Tensor,
                  lsp: torch.Tensor, k: int) -> None:
    if k + 1 >= tiles.shape[0]:
        return
    s = mm_nt_rsplit(tiles[k + 1:, k], linvsp[k, 0], linvsp[k, 1])
    tiles[k + 1:, k] = s
    lsp[k + 1:, k, 0], lsp[k + 1:, k, 1] = split_bf16(s)


def updrow_plain(tiles: torch.Tensor, lsp: torch.Tensor, i: int,
                 k: int) -> None:
    lik = unsplit(lsp[i, k, 0], lsp[i, k, 1])
    ljk = unsplit(lsp[k + 1:i + 1, k, 0], lsp[k + 1:i + 1, k, 1])
    tiles[i, k + 1:i + 1] -= mm_nt(lik, ljk)


def updrow_batch_plain(tiles: torch.Tensor, lsp: torch.Tensor,
                       rows: Sequence[Tuple[int, int]]) -> None:
    """UPDROW of each (i, k) in ``rows``, in order."""
    for i, k in rows:
        updrow_plain(tiles, lsp, i, k)


def potrf_body(ctx: KernelContext) -> None:
    d = ctx.data
    potrf_plain(d["tiles"], d["linvsp"], ctx.arg(0),
                ctx.params["factor_base"])


def trsm_body(ctx: KernelContext) -> None:
    d = ctx.data
    trsm_plain(d["tiles"], d["linvsp"], d["lsp"], ctx.arg(0), ctx.arg(1))


def trsmcol_body(ctx: KernelContext) -> None:
    d = ctx.data
    trsmcol_plain(d["tiles"], d["linvsp"], d["lsp"], ctx.arg(0))


def updrow_body(ctx: KernelContext) -> None:
    updrow_plain(ctx.data["tiles"], ctx.data["lsp"], ctx.arg(0), ctx.arg(1))


def updrow_batch_body(ctx: BatchContext) -> None:
    updrow_batch_plain(ctx.data["tiles"], ctx.data["lsp"],
                       [(ctx.arg(s, 0), ctx.arg(s, 1))
                        for s in range(ctx.count)])


# ------------------------------------------------- standalone body wrappers


def _check_buffers(tiles, linvsp=None, lsp=None) -> Tuple[int, int]:
    if tiles.dim() != 4 or tiles.dtype != torch.float32:
        raise ValueError("tiles must be (nt, nt, ts, ts) float32")
    nt, ts = tiles.shape[0], tiles.shape[-1]
    want = [(tiles, (nt, nt, ts, ts), torch.float32)]
    if linvsp is not None:
        want.append((linvsp, (nt, 2, ts, ts), torch.bfloat16))
    if lsp is not None:
        want.append((lsp, (nt, nt, 2, ts, ts), torch.bfloat16))
    for t, shape, dtype in want:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != tiles.device or not t.is_contiguous()):
            raise ValueError(
                f"buffer must be a contiguous {shape} {dtype} tensor on "
                f"{tiles.device}"
            )
    return nt, ts


def _check_base(ts: int, factor_base: int) -> None:
    if not (0 < factor_base <= MAX_FACTOR_BASE and ts % factor_base == 0):
        raise ValueError(
            f"factor_base must divide the tile ({ts}) and be <= "
            f"{MAX_FACTOR_BASE}, got {factor_base}"
        )


def _lib():
    return _build.library("megakernel")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def potrf(tiles: torch.Tensor, linvsp: torch.Tensor, k: int,
          factor_base: int = 128) -> None:
    """POTRF of tile (k, k), in place."""
    nt, ts = _check_buffers(tiles, linvsp)
    _check_base(ts, factor_base)
    if tiles.device.type == "cpu":
        potrf_plain(tiles, linvsp, k, factor_base)
        return
    work = torch.empty(ts * ts, dtype=torch.float32, device=tiles.device)
    lib = _lib()
    fn = lib.hclib_potrf_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    err = fn(tiles.data_ptr(), linvsp.data_ptr(), work.data_ptr(), k, nt, ts,
             factor_base, potrf_smem_bytes(factor_base), _stream(tiles))
    _build.check(lib, err, "potrf")
    _build.LAUNCHES["potrf"] += 1


def trsm(tiles: torch.Tensor, linvsp: torch.Tensor, lsp: torch.Tensor,
         i: int, k: int) -> None:
    """TRSM of tile (i, k), in place."""
    nt, ts = _check_buffers(tiles, linvsp, lsp)
    if tiles.device.type == "cpu":
        trsm_plain(tiles, linvsp, lsp, i, k)
        return
    work = torch.empty(ts * ts, dtype=torch.float32, device=tiles.device)
    lib = _lib()
    fn = lib.hclib_trsm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    err = fn(tiles.data_ptr(), linvsp.data_ptr(), lsp.data_ptr(),
             work.data_ptr(), i, k, nt, ts, _stream(tiles))
    _build.check(lib, err, "trsm")
    _build.LAUNCHES["trsm"] += 1


def trsmcol(tiles: torch.Tensor, linvsp: torch.Tensor, lsp: torch.Tensor,
            k: int) -> None:
    """TRSMCOL column stream of step k, in place."""
    nt, ts = _check_buffers(tiles, linvsp, lsp)
    if tiles.device.type == "cpu":
        trsmcol_plain(tiles, linvsp, lsp, k)
        return
    work = torch.empty(ts * ts, dtype=torch.float32, device=tiles.device)
    lib = _lib()
    fn = lib.hclib_trsmcol_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(tiles.data_ptr(), linvsp.data_ptr(), lsp.data_ptr(),
             work.data_ptr(), k, nt, ts, _stream(tiles))
    _build.check(lib, err, "trsmcol")
    _build.LAUNCHES["trsmcol"] += 1


def updrow(tiles: torch.Tensor, lsp: torch.Tensor, i: int, k: int) -> None:
    """UPDROW row stream of row i at step k, in place."""
    nt, ts = _check_buffers(tiles, lsp=lsp)
    if tiles.device.type == "cpu":
        updrow_plain(tiles, lsp, i, k)
        return
    lib = _lib()
    fn = lib.hclib_updrow_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    err = fn(tiles.data_ptr(), lsp.data_ptr(), i, k, nt, ts, _stream(tiles))
    _build.check(lib, err, "updrow")
    _build.LAUNCHES["updrow"] += 1


def updrow_batch(tiles: torch.Tensor, lsp: torch.Tensor,
                 rows: Sequence[Tuple[int, int]]) -> None:
    """The batched UPDROW body on ``rows`` ((i, k) pairs, at most
    ``UPD_B``), in place."""
    nt, ts = _check_buffers(tiles, lsp=lsp)
    rows = [(int(i), int(k)) for i, k in rows]
    if not 1 <= len(rows) <= UPD_B or not all(
            0 <= k < i < nt for i, k in rows):
        raise ValueError(f"rows must be 1..{UPD_B} (i, k) with k < i < nt")
    if tiles.device.type == "cpu":
        updrow_batch_plain(tiles, lsp, rows)
        return
    flat = (ctypes.c_int * (2 * UPD_B))(*[x for r in rows for x in r])
    lib = _lib()
    fn = lib.hclib_updrow_batch_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(tiles.data_ptr(), lsp.data_ptr(),
             ctypes.cast(flat, ctypes.c_void_p), len(rows), nt, ts,
             _stream(tiles))
    _build.check(lib, err, "updrow_batch")
    _build.LAUNCHES["updrow_batch"] += 1


# --------------------------------------------------------------- the graph


def build_cholesky_graph(nt: int, fused_trsm: bool = True) -> TaskGraphBuilder:
    """Static DAG: POTRF / TRSM tile tasks + row-fused trailing updates
    (same tasks, order and edges as the JAX builder):
      POTRF(k)  <- R(k, k-1)
      C(k)      <- POTRF(k), R(i, k-1) for all i > k     (fused)
      R(i, k)   <- C(k)
    or, with ``fused_trsm=False``:
      TRSM(i,k) <- POTRF(k), R(i, k-1)
      R(i, k)   <- TRSM(j,k) for k<j<=i
    """
    b = TaskGraphBuilder()
    P = {}
    S = {}
    R = {}

    def dep(*ids):
        return [t for t in ids if t is not None]

    for k in range(nt):
        P[k] = b.add(POTRF, args=[k], deps=dep(R.get((k, k - 1))))
        if fused_trsm:
            if k + 1 < nt:
                prev = [R[(i, k - 1)] for i in range(k + 1, nt)] if k else []
                col = b.add(TRSMCOL, args=[k], deps=[P[k]] + prev)
                for i in range(k + 1, nt):
                    R[(i, k)] = b.add(UPDROW, args=[i, k], deps=[col])
        else:
            for i in range(k + 1, nt):
                S[(i, k)] = b.add(
                    TRSM, args=[i, k], deps=dep(P[k], R.get((i, k - 1)))
                )
            for i in range(k + 1, nt):
                R[(i, k)] = b.add(
                    UPDROW,
                    args=[i, k],
                    deps=[S[(j, k)] for j in range(k + 1, i + 1)],
                )
    return b


def make_cholesky_megakernel(
    nt: int,
    tile: int = T,
    factor_base: Optional[int] = None,
    fused_only: bool = False,
    batch_updrow: bool = True,
    device="cuda",
    checkpoint: Optional[bool] = None,
    trace=None,
    **later,
) -> Megakernel:
    """``batch_updrow`` routes the row tasks through the batch tier
    (``UPD_B`` a round); ``False`` restores scalar dispatch. The two
    factors are bit-identical. ``checkpoint`` / ``trace`` are the
    Megakernel's."""
    if factor_base is None:
        factor_base = min(tile, 128)
    _check_base(tile, factor_base)
    if fused_only:
        ntasks = nt + (nt - 1) + nt * (nt - 1) // 2
    else:
        ntasks = nt + 2 * (nt * (nt - 1) // 2)
    capacity = max(64, ntasks)
    return Megakernel(
        kernels=["potrf", "trsm", "updrow", "trsmcol"],
        data_specs={
            "tiles": ((nt, nt, tile, tile), torch.float32),
            "linvsp": ((nt, 2, tile, tile), torch.bfloat16),
            "lsp": ((nt, nt, 2, tile, tile), torch.bfloat16),
        },
        capacity=capacity,
        num_values=8,
        succ_capacity=max(
            64,
            4 * ntasks + (nt * nt if fused_only else nt * nt * nt // 2),
        ),
        params={"tile": tile, "factor_base": factor_base, "nt": nt},
        route={"updrow": BatchSpec(UPD_B)} if batch_updrow else None,
        device=device,
        checkpoint=checkpoint,
        trace=trace,
        **later,
    )


def _to_tiles(a: np.ndarray, nt: int, ts: int = T) -> np.ndarray:
    return (
        a.reshape(nt, ts, nt, ts).swapaxes(1, 2).astype(np.float32).copy()
    )


def _from_tiles(tiles, nt: int, ts: int = T):
    """(nt, nt, ts, ts) tiles -> (n, n) matrix (numpy array or tensor)."""
    return tiles.swapaxes(1, 2).reshape(nt * ts, nt * ts)


def cholesky_buffers(a: np.ndarray, nt: int, tile: int = T,
                     device="cuda") -> dict:
    """The three data buffers of a run: f32 tiles plus the bf16 split
    caches (inverse + subdiagonal L operands), as tensors on ``device``."""
    dev = resolve_device(device)
    return {
        "tiles": torch.from_numpy(_to_tiles(a, nt, tile)).to(dev),
        "linvsp": torch.zeros((nt, 2, tile, tile), dtype=torch.bfloat16,
                              device=dev),
        "lsp": torch.zeros((nt, nt, 2, tile, tile), dtype=torch.bfloat16,
                           device=dev),
    }


def device_cholesky(
    a: np.ndarray,
    mk: Optional[Megakernel] = None,
    tile: int = T,
    fused_trsm: bool = True,
    batch_updrow: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, dict]:
    """Factor SPD ``a`` ((nt*tile)^2) in the megakernel; returns (L as a
    tensor on the run's device, info)."""
    n = a.shape[0]
    if n % tile != 0:
        raise ValueError(f"matrix size must be a multiple of {tile}")
    nt = n // tile
    if mk is None:
        mk = make_cholesky_megakernel(nt, tile=tile,
                                      batch_updrow=batch_updrow,
                                      device=device)
    b = build_cholesky_graph(nt, fused_trsm=fused_trsm)
    bufs = cholesky_buffers(a, nt, tile, device=mk.device)
    t0 = time.perf_counter()
    _, data, info = mk.run(b, data=bufs)  # reads counts back: synchronises
    dt = time.perf_counter() - t0
    L = torch.tril(_from_tiles(data["tiles"], nt, tile))
    info = dict(info)
    info["seconds"] = dt
    info["gflops"] = (n**3 / 3.0) / dt / 1e9
    return L, info
