"""Batched Smith-Waterman scores in one kernel (port of
``hclib_tpu/device/sw_pallas.py``).

B independent pairs, a_batch (B, n) against b_batch (B, m), give B int32
local-alignment scores (the recurrences of ``models/smithwaterman.py``,
unit linear gap). The TPU kernel (``_sw_pallas`` -> ``_kernel``) sweeps the
n rows over (m, B) planes with the batch on lanes: per row
``t = max(diag + s, prev - GAP, 0)`` and the in-row gap chain as
``cummax(t + j) - j``, the cummax taken as log2(m) shifted maxima
(``_shifted_cummax0``).

``sw_scores_plain`` is that kernel translated to torch ops, plane for
plane (it is not ``sw_vec``'s ``torch.cummax`` form, so the two plain
versions stay independent). The kernel is ``csrc/sw_scores.cu``, one warp
a pair with no padding (any n and m). On a CPU tensor the wrapper runs the
plain version, with JAX's padding (B to whole 128-lane blocks, n to a
multiple of 8, with the symbol -1 that matches nothing).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..models.smithwaterman import GAP, MATCH, MISMATCH
from .state import resolve_device

__all__ = ["sw_scores_pallas", "sw_scores_plain", "sw_scores_batch"]

assert GAP == 1, "decay-cummax form assumes unit linear gap"

_NEG = -(1 << 30)


def _shifted_cummax0(c: torch.Tensor) -> torch.Tensor:
    """cummax along dim 0 as log2(m) shifted maxima."""
    m = c.shape[0]
    sh = 1
    while sh < m:
        pad = torch.full((sh, c.shape[1]), _NEG, dtype=c.dtype,
                         device=c.device)
        c = torch.maximum(c, torch.cat([pad, c[:-sh]], dim=0))
        sh *= 2
    return c


def sw_scores_plain(a_t: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """JAX's ``_kernel`` over (m, B) planes: a_t (n, B) and b_t (m, B)
    int32, pre-transposed; returns the (B,) int32 scores."""
    n = a_t.shape[0]
    m, nb = b_t.shape
    dev = b_t.device
    iidx = torch.arange(m, dtype=torch.int32, device=dev).view(m, 1)
    match = torch.tensor(MATCH, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, nb), dtype=torch.int32, device=dev)
    prev = torch.zeros((m, nb), dtype=torch.int32, device=dev)
    best = torch.zeros((m, nb), dtype=torch.int32, device=dev)
    for i in range(n):
        s = torch.where(b_t == a_t[i:i + 1], match, mismatch)
        diag = torch.cat([zero_row, prev[:-1]], dim=0)
        t = torch.clamp_min(torch.maximum(diag + s, prev - GAP), 0)
        prev = _shifted_cummax0(t + iidx) - iidx
        best = torch.maximum(best, prev)
    if m == 0:
        return torch.zeros(nb, dtype=torch.int32, device=dev)
    return best.amax(dim=0)


def _padded_plain(a: torch.Tensor, b: torch.Tensor,
                  block_b: int) -> torch.Tensor:
    """JAX's ``sw_scores_pallas`` around the plain version: B padded to a
    whole number of batch blocks, n to a multiple of 8."""
    nb = a.shape[0]
    block_b = max(128, (min(block_b, nb) // 128) * 128)
    padb = (-nb) % block_b
    if padb:
        a = torch.cat([a, a.new_zeros((padb, a.shape[1]))])
        b = torch.cat([b, b.new_full((padb, b.shape[1]), -1)])
    padn = (-a.shape[1]) % 8
    if padn:
        a = torch.cat([a, a.new_full((a.shape[0], padn), -1)], dim=1)
    return sw_scores_plain(a.T.contiguous(), b.T.contiguous())[:nb]


def sw_scores_batch(a: torch.Tensor, b: torch.Tensor,
                    block_b: int = 512) -> torch.Tensor:
    """Scores of a (B, n) against b (B, m), int32 tensors on one device:
    on the card the CUDA kernel (counted in ``_build.LAUNCHES
    ["sw_scores"]``), on the CPU the plain version."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"want a (B, n) and b (B, m), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("sequences must be int32")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")
    if a.device.type == "cpu":
        return _padded_plain(a, b, block_b)
    a, b = a.contiguous(), b.contiguous()
    nb, n = a.shape
    m = b.shape[1]
    out = torch.zeros(nb, dtype=torch.int32, device=a.device)
    if nb == 0:
        return out
    lib = _build.library("sw_scores")
    fn = lib.hclib_sw_scores_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), nb, n, m,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, "sw_scores")
    _build.LAUNCHES["sw_scores"] += 1
    return out


def sw_scores_pallas(a_batch, b_batch, block_b: int = 512,
                     device="cuda") -> torch.Tensor:
    """Scores for B pairs: a_batch (B, n) vs b_batch (B, m) -> (B,) int32
    on ``device`` (default the card; ``"cpu"`` runs the plain version)."""
    dev = resolve_device(device)

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.int32)
        return torch.as_tensor(np.asarray(x, np.int32)).to(dev)

    return sw_scores_batch(tensor(a_batch), tensor(b_batch), block_b)
