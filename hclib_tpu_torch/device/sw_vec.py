"""Vectorized Smith-Waterman scores as torch ops (port of
``hclib_tpu/device/sw_vec.py``, which is jnp orchestration, not Pallas).

One alignment sweeps the DP matrix row by row; the in-row horizontal-gap
dependency h[j] = max(t[j], h[j-1] - 1) is solved with the decay-cummax
identity

    h[j] = max_{j' <= j} (t[j'] - (j - j')) = cummax(t + j)[j] - j

(exact for the unit linear gap of the reference scoring). B independent
pairs go through as one (B, m) plane a row. This is an independent
formulation of the same DP as the tile engines of ``smithwaterman.py``:
the score they are held to at full size on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.smithwaterman import GAP, MATCH, MISMATCH
from .state import resolve_device

__all__ = ["decay_cummax", "sw_scores", "sw_score_one"]

assert GAP == 1, "decay-cummax form assumes unit linear gap"


def decay_cummax(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Solve c[j] = max(t[j], c[j-1] - 1) along ``dim`` (the port's copy of
    ``hclib_tpu/ops/scan.py`` ``decay_cummax``)."""
    shape = [1] * t.dim()
    shape[dim] = -1
    j = torch.arange(t.shape[dim], dtype=t.dtype, device=t.device)
    j = j.reshape(shape)
    return torch.cummax(t + j, dim=dim).values - j


def sw_scores(a_batch, b_batch, device="cuda") -> torch.Tensor:
    """Scores for B pairs: a_batch (B, n) vs b_batch (B, m) -> (B,) int32
    on ``device``."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a_batch, np.int32)).to(dev)
    b = torch.as_tensor(np.asarray(b_batch, np.int32)).to(dev)
    nb, m = b.shape
    match = torch.tensor(MATCH, dtype=torch.int32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=torch.int32, device=dev)
    prev = torch.zeros((nb, m), dtype=torch.int32, device=dev)
    best = torch.zeros(nb, dtype=torch.int32, device=dev)
    zero = torch.zeros((nb, 1), dtype=torch.int32, device=dev)
    for i in range(a.shape[1]):
        s = torch.where(b == a[:, i:i + 1], match, mismatch)
        diag = torch.cat([zero, prev[:, :-1]], dim=1)
        t = torch.clamp_min(torch.maximum(diag + s, prev - GAP), 0)
        prev = decay_cummax(t)
        best = torch.maximum(best, prev.amax(dim=1))
    return best


def sw_score_one(a: np.ndarray, b: np.ndarray, device="cuda") -> int:
    return int(sw_scores(np.asarray(a)[None], np.asarray(b)[None],
                         device=device)[0])
