"""Smith-Waterman scoring and inputs (the numpy part of
``hclib_tpu/models/smithwaterman.py``): the affine-free local-alignment
recurrence

    H[i,j] = max(0, H[i-1,j-1] + sub(a_i, b_j), H[i-1,j] - gap, H[i,j-1] - gap)

with its sequential reference DP. ``sw_tiled`` and ``run`` (the wavefront
on the task-parallel host runtime) stay in the JAX package until that
runtime is ported (ROADMAP A13).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MATCH", "MISMATCH", "GAP", "random_seq", "sw_seq"]

MATCH = 2
MISMATCH = -1
GAP = 1


def random_seq(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.int32)


def sw_seq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sequential reference DP; returns the full (len(a)+1, len(b)+1) H."""
    h = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int32)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            sub = MATCH if a[i - 1] == b[j - 1] else MISMATCH
            h[i, j] = max(
                0, h[i - 1, j - 1] + sub, h[i - 1, j] - GAP, h[i, j - 1] - GAP
            )
    return h
