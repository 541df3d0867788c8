"""Input generator of the Cholesky workload (``hclib_tpu/models/cholesky.py``
``make_spd``). The host-runtime DDF model itself stays in the JAX package."""

from __future__ import annotations

import numpy as np

__all__ = ["make_spd"]


def make_spd(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)
