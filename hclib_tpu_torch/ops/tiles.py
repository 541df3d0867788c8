"""Tile math of the Cholesky bodies: the plain PyTorch versions.

Port of ``hclib_tpu/ops/tiles.py``. The JAX functions are written for the
TPU's matrix unit: every product is three bf16 passes on hi/lo splits, and
the triangular inverse is a Newton-Schulz iteration. The CUDA bodies
(``csrc/tiles.cuh``) compute the same functions in f32 on the SM's FMA
units instead, and the functions here follow the CUDA algorithms step for
step (same blocking, same operations, f32 throughout), so the kernels can
be held against them; they differ from the JAX results only by rounding
(JAX drops the lo*lo term and sums in another order).

- ``factor_tile``: blocked right-looking Cholesky with ``nb``-wide
  diagonal blocks factored serially and left-looking (``_chol_block``),
  panels solved against the diagonal block's inverse, and a trailing
  rank-``nb`` update.
- ``tri_inverse``: blocked forward substitution by row blocks:
  X[i, :i] = -X_ii (L[i, :i] X[:i, :i]).
- ``factor_and_inv``: both; ``base`` is the diagonal block width (the
  counterpart of the JAX ``base``: the only serial math runs on blocks of
  that size).
- ``_chol_block`` / ``_inv_block``: the serial diagonal-block math, the
  counterpart of JAX's ``_chol8_and_inv`` (JAX's ``_mm_tn`` rank-8 panel
  product has none: the trailing update here is one ``mm_nt``).
- ``split_bf16``: bit-exact hi/lo split as JAX's.
- ``mm_nt_split`` / ``mm_nt_rsplit``: A B^T over the split operands, as
  f32 products of the (hi + lo) values.
"""

from __future__ import annotations

import torch

__all__ = [
    "factor_tile", "tri_inverse", "factor_and_inv", "mm_nt", "mm_nn",
    "split_bf16", "unsplit", "mm_nt_split", "mm_nt_rsplit",
]


def split_bf16(x: torch.Tensor):
    """bf16 hi/lo decomposition of an f32 tensor (round to nearest even,
    as ``astype(bfloat16)``): x ~= hi + lo."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def unsplit(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The f32 value a hi/lo pair stands for."""
    return hi.to(torch.float32) + lo.to(torch.float32)


def mm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T in f32."""
    return a @ b.transpose(-1, -2)


def mm_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32."""
    return a @ b


def mm_nt_split(ah, al, bh, bl) -> torch.Tensor:
    """a @ b^T with both operands given as bf16 hi/lo splits."""
    return mm_nt(unsplit(ah, al), unsplit(bh, bl))


def mm_nt_rsplit(a, bh, bl) -> torch.Tensor:
    """a @ b^T with only the right operand pre-split (a is split here,
    as the JAX function does, so both see the same operand values)."""
    return mm_nt(unsplit(*split_bf16(a)), unsplit(bh, bl))


def _chol_block(d: torch.Tensor) -> torch.Tensor:
    """Serial lower Cholesky of a small diagonal block, one column at a
    time, left-looking: each entry subtracts one dot product of the
    columns before it (the CUDA body runs the same loop in shared
    memory)."""
    nb = d.shape[0]
    l = torch.zeros_like(d)
    for c in range(nb):
        l[c, c] = torch.sqrt(d[c, c] - l[c, :c] @ l[c, :c])
        l[c + 1:, c] = (d[c + 1:, c] - l[c + 1:, :c] @ l[c, :c]) / l[c, c]
    return l


def _inv_block(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a small lower-triangular block by forward substitution."""
    nb = l.shape[0]
    x = torch.zeros_like(l)
    eye = torch.eye(nb, dtype=l.dtype, device=l.device)
    for r in range(nb):
        x[r] = (eye[r] - l[r, :r] @ x[:r]) / l[r, r]
    return x


def factor_tile(t: torch.Tensor, ts: int, nb: int = 128) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric (ts, ts) tile (upper zeroed)."""
    if ts % nb:
        raise ValueError(f"tile {ts} is not a multiple of block {nb}")
    a = t.to(torch.float32).clone()
    for j0 in range(0, ts, nb):
        j1 = j0 + nb
        ljj = _chol_block(a[j0:j1, j0:j1])
        a[j0:j1, j0:j1] = ljj
        if j1 < ts:
            panel = mm_nt(a[j1:, j0:j1], _inv_block(ljj))
            a[j1:, j0:j1] = panel
            a[j1:, j1:] -= mm_nt(panel, panel)
    return torch.tril(a)


def tri_inverse(l: torch.Tensor, ts: int, nb: int = 128) -> torch.Tensor:
    """inv(L) for a lower-triangular (ts, ts) L by row-block forward
    substitution."""
    x = torch.zeros_like(l)
    for i0 in range(0, ts, nb):
        i1 = i0 + nb
        xii = _inv_block(l[i0:i1, i0:i1])
        x[i0:i1, i0:i1] = xii
        if i0:
            x[i0:i1, :i0] = -mm_nn(xii, mm_nn(l[i0:i1, :i0], x[:i0, :i0]))
    return x


def factor_and_inv(t: torch.Tensor, ts: int, base: int = 128):
    """(L, inv(L)) of a symmetric (ts, ts) tile; ``base``-wide diagonal
    blocks (a tile smaller than ``base`` is one block)."""
    nb = min(base, ts)
    l = factor_tile(t, ts, nb)
    return l, tri_inverse(l, ts, nb)
