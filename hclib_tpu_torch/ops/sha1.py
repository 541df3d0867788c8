"""FIPS-180-1 SHA-1 compression, elementwise over tensors or numpy arrays
(port of ``hclib_tpu/ops/sha1.py``): the UTS splittable RNG, one hash per
tree node.

- ``sha1_block`` / ``sha1_child`` work on torch tensors: the plain
  lockstep engine (``device/uts_vec.py``) hashes one child per lane with
  them, on the CPU or the card. ``torch.uint32`` has no shifts, adds or
  ``~``, so a 32-bit word is held in an int64 tensor as its unsigned
  value in [0, 2^32): sums and left shifts are masked back with
  ``& 0xFFFFFFFF``, and ``>>`` of a non-negative int64 is logical.
- ``sha1_block_np`` / ``sha1_child_np`` work on numpy uint32 arrays (whose
  arithmetic wraps): host seeding hashes whole BFS levels with them.
  They need no masks and move half the bytes of the int64 form, and
  seeding is most of T1L's wall.

The CUDA engine computes the same function per thread in registers
(``csrc/uts.cu``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

__all__ = ["sha1_block", "sha1_child", "sha1_block_np", "sha1_child_np"]

M32 = 0xFFFFFFFF
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
_H = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    return ((x << s) & M32) | (x >> (32 - s))


def sha1_block(w16: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SHA-1 compression of one 16-word block; words are int64 tensors of
    one shape holding values in [0, 2^32). Returns the 5 digest words in
    the same form. The round functions are the standard ones written with
    fewer operations (Ch = d ^ (b & (c ^ d)), Maj = (b & c) | (d & (b | c)):
    the same bits)."""
    w = [x.to(torch.int64) for x in w16]
    a = torch.full_like(w[0], _H[0])
    b = torch.full_like(w[0], _H[1])
    c = torch.full_like(w[0], _H[2])
    d = torch.full_like(w[0], _H[3])
    e = torch.full_like(w[0], _H[4])
    for i in range(80):
        if i >= 16:
            w[i % 16] = _rotl(w[(i - 3) % 16] ^ w[(i - 8) % 16]
                              ^ w[(i - 14) % 16] ^ w[i % 16], 1)
        if i < 20:
            f = d ^ (b & (c ^ d))
        elif i < 40 or i >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (d & (b | c))
        tmp = (_rotl(a, 5) + f + e + w[i % 16] + _K[i // 20]) & M32
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return [(x + h) & M32 for x, h in zip((a, b, c, d, e), _H)]


def sha1_child(state5: Sequence[torch.Tensor],
               child_idx: torch.Tensor) -> List[torch.Tensor]:
    """SHA1(parent_state(20B) || BE32(child)) for UTS's 24-byte messages:
    one padded block (0x80 terminator, bit length 192)."""
    zero = torch.zeros_like(state5[0], dtype=torch.int64)
    w16 = [
        state5[0], state5[1], state5[2], state5[3], state5[4],
        child_idx.to(torch.int64) & M32,
        torch.full_like(zero, 0x80000000),
        zero, zero, zero, zero, zero, zero, zero, zero,
        torch.full_like(zero, 24 * 8),
    ]
    return sha1_block(w16)


def _rotl_np(x: np.ndarray, s: int) -> np.ndarray:
    return (x << np.uint32(s)) | (x >> np.uint32(32 - s))


def sha1_block_np(w16: Sequence[np.ndarray]) -> List[np.ndarray]:
    """``sha1_block`` over numpy uint32 arrays (wrapping arithmetic)."""
    w = [np.asarray(x, np.uint32) for x in w16]
    a, b, c, d, e = (np.full_like(w[0], h) for h in _H)
    for i in range(80):
        if i >= 16:
            w[i % 16] = _rotl_np(w[(i - 3) % 16] ^ w[(i - 8) % 16]
                                 ^ w[(i - 14) % 16] ^ w[i % 16], 1)
        if i < 20:
            f = d ^ (b & (c ^ d))
        elif i < 40 or i >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (d & (b | c))
        tmp = _rotl_np(a, 5) + f + e + w[i % 16] + np.uint32(_K[i // 20])
        e, d, c, b, a = d, c, _rotl_np(b, 30), a, tmp
    return [x + np.uint32(h) for x, h in zip((a, b, c, d, e), _H)]


def sha1_child_np(state5: Sequence[np.ndarray],
                  child_idx: np.ndarray) -> List[np.ndarray]:
    """``sha1_child`` over numpy uint32 arrays."""
    zero = np.zeros_like(state5[0], dtype=np.uint32)
    w16 = [
        state5[0], state5[1], state5[2], state5[3], state5[4],
        np.asarray(child_idx).astype(np.uint32),
        np.full_like(zero, 0x80000000),
        zero, zero, zero, zero, zero, zero, zero, zero,
        np.full_like(zero, 24 * 8),
    ]
    return sha1_block_np(w16)
