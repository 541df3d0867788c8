"""UTS - Unbalanced Tree Search: the tree specification (port of
``hclib_tpu/models/uts.py``; hashlib and math only).

- Node state: 20-byte SHA-1 digest. Root: SHA1(16 zero bytes || BE32(seed)).
  Child i of a node: SHA1(parent_state || BE32(i)).
- rng_rand: last 4 state bytes, big-endian, masked positive; toProb =
  r / 2^31.
- GEO child count: target branching b_i from the shape function - LINEAR:
  b0*(1 - d/gen_mx); EXPDEC: b0*d^(-ln b0/ln gen_mx); CYCLIC; FIXED: b0
  while d < gen_mx else 0 - then p = 1/(1+b_i) and numChildren =
  floor(log(1-u)/log(1-p)), capped at 100.

Canonical trees: T1 = GEO/FIXED d=10 b=4 r=19 (4,130,071 nodes); T1L =
GEO/FIXED d=13 b=4 r=29 (102,181,082 nodes).

The JAX module's host-runtime traversal (``count_parallel``, ``run``)
needs the task-parallel host runtime, which is not ported yet (ROADMAP.md,
queue A item 13). The device engines are ``device/uts_vec.py`` (plain
lockstep engine) and ``device/uts_fused.py`` (the CUDA engine).
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass
from typing import Tuple

__all__ = [
    "UTSParams", "T1", "T1L", "T1XL", "T1XXL", "T2", "T3", "T5",
    "LINEAR", "EXPDEC", "CYCLIC", "FIXED", "MAX_CHILDREN",
    "root_state", "spawn_state", "rng_rand", "num_children", "count_seq",
]

MAX_CHILDREN = 100  # MAXNUMCHILDREN

LINEAR, EXPDEC, CYCLIC, FIXED = 0, 1, 2, 3  # geoshape enum


@dataclass(frozen=True)
class UTSParams:
    shape: int = FIXED  # -a
    gen_mx: int = 10  # -d (tree depth)
    b0: float = 4.0  # -b (branching factor)
    root_seed: int = 19  # -r


# Canonical trees (the UTS distribution's sample_trees.sh)
T1 = UTSParams(shape=FIXED, gen_mx=10, b0=4.0, root_seed=19)  # 4,130,071 nodes
T1L = UTSParams(shape=FIXED, gen_mx=13, b0=4.0, root_seed=29)  # 102,181,082 nodes
# Canonical depth-varying trees:
T5 = UTSParams(shape=LINEAR, gen_mx=20, b0=4.0, root_seed=34)  # 4,147,582
T2 = UTSParams(shape=CYCLIC, gen_mx=16, b0=6.0, root_seed=502)  # 4,117,769
# XL/XXL geometric trees. Per-lane counters stay well under int32 for
# both; T1XXL's 4.23B TOTAL exceeds int32, which is why engine totals are
# summed in int64 on the host.
T1XL = UTSParams(shape=FIXED, gen_mx=15, b0=4.0, root_seed=29)  # 1,635,119,272
T1XXL = UTSParams(shape=FIXED, gen_mx=15, b0=4.0, root_seed=19)  # 4,230,646,601
T3 = UTSParams(shape=FIXED, gen_mx=5, b0=4.0, root_seed=42)  # small, for tests


def root_state(seed: int) -> bytes:
    return hashlib.sha1(b"\x00" * 16 + struct.pack(">i", seed)).digest()


def spawn_state(parent: bytes, i: int) -> bytes:
    return hashlib.sha1(parent + struct.pack(">i", i)).digest()


def rng_rand(state: bytes) -> int:
    return struct.unpack(">I", state[16:20])[0] & 0x7FFFFFFF


def _branching(params: UTSParams, depth: int) -> float:
    if depth <= 0:
        return params.b0
    if params.shape == LINEAR:
        return params.b0 * (1.0 - depth / params.gen_mx)
    if params.shape == EXPDEC:
        return params.b0 * depth ** (-math.log(params.b0) / math.log(params.gen_mx))
    if params.shape == CYCLIC:
        if depth > 5 * params.gen_mx:
            return 0.0
        return params.b0 ** math.sin(2.0 * math.pi * depth / params.gen_mx)
    if params.shape == FIXED:
        return params.b0 if depth < params.gen_mx else 0.0
    raise ValueError(f"unknown shape {params.shape}")


def num_children(params: UTSParams, state: bytes, depth: int) -> int:
    b_i = _branching(params, depth)
    if b_i <= 0.0:
        return 0
    p = 1.0 / (1.0 + b_i)
    u = rng_rand(state) / 2147483648.0
    n = int(math.floor(math.log(1.0 - u) / math.log(1.0 - p)))
    return min(n, MAX_CHILDREN)


def count_seq(params: UTSParams) -> Tuple[int, int, int]:
    """Sequential traversal; returns (nodes, leaves, max_depth)."""
    nodes = leaves = max_depth = 0
    stack = [(root_state(params.root_seed), 0)]
    while stack:
        state, depth = stack.pop()
        nodes += 1
        max_depth = max(max_depth, depth)
        nc = num_children(params, state, depth)
        if nc == 0:
            leaves += 1
        for i in range(nc):
            stack.append((spawn_state(state, i), depth + 1))
    return nodes, leaves, max_depth
