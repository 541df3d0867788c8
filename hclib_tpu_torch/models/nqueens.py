"""N-Queens counts (the sequential part of ``hclib_tpu/models/nqueens.py``).

The reference workload is BOTS nqueens (test/misc/nqueens): place n queens
row by row, one task per safe column. ``count_seq`` walks that search tree
sequentially and returns both what the vector tier's n-queens family
reports: the number of solutions and the number of safe partial
placements (the tree's nodes below the empty board, which is what
``device_nqueens``' ``info["executed"]`` counts, plus one for the seed
task). The host-runtime ``run`` stays in the JAX package until that
runtime is ported (ROADMAP A13).
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["KNOWN_COUNTS", "count_seq", "nqueens_count"]

# Known solution counts for self-checking.
KNOWN_COUNTS = {1: 1, 2: 0, 3: 0, 4: 2, 5: 10, 6: 4, 7: 40, 8: 92, 9: 352,
                10: 724, 11: 2680, 12: 14200, 13: 73712}


def count_seq(n: int) -> Tuple[int, int]:
    """(solutions, safe partial placements of 1..n queens) for an n x n
    board, by sequential backtracking over occupied columns and
    diagonals."""
    solutions = placements = 0

    def place(row: int, cols: set, up: set, down: set) -> None:
        nonlocal solutions, placements
        for c in range(n):
            if c in cols or row + c in up or row - c in down:
                continue
            placements += 1
            if row + 1 == n:
                solutions += 1
            else:
                place(row + 1, cols | {c}, up | {row + c}, down | {row - c})

    if n > 0:
        place(0, set(), set(), set())
    return solutions, placements


def nqueens_count(n: int) -> int:
    return count_seq(n)[0]
