"""Closed forms of naive fib: the port's copy of ``hclib_tpu/models/fib.py``
``fib_seq`` (:20) and ``task_count`` (:27), which the forest-steal totals
are held to."""

__all__ = ["fib_seq", "task_count"]


def fib_seq(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


def task_count(n: int) -> int:
    """Number of recursive calls in naive fib(n): 2*F(n+1) - 1."""
    return 2 * fib_seq(n + 1) - 1
