"""FibonacciAir: width-3 example AIR (reference: src/p3/mod.rs:167-222); a
copy of plonky25_torch/models/fibonacci.py.

Columns (a, b, c) with constraints
    a + b == c                     (everywhere)
    a == 1, b == 1                 (first row)
    a' == b, b' == c               (transitions)
"""

from .air import Air, VerifierConstraintFolder
from .constants import GOLDILOCKS_P as P

NUM_FIBONACCI_COLS = 3


def fibonacci_trace(height: int):
    """Row-major fib trace: (a, b, c) with c = a+b, a' = b, b' = c."""
    rows = []
    a, b = 1, 1
    for _ in range(height):
        c = (a + b) % P
        rows.append([a, b, c])
        a, b = b, c
    return rows


class FibonacciAir(Air):
    def name(self) -> str:
        return "Fibonacci"

    def width(self) -> int:
        return NUM_FIBONACCI_COLS

    def eval(self, folder: VerifierConstraintFolder) -> None:
        ops = folder.ops
        a, b, c = folder.main.trace_local[:3]
        na, nb, _nc = folder.main.trace_next[:3]

        folder.assert_eq(ops.add(a, b), c)

        one = ops.one()
        folder.when_first_row().assert_eq(one, a)
        folder.when_first_row().assert_eq(one, b)

        folder.when_transition().assert_eq(na, b)
        folder.when_transition().assert_eq(nb, c)


def seeded_trace(rng, log_n: int):
    """The Fibonacci trace of 2^log_n rows (its first row is fixed, so rng
    draws nothing)."""
    import numpy as np

    return np.asarray(fibonacci_trace(1 << log_n), dtype=np.uint64)


def broken_trace(rng, log_n: int):
    """The Fibonacci trace of 2^log_n rows with one value, at a row and
    column drawn by rng, moved by a nonzero delta: a + b == c fails on that
    row, so a proof of it may be rejected only by the constraint check."""
    import numpy as np

    t = seeded_trace(rng, log_n)
    row, col = int(rng.integers(len(t))), int(rng.integers(t.shape[1]))
    delta = int(rng.integers(1, P, dtype=np.uint64))
    t[row, col] = np.uint64((int(t[row, col]) + delta) % P)
    return t
