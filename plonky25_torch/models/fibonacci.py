"""FibonacciAir: width-3 example AIR (reference: src/p3/mod.rs:167-222); a
copy of plonky25_tpu/models/fibonacci.py.

Columns (a, b, c) with constraints
    a + b == c                     (everywhere)
    a == 1, b == 1                 (first row)
    a' == b, b' == c               (transitions)
"""

from ..air import Air, VerifierConstraintFolder
from ..constants import GOLDILOCKS_P as P

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
