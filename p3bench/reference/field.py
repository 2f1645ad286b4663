"""Goldilocks base field, GF(p^2) and GF(p^3) in plain Python ints (a
copy of plonky25_torch/refimpl/field.py).

Semantics mirror the reference:
  - base ops: plonky2 GoldilocksField (canonical values in [0, p))
  - extension ops: src/p3/extension.rs (X^2 - 7, dth_root = p-1; and
    X^3 - 7)
  - two-adic generators: src/p3/extension.rs:154-171
"""

from .constants import (
    GOLDILOCKS_P as P,
    TWO_ADIC_GENERATOR_32,
    TWO_ADICITY,
    EXT_W,
    DTH_ROOT,
)


class Gl:
    """Static helpers over canonical ints in [0, p)."""

    P = P

    @staticmethod
    def add(a: int, b: int) -> int:
        return (a + b) % P

    @staticmethod
    def sub(a: int, b: int) -> int:
        return (a - b) % P

    @staticmethod
    def mul(a: int, b: int) -> int:
        return (a * b) % P

    @staticmethod
    def neg(a: int) -> int:
        return (-a) % P

    @staticmethod
    def inv(a: int) -> int:
        if a % P == 0:
            raise ZeroDivisionError("inverse of zero in Goldilocks")
        return pow(a, P - 2, P)

    @staticmethod
    def exp(a: int, e: int) -> int:
        return pow(a, e, P)

    @staticmethod
    def from_noncanonical(a: int) -> int:
        return a % P

    @staticmethod
    def two_adic_generator(bits: int) -> int:
        """g_bits = g_32^(2^(32-bits)); order exactly 2^bits."""
        assert 0 <= bits <= TWO_ADICITY
        return pow(TWO_ADIC_GENERATOR_32, 1 << (TWO_ADICITY - bits), P)


class Gl2:
    """GF(p^2) = GF(p)[X]/(X^2 - 7), elements as (c0, c1) int tuples."""

    W = EXT_W
    D = 2

    ZERO = (0, 0)
    ONE = (1, 0)
    X = (0, 1)

    @staticmethod
    def add(x, y):
        return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)

    @staticmethod
    def sub(x, y):
        return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)

    @staticmethod
    def neg(x):
        return ((-x[0]) % P, (-x[1]) % P)

    @staticmethod
    def add_base(x, b):
        """x + b with b in the base field (touches only c0).

        Mirrors p3_ext_add_single (extension.rs:393-401)."""
        return ((x[0] + b) % P, x[1])

    @staticmethod
    def sub_base(x, b):
        return ((x[0] - b) % P, x[1])

    @staticmethod
    def mul(x, y):
        a0, a1 = x
        b0, b1 = y
        return ((a0 * b0 + EXT_W * a1 * b1) % P, (a0 * b1 + a1 * b0) % P)

    @staticmethod
    def mul_base(x, b):
        return ((x[0] * b) % P, (x[1] * b) % P)

    @staticmethod
    def square(x):
        return Gl2.mul(x, x)

    @staticmethod
    def inv(x):
        """1/x via the degree-2 norm formula (extension.rs:304-321)."""
        a0, a1 = x
        scalar = Gl.inv((a0 * a0 - EXT_W * a1 * a1) % P)
        return ((a0 * scalar) % P, ((-a1) % P) * scalar % P)

    @staticmethod
    def div(x, y):
        return Gl2.mul(x, Gl2.inv(y))

    @staticmethod
    def exp_power_of_2(x, power_log: int):
        for _ in range(power_log):
            x = Gl2.mul(x, x)
        return x

    @staticmethod
    def frobenius(x):
        """x -> x^p: c1 scales by DTH_ROOT (= p-1, i.e. -1)."""
        return (x[0], (x[1] * DTH_ROOT) % P)

    @staticmethod
    def from_base(b: int):
        return (b % P, 0)

    @staticmethod
    def two_adic_generator(bits: int):
        """Extension-field two-adic generator (extension.rs:159-171).

        For bits <= 32 it's the base generator embedded in c0; the reference
        has a special case at bits == 33 placing it in c1."""
        base = pow(TWO_ADIC_GENERATOR_32, 1 << ((TWO_ADICITY - bits) % (1 << 64)), P) \
            if bits <= TWO_ADICITY else None
        if bits == 33:
            # reference computes exp_power_of_2(g32, 32-33) which in Rust
            # usize arithmetic would underflow; it relies on bits<=32 for the
            # base path and swaps coefficients for 33. We only need <= 32 + 33.
            return (0, Gl.two_adic_generator(32))
        assert base is not None
        return (base, 0)


class Gl3:
    """GF(p^3) = GF(p)[X]/(X^3 - 7), elements as (c0, c1, c2) int tuples:
    the int counterpart of fields/extension3.py (extension.rs:330-390
    Karatsuba mul, :473-532 adjugate inverse), with Gl2's static-method
    API (ext_ops(d) selects the class)."""

    W = EXT_W
    D = 3

    ZERO = (0, 0, 0)
    ONE = (1, 0, 0)
    X = (0, 1, 0)

    @staticmethod
    def add(x, y):
        return tuple((a + b) % P for a, b in zip(x, y))

    @staticmethod
    def sub(x, y):
        return tuple((a - b) % P for a, b in zip(x, y))

    @staticmethod
    def neg(x):
        return tuple((-a) % P for a in x)

    @staticmethod
    def add_base(x, b):
        return ((x[0] + b) % P, x[1], x[2])

    @staticmethod
    def sub_base(x, b):
        return ((x[0] - b) % P, x[1], x[2])

    @staticmethod
    def mul(x, y):
        a0, a1, a2 = x
        b0, b1, b2 = y
        a0b0, a1b1, a2b2 = a0 * b0, a1 * b1, a2 * b2
        c0 = (a0b0 + EXT_W * ((a1 + a2) * (b1 + b2) - a1b1 - a2b2)) % P
        c1 = ((a0 + a1) * (b0 + b1) - a0b0 - a1b1 + EXT_W * a2b2) % P
        c2 = ((a0 + a2) * (b0 + b2) - a0b0 - a2b2 + a1b1) % P
        return (c0, c1, c2)

    @staticmethod
    def mul_base(x, b):
        return tuple((a * b) % P for a in x)

    @staticmethod
    def square(x):
        return Gl3.mul(x, x)

    @staticmethod
    def inv(x):
        a0, a1, a2 = x
        det = (a0 * a0 * a0 + EXT_W * a1 * a1 * a1
               + EXT_W * EXT_W * a2 * a2 * a2
               - 3 * EXT_W * a0 * a1 * a2) % P
        s = Gl.inv(det)
        return (
            (a0 * a0 - EXT_W * a1 * a2) * s % P,
            (EXT_W * a2 * a2 - a0 * a1) * s % P,
            (a1 * a1 - a0 * a2) * s % P,
        )

    @staticmethod
    def div(x, y):
        return Gl3.mul(x, Gl3.inv(y))

    @staticmethod
    def exp_power_of_2(x, power_log: int):
        for _ in range(power_log):
            x = Gl3.mul(x, x)
        return x

    @staticmethod
    def from_base(b: int):
        return (b % P, 0, 0)

    @staticmethod
    def monomial(e: int):
        cs = [0, 0, 0]
        cs[e] = 1
        return tuple(cs)

    @staticmethod
    def two_adic_generator(bits: int):
        assert bits <= TWO_ADICITY, "D=3 ext generator needed only <= 32"
        return (Gl.two_adic_generator(bits), 0, 0)


def ext_ops(d: int):
    """The int extension-field class for extension degree d (the reference
    selects by its EXT_DEGREE constant, p3/constants.rs)."""
    if d == 2:
        return Gl2
    if d == 3:
        return Gl3
    raise ValueError(f"unsupported extension degree {d}")
