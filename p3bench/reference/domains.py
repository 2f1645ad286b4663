"""Two-adic multiplicative coset domains on plain Python ints (a frozen copy of
plonky25_torch/refimpl/domains.py).

Mirrors src/p3/serde/two_adic.rs (closed-form domain & selector math)."""

from dataclasses import dataclass

from .constants import GOLDILOCKS_P as P
from .bits import log2_strict, log2_ceil
from .field import Gl, Gl2


@dataclass(frozen=True)
class LagrangeSelectors:
    is_first_row: tuple
    is_last_row: tuple
    is_transition: tuple
    inv_zeroifier: tuple


@dataclass(frozen=True)
class TwoAdicMultiplicativeCoset:
    log_n: int
    shift: int

    def size(self) -> int:
        return 1 << self.log_n

    def first_point(self) -> int:
        return self.shift

    def gen(self) -> int:
        return Gl.two_adic_generator(self.log_n)

    def next_point(self, x, ext=Gl2):
        """x * g (ext * base), two_adic.rs:39-46."""
        return ext.mul_base(x, self.gen())

    @staticmethod
    def natural_domain_for_degree(log_n_max: int, degree: int) -> "TwoAdicMultiplicativeCoset":
        log_n = log2_strict(degree)
        assert log_n <= log_n_max
        return TwoAdicMultiplicativeCoset(log_n=log_n, shift=1)

    def create_disjoint_domain(self, min_size: int) -> "TwoAdicMultiplicativeCoset":
        """shift *= 7 (two_adic.rs:61-71)."""
        return TwoAdicMultiplicativeCoset(
            log_n=log2_ceil(min_size), shift=Gl.mul(self.shift, 7)
        )

    def split_domains(self, num_chunks: int):
        """two_adic.rs:73-90."""
        log_chunks = log2_strict(num_chunks)
        g = self.gen()
        return [
            TwoAdicMultiplicativeCoset(
                log_n=self.log_n - log_chunks,
                shift=Gl.mul(self.shift, pow(g, i, P)),
            )
            for i in range(num_chunks)
        ]

    def selectors_at_point(self, point, ext=Gl2) -> LagrangeSelectors:
        """Lagrange selectors from z_H(x) = x^(2^log_n) - 1 (two_adic.rs:92-122)."""
        unshifted = ext.mul_base(point, Gl.inv(self.shift))
        z_h = ext.sub_base(ext.exp_power_of_2(unshifted, self.log_n), 1)
        gen_inv = Gl.inv(self.gen())
        up_minus_one = ext.sub_base(unshifted, 1)
        up_minus_gen_inv = ext.sub_base(unshifted, gen_inv)
        return LagrangeSelectors(
            is_first_row=ext.div(z_h, up_minus_one),
            is_last_row=ext.div(z_h, up_minus_gen_inv),
            is_transition=up_minus_gen_inv,
            inv_zeroifier=ext.inv(z_h),
        )

    def zp_at_point(self, point, ext=Gl2):
        """(point/shift)^(2^log_n) - 1, ext (two_adic.rs:124-135)."""
        unshifted = ext.mul_base(point, Gl.inv(self.shift))
        return ext.sub_base(ext.exp_power_of_2(unshifted, self.log_n), 1)

    def zp_at_single_point(self, point: int) -> int:
        """Base-field variant (two_adic.rs:137-147)."""
        unshifted = Gl.mul(point, Gl.inv(self.shift))
        return Gl.sub(pow(unshifted, 1 << self.log_n, P), 1)
