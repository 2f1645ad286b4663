"""Two-adic multiplicative coset domains on plain ints (the part of
plonky25_tpu/refimpl/domains.py that the verifier's constructor uses).

Mirrors src/p3/serde/two_adic.rs (closed-form domain math)."""

from dataclasses import dataclass

from ..constants import GOLDILOCKS_P as P
from ..utils.bits import log2_strict, log2_ceil
from .field import Gl


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

    def zp_at_single_point(self, point: int) -> int:
        """Base-field variant (two_adic.rs:137-147)."""
        unshifted = Gl.mul(point, Gl.inv(self.shift))
        return Gl.sub(pow(unshifted, 1 << self.log_n, P), 1)
