"""MultisetAir: a tagged multiset-equality (permutation) argument (a copy
of plonky25_tpu/models/multiset_air.py, with a device builder of its own).

Two streams of (tag, value) pairs, side A and side B, are equal as
multisets.  With challenges gamma, delta in GF(p^2) sampled after the main
trace is committed, each pair compresses to `tag + delta * value` and a
running grand product accumulates

    z_i = prod_{j<=i} (gamma - (ta_j + delta * va_j))
                    / (gamma - (tb_j + delta * vb_j)),

so z_last == 1 iff the products agree (Schwartz-Zippel over the sampled
challenges).

Columns.  Main trace (width 4): ta, va, tb, vb.  Stage 2 (width 2): z as
one GF(p^2) column.  Constraints (degree 3 with the selector, hence two
quotient chunks):

    first row:   z * (gamma - (tb + delta*vb)) = gamma - (ta + delta*va)
    transition:  z' * (gamma - (tb' + delta*vb')) = z * (gamma - (ta' + delta*va'))
    last row:    z = 1

If a sampled gamma equals a compressed side-B pair (probability about
2H / |GF(p^2)|), the grand product divides by zero: both builders raise
ZeroDivisionError, as the int oracle does.

Padding.  `pad_pairs` right-pads both streams with (0, 0) rows to a
power-of-two height: identical pairs on both sides contribute a ratio of
exactly 1.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..air import Air, VerifierConstraintFolder
from ..constants import GOLDILOCKS_P as P
from ..fields import gl, gl2
from ..fields.goldilocks import GL
from ..refimpl.field import Gl2

ZERO_DENOMINATOR = "a sampled gamma equals a compressed side-B pair"


def pad_pairs(side_a: Sequence[Tuple[int, int]],
              side_b: Sequence[Tuple[int, int]],
              min_height: int = 4) -> List[List[int]]:
    """Row-major main trace from two (tag, value) streams, zero-padded to
    a power-of-two height >= max(len, min_height)."""
    if len(side_a) != len(side_b):
        raise ValueError("multiset sides must have equal length "
                         f"({len(side_a)} vs {len(side_b)})")
    h = max(len(side_a), min_height, 1)
    height = 1 << (h - 1).bit_length()
    rows = [[ta % P, va % P, tb % P, vb % P]
            for (ta, va), (tb, vb) in zip(side_a, side_b)]
    rows.extend([[0, 0, 0, 0]] * (height - len(rows)))
    return rows


class MultisetAir(Air):
    def name(self) -> str:
        return "Multiset"

    def width(self) -> int:
        return 4

    def stage2_width(self) -> int:
        return 2  # one GF(p^2) grand-product column as (c0, c1)

    def num_challenges(self) -> int:
        return 2  # gamma (grand-product point), delta (pair compressor)

    def quotient_degree(self) -> int:
        return 2  # max constraint degree 3 (selector * z * linear factor)

    # -- prover callbacks -------------------------------------------------
    def build_stage2(self, trace, challenges) -> List[List[int]]:
        """Host ints: trace rows (H, 4), challenges [(c0, c1)] * 2 ->
        columns (2, H)."""
        gamma, delta = challenges
        z = Gl2.ONE
        z0, z1 = [], []
        for ta, va, tb, vb in trace:
            num = Gl2.sub(gamma, Gl2.add_base(Gl2.mul_base(delta, int(va) % P),
                                              int(ta) % P))
            den = Gl2.sub(gamma, Gl2.add_base(Gl2.mul_base(delta, int(vb) % P),
                                              int(tb) % P))
            z = Gl2.mul(z, Gl2.div(num, den))
            z0.append(z[0])
            z1.append(z[1])
        return [z0, z1]

    def build_stage2_device(self, cols: GL, challenges) -> GL:
        """The grand product on the device: cols GL (..., 4, H), challenges
        [GL2 (...)] * 2 -> GL (..., 2, H), equal to build_stage2.  One bool
        comes back to the host: whether any denominator is zero, which
        raises ZeroDivisionError as the int oracle does."""
        z, zero = self.build_stage2_device_flagged(cols, challenges)
        if bool(zero):
            raise ZeroDivisionError(ZERO_DENOMINATOR)
        return z

    def build_stage2_device_flagged(self, cols: GL, challenges):
        """build_stage2_device without the host sync: (columns, zero), zero
        a device bool that is true where a denominator is zero.  The
        prover takes this form, so that its stage-2 program never waits
        for the host; it raises ZeroDivisionError at the proof's first
        sync.

        The JAX package runs a lax.scan with one inversion per row; here
        all H denominators invert in one vectorised GF(p^2) inversion, the
        ratios multiply elementwise, and a prefix product of log2(H) steps
        (fields.extension.prefix_product) runs along the rows."""
        gamma, delta = (c[..., None] for c in challenges)

        def compress(tag: GL, val: GL):
            return gl2.sub(gamma, gl2.add_base(gl2.mul_base(delta, val), tag))

        num = compress(cols[..., 0, :], cols[..., 1, :])
        den = compress(cols[..., 2, :], cols[..., 3, :])
        zero = (gl2.eq(den, gl2.zeros((), den.c0.device))).any()
        z = gl2.prefix_product(gl2.mul(num, gl2.inv(den)))
        return gl.stack([z.c0, z.c1], dim=-2), zero

    # -- constraints ------------------------------------------------------
    def eval(self, folder: VerifierConstraintFolder) -> None:
        ops = folder.ops
        gamma, delta = folder.challenges

        def compress(tag, val):
            return ops.sub(gamma, ops.add(tag, ops.mul(delta, val)))

        ta, va, tb, vb = folder.main.trace_local
        tan, van, tbn, vbn = folder.main.trace_next
        z = ops.from_parts(*folder.main.stage2_local)
        zn = ops.from_parts(*folder.main.stage2_next)

        folder.when_first_row().assert_eq(
            ops.mul(z, compress(tb, vb)), compress(ta, va))
        folder.when_transition().assert_eq(
            ops.mul(zn, compress(tbn, vbn)),
            ops.mul(z, compress(tan, van)))
        folder.when_last_row().assert_eq(z, ops.one())
