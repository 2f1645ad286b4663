"""RlcAir: the minimal multi-stage AIR (a copy of
plonky25_tpu/models/rlc_air.py, with a device builder of its own).

A main trace of two base columns (a, b) and one stage-2 GF(p^2) column,
the running random linear combination

    z_0 = a_0 + gamma * b_0
    z_{i+1} = gamma * z_i + a_{i+1} + gamma * b_{i+1},

where gamma is sampled from the transcript after the main trace is
committed.  z is fixed by (a, b, gamma) through the first-row and
transition constraints, so a proof binds the stage-2 matrix to the main
trace under a challenge the prover could not predict.
"""

from __future__ import annotations

from typing import List

from ..air import Air, VerifierConstraintFolder
from ..constants import GOLDILOCKS_P as P
from ..fields import gl, gl2
from ..fields.goldilocks import GL
from ..refimpl.field import Gl2


class RlcAir(Air):
    def name(self) -> str:
        return "Rlc"

    def width(self) -> int:
        return 2

    def stage2_width(self) -> int:
        return 2  # one GF(p^2) column as two base columns (c0, c1)

    def num_challenges(self) -> int:
        return 1

    def build_stage2(self, trace, challenges) -> List[List[int]]:
        """Host ints: trace rows (H, 2), challenges [(c0, c1)] ->
        columns (2, H)."""
        gamma = challenges[0]
        z = Gl2.ZERO
        z0, z1 = [], []
        for row in trace:
            a, b = int(row[0]) % P, int(row[1]) % P
            z = Gl2.add(Gl2.mul(gamma, z),
                        Gl2.add_base(Gl2.mul_base(gamma, b), a))
            z0.append(z[0])
            z1.append(z[1])
        return [z0, z1]

    def build_stage2_device(self, cols: GL, challenges) -> GL:
        """The stage-2 columns on the device: cols GL (..., 2, H),
        challenges [GL2 (...)] -> GL (..., 2, H), equal to build_stage2.

        The JAX package runs the recurrence as a lax.scan over rows; here
        it is an affine prefix scan of log2(H) steps over all rows at once
        (fields.extension.prefix_affine).  The challenge stays on the
        device."""
        gamma = challenges[0]
        a, b = cols[..., 0, :], cols[..., 1, :]
        rlc = gl2.add_base(gl2.mul_base(gamma[..., None], b), a)
        z = gl2.prefix_affine(gamma, rlc)
        return gl.stack([z.c0, z.c1], dim=-2)

    def eval(self, folder: VerifierConstraintFolder) -> None:
        ops = folder.ops
        gamma = folder.challenges[0]
        a, b = folder.main.trace_local
        an, bn = folder.main.trace_next
        z = ops.from_parts(*folder.main.stage2_local)
        zn = ops.from_parts(*folder.main.stage2_next)

        def rlc(aa, bb):
            return ops.add(aa, ops.mul(gamma, bb))

        folder.when_first_row().assert_eq(z, rlc(a, b))
        folder.when_transition().assert_eq(
            zn, ops.add(ops.mul(gamma, z), rlc(an, bn)))
