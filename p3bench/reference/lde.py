"""A trace's polynomials evaluated at an extension point, in NumPy: the
benchmark's check that a proof opens the trace it was given.

Column j's polynomial takes the trace's value t_ij at g^i, g generating
the subgroup of the trace's height n (the trace domain, shift 1).  At a
point z outside it, by the barycentric formula,

    f_j(z) = (z^n - 1) / n * sum_i t_ij * g^i / (z - g^i).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .bits import log2_strict
from .constants import GOLDILOCKS_P as P
from .field import Gl, Gl2
from .npgl import U, mul, sum_mod


def evaluate(trace: np.ndarray, z: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Every column of trace (n, W) (canonical uint64) at z in GF(p^2)."""
    n = trace.shape[0]
    g = Gl.two_adic_generator(log2_strict(n))
    scale = Gl2.mul_base(Gl2.sub_base(Gl2.exp_power_of_2(z, log2_strict(n)),
                                      1), Gl.inv(n))
    weights, x = [], 1
    for _ in range(n):
        weights.append(Gl2.mul(Gl2.mul_base(scale, x),
                               Gl2.inv(Gl2.sub_base(z, x))))
        x = x * g % P
    t = np.asarray(trace, dtype=U)
    parts = []
    for k in range(2):
        wk = np.asarray([w[k] for w in weights], dtype=U)[:, None]
        # a few columns at a time: the temporaries stay in cache
        parts.append(np.concatenate([
            sum_mod(mul(t[:, j:j + 32], wk), axis=0)
            for j in range(0, t.shape[1], 32)]))
    return [(int(a), int(b)) for a, b in zip(*parts)]
