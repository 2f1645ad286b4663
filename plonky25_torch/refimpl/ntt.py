"""NTTs on plain Python ints for the int prover (a copy of
plonky25_tpu/refimpl/ntt.py)."""

from ..constants import GOLDILOCKS_P as P
from ..utils.bits import log2_strict, reverse_bits_len
from .field import Gl


def ntt(vec, inverse=False):
    """Iterative radix-2 NTT, natural order in/out."""
    n = len(vec)
    log_n = log2_strict(n)
    if n == 1:
        return list(vec)
    a = [vec[reverse_bits_len(i, log_n)] for i in range(n)]
    w_root = Gl.two_adic_generator(log_n)
    if inverse:
        w_root = Gl.inv(w_root)
    # precompute root powers
    w_pow = [1] * (n // 2)
    for i in range(1, n // 2):
        w_pow[i] = w_pow[i - 1] * w_root % P
    half = 1
    while half < n:
        stride = n // (2 * half)
        for start in range(0, n, 2 * half):
            for k in range(half):
                e = a[start + k]
                o = a[start + k + half]
                t = w_pow[k * stride] * o % P
                a[start + k] = (e + t) % P
                a[start + k + half] = (e - t) % P
        half *= 2
    if inverse:
        n_inv = Gl.inv(n)
        a = [v * n_inv % P for v in a]
    return a


def intt(vec):
    return ntt(vec, inverse=True)


def coset_intt(evals, shift):
    """Coefficients of the poly whose evals on shift*<g_N> are given."""
    coeffs = intt(evals)
    s_inv = Gl.inv(shift)
    pw = 1
    out = []
    for c in coeffs:
        out.append(c * pw % P)
        pw = pw * s_inv % P
    return out


def coset_ntt(coeffs, shift):
    """Evaluate coeffs on shift*<g_N>."""
    pw = 1
    scaled = []
    for c in coeffs:
        scaled.append(c * pw % P)
        pw = pw * shift % P
    return ntt(scaled)
