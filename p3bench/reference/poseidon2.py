"""Poseidon2 width-12 permutation over Goldilocks on plain Python ints (a
copy of plonky25_torch/refimpl/poseidon2.py).

Structure mirrors the reference permutation (poseidon2.rs:59-91):

    state = M_E * input
    4 external rounds: +RC[r], x^7 all lanes, M_E
    22 internal rounds: lane0 += RC_MID[r], lane0 = lane0^7, M_I
    4 external rounds: +RC[r], x^7 all lanes, M_E

M_E = circ(2*M4, M4, M4) applied via the M4 add/double chain
(poseidon2.rs:185-243); M_I = diag(MAT_DIAG_M_1) + all-ones
(poseidon2.rs:164-182).
"""

from .constants import (
    GOLDILOCKS_P as P,
    WIDTH,
    ROUND_F_BEGIN,
    ROUND_F_END,
    ROUND_P,
    MAT_DIAG_M_1,
    RC,
    RC_MID,
)


def _sbox(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    x3 = x * x2 % P
    return x3 * x4 % P


def _matmul_m4(s):
    """In-place cheap 4x4 MDS on each 4-lane block (poseidon2.rs:185-243)."""
    for blk in range(WIDTH // 4):
        o = blk * 4
        t0 = (s[o] + s[o + 1]) % P
        t1 = (s[o + 2] + s[o + 3]) % P
        t2 = (t1 + 2 * s[o + 1]) % P
        t3 = (t0 + 2 * s[o + 3]) % P
        t4 = (t3 + 4 * t1) % P
        t5 = (t2 + 4 * t0) % P
        s[o] = (t3 + t5) % P
        s[o + 1] = t5
        s[o + 2] = (t2 + t4) % P
        s[o + 3] = t4


def _matmul_external(s):
    _matmul_m4(s)
    stored = [0] * 4
    for l in range(4):
        stored[l] = (s[l] + s[4 + l] + s[8 + l]) % P
    for i in range(WIDTH):
        s[i] = (s[i] + stored[i % 4]) % P


def _matmul_internal(s):
    total = sum(s) % P
    for i in range(WIDTH):
        s[i] = ((MAT_DIAG_M_1[i] - 1) * s[i] + total) % P


def poseidon2(inputs):
    """Permute a 12-lane state of canonical ints; returns a new list."""
    s = [x % P for x in inputs]
    assert len(s) == WIDTH

    _matmul_external(s)

    for r in range(ROUND_F_BEGIN):
        for i in range(WIDTH):
            s[i] = (s[i] + RC[r][i]) % P
        for i in range(WIDTH):
            s[i] = _sbox(s[i])
        _matmul_external(s)

    for r in range(ROUND_P):
        s[0] = _sbox((s[0] + RC_MID[r]) % P)
        _matmul_internal(s)

    for r in range(ROUND_F_BEGIN, ROUND_F_END):
        for i in range(WIDTH):
            s[i] = (s[i] + RC[r][i]) % P
        for i in range(WIDTH):
            s[i] = _sbox(s[i])
        _matmul_external(s)

    return s
