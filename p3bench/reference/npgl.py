"""Goldilocks arithmetic and the Poseidon2 width-12 permutation on NumPy
uint64 arrays, and MMCS Merkle-path checks over many lanes at once.

The same arithmetic as poseidon2.py and the int oracle's commit.py
(src/p3/commit.rs), vectorised over lanes so that a proof's leaf hashes
and paths (659 sponge chunks for a KeccakAir row) cost one array call per
chunk and per level for every query of every proof together.  Every
value is canonical (in [0, p)); uint64 arithmetic wraps, and each step
below says how the wrap is taken back.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .constants import (
    DIGEST_ELEMS,
    GOLDILOCKS_P,
    MAT_DIAG_M_1,
    RATE,
    RC,
    RC_MID,
    ROUND_F_BEGIN,
    ROUND_F_END,
    ROUND_P,
    WIDTH,
)

U = np.uint64
P = U(GOLDILOCKS_P)
EPS = U(0xFFFFFFFF)          # 2^64 mod p
M32 = U(0xFFFFFFFF)
S32 = U(32)

_RC = [np.asarray(r, dtype=U)[:, None] for r in RC]
_RC_MID = [U(c) for c in RC_MID]
_DIAG = np.asarray([(d - 1) % GOLDILOCKS_P for d in MAT_DIAG_M_1],
                   dtype=U)[:, None]


def add(a, b):
    s = a + b
    s = np.where(s < a, s + EPS, s)          # a carry out: 2^64 = EPS
    return np.where(s >= P, s - P, s)


def sub(a, b):
    d = a - b
    return np.where(a < b, d - EPS, d)       # a borrow: -2^64 = -EPS


def reduce128(lo, hi):
    """lo + hi * 2^64 mod p, with 2^64 = EPS and 2^96 = -1."""
    hh, hl = hi >> S32, hi & M32
    t0 = lo - hh
    t0 = np.where(lo < hh, t0 - EPS, t0)
    t1 = hl * EPS
    r = t0 + t1
    r = np.where(r < t1, r + EPS, r)
    return np.where(r >= P, r - P, r)


def mul(a, b):
    al, ah = a & M32, a >> S32
    bl, bh = b & M32, b >> S32
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = lh + hl
    mid_carry = (mid < lh).astype(U) << S32      # 2^64 * 2^32 into hi
    lo = ll + (mid << S32)
    hi = hh + (mid >> S32) + (lo < ll).astype(U) + mid_carry
    return reduce128(lo, hi)


def sum_mod(x, axis=-1):
    """Sum of canonical values along `axis`, mod p, as Python ints (an
    object array): the 32-bit halves are summed exactly in uint64 (up to
    2^32 terms) and joined with Python ints."""
    lo = (x & M32).sum(axis=axis, dtype=U).astype(object)
    hi = (x >> S32).sum(axis=axis, dtype=U).astype(object)
    return (hi * (1 << 32) + lo) % GOLDILOCKS_P


# ------------------------------------------------------------ Poseidon2

def _sbox(x):
    x2 = mul(x, x)
    x3 = mul(x, x2)
    x4 = mul(x2, x2)
    return mul(x3, x4)


def _m4(s):
    """The cheap 4x4 MDS on each 4-lane block of s (12, N)."""
    s = s.reshape(3, 4, -1)
    x0, x1, x2, x3 = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    t0 = add(x0, x1)
    t1 = add(x2, x3)
    t2 = add(t1, add(x1, x1))
    t3 = add(t0, add(x3, x3))
    t1_4 = add(t1, t1)
    t0_4 = add(t0, t0)
    t4 = add(t3, add(t1_4, t1_4))
    t5 = add(t2, add(t0_4, t0_4))
    return np.stack([add(t3, t5), t5, add(t2, t4), t4], axis=1).reshape(
        WIDTH, -1)


def _external(s):
    s = _m4(s)
    b = s.reshape(3, 4, -1)
    stored = add(add(b[0], b[1]), b[2])
    return add(b, stored[None]).reshape(WIDTH, -1)


def _internal(s):
    # the 12 lanes' sum: 32-bit halves summed exactly, then reduced
    lo = (s & M32).sum(axis=0, dtype=U)
    hi = (s >> S32).sum(axis=0, dtype=U)          # below 12 * 2^32
    low = lo + (hi << S32)
    total = reduce128(low, (hi >> S32) + (low < lo).astype(U))
    return add(mul(_DIAG, s), total[None])


def permute(s: np.ndarray) -> np.ndarray:
    """Poseidon2 of N states, s (12, N) uint64 -> (12, N)."""
    s = _external(s)
    for r in range(ROUND_F_BEGIN):
        s = _external(_sbox(add(s, _RC[r])))
    for r in range(ROUND_P):
        s = s.copy()
        s[0] = _sbox(add(s[0], _RC_MID[r]))
        s = _internal(s)
    for r in range(ROUND_F_BEGIN, ROUND_F_END):
        s = _external(_sbox(add(s, _RC[r])))
    return s


def hash_rows(flat: np.ndarray) -> np.ndarray:
    """Overwrite-mode sponge of each row of flat (N, L): digests (4, N)
    (commit.rs:23-46; a final partial chunk still permutes)."""
    n, length = flat.shape
    state = np.zeros((WIDTH, n), dtype=U)
    for i in range(0, length, RATE):
        chunk = flat[:, i:i + RATE]
        state[:chunk.shape[1]] = chunk.T
        state = permute(state)
    return state[:DIGEST_ELEMS]


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """2-to-1 compression of (4, N) digests: permute [l || r || 0^4]."""
    zero = np.zeros((WIDTH - 2 * DIGEST_ELEMS, left.shape[1]), dtype=U)
    return permute(np.concatenate([left, right, zero]))[:DIGEST_ELEMS]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class MerkleChecks:
    """verify_batch calls (commit.rs:62-129) gathered, then checked all at
    once: calls of one shape (the widths per height, the path length)
    share every array call.  `add` returns a handle; `run` gives each
    handle's verdict."""

    def __init__(self):
        self._calls: List[Tuple] = []

    def add(self, commit, dimensions, index, opened_values, proof) -> int:
        self._calls.append((commit, dimensions, index, opened_values, proof))
        return len(self._calls) - 1

    def run(self) -> List[bool]:
        # equal calls (a tampered proof repeats most of its original's)
        # are checked once
        first: Dict[Tuple, int] = {}
        same = []
        for h, (commit, dims, index, opened, proof) in enumerate(self._calls):
            key = (tuple(commit), tuple(map(tuple, dims)), index,
                   tuple(map(tuple, opened)), tuple(map(tuple, proof)))
            same.append(first.setdefault(key, h))
        groups: Dict[Tuple, List[int]] = {}
        for h in sorted(set(same)):
            _, dims, _, opened, proof = self._calls[h]
            key = (tuple(d[1] for d in dims),
                   tuple(len(r) for r in opened), len(proof))
            groups.setdefault(key, []).append(h)
        ok = {}
        for hs in groups.values():
            for h, v in zip(hs, _verify_group([self._calls[h] for h in hs])):
                ok[h] = v
        return [ok[s] for s in same]


def _verify_group(calls) -> List[bool]:
    """verify_batch of same-shape calls, vectorised over the calls."""
    _, dims, _, opened0, proof0 = calls[0]
    order = sorted(range(len(dims)), key=lambda i: -dims[i][1])
    index = np.asarray([c[2] for c in calls], dtype=np.int64)

    def rows(mats):
        return np.concatenate(
            [canonical([c[3][i] for c in calls]).reshape(len(calls), -1)
             for i in mats], axis=1)

    pos = 0
    height = _next_pow2(dims[order[0]][1])
    first = []
    while pos < len(order) and _next_pow2(dims[order[pos]][1]) == height:
        first.append(order[pos])
        pos += 1
    root = hash_rows(rows(first))
    sibs = canonical([c[4] for c in calls])                     # (N, D, 4)
    for level in range(len(proof0)):
        sib = sibs[:, level].T
        odd = (index & 1).astype(bool)
        left = np.where(odd, sib, root)
        right = np.where(odd, root, sib)
        root = compress(left, right)
        index = index >> 1
        height >>= 1
        if pos < len(order) and _next_pow2(dims[order[pos]][1]) == height:
            nxt = dims[order[pos]][1]
            mats = []
            while pos < len(order) and dims[order[pos]][1] == nxt:
                mats.append(order[pos])
                pos += 1
            root = compress(root, hash_rows(rows(mats)))
    # the commitment as given: a value that is not canonical matches nothing
    return [r == list(c[0]) for r, c in zip(root.T.tolist(), calls)]


def canonical(values) -> np.ndarray:
    """Nested lists of ints as canonical uint64 (the oracle's permutation
    reduces its inputs mod p)."""
    return np.asarray(np.asarray(values, dtype=object) % GOLDILOCKS_P,
                      dtype=U)


def permute_states(states: Sequence[Sequence[int]]) -> List[List[int]]:
    """Poseidon2 of a list of 12-lane int states (the oracle's calling
    convention, for tests)."""
    s = canonical(states).T
    return permute(s).T.tolist()
