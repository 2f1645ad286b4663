"""Hash-chain AIR (a copy of plonky25_tpu/models/poseidon2_air.py, its
trace builder in PyTorch ops): Poseidon2 permutations as degree-3
constraints, with chaining and data-binding columns — the
constraint-evaluation form of the reference's Poseidon2Gate
(src/common/poseidon2/poseidon2_gate.rs:150-397, the 123-constraint
degree-7 gate) re-shaped for a STARK prover capped at degree 3, plus the
row-linking machinery the recursive attestation needs (attest.py).

One row = one width-12 Poseidon2 permutation.  Core columns store, per
round, the CUBE of each S-box input (so x^7 = t^2 * x stays degree 3 given
the constraint t = x^3) and the post-round state (so the next round's
constraints stay degree 3 in stored columns):

    in[12]
    | per external round r (8): t_r[12], out_r[12]
    | per internal round r (22): t_r[1],  out_r[12]

with the initial external matmul and all linear layers folded into the
constraint expressions as integer matrices.  out of the last external
round is the permutation output.

Chain columns (see attest.py for the protocol):

    sel_t, sel_c, sel_l : row type one-hot-or-zero (transcript duplex,
                          Merkle compress, leaf absorb); all zero = padding
    b                   : sibling-order bit for compress rows
    m[12]               : input-lane absorb mask (fresh data lanes)
    mo[12]              : output-lane expose mask (digests / challenges)
    acc1, acc2          : running absorb accumulators (slots gamma^j)
    acco1, acco2        : running expose accumulators

Transition constraints (all trace-degree <= 3):
  compress row r+1: non-sibling input half copies row r's output digest
    (side chosen by b), capacity lanes 8..11 are zero;
  transcript row r+1: non-absorbed lanes copy row r's full output;
  leaf row r+1: non-absorbed lanes are zero (chain start);
  acc/acco: acc' = active'*(acc*g^12 + sum_j m'_j in'_j g^j) +
            (1-active')*acc, for two independent gammas.
Boundary: first row is a chain start; last row's accumulators equal the
public values carried by the Air instance.

The soundness story for why free m/mo witness masks still bind the data
(any deviation from the canonical absorb/expose schedule shifts a slot and
breaks the accumulator equality the checker recomputes) lives in
attest.py's module docstring.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..air import Air, VerifierConstraintFolder
from ..fields import gl
from ..fields.goldilocks import GL
from ..ops.poseidon2 import _matmul_external, _plain_constants, _sum_lanes
from ..constants import (
    GOLDILOCKS_P as P,
    MAT_DIAG_M_1,
    RC,
    RC_MID,
    ROUND_F_BEGIN,
    ROUND_F_END,
    WIDTH,
)

N_EXT = ROUND_F_END  # 8
N_INT = len(RC_MID)  # 22

# ---------------------------------------------------------------- layout
IN_OFF = 0


def _build_layout():
    """Round order: ext 0..3, int 0..21, ext 4..7 (poseidon2.rs:93-111)."""
    rounds = []
    off = WIDTH
    for r in range(ROUND_F_BEGIN):
        rounds.append(("ext", r, off, off + WIDTH))
        off += 2 * WIDTH
    for r in range(N_INT):
        rounds.append(("int", r, off, off + 1))
        off += 1 + WIDTH
    for r in range(ROUND_F_BEGIN, N_EXT):
        rounds.append(("ext", r, off, off + WIDTH))
        off += 2 * WIDTH
    return rounds, off


ROUNDS, CORE_WIDTH = _build_layout()
OUT_OFF = ROUNDS[-1][3]  # final state columns

SEL_T = CORE_WIDTH
SEL_C = CORE_WIDTH + 1
SEL_L = CORE_WIDTH + 2
B_COL = CORE_WIDTH + 3
M_OFF = CORE_WIDTH + 4
MO_OFF = M_OFF + WIDTH
ACC_OFF = MO_OFF + WIDTH     # acc1, acc2
ACCO_OFF = ACC_OFF + 2       # acco1, acco2
NUM_HASH_COLS = ACCO_OFF + 2


def _m4() -> np.ndarray:
    return np.array(
        [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]], object)


def _m_ext() -> np.ndarray:
    """External matrix circ(2*M4, M4, M4) (poseidon2.rs:127-147)."""
    m4 = _m4()
    m = np.zeros((WIDTH, WIDTH), object)
    for a in range(3):
        for b in range(3):
            m[4 * a:4 * a + 4, 4 * b:4 * b + 4] = m4 * (2 if a == b else 1)
    return m


def _m_int() -> np.ndarray:
    """Internal matrix diag(MAT_DIAG_M_1) ... = J + diag(d_i - 1)
    (poseidon2.rs:164-182): entry (i, j) = d_i if i == j else 1."""
    m = np.ones((WIDTH, WIDTH), object)
    for i in range(WIDTH):
        m[i, i] = MAT_DIAG_M_1[i] % P
    return m


M_EXT = _m_ext()
M_INT = _m_int()


# ---------------------------------------------------------- trace

def poseidon2_core_rows(states: GL) -> GL:
    """Core-column trace on the states' device: GL (R, 12) inputs -> GL
    (R, CORE_WIDTH).

    The plain permutation of ops/poseidon2.py, storing each S-box cube and
    post-round state (JAX jits this; eager PyTorch runs its ops on the
    caller's device).  Columns OUT_OFF..OUT_OFF+11 are the permutation's
    output, equal to the Poseidon2 kernels' for the same states."""
    rc_ext, rc_mid, diag = _plain_constants(states.device)
    cols = [states]
    s = _matmul_external(states)
    for kind, r, _, _ in ROUNDS:
        if kind == "ext":
            u = gl.add(s, rc_ext[r])
            t = gl.mul(gl.square(u), u)                  # x^3
            y = gl.mul(gl.square(t), u)                  # x^7
            s = _matmul_external(y)
            cols.append(t)
            cols.append(s)
        else:
            u0 = gl.add(s[..., 0], rc_mid[r])
            t0 = gl.mul(gl.square(u0), u0)
            y0 = gl.mul(gl.square(t0), u0)
            s = gl.concatenate([y0[..., None], s[..., 1:]], dim=-1)
            s = gl.add(gl.mul(diag, s), _sum_lanes(s)[..., None])
            cols.append(t0[..., None])
            cols.append(s)
    return gl.concatenate(cols, dim=-1)


# ------------------------------------------------------------------- AIR

def eval_poseidon2_core(folder: VerifierConstraintFolder, L):
    """Emit the Poseidon2 core constraints (one permutation per row) on
    the stacked local vector `L`; returns the (12,) input-lane segment.
    Shared by HashChainAir and VerifierAir (models/verifier_air.py).

    Vectorized over the ROUND axis: per-round unrolling put ~50k HLO ops
    in the quotient graph and sent XLA's algebraic simplifier into
    minutes-long loops; instead the rounds of a kind are stacked on the
    constraint axis and each segment emits ONE vector constraint pair
    (compile-cost discipline, see verifier.py module docstring)."""
    ops = folder.ops
    take = ops.take

    def cvec(ints):
        return ops.const_base(np.asarray(ints, object))

    def matvec(mat, v):
        """(12,)-vector constraint expr: mat @ v with integer mat."""
        out = None
        for j in range(WIDTH):
            vj = take(v, np.full(WIDTH, j))
            term = ops.mul(cvec(mat[:, j]), vj)
            out = term if out is None else ops.add(out, term)
        return out

    in_v = take(L, np.arange(IN_OFF, IN_OFF + WIDTH))
    s0 = matvec(M_EXT, in_v)                     # (12,) expr

    ext_rounds = [rt for rt in ROUNDS if rt[0] == "ext"]
    int_rounds = [rt for rt in ROUNDS if rt[0] == "int"]
    ext_t_idx = np.asarray([[t + j for j in range(WIDTH)]
                            for _, _, t, _ in ext_rounds])   # (8, 12)
    ext_o_idx = np.asarray([[o + j for j in range(WIDTH)]
                            for _, _, _, o in ext_rounds])
    int_t_idx = np.asarray([t for _, _, t, _ in int_rounds])  # (22,)
    int_o_idx = np.asarray([[o + j for j in range(WIDTH)]
                            for _, _, _, o in int_rounds])

    def matvec_rounds(mat, y_flat, n_rounds):
        """Per-round matvec on a flattened (n_rounds*12,) vector."""
        base = (np.arange(n_rounds * WIDTH) // WIDTH) * WIDTH
        out = None
        for j in range(WIDTH):
            yj = take(y_flat, base + j)
            coef = cvec([mat[i % WIDTH, j]
                         for i in range(n_rounds * WIDTH)])
            term = ops.mul(coef, yj)
            out = term if out is None else ops.add(out, term)
        return out

    def cube(u):
        return ops.mul(ops.mul(u, u), u)

    # --- external segment 1 (rounds 0..3) and 2 (rounds 4..7) ------
    for seg_r in (range(0, ROUND_F_BEGIN), range(ROUND_F_BEGIN, N_EXT)):
        seg_r = list(seg_r)
        k = len(seg_r)
        t_flat = take(L, ext_t_idx[seg_r].reshape(-1))       # (k*12,)
        out_flat = take(L, ext_o_idx[seg_r].reshape(-1))
        # s_prev rows: round seg_r[0] chains from M_E(in) or the last
        # internal round; later rounds from the previous ext out
        if seg_r[0] == 0:
            first_prev = s0
        else:
            first_prev = take(L, int_o_idx[-1])
        prev_flat = ops.concat(
            [first_prev] +
            [take(L, ext_o_idx[r - 1].reshape(-1))
             for r in seg_r[1:]])
        rc_flat = cvec([RC[r][j] % P for r in seg_r
                        for j in range(WIDTH)])
        u = ops.add(prev_flat, rc_flat)
        folder.assert_zero(ops.sub(t_flat, cube(u)))
        y = ops.mul(ops.mul(t_flat, t_flat), u)
        folder.assert_zero(
            ops.sub(out_flat, matvec_rounds(M_EXT, y, k)))

    # --- internal segment (22 rounds) --------------------------------
    ki = N_INT
    prev_i = ops.concat(
        [take(L, ext_o_idx[ROUND_F_BEGIN - 1].reshape(-1))] +
        [take(L, int_o_idx[r - 1].reshape(-1)) for r in range(1, ki)]
    )                                                       # (22*12,)
    lane0 = (np.arange(ki * WIDTH) % WIDTH == 0).astype(object)
    u0 = ops.add(take(prev_i, np.arange(ki) * WIDTH),
                 cvec([RC_MID[r] % P for r in range(ki)]))   # (22,)
    t0 = take(L, int_t_idx)                                  # (22,)
    folder.assert_zero(ops.sub(t0, cube(u0)))
    y0 = ops.mul(ops.mul(t0, t0), u0)                        # (22,)
    # y_flat: lane 0 of each round replaced by y0
    y0_g = take(y0, np.arange(ki * WIDTH) // WIDTH)          # (22*12,)
    mask0 = cvec(lane0)
    one_flat = cvec(np.ones(ki * WIDTH, object))
    y_flat = ops.add(ops.mul(mask0, y0_g),
                     ops.mul(ops.sub(one_flat, mask0), prev_i))
    out_i_flat = take(L, int_o_idx.reshape(-1))
    folder.assert_zero(
        ops.sub(out_i_flat, matvec_rounds(M_INT, y_flat, ki)))

    return in_v


class HashChainAir(Air):
    """The attestation AIR.  `publics` carries the boundary values the
    last row's accumulators must equal, plus the two gammas; they become
    constants of the constraint system, so the verifier/prover cache key
    (name()) includes their hash."""

    def __init__(self, publics: Optional[Dict] = None):
        # publics: {"gamma": (g1, g2), "acc": (a1, a2), "acc_out": (o1, o2)}
        self.publics = publics or {
            "gamma": (0, 0), "acc": (0, 0), "acc_out": (0, 0)}

    def name(self) -> str:
        # publics are runtime inputs (folder.publics), not baked constants,
        # so every attestation shares one prover/verifier specialization
        return "HashChain"

    def public_values(self):
        return {
            "gamma1": self.publics["gamma"][0],
            "gamma2": self.publics["gamma"][1],
            "acc1": self.publics["acc"][0],
            "acc2": self.publics["acc"][1],
            "acco1": self.publics["acc_out"][0],
            "acco2": self.publics["acc_out"][1],
        }

    def width(self) -> int:
        return NUM_HASH_COLS

    def quotient_degree(self) -> int:
        return 2  # max constraint degree 3

    def eval(self, folder: VerifierConstraintFolder) -> None:
        ops = folder.ops
        main = folder.main
        L = getattr(main, "local_vec", None)
        if L is None:
            L = ops.stack(main.trace_local)
        N = getattr(main, "next_vec", None)
        if N is None:
            N = ops.stack(main.trace_next)
        take = ops.take

        def seg(src, off, n):
            return take(src, np.arange(off, off + n))

        def cvec(ints):
            return ops.const_base(np.asarray(ints, object))

        one = ops.const_base(np.ones(1, object))

        def assert_bool(v):
            folder.assert_zero(ops.mul(v, ops.sub(v, one)))

        in_v = eval_poseidon2_core(folder, L)

        # ---- chain machinery -------------------------------------------
        sel_t = seg(L, SEL_T, 1)
        sel_c = seg(L, SEL_C, 1)
        sel_l = seg(L, SEL_L, 1)
        b = seg(L, B_COL, 1)
        m = seg(L, M_OFF, WIDTH)
        mo = seg(L, MO_OFF, WIDTH)
        n_sel_t = seg(N, SEL_T, 1)
        n_sel_c = seg(N, SEL_C, 1)
        n_sel_l = seg(N, SEL_L, 1)
        n_b = seg(N, B_COL, 1)
        n_m = seg(N, M_OFF, WIDTH)
        n_in = seg(N, IN_OFF, WIDTH)
        out_d = seg(L, OUT_OFF, WIDTH)       # this row's digest/output

        for v in (sel_t, sel_c, sel_l, b):
            assert_bool(v)
        assert_bool(m)
        assert_bool(mo)
        active = ops.add(ops.add(sel_t, sel_c), sel_l)
        assert_bool(active)                   # row types mutually exclusive
        # active rows form a PREFIX: once inactive, always inactive.
        # Without this, an interior padding row's unconstrained input lanes
        # let a prover chain a later sel_t row from perm^-1 of a chosen
        # state while the accumulators stay canonical — forged Fiat-Shamir
        # samples for absorb-free duplexes (advisor finding, round 2).
        folder.when_transition().assert_zero(
            ops.mul(ops.sub(one, active),
                    ops.add(ops.add(n_sel_t, n_sel_c), n_sel_l)))

        def rep(x):
            """(1,) -> broadcast against (k,) vectors via take."""
            return take(x, np.zeros(WIDTH, np.int32))

        def rep4(x):
            return take(x, np.zeros(4, np.int32))

        # compress chaining (transition): the half NOT holding the sibling
        # copies the previous row's digest; capacity lanes are zero.
        prev_dig = take(out_d, np.arange(4))
        nb4 = rep4(n_b)
        n_left = take(n_in, np.arange(0, 4))
        n_right = take(n_in, np.arange(4, 8))
        n_cap = take(n_in, np.arange(8, WIDTH))
        gate_c = rep4(n_sel_c)
        folder.when_transition().assert_zero(
            ops.mul(gate_c, ops.mul(ops.sub(one, nb4),
                                    ops.sub(n_left, prev_dig))))
        folder.when_transition().assert_zero(
            ops.mul(gate_c, ops.mul(nb4, ops.sub(n_right, prev_dig))))
        folder.when_transition().assert_zero(
            ops.mul(take(n_sel_c, np.zeros(4, np.int32)), n_cap))

        # transcript chaining: non-absorbed lanes copy the previous output
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_t),
                    ops.mul(ops.sub(one, n_m), ops.sub(n_in, out_d))))

        # leaf chain start: non-absorbed lanes are zero
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_l), ops.mul(ops.sub(one, n_m), n_in)))
        # row 0 is a chain start of some type
        folder.when_first_row().assert_zero(
            ops.mul(ops.sub(one, m), in_v))

        # ---- accumulators ----------------------------------------------
        # publics come through the folder as RUNTIME backend scalars (so
        # all attestations share one compiled module); direct-eval tests
        # without a publics channel fall back to baked constants.
        if folder.publics:
            pub = folder.publics
        else:
            pub = {
                "gamma1": ops.from_base(self.publics["gamma"][0]),
                "gamma2": ops.from_base(self.publics["gamma"][1]),
                "acc1": ops.from_base(self.publics["acc"][0]),
                "acc2": ops.from_base(self.publics["acc"][1]),
                "acco1": ops.from_base(self.publics["acc_out"][0]),
                "acco2": ops.from_base(self.publics["acc_out"][1]),
            }
        gammas = (pub["gamma1"], pub["gamma2"])
        # gamma^j tables as scalar expression chains (public, degree 0)
        gpows = []
        for g in gammas:
            row = [ops.one()]
            for _ in range(WIDTH):
                row.append(ops.mul(row[-1], g))
            gpows.append(row)

        acc = seg(L, ACC_OFF, 2)
        acco = seg(L, ACCO_OFF, 2)
        n_acc = seg(N, ACC_OFF, 2)
        n_acco = seg(N, ACCO_OFF, 2)
        n_mo = seg(N, MO_OFF, WIDTH)
        n_out = seg(N, OUT_OFF, WIDTH)
        n_active = ops.add(ops.add(n_sel_t, n_sel_c), n_sel_l)

        def contrib_k(k, mask, vals):
            """(1,)-vector: sum_j mask_j vals_j gamma_k^j."""
            accum = None
            for j in range(WIDTH):
                term = ops.mul(
                    ops.mul(take(mask, [j]), take(vals, [j])), gpows[k][j])
                accum = term if accum is None else ops.add(accum, term)
            return accum

        def acc_step(cur, nxt, mask, vals):
            for k in range(2):
                cur_k = take(cur, [k])
                nxt_k = take(nxt, [k])
                want = ops.add(ops.mul(cur_k, gpows[k][WIDTH]),
                               contrib_k(k, mask, vals))
                folder.when_transition().assert_zero(
                    ops.sub(nxt_k,
                            ops.add(ops.mul(n_active, want),
                                    ops.mul(ops.sub(one, n_active), cur_k))))

        acc_step(acc, n_acc, n_m, n_in)
        acc_step(acco, n_acco, n_mo, n_out)
        # first row: acc = contribution(row0), acco = exposure(row0)
        for k in range(2):
            folder.when_first_row().assert_zero(
                ops.sub(take(acc, [k]), contrib_k(k, m, in_v)))
            folder.when_first_row().assert_zero(
                ops.sub(take(acco, [k]), contrib_k(k, mo, out_d)))
        # last row: accumulators equal the public values
        for k, name in ((0, "acc1"), (1, "acc2")):
            folder.when_last_row().assert_zero(
                ops.sub(take(acc, [k]), pub[name]))
        for k, name in ((0, "acco1"), (1, "acco2")):
            folder.when_last_row().assert_zero(
                ops.sub(take(acco, [k]), pub[name]))
