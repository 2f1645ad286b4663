"""Keccak-f[1600] AIR: one row per round, 2633 columns (BASELINE config 4);
a frozen copy of plonky25_torch/models/keccak_air.py.

Plonky3-keccak-air-shaped layout (same column groups and count):

    step_flags[24] | export | preimage[y][x][limb] (100) | a[y][x][limb]
    (100) | c[x][z] (320) | c_prime[x][z] (320) | a_prime[y][x][z] (1600) |
    a_prime_prime[y][x][limb] (100) | a_prime_prime_0_0_bits[64] |
    a_prime_prime_prime_0_0_limbs[4]                       = 2633 columns

Lanes are 64-bit, stored as 4 x u16 limbs (little-endian); single bits are
boolean columns.  Logical lane (x, y) lives at storage index [y][x].

Constraint set (max degree 3 => quotient_degree 2, two quotient chunks):
  (a) flags rotate one step per row (transition)
  (b) first row: step_flags == one-hot(0)
  (c) export is boolean
  (d) preimage constant within a permutation (transition, gated on the
      next row not starting a new permutation)
  (e) rows starting a permutation load a == preimage
  (f..i) all bit columns boolean
  (j) c_prime[x,z] == xor3(c[x,z], c[x-1,z], c[x+1,z-1])      (theta aux)
  (k) a limbs recompose from xor3(a_prime, c, c_prime)        (theta undo)
  (l) sum_y a_prime[y][x][z] has parity c_prime[x,z]:
      diff*(diff-2)*(diff-4) == 0                             (theta link)
  (m) a_prime_prime limbs recompose chi(rho/pi(a_prime)) bits (rho/pi/chi)
  (n) a_prime_prime[0][0] limbs recompose its bit column
  (o) a_prime_prime_prime_0_0_limbs recompose bits xor RC(flags)   (iota)
  (p) next row's a continues this round's output (transition, gated)

All constraints are emitted as VECTORS (GL2 tensors with a leading
constraint axis) so the 3,501 constraints cost a few hundred tensor ops, not
thousands of scalar ones; the folding order is the fixed (a)..(p) order
above with C-order flattening inside each vector (fields/extension.py,
Ops.fold_constraints).  The wiring tables are static numpy arrays; Ops.take
turns each into an index tensor once per device (an ascending run into a
slice, a view), so an eval sends no table to the device after the first.
"""

from __future__ import annotations

import numpy as np

from .air import Air, VerifierConstraintFolder
from .keccak import MASK64, NUM_ROUNDS, R, RC

# ---------------------------------------------------------------- layout
OFF_FLAGS = 0
OFF_EXPORT = 24
OFF_PREIMAGE = 25
OFF_A = 125
OFF_C = 225
OFF_C_PRIME = 545
OFF_A_PRIME = 865
OFF_APP = 2465
OFF_APP00_BITS = 2565
OFF_APPP00_LIMBS = 2629
NUM_KECCAK_COLS = 2633

LIMBS = 4
BITS_PER_LIMB = 16


def _lane(y: int, x: int) -> int:
    return y * 5 + x


def _a_prime_idx(y: int, x: int, z: int) -> int:
    return _lane(y, x) * 64 + z


def _c_idx(x: int, z: int) -> int:
    return x * 64 + z


# ---- static index tables (wiring) -----------------------------------------

def _build_tables():
    # (j) xor3 sources over the 320 (x, z) entries
    cp_src = np.zeros((3, 320), np.int32)
    for x in range(5):
        for z in range(64):
            i = _c_idx(x, z)
            cp_src[0, i] = _c_idx(x, z)
            cp_src[1, i] = _c_idx((x - 1) % 5, z)
            cp_src[2, i] = _c_idx((x + 1) % 5, (z - 1) % 64)

    # (k) for each a_prime bit: matching c / c_prime index
    ap_to_c = np.zeros(1600, np.int32)
    for y in range(5):
        for x in range(5):
            for z in range(64):
                ap_to_c[_a_prime_idx(y, x, z)] = _c_idx(x, z)

    # limb recomposition: limb entry j (lane j//4, limb j%4) sums bits
    # 16*(j%4) .. of its lane
    limb_bits = np.zeros((100, BITS_PER_LIMB), np.int32)
    for j in range(100):
        lane, l = divmod(j, LIMBS)
        for i in range(BITS_PER_LIMB):
            limb_bits[j, i] = lane * 64 + l * BITS_PER_LIMB + i

    # rho/pi: B(xB, yB, z) = a_prime[y][x][(z - R[x][y]) % 64]
    # with xB = y, yB = (2x + 3y) % 5
    b_index = np.zeros((5, 5, 64), np.int32)
    for x in range(5):
        for y in range(5):
            xb, yb = y, (2 * x + 3 * y) % 5
            for z in range(64):
                b_index[xb, yb, z] = _a_prime_idx(y, x, (z - R[x][y]) % 64)

    # chi sources for output lane (x, y) bit z, in storage order [y][x][z]
    chi_src = np.zeros((3, 1600), np.int32)
    for y in range(5):
        for x in range(5):
            for z in range(64):
                i = _lane(y, x) * 64 + z
                chi_src[0, i] = b_index[x, y, z]
                chi_src[1, i] = b_index[(x + 1) % 5, y, z]
                chi_src[2, i] = b_index[(x + 2) % 5, y, z]

    # parity sources: for each (x, z): the 5 a_prime bits over y
    par_src = np.zeros((5, 320), np.int32)
    for x in range(5):
        for z in range(64):
            i = _c_idx(x, z)
            for y in range(5):
                par_src[y, i] = _a_prime_idx(y, x, z)

    # RC bits per round
    rc_bits = np.zeros((NUM_ROUNDS, 64), np.int64)
    for r in range(NUM_ROUNDS):
        for z in range(64):
            rc_bits[r, z] = (RC[r] >> z) & 1

    return cp_src, ap_to_c, limb_bits, b_index, chi_src, par_src, rc_bits


(_CP_SRC, _AP_TO_C, _LIMB_BITS, _B_INDEX, _CHI_SRC, _PAR_SRC,
 _RC_BITS) = _build_tables()

_POW2 = [1 << i for i in range(BITS_PER_LIMB)]


class KeccakAir(Air):
    def name(self) -> str:
        return "Keccak"

    def width(self) -> int:
        return NUM_KECCAK_COLS

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

        def xor(a, b):
            ab = ops.mul(a, b)
            return ops.sub(ops.sub(ops.add(a, b), ab), ab)

        def assert_bool(v):
            one_like = ops.const_base(np.ones(1, np.int64))
            folder.assert_zero(ops.mul(v, ops.sub(v, one_like)))

        flags = seg(L, OFF_FLAGS, 24)
        nflags = seg(N, OFF_FLAGS, 24)
        export = seg(L, OFF_EXPORT, 1)
        preimage = seg(L, OFF_PREIMAGE, 100)
        npreimage = seg(N, OFF_PREIMAGE, 100)
        a = seg(L, OFF_A, 100)
        na = seg(N, OFF_A, 100)
        c = seg(L, OFF_C, 320)
        c_prime = seg(L, OFF_C_PRIME, 320)
        a_prime = seg(L, OFF_A_PRIME, 1600)
        app = seg(L, OFF_APP, 100)
        app00_bits = seg(L, OFF_APP00_BITS, 64)
        appp00 = seg(L, OFF_APPP00_LIMBS, 4)

        one = ops.const_base(np.ones(1, np.int64))
        not_new_perm = ops.sub(one, take(N, [OFF_FLAGS]))  # 1 - next.flags[0]

        # (a) flags rotation
        folder.when_transition().assert_zero(
            ops.sub(nflags, take(flags, [(i - 1) % 24 for i in range(24)]))
        )
        # (b) first row one-hot
        onehot = np.zeros(24, np.int64)
        onehot[0] = 1
        folder.when_first_row().assert_zero(ops.sub(flags, ops.const_base(onehot)))
        # (c) export boolean
        assert_bool(export)
        # (d) preimage continuity
        folder.when_transition().assert_zero(
            ops.mul(not_new_perm, ops.sub(npreimage, preimage))
        )
        # (e) permutation start loads the preimage
        folder.assert_zero(ops.mul(take(flags, [0]), ops.sub(a, preimage)))
        # (f..i) booleanity
        assert_bool(c)
        assert_bool(c_prime)
        assert_bool(a_prime)
        assert_bool(app00_bits)
        # (j) theta aux: c_prime = xor3
        x3 = xor(xor(take(c, _CP_SRC[0]), take(c, _CP_SRC[1])), take(c, _CP_SRC[2]))
        folder.assert_zero(ops.sub(c_prime, x3))
        # (k) a limbs recompose xor3(a_prime, c, c_prime)
        bits_k = xor(xor(a_prime, take(c, _AP_TO_C)), take(c_prime, _AP_TO_C))
        folder.assert_zero(ops.sub(a, _recompose(ops, bits_k)))
        # (l) parity link
        s = take(a_prime, _PAR_SRC[0])
        for yy in range(1, 5):
            s = ops.add(s, take(a_prime, _PAR_SRC[yy]))
        diff = ops.sub(s, c_prime)
        two = ops.const_base(np.full(1, 2, np.int64))
        four = ops.const_base(np.full(1, 4, np.int64))
        folder.assert_zero(
            ops.mul(diff, ops.mul(ops.sub(diff, two), ops.sub(diff, four)))
        )
        # (m) rho/pi/chi
        b0 = take(a_prime, _CHI_SRC[0])
        b1 = take(a_prime, _CHI_SRC[1])
        b2 = take(a_prime, _CHI_SRC[2])
        andn = ops.sub(b2, ops.mul(b1, b2))  # (1 - b1) * b2
        chi_bits = xor(b0, andn)
        folder.assert_zero(ops.sub(app, _recompose(ops, chi_bits)))
        # (n) a_prime_prime[0][0] limbs == recompose(app00_bits)
        app00_limbs = take(app, np.arange(4))
        folder.assert_zero(ops.sub(app00_limbs, _recompose00(ops, app00_bits)))
        # (o) iota
        rc = None
        for r in range(NUM_ROUNDS):
            term = ops.mul(take(flags, np.full(64, r)),
                           ops.const_base(_RC_BITS[r]))
            rc = term if rc is None else ops.add(rc, term)
        iota_bits = xor(app00_bits, rc)
        folder.assert_zero(ops.sub(appp00, _recompose00(ops, iota_bits)))
        # (p) round chaining: output limbs = app with lane (0,0) from appp00
        non00 = np.arange(4, 100)
        folder.when_transition().assert_zero(
            ops.mul(not_new_perm,
                    ops.sub(take(na, non00), take(app, non00)))
        )
        folder.when_transition().assert_zero(
            ops.mul(not_new_perm, ops.sub(take(na, np.arange(4)), appp00))
        )


def _recompose(ops, bits):
    """(1600,...) bit vector -> (100,...) u16-limb vector."""
    out = None
    for i in range(BITS_PER_LIMB):
        term = ops.mul(ops.take(bits, _LIMB_BITS[:, i]),
                       ops.const_base(np.full(1, _POW2[i], np.int64)))
        out = term if out is None else ops.add(out, term)
    return out


def _recompose00(ops, bits64):
    """(64,...) bit vector -> (4,...) limbs of one lane."""
    idx = np.arange(64).reshape(4, 16)
    out = None
    for i in range(BITS_PER_LIMB):
        term = ops.mul(ops.take(bits64, idx[:, i]),
                       ops.const_base(np.full(1, _POW2[i], np.int64)))
        out = term if out is None else ops.add(out, term)
    return out


# ------------------------------------------------------------- trace gen

def keccak_trace(inputs, min_height: int = 0):
    """Row-major trace for a list of 25-lane permutation inputs.

    Pads the height to a power of two by continuing with (possibly
    truncated) dummy permutations on the all-zero input — truncated rounds
    are genuine rounds, so every padding row satisfies the constraints."""
    def bits(v, n=64):
        return [(v >> i) & 1 for i in range(n)]

    def limbs(v):
        return [(v >> (16 * i)) & 0xFFFF for i in range(LIMBS)]

    rows = []
    height = max(len(inputs) * NUM_ROUNDS, min_height, 1)
    height = 1 << (height - 1).bit_length()
    n_perms = -(-height // NUM_ROUNDS)
    all_inputs = list(inputs) + [[0] * 25] * (n_perms - len(inputs))

    for p_i, flat in enumerate(all_inputs):
        A = [[flat[x + 5 * y] for y in range(5)] for x in range(5)]
        pre = flat
        for r in range(NUM_ROUNDS):
            if len(rows) == height:
                break
            row = [0] * NUM_KECCAK_COLS
            row[OFF_FLAGS + r] = 1
            row[OFF_EXPORT] = 1 if (r == NUM_ROUNDS - 1 and p_i < len(inputs)) else 0
            for y in range(5):
                for x in range(5):
                    for l in range(LIMBS):
                        row[OFF_PREIMAGE + _lane(y, x) * 4 + l] = limbs(pre[x + 5 * y])[l]
                        row[OFF_A + _lane(y, x) * 4 + l] = limbs(A[x][y])[l]
            # theta
            C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
            Cp = [C[x] ^ C[(x - 1) % 5] ^ (((C[(x + 1) % 5] << 1)
                  | (C[(x + 1) % 5] >> 63)) & MASK64) for x in range(5)]
            D = [C[x] ^ Cp[x] for x in range(5)]
            Ath = [[A[x][y] ^ D[x] for y in range(5)] for x in range(5)]
            for x in range(5):
                for z in range(64):
                    row[OFF_C + _c_idx(x, z)] = (C[x] >> z) & 1
                    row[OFF_C_PRIME + _c_idx(x, z)] = (Cp[x] >> z) & 1
            for y in range(5):
                for x in range(5):
                    for z in range(64):
                        row[OFF_A_PRIME + _a_prime_idx(y, x, z)] = (Ath[x][y] >> z) & 1
            # rho/pi
            B = [[0] * 5 for _ in range(5)]
            for x in range(5):
                for y in range(5):
                    v = Ath[x][y]
                    n = R[x][y]
                    B[y][(2 * x + 3 * y) % 5] = ((v << n) | (v >> (64 - n))) & MASK64 if n else v
            # chi
            out = [[B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y] & MASK64)
                    for y in range(5)] for x in range(5)]
            for y in range(5):
                for x in range(5):
                    for l in range(LIMBS):
                        row[OFF_APP + _lane(y, x) * 4 + l] = limbs(out[x][y])[l]
            for z in range(64):
                row[OFF_APP00_BITS + z] = (out[0][0] >> z) & 1
            # iota
            o00 = out[0][0] ^ RC[r]
            for l in range(LIMBS):
                row[OFF_APPP00_LIMBS + l] = limbs(o00)[l]
            out[0][0] = o00
            A = out
            rows.append(row)
        if len(rows) == height:
            break
    return rows


def keccak_trace_np(inputs, min_height: int = 0) -> "np.ndarray":
    """Vectorized trace generation: (height, NUM_KECCAK_COLS) int64.

    Semantics identical to keccak_trace (asserted in tests), but all
    permutations advance together as numpy uint64 lane arrays — the host
    scalar loops over 2633 columns per row made 2^12-row traces take
    minutes (VERDICT r1 weak #1); this path is array ops throughout."""
    U = np.uint64
    MASK = U(0xFFFFFFFFFFFFFFFF)

    height = max(len(inputs) * NUM_ROUNDS, min_height, 1)
    height = 1 << (height - 1).bit_length()
    n_perms = -(-height // NUM_ROUNDS)
    flat = np.zeros((n_perms, 25), U)
    for i, inp in enumerate(inputs):
        flat[i] = [v & 0xFFFFFFFFFFFFFFFF for v in inp]

    # lane (x, y) = flat[:, x + 5y]; A[p, x, y]
    A = flat.reshape(n_perms, 5, 5).transpose(0, 2, 1).copy()
    pre = A.copy()
    out = np.zeros((n_perms, NUM_ROUNDS, NUM_KECCAK_COLS), np.int64)

    z64 = np.arange(64, dtype=U)
    l16 = (np.arange(LIMBS, dtype=U) * U(16))

    def put_limbs(dst_off, lanes_yx):
        """lanes_yx: (P, 5, 5) indexed [p, x, y]; storage order is
        _lane(y, x)*4 + l."""
        v = lanes_yx.transpose(0, 2, 1).reshape(n_perms, 25)  # [p, y*5+x]
        limbs = ((v[:, :, None] >> l16) & U(0xFFFF)).astype(np.int64)
        out[:, r, dst_off:dst_off + 100] = limbs.reshape(n_perms, 100)

    def bits64(v):
        return ((v[:, None] >> z64) & U(1)).astype(np.int64)

    for r in range(NUM_ROUNDS):
        out[:, r, OFF_FLAGS + r] = 1
        if r == NUM_ROUNDS - 1:
            out[:len(inputs), r, OFF_EXPORT] = 1
        put_limbs(OFF_PREIMAGE, pre)
        put_limbs(OFF_A, A)

        C = A[:, :, 0] ^ A[:, :, 1] ^ A[:, :, 2] ^ A[:, :, 3] ^ A[:, :, 4]
        Cl = np.roll(C, 1, axis=1)                      # C[(x-1) % 5]
        Cr = np.roll(C, -1, axis=1)                     # C[(x+1) % 5]
        Cp = C ^ Cl ^ (((Cr << U(1)) | (Cr >> U(63))) & MASK)
        D = C ^ Cp
        Ath = A ^ D[:, :, None]
        for x in range(5):
            out[:, r, OFF_C + x * 64:OFF_C + x * 64 + 64] = bits64(C[:, x])
            out[:, r, OFF_C_PRIME + x * 64:OFF_C_PRIME + x * 64 + 64] = \
                bits64(Cp[:, x])
        for y in range(5):
            for x in range(5):
                o = OFF_A_PRIME + _a_prime_idx(y, x, 0)
                out[:, r, o:o + 64] = bits64(Ath[:, x, y])

        # rho/pi
        B = np.zeros_like(A)
        for x in range(5):
            for y in range(5):
                v = Ath[:, x, y]
                n = R[x][y]
                B[:, y, (2 * x + 3 * y) % 5] = (
                    ((v << U(n)) | (v >> U(64 - n))) & MASK if n else v)
        # chi
        Bx1 = np.roll(B, -1, axis=1)
        Bx2 = np.roll(B, -2, axis=1)
        chi = B ^ ((~Bx1) & Bx2)
        put_limbs(OFF_APP, chi)
        out[:, r, OFF_APP00_BITS:OFF_APP00_BITS + 64] = bits64(chi[:, 0, 0])
        o00 = chi[:, 0, 0] ^ U(RC[r])
        out[:, r, OFF_APPP00_LIMBS:OFF_APPP00_LIMBS + LIMBS] = (
            ((o00[:, None] >> l16) & U(0xFFFF)).astype(np.int64))
        chi[:, 0, 0] = o00
        A = chi
    return out.reshape(n_perms * NUM_ROUNDS, NUM_KECCAK_COLS)[:height]


def seeded_trace(rng, log_n: int) -> np.ndarray:
    """A trace of 2^log_n rows over as many keccak-f inputs as fit
    (2^log_n // 24), each 25 random 64-bit lanes drawn by rng."""
    n_perms = (1 << log_n) // NUM_ROUNDS
    inputs = rng.integers(0, 1 << 64, size=(n_perms, 25), dtype=np.uint64,
                          endpoint=False)
    return keccak_trace_np(inputs.tolist(), 1 << log_n).astype(np.uint64)


def broken_trace(rng, log_n: int) -> np.ndarray:
    """seeded_trace with one a_prime bit, at a row and bit drawn by rng,
    set to 2: its booleanity constraint fails on that row, so a proof of it
    may be rejected only by the constraint check."""
    t = seeded_trace(rng, log_n)
    row = int(rng.integers(len(t)))
    t[row, OFF_A_PRIME + int(rng.integers(1600))] = 2
    return t
