"""VerifierAir: the self-contained attestation AIR (a copy of
plonky25_tpu/models/verifier_air.py).

Extends the hash-chain AIR (models/poseidon2_air.py) so that ONE trace
carries the *entire* Plonky3 verification — the Fiat-Shamir transcript and
Merkle hashing (as before, one Poseidon2 permutation per hash row) AND the
verification's field algebra: reduced-opening accumulation
(src/p3/verifier.rs:296-344), FRI fold interpolation (:419-519), quotient
reconstruction / Lagrange selectors / AIR constraint folding (:169-239).
With the algebra in-trace, the attestation checker re-executes NOTHING of
the verification: it marshals proof bytes + Fiat-Shamir samples into a
canonical slot sequence, folds the binding accumulator, and verifies this
one STARK (attest.py).

Two new row types join t/c/l:

  'a' (algebra): the row performs one GF(p^2) fused multiply-add over a
      bank of NUM_REGS ext registers carried in dedicated columns:
          R[dst] = ua * ub + uc
      Each operand is either ROUTED from a previous-row register (one-hot
      pa/pb/pc columns) or LOADED: a load is bound to the canonical
      schedule via a gamma slot when its ml flag is set, or left free
      (inverse witnesses — pinned by a subsequent assert row).  An assert
      binds the written register to a canonical value via its mr flag
      (write + bind = equality constraint against the canonical value).

  'f' (fold leaf): a hash chain start whose four leaf lanes are
      CONSTRAINED equal to registers R10/R11 (e0, e1) of the previous row —
      this is how values DERIVED in-trace (the FRI fold's interpolated
      evals) feed the Merkle hashing without the checker ever computing
      them: binding by adjacency instead of by accumulator.

  'w' (witness-fold, round 5 — the in-trace recursion compression row,
      docs/SOUNDNESS.md "Recursion depth"): a chain-CONTINUE hash row
      whose lanes 0..1 carry one PRIVATE (slot, value) pair of an INNER
      attestation's canonical sequence — absorbed into the running
      sponge (lanes 2..11 copy from the previous row's output) but NOT
      accumulator-bound; the same row performs one ext FMA
      `ACC = (v, 0) * (W1, W2) + ACC` whose ua operand is row-locally
      constrained equal to lane 1 (the value) and whose ub is a
      CANONICAL load of the per-pair weights W_k = gamma_inner_k ^
      (slot + 52*(R-1-row)).  A run of 'w' rows therefore recomputes,
      inside the trace, BOTH halves of an inner attestation's binding:
      the chain's final digest (exposed, canonically equal to the inner
      gammas — hash-preimage binding) and the slot-weighted accumulator
      finals (asserted equal to the inner acc) — so checking a
      recursive attestation needs no host-side re-fold of the inner
      schedule.  The witnessed pair values are pinned solely by the
      digest equality (collision resistance of Poseidon2), exactly as
      Merkle leaves are.

Registers copy across rows unless written (pc one-hot doubles as the copy
exemption), so values transit hash-row spans untouched.

## Binding (why free witness columns cannot cheat)

EVERY control column — row-type selectors, the sibling bit, absorb/expose
masks, operand routing, load/assert flags — is bit-packed into two pack
columns whose values occupy dedicated gamma slots of the running
accumulator, alongside the absorbed lanes, exposed lanes, bound operand
loads and asserted registers.  The checker recomputes the accumulator from
the canonical schedule (derived from proof bytes + samples + shape
constants only); by Schwartz-Zippel over two independent gammas (derived
by hashing the canonical sequence itself), a committed trace whose control
plane or bound data deviates ANYWHERE from the canonical schedule breaks
the final-accumulator equality.  Booleanity constraints on every packed
bit make the packing injective.  The only unbound witness values are
routed intermediates (pinned by the FMA dataflow from bound sources) and
inverse witnesses (pinned by their product-equals-one asserts).

Slot layout per active row (gamma exponents):
  0..11   m_j * in_j          (absorbed hash lanes)
  12..23  mo_j * out_j        (exposed digests / samples)
  24, 25  pack1, pack2        (ALL control bits, 2^j-weighted)
  26..31  ml_x * u_x          (bound operand loads, ext pairs a/b/c)
  32..51  mr_k * R_k          (asserted registers, ext pairs)
row shift gamma^52.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..air import Air, VerifierConstraintFolder
from ..constants import WIDTH
from .poseidon2_air import CORE_WIDTH, OUT_OFF, eval_poseidon2_core

NUM_REGS = 12         # 5*NUM_REGS+3 = 63 pack2 bits; sum < 2^63 < p
E0_REG = 10           # 'f' rows hash [R10, R11] of the previous row
E1_REG = 11

# ---------------------------------------------------------------- layout
SEL_T = CORE_WIDTH
SEL_C = CORE_WIDTH + 1
SEL_L = CORE_WIDTH + 2
SEL_F = CORE_WIDTH + 3
SEL_A = CORE_WIDTH + 4
B_COL = CORE_WIDTH + 5
M_OFF = CORE_WIDTH + 6
MO_OFF = M_OFF + WIDTH
R_OFF = MO_OFF + WIDTH            # register k: c0 at R_OFF+2k, c1 at +2k+1
UA_OFF = R_OFF + 2 * NUM_REGS
UB_OFF = UA_OFF + 2
UC_OFF = UB_OFF + 2
PA_OFF = UC_OFF + 2               # routes ua from a register
PB_OFF = PA_OFF + NUM_REGS        # routes ub
PD_OFF = PB_OFF + NUM_REGS        # routes uc
PC_OFF = PD_OFF + NUM_REGS        # write destination
MLA_COL = PC_OFF + NUM_REGS
MLB_COL = MLA_COL + 1
MLC_COL = MLB_COL + 1
MR_OFF = MLC_COL + 1
PACK1_COL = MR_OFF + NUM_REGS
PACK2_COL = PACK1_COL + 1
ACC_OFF = PACK2_COL + 1           # acc1, acc2
SEL_W = ACC_OFF + 2               # 'w': witness-fold row (appended r5)
SEL_G = SEL_W + 1                 # 'g': register-fed combine-hash row
CAP_COL = SEL_G + 1               # flag: ua captures prev row's out[0..1]
NUM_COLS = CAP_COL + 1

# number of parallel gamma sub-chains (protocol constant): the pair
# stream splits into GAMMA_LANES contiguous slices hashed by independent
# chains whose digests land in registers 0..GAMMA_LANES-1 (cap rows) and
# combine in ONE 'g' permutation — the sequential chain length drops by
# 5x on both the checker and the trace (the chain is the derivation's
# only serial dependency; a single 77k-perm chain cost ~11 s/side at
# golden scale, r5 measurement)
GAMMA_LANES = 5

# pack bit orders (fixed; injective given booleanity)
PACK1_BITS = ([SEL_T, SEL_C, SEL_L, SEL_F, SEL_A, B_COL]
              + list(range(M_OFF, M_OFF + WIDTH))
              + list(range(MO_OFF, MO_OFF + WIDTH))
              + [SEL_W, SEL_G, CAP_COL])                        # 33 bits
PACK2_BITS = (list(range(PA_OFF, PA_OFF + NUM_REGS))
              + list(range(PB_OFF, PB_OFF + NUM_REGS))
              + list(range(PD_OFF, PD_OFF + NUM_REGS))
              + list(range(PC_OFF, PC_OFF + NUM_REGS))
              + [MLA_COL, MLB_COL, MLC_COL]
              + list(range(MR_OFF, MR_OFF + NUM_REGS)))         # 53 bits

# slot exponents
SLOT_IN = 0            # ..11
SLOT_OUT = 12          # ..23
SLOT_PACK1 = 24
SLOT_PACK2 = 25
SLOT_U = 26            # ua.c0, ua.c1, ub.c0, ub.c1, uc.c0, uc.c1
SLOT_R = 32            # R_k.c0, R_k.c1 for k in 0..NUM_REGS-1
SLOT_SHIFT = SLOT_R + 2 * NUM_REGS   # 52: per-row gamma shift exponent

W_EXT = 7              # GF(p^2) = GF(p)[X]/(X^2 - 7)


class VerifierAir(Air):
    """The self-contained attestation AIR (see module docstring).  As with
    HashChainAir, `publics` travel as RUNTIME inputs (folder.publics) so
    every attestation shares one compiled prover/verifier specialization."""

    def __init__(self, publics: Optional[Dict] = None):
        # publics: {"gamma": (g1, g2), "acc": (a1, a2)}
        self.publics = publics or {"gamma": (0, 0), "acc": (0, 0)}

    def name(self) -> str:
        return "VerifierChain"

    def public_values(self):
        return {
            "gamma1": self.publics["gamma"][0],
            "gamma2": self.publics["gamma"][1],
            "acc1": self.publics["acc"][0],
            "acc2": self.publics["acc"][1],
        }

    def width(self) -> int:
        return NUM_COLS

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

        # ---- control columns -------------------------------------------
        sel_t, sel_c, sel_l = seg(L, SEL_T, 1), seg(L, SEL_C, 1), seg(L, SEL_L, 1)
        sel_f, sel_a = seg(L, SEL_F, 1), seg(L, SEL_A, 1)
        sel_w = seg(L, SEL_W, 1)
        sel_g, cap = seg(L, SEL_G, 1), seg(L, CAP_COL, 1)
        b = seg(L, B_COL, 1)
        m = seg(L, M_OFF, WIDTH)
        mo = seg(L, MO_OFF, WIDTH)
        out_d = seg(L, OUT_OFF, WIDTH)

        n_sel_t, n_sel_c = seg(N, SEL_T, 1), seg(N, SEL_C, 1)
        n_sel_l, n_sel_f = seg(N, SEL_L, 1), seg(N, SEL_F, 1)
        n_sel_a, n_sel_w = seg(N, SEL_A, 1), seg(N, SEL_W, 1)
        n_sel_g, n_cap = seg(N, SEL_G, 1), seg(N, CAP_COL, 1)
        n_b = seg(N, B_COL, 1)
        n_m = seg(N, M_OFF, WIDTH)
        n_mo = seg(N, MO_OFF, WIDTH)
        n_in = seg(N, IN_OFF := 0, WIDTH)
        n_out = seg(N, OUT_OFF, WIDTH)

        # booleanity of every packed bit (injective packing)
        bits_l = ops.concat([sel_t, sel_c, sel_l, sel_f, sel_a, sel_w,
                             sel_g, cap, b, m, mo,
                             seg(L, PA_OFF, NUM_REGS),
                             seg(L, PB_OFF, NUM_REGS),
                             seg(L, PD_OFF, NUM_REGS),
                             seg(L, PC_OFF, NUM_REGS),
                             seg(L, MLA_COL, 3),
                             seg(L, MR_OFF, NUM_REGS)])
        assert_bool(bits_l)

        # pack columns equal their weighted bit sums
        for pcol, pbits in ((PACK1_COL, PACK1_BITS), (PACK2_COL, PACK2_BITS)):
            bits = take(L, np.asarray(pbits))
            w2 = cvec([1 << j for j in range(len(pbits))])
            s = ops.mul(bits, w2)
            # tree-sum to one scalar
            tot = None
            for j in range(len(pbits)):
                tj = take(s, [j])
                tot = tj if tot is None else ops.add(tot, tj)
            folder.assert_zero(ops.sub(seg(L, pcol, 1), tot))

        active = ops.add(ops.add(ops.add(ops.add(ops.add(ops.add(
            sel_t, sel_c), sel_l), sel_f), sel_a), sel_w), sel_g)
        n_active = ops.add(ops.add(ops.add(ops.add(ops.add(ops.add(
            n_sel_t, n_sel_c), n_sel_l), n_sel_f), n_sel_a), n_sel_w),
            n_sel_g)
        # active rows form a PREFIX (interior-padding forgery guard; the
        # round-2 advisor finding — still required even with the control
        # plane accumulator-bound, because inactive rows do not shift the
        # accumulator and would otherwise slot in anywhere)
        folder.when_transition().assert_zero(
            ops.mul(ops.sub(one, active), n_active))

        def rep(x, k=WIDTH):
            return take(x, np.zeros(k, np.int32))

        # ---- hash chain transitions (as HashChainAir) -------------------
        prev_dig = take(out_d, np.arange(4))
        nb4 = rep(n_b, 4)
        n_left = take(n_in, np.arange(0, 4))
        n_right = take(n_in, np.arange(4, 8))
        n_capacity = take(n_in, np.arange(8, WIDTH))
        gate_c = rep(n_sel_c, 4)
        folder.when_transition().assert_zero(
            ops.mul(gate_c, ops.mul(ops.sub(one, nb4),
                                    ops.sub(n_left, prev_dig))))
        folder.when_transition().assert_zero(
            ops.mul(gate_c, ops.mul(nb4, ops.sub(n_right, prev_dig))))
        folder.when_transition().assert_zero(
            ops.mul(take(n_sel_c, np.zeros(4, np.int32)), n_capacity))

        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_t),
                    ops.mul(ops.sub(one, n_m), ops.sub(n_in, out_d))))

        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_l), ops.mul(ops.sub(one, n_m), n_in)))

        # 'f' rows: lanes 0..3 equal prev-row registers R10 (e0) and R11
        # (e1) in hash order [e0.c0, e0.c1, e1.c0, e1.c1]; lanes 4..11 = 0
        e_cols = np.asarray([R_OFF + 2 * E0_REG, R_OFF + 2 * E0_REG + 1,
                             R_OFF + 2 * E1_REG, R_OFF + 2 * E1_REG + 1])
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_f, 4),
                    ops.sub(take(n_in, np.arange(4)), take(L, e_cols))))
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_f, 8), take(n_in, np.arange(4, WIDTH))))

        # 'w' rows: sponge-chain continue with 2 private absorb lanes —
        # lanes 2..11 copy from the previous row's output (overwrite-rate-2
        # duplex); lanes 0..1 are FREE witness (pinned only by the chain's
        # final digest exposure).  The row's FMA ua operand is tied to
        # lane 1 (the pair VALUE), making the hashed value and the folded
        # value the same trace cell family by construction.
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_w, 10),
                    ops.sub(take(n_in, np.arange(2, WIDTH)),
                            take(out_d, np.arange(2, WIDTH)))))
        ua_l = seg(L, UA_OFF, 2)
        folder.assert_zero(
            ops.mul(sel_w, ops.sub(take(ua_l, [0]), take(in_v, [1]))))
        folder.assert_zero(ops.mul(sel_w, take(ua_l, [1])))

        # 'g' rows (gamma combine): lanes 0..9 equal the PREVIOUS row's
        # first 10 register base columns (the GAMMA_LANES captured
        # sub-chain digests, register k -> lanes 2k..2k+1); lanes 10..11
        # are m-bound canonical values (the length header).  The combine
        # digest is exposed on the same row.
        folder.when_transition().assert_zero(
            ops.mul(rep(n_sel_g, 10),
                    ops.sub(take(n_in, np.arange(10)),
                            seg(L, R_OFF, 10))))

        # cap flag: the row's ua operand captures the PREVIOUS row's
        # permutation output lanes 0..1 (a sub-chain digest) so an FMA
        # can move in-trace hash outputs into the register file — the
        # dual of the 'f' row's register->lane adjacency binding.
        n_ua_cap = seg(N, UA_OFF, 2)
        folder.when_transition().assert_zero(
            ops.mul(rep(n_cap, 2),
                    ops.sub(n_ua_cap, take(out_d, np.arange(2)))))

        # first row: a chain start ('l'), never 'f'/'a'/'w'/'g'/cap
        folder.when_first_row().assert_zero(
            ops.mul(ops.sub(one, m), in_v))
        folder.when_first_row().assert_zero(
            ops.concat([sel_f, sel_a, sel_w, sel_g, cap]))

        # ---- algebra: FMA + routing + copy ------------------------------
        R_l = seg(L, R_OFF, 2 * NUM_REGS)
        n_R = seg(N, R_OFF, 2 * NUM_REGS)
        n_ua = seg(N, UA_OFF, 2)
        n_ub = seg(N, UB_OFF, 2)
        n_uc = seg(N, UC_OFF, 2)
        ua = seg(L, UA_OFF, 2)
        ub = seg(L, UB_OFF, 2)
        uc = seg(L, UC_OFF, 2)
        pc_bits = seg(L, PC_OFF, NUM_REGS)

        # FMA write (row-local): pc_k * (R_k - (ua*ub + uc)) = 0, ext
        a0, a1 = take(ua, [0]), take(ua, [1])
        b0, b1 = take(ub, [0]), take(ub, [1])
        f0 = ops.add(ops.mul(a0, b0),
                     ops.mul(cvec([W_EXT]), ops.mul(a1, b1)))
        f0 = ops.add(f0, take(uc, [0]))
        f1 = ops.add(ops.mul(a0, b1), ops.mul(a1, b0))
        f1 = ops.add(f1, take(uc, [1]))
        # broadcast (f0, f1) over the register axis
        fma0 = take(f0, np.zeros(NUM_REGS, np.int32))
        fma1 = take(f1, np.zeros(NUM_REGS, np.int32))
        r_c0 = take(R_l, np.arange(NUM_REGS) * 2)
        r_c1 = take(R_l, np.arange(NUM_REGS) * 2 + 1)
        folder.assert_zero(ops.mul(pc_bits, ops.sub(r_c0, fma0)))
        folder.assert_zero(ops.mul(pc_bits, ops.sub(r_c1, fma1)))

        # routing (transition): n_px_k * (n_ux - R_k(prev)) = 0
        for px_off, n_ux in ((PA_OFF, n_ua), (PB_OFF, n_ub), (PD_OFF, n_uc)):
            px = seg(N, px_off, NUM_REGS)
            for comp in range(2):
                uxc = take(n_ux, np.zeros(NUM_REGS, np.int32) + comp)
                rc = take(R_l, np.arange(NUM_REGS) * 2 + comp)
                folder.when_transition().assert_zero(
                    ops.mul(px, ops.sub(uxc, rc)))

        # copy (transition): (1 - n_pc_k) * (n_R_k - R_k) = 0
        npc = seg(N, PC_OFF, NUM_REGS)
        for comp in range(2):
            ncr = take(n_R, np.arange(NUM_REGS) * 2 + comp)
            rc = take(R_l, np.arange(NUM_REGS) * 2 + comp)
            folder.when_transition().assert_zero(
                ops.mul(ops.sub(one, npc), ops.sub(ncr, rc)))

        # ---- accumulators ----------------------------------------------
        if folder.publics:
            pub = folder.publics
        else:
            pub = {
                "gamma1": ops.from_base(self.publics["gamma"][0]),
                "gamma2": ops.from_base(self.publics["gamma"][1]),
                "acc1": ops.from_base(self.publics["acc"][0]),
                "acc2": ops.from_base(self.publics["acc"][1]),
            }
        gammas = (pub["gamma1"], pub["gamma2"])
        gpows = []
        for g in gammas:
            row = [ops.one()]
            for _ in range(SLOT_SHIFT):
                row.append(ops.mul(row[-1], g))
            gpows.append(row)

        acc = seg(L, ACC_OFF, 2)
        n_acc = seg(N, ACC_OFF, 2)

        def contrib_k(k, row_cols, extra_terms=()):
            """Slot contribution of one row, gamma_k powers.  row_cols:
            dict of the row's column segments.  `extra_terms` are folded
            in LAST — terms consume gamma powers in slot order, so a
            term needing gp[SLOT_SHIFT] (the highest power) must come
            after every contrib term: the attestation assembler frees
            each power at its last read, and evaluating the top power
            first would hold the whole chain live (it overflows the
            NUM_REGS file when this AIR is itself attested)."""
            gp = gpows[k]
            terms = []
            for j in range(WIDTH):
                terms.append(ops.mul(
                    ops.mul(take(row_cols["m"], [j]),
                            take(row_cols["in"], [j])), gp[SLOT_IN + j]))
            for j in range(WIDTH):
                terms.append(ops.mul(
                    ops.mul(take(row_cols["mo"], [j]),
                            take(row_cols["out"], [j])), gp[SLOT_OUT + j]))
            terms.append(ops.mul(row_cols["pack1"], gp[SLOT_PACK1]))
            terms.append(ops.mul(row_cols["pack2"], gp[SLOT_PACK2]))
            for xi, (mlc, uxx) in enumerate(row_cols["loads"]):
                for comp in range(2):
                    terms.append(ops.mul(
                        ops.mul(mlc, take(uxx, [comp])),
                        gp[SLOT_U + 2 * xi + comp]))
            for kk in range(NUM_REGS):
                mrk = take(row_cols["mr"], [kk])
                for comp in range(2):
                    terms.append(ops.mul(
                        ops.mul(mrk, take(row_cols["R"], [2 * kk + comp])),
                        gp[SLOT_R + 2 * kk + comp]))
            terms.extend(extra_terms)
            tot = terms[0]
            for t in terms[1:]:
                tot = ops.add(tot, t)
            return tot

        cols_l = {
            "m": m, "in": in_v, "mo": mo, "out": out_d,
            "pack1": seg(L, PACK1_COL, 1), "pack2": seg(L, PACK2_COL, 1),
            "loads": [(seg(L, MLA_COL, 1), ua), (seg(L, MLB_COL, 1), ub),
                      (seg(L, MLC_COL, 1), uc)],
            "mr": seg(L, MR_OFF, NUM_REGS), "R": R_l,
        }
        cols_n = {
            "m": n_m, "in": n_in, "mo": n_mo, "out": n_out,
            "pack1": seg(N, PACK1_COL, 1), "pack2": seg(N, PACK2_COL, 1),
            "loads": [(seg(N, MLA_COL, 1), n_ua), (seg(N, MLB_COL, 1), n_ub),
                      (seg(N, MLC_COL, 1), n_uc)],
            "mr": seg(N, MR_OFF, NUM_REGS), "R": n_R,
        }

        for k in range(2):
            cur_k = take(acc, [k])
            nxt_k = take(n_acc, [k])
            want = contrib_k(
                k, cols_n,
                extra_terms=[ops.mul(cur_k, gpows[k][SLOT_SHIFT])])
            folder.when_transition().assert_zero(
                ops.sub(nxt_k,
                        ops.add(ops.mul(n_active, want),
                                ops.mul(ops.sub(one, n_active), cur_k))))
            folder.when_first_row().assert_zero(
                ops.sub(cur_k, contrib_k(k, cols_l)))
        for k, name in ((0, "acc1"), (1, "acc2")):
            folder.when_last_row().assert_zero(
                ops.sub(take(acc, [k]), pub[name]))
