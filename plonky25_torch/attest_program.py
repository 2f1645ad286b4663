"""Verification-program schedule for the self-contained attestation (a
copy of plonky25_tpu/attest_program.py; the gamma sponge and the trace
builder run on PyTorch tensors on the caller's device, every permutation
on a CUDA tensor through the Poseidon2 kernels).

Compiles one Plonky3 verification (src/p3/verifier.rs:100-519) into the
canonical row schedule of a VerifierAir trace (models/verifier_air.py):

  * hash rows ('t'/'c'/'l') — the Fiat-Shamir transcript and Merkle
    chains, as in the round-2 attestation;
  * algebra rows ('a') — one GF(p^2) fused multiply-add each, carrying
    the verification's field algebra: reduced-opening accumulation
    (verifier.rs:296-344), FRI fold interpolation (:419-519), quotient
    reconstruction / Lagrange selectors / AIR folding (:169-239);
  * fold-leaf rows ('f') — hash chain starts whose lanes are constrained
    equal to the in-trace-derived FRI fold evals (registers R10/R11, E0_REG/E1_REG).

The SCHEDULE (control bits + canonically-loaded operand values) is a pure
function of (proof bytes, Fiat-Shamir samples, shape constants) — the
checker builds it with NO field arithmetic beyond the binding accumulator
itself: only byte marshaling, bit masking/selection, and shape-derived
constants (two-adic generator powers, coset shifts — the analogue of the
reference baking `p3_constant(...)`s into its circuit at build time).
Derived values (interpolations, inverses, accumulators) exist only in the
prover-side EXECUTION of the program (execute_program), never host-side
in the checker.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .challenger import SymbolicChallenger
from .constants import GOLDILOCKS_P as P, EXT_DEGREE, RATE, WIDTH
from .device import resolve_device
from .fields import gl
from .fields.goldilocks import GL
from .models.poseidon2_air import CORE_WIDTH as CORE_W, poseidon2_core_rows
from .models.verifier_air import (
    ACC_OFF,
    B_COL,
    CAP_COL,
    GAMMA_LANES,
    E0_REG,
    E1_REG,
    M_OFF,
    MLA_COL,
    MLB_COL,
    MLC_COL,
    MO_OFF,
    MR_OFF,
    NUM_COLS,
    NUM_REGS,
    PA_OFF,
    PACK1_BITS,
    PACK1_COL,
    PACK2_BITS,
    PACK2_COL,
    PB_OFF,
    PC_OFF,
    PD_OFF,
    R_OFF,
    SEL_A,
    SEL_C,
    SEL_F,
    SEL_G,
    SEL_L,
    SEL_T,
    SEL_W,
    SLOT_IN,
    SLOT_OUT,
    SLOT_PACK1,
    SLOT_PACK2,
    SLOT_R,
    SLOT_SHIFT,
    SLOT_U,
    UA_OFF,
    UB_OFF,
    UC_OFF,
)
from .ops.poseidon2 import poseidon2_permute
from .proof import Proof
from .refimpl.domains import TwoAdicMultiplicativeCoset
from .refimpl.field import Gl, Gl2
from .refimpl.poseidon2 import poseidon2
from .utils.bits import log2_strict
from .utils.graphs import StaticProgram

ZERO2 = (0, 0)
ONE2 = (1, 0)


def _ext_pow(x: Tuple[int, int], n: int) -> Tuple[int, int]:
    """GF(p^2) square-and-multiply (host; sample-derived canonical
    constants like alpha_fri^run_length)."""
    r, b = ONE2, tuple(x)
    while n:
        if n & 1:
            r = Gl2.mul(r, b)
        b = Gl2.mul(b, b)
        n >>= 1
    return r
NEG1 = (P - 1, 0)
NEG2 = (P - 2, 0)
X2 = (0, 1)   # the GF(p^2) monomial X
POW_WINDOW = 4   # exponent bits consumed per two-adic pow-chain row


@dataclass
class VRow:
    """One canonical trace row (control + canonically-bound values)."""

    sel: str                                  # 't'|'c'|'l'|'f'|'a'|'w'
    b: int = 0
    absorbed: Tuple = ()                      # ((lane, value), ...)
    exposed: Tuple = ()                       # ((lane, value), ...)
    # algebra ('a') rows: R[dst] = ua * ub + uc
    pa: int = -1                              # route ua from register
    pb: int = -1
    pd: int = -1                              # route uc from register
    la: Optional[Tuple] = None                # canonical ext load for ua
    lb: Optional[Tuple] = None
    lc: Optional[Tuple] = None
    free_b: Optional[Tuple] = None            # ("inv", reg): ub = 1/R[reg]
    dst: int = -1
    assert_val: Optional[Tuple] = None        # bind R[dst] to this value
    # 'w' rows only: the PRIVATE (slot, value) pair absorbed on lanes
    # 0..1 — witness data, never part of canonical_slots (pinned by the
    # chain digest, not the accumulator); ua = (value, 0) by the sel_w
    # row-local tie constraint
    priv: Optional[Tuple] = None
    # cap flag: this row's ua captures the PREVIOUS row's permutation
    # output lanes 0..1 (a sub-chain digest -> register move)
    cap: int = 0


# ------------------------------------------------------------- assembler

class _Handle:
    """Operand handle: a live register or a canonical constant.
    `node` tags values created inside an AIR fold for exact-liveness
    freeing (_AsmOps); None for caller-managed registers."""

    __slots__ = ("kind", "val", "node")

    def __init__(self, kind, val):
        self.kind = kind    # "reg" | "const"
        self.val = val
        self.node = None

    def __repr__(self):
        return f"_{self.kind}:{self.val}"


def K(v) -> _Handle:
    """Canonical ext constant (int or (c0, c1) pair)."""
    if isinstance(v, tuple):
        return _Handle("const", (v[0] % P, v[1] % P))
    return _Handle("const", (v % P, 0))


class _Asm:
    """Emits 'a' rows; allocates registers with liveness tracking."""

    def __init__(self, rows: List[VRow]):
        self.rows = rows
        self._free = [k for k in range(NUM_REGS)
                      if k not in (E0_REG, E1_REG)]
        self._epinned = False

    def alloc(self) -> _Handle:
        if not self._free:
            raise RuntimeError("out of attestation program registers")
        return _Handle("reg", self._free.pop())

    def alloc_e(self) -> Tuple[_Handle, _Handle]:
        """The pinned e0/e1 registers hashed by 'f' rows."""
        assert not self._epinned
        self._epinned = True
        return _Handle("reg", E0_REG), _Handle("reg", E1_REG)

    def free(self, *hs):
        for h in hs:
            if h.kind == "reg":
                if h.val in (E0_REG, E1_REG):
                    self._epinned = False
                else:
                    self._free.append(h.val)
            h.kind = "dead"

    def fma(self, a: _Handle, b: _Handle, c: _Handle,
            dst: Optional[_Handle] = None,
            assert_val: Optional[Tuple] = None) -> _Handle:
        """R[dst] = a*b + c; returns the dst handle (fresh unless given)."""
        if dst is None:
            dst = self.alloc()
        row = VRow(sel="a", dst=dst.val, assert_val=assert_val)
        for h, rattr, lattr in ((a, "pa", "la"), (b, "pb", "lb"),
                                (c, "pd", "lc")):
            if h.kind == "reg":
                setattr(row, rattr, h.val)
            elif h.kind == "const":
                setattr(row, lattr, h.val)
            else:
                raise ValueError(f"dead/invalid operand {h}")
        self.rows.append(row)
        return dst

    def inv(self, den: _Handle) -> _Handle:
        """w = 1/R[den], pinned by a product-equals-one assert."""
        w = self.alloc()
        row = VRow(sel="a", dst=w.val, la=ONE2, free_b=("inv", den.val),
                   lc=ZERO2)
        self.rows.append(row)
        chk = self.fma(den, w, K(ZERO2), assert_val=ONE2)
        self.free(chk)
        return w

    def mul(self, a, b, **kw):
        return self.fma(a, b, K(ZERO2), **kw)

    def add(self, a, b, **kw):
        return self.fma(a, K(ONE2), b, **kw)

    def sub(self, a, b, **kw):
        """a - b  (as (-1)*b + a)."""
        return self.fma(b, K(NEG1), a, **kw)

    def assert_eq_const(self, reg: _Handle, val: Tuple):
        chk = self.fma(reg, K(ONE2), K(ZERO2), assert_val=val)
        self.free(chk)


# ------------------------------------------------- hash row constructors

def _leaf_rows(flat_vals: List[int]) -> List[VRow]:
    """Overwrite-mode sponge rows for one leaf (commit.rs:23-46)."""
    rows = []
    for off in range(0, len(flat_vals), RATE):
        chunk = flat_vals[off:off + RATE]
        rows.append(VRow(
            sel="l" if off == 0 else "t",
            absorbed=tuple((j, v % P) for j, v in enumerate(chunk))))
    return rows


def _path_rows(index: int, siblings: List[List[int]],
               root_vals: List[int]) -> List[VRow]:
    """Compress-chain rows for one Merkle path; last row exposes the
    root (canonically: the commitment)."""
    rows = []
    idx = index
    for sib in siblings:
        b = idx & 1
        lanes = range(0, 4) if b else range(4, 8)
        rows.append(VRow(sel="c", b=b,
                         absorbed=tuple((j, v % P)
                                        for j, v in zip(lanes, sib))))
        idx >>= 1
    rows[-1].exposed = tuple((j, v % P) for j, v in enumerate(root_vals))
    return rows


def _obs_values(proof: Proof) -> List[int]:
    fp = proof.opening_proof.fri_proof
    obs: List[int] = []
    obs += proof.commitments.trace.value
    if proof.commitments.stage2 is not None:
        obs += proof.commitments.stage2.value
    obs += proof.commitments.quotient_chunks.value
    for c in fp.commit_phase_commits:
        obs += c.value
    obs.append(fp.pow_witness)
    return obs


def _transcript_rows(proof: Proof, config, samples: List[int],
                     n_challenges: int = 0) -> List[VRow]:
    """Transcript duplex rows from the symbolic schedule
    (verifier.rs:135-140, 363-376; multi-stage: challenges are sampled
    from the main-trace commitment, then the stage-2 commitment is
    observed before alpha — refimpl/verifier.py transcript head)."""
    fc = config.fri_config
    sym = SymbolicChallenger()
    sym.observe(4)
    for _ in range(n_challenges):
        sym.sample_ext()              # stage-2 challenge
    if config.stage2_width:
        sym.observe(4)
    sym.sample_ext()                  # alpha
    sym.observe(4)
    sym.sample_ext()                  # zeta
    sym.sample_ext()                  # alpha_fri
    for _ in range(config.log_trace_height):
        sym.observe(4)
        sym.sample_ext()              # beta
    sym.observe(1)                    # pow witness
    sym.sample()                      # pow check
    for _ in range(fc.num_queries):
        sym.sample()                  # query index sample

    obs = _obs_values(proof)
    rows = [
        VRow(sel="t",
             absorbed=tuple((lane, obs[oid] % P)
                            for lane, oid in enumerate(step)))
        for step in sym.steps
    ]
    rows[0].sel = "l"     # chain start (concatenable schedules)
    exposed: Dict[int, List] = {}
    for i, (step, lane) in enumerate(sym.sample_srcs):
        exposed.setdefault(step, []).append((lane, samples[i] % P))
    for step, lanes in exposed.items():
        rows[step].exposed = tuple(lanes)
    return rows


# -------------------------------------------------------- the verification

def n_presamples(config, n_challenges: int = 0) -> int:
    """Samples before the query indices: stage-2 challenges, alpha, zeta,
    alpha_fri (2 each), betas (2 per phase), pow (1)."""
    return 2 * n_challenges + 6 + 2 * config.log_trace_height + 1


def expected_sample_count(config, n_challenges: int = 0) -> int:
    return (n_presamples(config, n_challenges)
            + config.fri_config.num_queries)


def build_verification_schedule(proof: Proof, config, air,
                                samples: List[int]) -> List[VRow]:
    """The canonical rows of ONE verification (hash + algebra).

    Checker-grade: consumes only proof bytes, `samples`, and shape
    constants.  Raises on shape mismatch (callers pre-validate with
    check_proof_shape)."""
    fc = config.fri_config
    fp = proof.opening_proof.fri_proof
    L = config.log_trace_height
    log_max = L + fc.log_blowup
    Q = fc.num_queries
    w = config.trace_width
    nchunks = 1 << config.log_quotient_degree
    s2w = air.stage2_width()
    n_ch = air.num_challenges()
    assert config.stage2_width == s2w
    assert len(samples) == expected_sample_count(config, n_ch)

    degree = 1 << config.degree_bits
    trace_domain = TwoAdicMultiplicativeCoset.natural_domain_for_degree(
        L, degree)
    qd = trace_domain.create_disjoint_domain(
        1 << (config.degree_bits + config.log_quotient_degree))
    quotient_chunks_domains = qd.split_domains(nchunks)

    h_tr = log2_strict(trace_domain.size()) + fc.log_blowup
    mats = [{"batch": 0, "row": 0, "log_height": h_tr}]
    for c, dom in enumerate(quotient_chunks_domains):
        mats.append({"batch": 1, "row": c,
                     "log_height": log2_strict(dom.size()) + fc.log_blowup})

    ov = proof.opened_values
    ch0 = 2 * n_ch                    # sample offset past the challenges
    challenges = [(samples[2 * c] % P, samples[2 * c + 1] % P)
                  for c in range(n_ch)]
    alpha = (samples[ch0] % P, samples[ch0 + 1] % P)
    zeta = (samples[ch0 + 2] % P, samples[ch0 + 3] % P)
    alpha_fri = (samples[ch0 + 4] % P, samples[ch0 + 5] % P)
    betas = [(samples[ch0 + 6 + 2 * l] % P, samples[ch0 + 7 + 2 * l] % P)
             for l in range(L)]
    n_pre = n_presamples(config, n_ch)

    # per-height term buckets, in the reference's exact order
    # (batch, matrix, point, column — verifier.rs:296-344); each term is
    # (z_kind, p_at_z) with p_at_x supplied per query later
    buckets: Dict[int, List] = {}

    def add_term(h, z_kind, batch, mrow, col, p_at_z):
        buckets.setdefault(h, []).append((z_kind, batch, mrow, col, p_at_z))

    # batch order: trace, (stage2), quotient — refimpl/verifier.py
    # commits_and_points; terms per batch: per point, per column
    qb = 2 if s2w else 1              # quotient batch index
    for col in range(w):
        add_term(h_tr, "zeta", 0, 0, col, ov.trace_local[col])
    for col in range(w):
        add_term(h_tr, "zeta_next", 0, 0, col, ov.trace_next[col])
    if s2w:
        for col in range(s2w):
            add_term(h_tr, "zeta", 1, 0, col, tuple(ov.stage2_local[col]))
        for col in range(s2w):
            add_term(h_tr, "zeta_next", 1, 0, col,
                     tuple(ov.stage2_next[col]))
    for c in range(nchunks):
        h = mats[1 + c]["log_height"]
        for e in range(EXT_DEGREE):
            add_term(h, "zeta", qb, c, e, tuple(ov.quotient_chunks[c][e]))

    # fold level l consumes the bucket at height log_max - l
    bucket_of_level = {}
    for h in buckets:
        lvl = log_max - h
        assert 0 <= lvl < L, f"opening height {h} outside fold range"
        assert lvl not in bucket_of_level
        bucket_of_level[lvl] = h

    rows: List[VRow] = _transcript_rows(proof, config, samples, n_ch)
    asm = _Asm(rows)

    # zeta_next = zeta * g_trace — in-trace, once (the only sample-derived
    # value the reduced openings need besides zeta itself)
    r_zeta_next = asm.fma(K(zeta), K(trace_domain.gen()), K(ZERO2))

    pow_tables: Dict = {}   # shape constants: (h, w0, init) -> [g^(v<<w0)]

    def pow_table(h, w0, init):
        key = (h, w0, init)
        if key not in pow_tables:
            g = Gl.two_adic_generator(h)
            pow_tables[key] = [
                init * pow(g, v << w0, P) % P
                for v in range(1 << POW_WINDOW)
            ]
        return pow_tables[key]

    def emit_pow_chain(h, bits_msb_first, init=1):
        """r = init * g_h^(rev-indexed exponent): windowed — each row
        multiplies by a table constant SELECTED by POW_WINDOW exponent
        bits (table entries are shape constants; the checker only does
        bit selection).  rev_bits_len(i, h): bit t of rev = bit (h-1-t)
        of i, so window w0 covers exponent bits w0..w0+3."""
        r = None
        for w0 in range(0, max(len(bits_msb_first), 1), POW_WINDOW):
            wbits = bits_msb_first[w0:w0 + POW_WINDOW]
            v = sum(b << t for t, b in enumerate(wbits))
            c = pow_table(h, w0, init if w0 == 0 else 1)[v]
            if r is None:
                r = asm.fma(K(c), K(ONE2), K(ZERO2))
            else:
                r = asm.fma(r, K(c), K(ZERO2), dst=r)
        return r

    for q in range(Q):
        index = samples[n_pre + q] % P & ((1 << log_max) - 1)
        batches = proof.opening_proof.query_openings[q]
        commits = [proof.commitments.trace.value]
        if s2w:
            commits.append(proof.commitments.stage2.value)
        commits.append(proof.commitments.quotient_chunks.value)
        assert len(batches) == len(commits)
        # ---- batch leaf + path hash rows (as round-2) ------------------
        for b_i, batch in enumerate(batches):
            flat = [v for mrow in batch.opened_values for v in mrow]
            rows += _leaf_rows(flat)
            rows += _path_rows(index, batch.opening_proof, commits[b_i])

        # ---- fold: x_init = g_logmax^rev(index) (verifier.rs:431-436)
        bits = [(index >> (log_max - 1 - t)) & 1 for t in range(log_max)]
        r_x = emit_pow_chain(log_max, bits)
        r_fold = asm.fma(K(ZERO2), K(ZERO2), K(ZERO2))   # folded = 0

        idx_l = index
        for lvl in range(L):
            # -- reduced-opening bucket consumed at this level ------------
            if lvl in bucket_of_level:
                h = bucket_of_level[lvl]
                shift = log_max - h
                hbits = [((index >> shift) >> (h - 1 - t)) & 1
                         for t in range(h)]
                r_xh = emit_pow_chain(h, hbits, init=7)
                invs = {}
                for z_kind in ("zeta", "zeta_next"):
                    if not any(t[0] == z_kind for t in buckets[h]):
                        continue
                    if z_kind == "zeta":
                        r_den = asm.fma(K(zeta), K(NEG1), r_xh)
                    else:
                        r_den = asm.fma(r_zeta_next, K(NEG1), r_xh)
                    invs[z_kind] = asm.inv(r_den)
                    asm.free(r_den)
                asm.free(r_xh)
                # ro = sum_j alpha_fri^j * num_j * inv_{z_j}: the bucket
                # order (batch, point, column) makes z constant over long
                # RUNS (all of a matrix's columns at one point), so the
                # common inverse factors out of each run's alpha-Horner —
                # 2 rows/term instead of 3 (r5: keeps the recursion-
                # compressed outer schedule inside a 2^19 trace).  Runs
                # recombine with canonical alpha-power constants:
                #   ro = H'_0 + a^{n_0} (H'_1 + a^{n_1} (...)),
                # H'_g = inv_g * Horner_g.  Identical field value to the
                # flat per-term form (inv commutes with the Horner).
                runs: List = []
                for t in buckets[h]:
                    if runs and runs[-1][0] == t[0]:
                        runs[-1][1].append(t)
                    else:
                        runs.append((t[0], [t]))
                r_ro = None
                for z_kind, terms in reversed(runs):
                    r_hg = None
                    for _, batch, mrow, col, p_at_z in reversed(terms):
                        p_at_x = batches[batch].opened_values[mrow][col]
                        r_t = asm.fma(K(p_at_z), K(NEG1),
                                      K((p_at_x % P, 0)))
                        if r_hg is None:
                            r_hg = r_t
                        else:
                            asm.fma(r_hg, K(alpha_fri), r_t, dst=r_hg)
                            asm.free(r_t)
                    asm.fma(r_hg, invs[z_kind], K(ZERO2), dst=r_hg)
                    if r_ro is None:
                        r_ro = r_hg
                    else:
                        asm.fma(r_ro, K(_ext_pow(alpha_fri, len(terms))),
                                r_hg, dst=r_ro)
                        asm.free(r_hg)
                asm.free(*invs.values())
                asm.add(r_ro, r_fold, dst=r_fold)
                asm.free(r_ro)

            # -- fold step (verifier.rs:419-519) --------------------------
            step = fp.query_proofs[q].commit_phase_openings[lvl]
            sib = tuple(v % P for v in step.sibling_value)
            is_odd = (idx_l ^ 1) & 1
            beta = betas[lvl]
            # xs0 = s*x with s = 2*is_odd - 1; s is folded into constant
            # SELECTS below (b ? c1 : c0 — bit selection, checker-side)
            e0, e1 = asm.alloc_e()
            # e0 = is_odd ? folded : sib ; e1 = is_odd ? sib : folded
            asm.fma(r_fold, K((is_odd, 0)),
                    K(ZERO2 if is_odd else sib), dst=e0)
            asm.fma(r_fold, K((1 - is_odd, 0)),
                    K(sib if is_odd else ZERO2), dst=e1)
            r_d = asm.sub(e1, e0)
            r_bx = asm.fma(r_x, K(NEG1 if is_odd else ONE2),
                           K(beta))                       # beta - xs0
            r_num = asm.mul(r_d, r_bx)
            asm.free(r_d, r_bx)
            r_den = asm.fma(r_x, K(NEG2 if is_odd else (2, 0)),
                            K(ZERO2))                     # xs1-xs0 = -2s*x
            r_w = asm.inv(r_den)
            asm.free(r_den)
            asm.fma(r_num, r_w, e0, dst=r_fold)           # e0 + num*w
            asm.free(r_num, r_w)
            asm.mul(r_x, r_x, dst=r_x)                    # x^2

            # -- fold leaf hash ('f' reads prev-row E0_REG/E1_REG) + path ---------
            rows.append(VRow(sel="f"))
            asm.free(e0, e1)
            rows += _path_rows(idx_l >> 1, step.opening_proof,
                               fp.commit_phase_commits[lvl].value)
            idx_l >>= 1

        # folded_eval == final_poly (verifier.rs:517: the fold must land
        # on the final polynomial's constant)
        asm.assert_eq_const(r_fold, tuple(v % P for v in fp.final_poly))
        asm.free(r_fold, r_x)

    # ---- per-proof finale: selectors + AIR folding + quotient
    # reconstruction (verifier.rs:169-239).  Selectors and the fold
    # accumulator stay held across air.eval, so the quotient product is
    # emitted AFTER folding to maximize the eval register pool.

    # Lagrange selectors at zeta (two_adic.rs:92-122)
    shift_inv = Gl.inv(trace_domain.shift)
    r_un = asm.fma(K(zeta), K(shift_inv), K(ZERO2))
    r_zh = asm.fma(r_un, K(ONE2), K(ZERO2))
    for _ in range(trace_domain.log_n):
        asm.mul(r_zh, r_zh, dst=r_zh)
    asm.fma(r_zh, K(ONE2), K(NEG1), dst=r_zh)
    r_dfirst = asm.fma(r_un, K(ONE2), K(NEG1))
    gen_inv = Gl.inv(trace_domain.gen())
    r_dlast = asm.fma(r_un, K(ONE2), K((P - gen_inv, 0)))
    asm.free(r_un)
    r_wf = asm.inv(r_dfirst)
    r_wl = asm.inv(r_dlast)
    asm.free(r_dfirst)
    r_first = asm.mul(r_zh, r_wf)
    r_last = asm.mul(r_zh, r_wl)
    asm.free(r_wf, r_wl, r_zh)

    # AIR constraint folding with exact-liveness register management
    r_folded = _fold_air(asm, air, alpha, ov, r_first, r_last, r_dlast,
                         challenges)
    asm.free(r_first, r_last, r_dlast)

    # zeroifier inverse, recomputed from constants AFTER the fold — held
    # across air.eval it costs a live register for the whole constraint
    # emission, which overflows the file when the AIR is VerifierAir
    # itself (recursive attestation)
    r_zh = asm.fma(K(zeta), K(shift_inv), K(ZERO2))
    for _ in range(trace_domain.log_n):
        asm.mul(r_zh, r_zh, dst=r_zh)
    asm.fma(r_zh, K(ONE2), K(NEG1), dst=r_zh)
    r_invz = asm.inv(r_zh)
    asm.free(r_zh)

    # quotient reconstruction from chunks (verifier.rs:169-219)
    zps_host = []
    for i, dom in enumerate(quotient_chunks_domains):
        acc = 1
        for j, other in enumerate(quotient_chunks_domains):
            if j != i:
                acc = Gl.mul(acc, Gl.inv(
                    other.zp_at_single_point(dom.first_point())))
        zps_host.append(acc)

    # zp_j(zeta) = (zeta/shift_j)^(2^log_n_j) - 1
    r_zp = []
    for dom in quotient_chunks_domains:
        r_u = asm.fma(K(zeta), K(Gl.inv(dom.shift)), K(ZERO2))
        for _ in range(dom.log_n):
            asm.mul(r_u, r_u, dst=r_u)
        r_zp.append(asm.fma(r_u, K(ONE2), K(NEG1)))
        asm.free(r_u)
    # zps_i = host_factor_i * prod_{j != i} zp_j(zeta)
    r_quot = asm.fma(K(ZERO2), K(ZERO2), K(ZERO2))
    for i in range(nchunks):
        r_zpsi = asm.fma(K(ONE2), K((zps_host[i], 0)), K(ZERO2))
        for j in range(nchunks):
            if j != i:
                asm.mul(r_zpsi, r_zp[j], dst=r_zpsi)
        # quotient += zps_i * (c_i0 + X*c_i1)
        c0 = tuple(ov.quotient_chunks[i][0])
        c1 = tuple(ov.quotient_chunks[i][1])
        r_m = asm.fma(K(c1), K(X2), K(c0))
        r_term = asm.mul(r_zpsi, r_m)
        asm.add(r_term, r_quot, dst=r_quot)
        asm.free(r_zpsi, r_m, r_term)
    asm.free(*r_zp)

    # folded * inv_zeroifier == quotient  (verifier.rs:238-239)
    r_lhs = asm.mul(r_folded, r_invz)
    asm.free(r_folded, r_invz)
    r_diff = asm.fma(r_quot, K(NEG1), r_lhs)
    asm.free(r_quot, r_lhs)
    asm.assert_eq_const(r_diff, ZERO2)
    asm.free(r_diff)

    return rows


class _Fma:
    """Lazy GF(p^2) expression node: a*b + c (operands are _Fma nodes or
    _Handle leaves).  AIR folds build these DAGs; emission happens at
    assert time (_AsmFolder.assert_zero) with per-tree use counting, so
    register pressure is bounded by expression depth, not by how many
    intermediates an AIR chains — wide/vector AIRs (Keccak, VerifierAir
    itself) fold with the same NUM_REGS-wide file."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = a
        self.b = b
        self.c = c


def _is_vec(x) -> bool:
    return isinstance(x, np.ndarray)


class _AsmOps:
    """GF(p^2) ops adapter for AIR folding inside the attestation
    schedule: LAZY scalar/vector expressions over canonical constants
    and caller registers.  Vector values are numpy object arrays of
    element nodes (the constraint axis, mirroring refimpl
    IntExtOps' vector helpers); every op lowers to fused multiply-adds
    at emission.  No host field arithmetic happens here — constants
    stay symbolic until they land in bound operand slots."""

    def __init__(self, asm: _Asm):
        self.asm = asm
        self.point_ndim = 0

    # ---- elementwise application with numpy-style broadcasting ---------
    @staticmethod
    def _ew(f, *xs):
        arrs = [x for x in xs if _is_vec(x)]
        if not arrs:
            return f(*xs)
        shape = np.broadcast_shapes(*[a.shape for a in arrs])
        bs = [np.broadcast_to(x, shape) if _is_vec(x) else None for x in xs]
        out = np.empty(shape, object)
        for i in np.ndindex(shape):
            out[i] = f(*[b[i] if b is not None else x
                         for b, x in zip(bs, xs)])
        return out

    def add(self, x, y):
        return self._ew(lambda a, b: _Fma(a, K(ONE2), b), x, y)

    def sub(self, x, y):
        """x - y  (as (-1)*y + x)."""
        return self._ew(lambda a, b: _Fma(b, K(NEG1), a), x, y)

    def mul(self, x, y):
        return self._ew(lambda a, b: _Fma(a, b, K(ZERO2)), x, y)

    def from_parts(self, a, b):
        """a + X*b: two base columns as one GF(p^2) value (the stage-2
        opened-value convention; refimpl IntExtOps.from_parts)."""
        return self._ew(lambda x, y: _Fma(y, K(X2), x), a, b)

    def zero(self):
        return K(ZERO2)

    def one(self):
        return K(ONE2)

    def from_base(self, b):
        return K(int(b) % P)

    # ---- vector helpers (constraint axis = axis 0) ----------------------
    @staticmethod
    def stack(vals):
        if vals and _is_vec(vals[0]):
            return np.stack(vals)
        out = np.empty((len(vals),), object)
        for i, v in enumerate(vals):
            out[i] = v
        return out

    @staticmethod
    def take(vec, idx):
        return vec[np.asarray(idx)]

    @staticmethod
    def concat(vals):
        return np.concatenate(vals, axis=0)

    def const_base(self, ints):
        out = np.empty((len(ints),), object)
        for i, v in enumerate(ints):
            out[i] = K(int(v) % P)
        return out

    # ---- emission --------------------------------------------------------
    def emit_tree(self, root) -> _Handle:
        """Evaluate one element DAG into a register (or pass a leaf
        through).  Within the tree, shared nodes are computed once and
        their registers freed at last use; leaves (canonical constants,
        caller-held registers) are never freed.  Registers created here
        are tagged node="tree" so the fold can free the root."""
        if not isinstance(root, _Fma):
            return root
        uses: Dict[int, int] = {}
        stack = [root]
        while stack:
            n = stack.pop()
            for o in (n.a, n.b, n.c):
                if isinstance(o, _Fma):
                    uses[id(o)] = uses.get(id(o), 0) + 1
                    if uses[id(o)] == 1:
                        stack.append(o)
        # Sethi–Ullman register need (tree approximation of the DAG):
        # evaluating a node's _Fma children in descending-need order
        # holds i earlier results while computing child i, and all k
        # child registers plus the fresh dst at the final fma.
        need: Dict[int, int] = {}
        nwork = [(root, False)]
        while nwork:
            n, ready = nwork.pop()
            if id(n) in need:
                continue
            kids = [o for o in (n.a, n.b, n.c) if isinstance(o, _Fma)]
            if not ready:
                nwork.append((n, True))
                nwork.extend((o, False) for o in kids
                             if id(o) not in need)
                continue
            ks = sorted((need[id(o)] for o in kids), reverse=True)
            need[id(n)] = max([k + i for i, k in enumerate(ks)]
                              + [len(ks) + 1])
        memo: Dict[int, _Handle] = {}

        # iterative post-order (constraint DAGs can be thousands deep —
        # e.g. the Poseidon2 core's internal-round chains)
        work = [(root, False)]
        while work:
            n, ready = work.pop()
            if not isinstance(n, _Fma) or id(n) in memo:
                continue
            if not ready:
                work.append((n, True))
                for o in sorted(
                        (o for o in (n.a, n.b, n.c)
                         if isinstance(o, _Fma) and id(o) not in memo),
                        key=lambda o: need[id(o)]):
                    work.append((o, False))   # popped desc-need first
                continue
            ops = [memo[id(o)] if isinstance(o, _Fma) else o
                   for o in (n.a, n.b, n.c)]
            r = self.asm.fma(*ops)
            r.node = "tree"
            for o, hh in zip((n.a, n.b, n.c), ops):
                if isinstance(o, _Fma):
                    uses[id(o)] -= 1
                    if uses[id(o)] == 0 and hh.kind == "reg":
                        self.asm.free(hh)
            memo[id(n)] = r
        return memo[id(root)]


class _AsmFolder:
    """VerifierConstraintFolder work-alike folding each constraint into
    the running accumulator AS IT IS ASSERTED (acc = acc*alpha + c,
    identical order/math to air.rs:63-69; vector constraints flatten in
    index order like refimpl IntExtOps.fold_constraints)."""

    def __init__(self, asm: _Asm, air, alpha, ov,
                 r_first, r_last, r_trans, challenges=()):
        self.asm = asm
        self.ops = _AsmOps(asm)
        self.alpha = alpha
        self.is_first_row = r_first
        self.is_last_row = r_last
        self.is_transition = r_trans
        self.publics = {k: K(int(v) % P)
                        for k, v in air.public_values().items()}
        self.challenges = [K(tuple(c)) for c in challenges]
        self.main = _MainView(ov)
        self.acc = asm.fma(K(ZERO2), K(ZERO2), K(ZERO2))

    def when(self, condition):
        return _AsmFiltered(self, condition)

    def when_first_row(self):
        return self.when(self.is_first_row)

    def when_last_row(self):
        return self.when(self.is_last_row)

    def when_transition(self):
        return self.when(self.is_transition)

    def _fold_one(self, elem):
        h = self.ops.emit_tree(elem)
        self.asm.fma(self.acc, K(self.alpha), h, dst=self.acc)
        if h.kind == "reg" and h.node == "tree":
            self.asm.free(h)

    def assert_zero(self, x):
        if isinstance(x, (list, tuple)):
            for c in x:
                self.assert_zero(c)
            return
        if _is_vec(x):
            for c in x.reshape(-1):
                self._fold_one(c)
            return
        self._fold_one(x)

    def assert_eq(self, x, y):
        self.assert_zero(self.ops.sub(x, y))

    def assert_bool(self, x):
        t = self.ops.sub(x, self.ops.one())
        self.assert_zero(self.ops.mul(x, t))


class _AsmFiltered:
    def __init__(self, inner: _AsmFolder, condition):
        self.inner = inner
        self.condition = condition

    def assert_zero(self, x):
        self.inner.assert_zero(self.inner.ops.mul(self.condition, x))

    def assert_eq(self, x, y):
        self.assert_zero(self.inner.ops.sub(x, y))


def _fold_air(asm: _Asm, air, alpha, ov, r_first, r_last, r_trans,
              challenges) -> _Handle:
    """AIR constraint folding into the schedule: builds the lazy
    constraint DAGs and emits them at assert time.  Returns the
    accumulator register."""
    f = _AsmFolder(asm, air, alpha, ov, r_first, r_last, r_trans,
                   challenges)
    air.eval(f)
    return f.acc


class _MainView:
    """Opened values as canonical-constant handles."""

    def __init__(self, ov):
        def mk(v):
            return K(tuple(v) if isinstance(v, (tuple, list)) else v)

        self.trace_local = [mk(v) for v in ov.trace_local]
        self.trace_next = [mk(v) for v in ov.trace_next]
        self.quotient_chunks = [[mk(tuple(e)) for e in ch]
                                for ch in ov.quotient_chunks]
        self.stage2_local = [mk(tuple(v)) for v in (ov.stage2_local or [])]
        self.stage2_next = [mk(tuple(v)) for v in (ov.stage2_next or [])]


def K_ext(pair) -> _Handle:   # convenience for tests
    return K(tuple(pair))


# --------------------------------------------------------------- executor

def _oracle_chain_out(rows: List[VRow], end: int) -> Tuple[int, int]:
    """Int-oracle fallback: the permutation output lanes 0..1 of the
    chain ending at row `end` (used by execute_program when no
    device-resolved outs are supplied — small schedules only)."""
    start = end
    while rows[start].sel not in ("l", "f"):
        start -= 1
    state = [0] * WIDTH
    for j in range(start, end + 1):
        r = rows[j]
        if r.sel == "l":
            state = [0] * WIDTH
            for lane, v in r.absorbed:
                state[lane] = v % P
        elif r.sel == "w":
            state = list(state)
            state[0], state[1] = r.priv[0] % P, r.priv[1] % P
        elif r.sel == "t":
            state = list(state)
            for lane, v in r.absorbed:
                state[lane] = v % P
        else:
            raise AssertionError(
                f"cap capture across unsupported row type {r.sel!r}")
        state = poseidon2(state)
    return (state[0], state[1])


def execute_program(rows: List[VRow], cap_inputs: Optional[Dict] = None):
    """Prover-side: run the algebra, returning per-row register file
    snapshots (AFTER the row) and operand values — plain-int host math.
    Also resolves each 'f' row's leaf lanes (= prev row's E0_REG/E1_REG).

    cap_inputs: {row_index: (o0, o1)} supplying each cap row's captured
    previous-row permutation output (build_trace_cols passes the
    device-resolved chain outs; when absent the int oracle recomputes
    the needed sub-chains — fine for test-size schedules)."""
    regs = [ZERO2] * NUM_REGS
    reg_rows = []
    operands = []            # (ua, ub, uc) per row (zeros for hash rows)
    f_lanes = []             # per 'f' row index: [4 lane values]
    for i, r in enumerate(rows):
        ua = ub = uc = ZERO2
        if r.dst >= 0:
            # any row may carry an FMA (the constraint is gated on the pc
            # bit, not the selector); 'w' rows draw ua from their private
            # pair value (the sel_w lane tie), cap rows from the previous
            # row's permutation output, everything else from the standard
            # route/load operands
            if r.sel == "w":
                ua = (r.priv[1] % P, 0)
            elif r.cap:
                if cap_inputs is not None and i in cap_inputs:
                    ua = tuple(v % P for v in cap_inputs[i])
                else:
                    ua = _oracle_chain_out(rows, i - 1)
            else:
                ua = regs[r.pa] if r.pa >= 0 else (r.la or ZERO2)
            if r.free_b is not None:
                ub = Gl2.inv(regs[r.free_b[1]])
            else:
                ub = regs[r.pb] if r.pb >= 0 else (r.lb or ZERO2)
            uc = regs[r.pd] if r.pd >= 0 else (r.lc or ZERO2)
            regs = list(regs)
            regs[r.dst] = Gl2.add(Gl2.mul(ua, ub), uc)
            if r.assert_val is not None:
                assert regs[r.dst] == tuple(v % P for v in r.assert_val), \
                    f"program assert failed at row {i}"
        elif r.sel == "f":
            prev = reg_rows[-1]
            f_lanes.append((i, [prev[E0_REG][0], prev[E0_REG][1],
                                prev[E1_REG][0], prev[E1_REG][1]]))
        reg_rows.append(regs)
        operands.append((ua, ub, uc))
    return reg_rows, operands, dict(f_lanes)


# ------------------------------------------------------- canonical slots

def _control_bits(r: VRow) -> Tuple[int, int]:
    """(pack1, pack2) canonical values for one row."""
    # 'w'/'g'/cap sit at PACK1 bits 30..32 (appended after mo;
    # PACK1_BITS order)
    sel_bits = {"t": 0, "c": 1, "l": 2, "f": 3, "a": 4, "w": 30, "g": 31}
    b1 = 1 << sel_bits[r.sel]
    b1 |= r.cap << 32
    b1 |= r.b << 5
    for lane, _ in r.absorbed:
        b1 |= 1 << (6 + lane)
    for lane, _ in r.exposed:
        b1 |= 1 << (6 + WIDTH + lane)

    b2 = 0
    if r.pa >= 0:
        b2 |= 1 << r.pa
    if r.pb >= 0:
        b2 |= 1 << (NUM_REGS + r.pb)
    if r.pd >= 0:
        b2 |= 1 << (2 * NUM_REGS + r.pd)
    if r.dst >= 0:
        b2 |= 1 << (3 * NUM_REGS + r.dst)
    base = 4 * NUM_REGS
    if r.la is not None:
        b2 |= 1 << base
    if r.lb is not None and r.free_b is None:
        b2 |= 1 << (base + 1)
    if r.lc is not None:
        b2 |= 1 << (base + 2)
    if r.assert_val is not None:
        b2 |= 1 << (base + 3 + r.dst)
    return b1, b2


def canonical_slots(r: VRow) -> List[Tuple[int, int]]:
    """Nonzero (gamma-exponent, value) slots of one row."""
    p1, p2 = _control_bits(r)
    slots = [(SLOT_PACK1, p1), (SLOT_PACK2, p2)]
    for lane, v in r.absorbed:
        slots.append((SLOT_IN + lane, v % P))
    for lane, v in r.exposed:
        slots.append((SLOT_OUT + lane, v % P))
    for xi, load in enumerate((r.la if r.pa < 0 else None,
                               (r.lb if r.free_b is None else None)
                               if r.pb < 0 else None,
                               r.lc if r.pd < 0 else None)):
        if load is not None:
            slots.append((SLOT_U + 2 * xi, load[0] % P))
            slots.append((SLOT_U + 2 * xi + 1, load[1] % P))
    if r.assert_val is not None:
        slots.append((SLOT_R + 2 * r.dst, r.assert_val[0] % P))
        slots.append((SLOT_R + 2 * r.dst + 1, r.assert_val[1] % P))
    return slots


def sequence_pairs(rows: List[VRow]) -> List[Tuple[int, int]]:
    """The canonical (slot, value) pair stream of a schedule, in order."""
    return [(s, v) for r in rows for s, v in canonical_slots(r)]


# Pair-stream chunk size for the gamma sponge: the stream is padded with
# (0, 0) pairs to a multiple of this per lane (protocol v3; the in-trace
# recomputation, build_compression_rows, carries at most GAMMA_CHUNK-1
# pad rows).
GAMMA_CHUNK = 256


def _chain(state: GL, pairs: GL, record: bool = False):
    """Rate-2 overwrite sponge over chains that run side by side: state
    GL (n, 12), pairs GL (steps, n, 2), all on one device.  Step t
    overwrites lanes 0..1 of every chain's state with pairs[t] and
    permutes: one Poseidon2 call over the n states (one state-major kernel
    launch on the card) and two in-place lane writes, with no host sync.
    Eagerly, one step after the other; _chain_chunk_fn and
    _chain_states_fn run GAMMA_CHUNK steps of it as one program.  The lane
    writes go into `state` and each step's output in place; with `record`,
    each step writes a copy instead, and every step's input and output
    states come back too, GL (steps, n, 12) each."""
    ins, outs = [], []
    for t in range(pairs.shape[0]):
        if record:
            state = GL(state.lo.clone(), state.hi.clone())
            ins.append(state)
        state.lo[:, 0:2] = pairs.lo[t]
        state.hi[:, 0:2] = pairs.hi[t]
        state = poseidon2_permute(state)
        if record:
            outs.append(state)
    if record:
        return state, gl.stack(ins), gl.stack(outs)
    return state


_chain_fn_cache: Dict = {}
_chain_fn_lock = threading.Lock()


def _chunk(state: GL, pairs: GL) -> GL:
    """_chain on a copy of `state`: a program's input buffer stays as it
    was loaded."""
    return _chain(GL(state.lo.clone(), state.hi.clone()), pairs)


def _chunk_states(state: GL, pairs: GL):
    return _chain(state, pairs, record=True)


def _chain_program(kind: str, fn, n: int, device) -> StaticProgram:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and the tensors' "cuda:0" name one device
        device = torch.device("cuda", torch.cuda.current_device())
    key = (kind, n, str(device))
    with _chain_fn_lock:
        prog = _chain_fn_cache.get(key)
        if prog is None:
            template = (gl.zeros((n, WIDTH), device),
                        gl.zeros((GAMMA_CHUNK, n, 2), device))
            prog = _chain_fn_cache[key] = StaticProgram(
                fn, template, device, name=f"{kind}_{n}")
    return prog


def _chain_chunk_fn(n: int, device="cuda") -> StaticProgram:
    """GAMMA_CHUNK sponge steps of n chains as one program, (state GL
    (n, 12), pairs GL (GAMMA_CHUNK, n, 2)) -> state: the JAX package's
    jitted lax.scan chunk (plonky25_tpu/attest_program.py:1053).  On the
    card one CUDA graph of GAMMA_CHUNK x (two lane writes and a
    state-major permutation launch), on the CPU _chain itself
    (utils/graphs.py); one per (n, device), made at the first call."""
    return _chain_program("chunk", _chunk, n, device)


def _chain_states_fn(n: int, device="cuda") -> StaticProgram:
    """_chain_chunk_fn that also returns every step's input and output
    state, -> (state, ins, outs), GL (GAMMA_CHUNK, n, 12) each: the trace
    builder's per-row sponge witness of the long 'w' chains
    (plonky25_tpu/attest_program.py:1096)."""
    return _chain_program("states", _chunk_states, n, device)


def _gamma_stream(pairs: List[Tuple[int, int]], device) -> GL:
    """The padded pair stream (padded_pair_count) as GL (lane_len,
    GAMMA_LANES, 2) on `device`, step axis first: lane k hashes slice k."""
    total = padded_pair_count(len(pairs))
    padded = np.zeros((total, 2), np.uint64)
    if pairs:
        padded[:len(pairs)] = np.asarray(pairs, np.uint64)
    sliced = padded.reshape(GAMMA_LANES, total // GAMMA_LANES, 2)
    return gl.from_u64(np.ascontiguousarray(sliced.transpose(1, 0, 2)),
                       device)


def _chain_digests(stream: GL) -> np.ndarray:
    """The GAMMA_LANES sub-chains over `stream` (_gamma_stream), each
    from the permutation of the zero state (the trace's empty 'l'
    chain-start row): their final states, uint64 (GAMMA_LANES, 12).  The
    chunk program replays once per GAMMA_CHUNK steps, each chunk loaded
    from the stream on the device; the states come back once."""
    state = poseidon2_permute(gl.zeros((GAMMA_LANES, WIDTH), stream.device))
    prog = _chain_chunk_fn(GAMMA_LANES, stream.device)
    with prog.lock:
        for off in range(0, stream.shape[0], GAMMA_CHUNK):
            prog.load(state, stream[off:off + GAMMA_CHUNK])
            state = prog.run()
        return gl.to_u64_np(state)


def padded_pair_count(n_pairs: int) -> int:
    """Pair stream padded with (0,0) to GAMMA_LANES equal slices whose
    length is a multiple of GAMMA_CHUNK."""
    lane_len = -(-max(n_pairs, 1) // GAMMA_LANES)
    lane_len = -(-lane_len // GAMMA_CHUNK) * GAMMA_CHUNK
    return GAMMA_LANES * lane_len


def derive_gammas_from_pairs(n_rows: int, pairs: List[Tuple[int, int]],
                             device="cuda") -> Tuple[int, int]:
    """Two independent gammas from the canonical pair stream, protocol
    v3 (round 5): the stream (padded, padded_pair_count) splits into
    GAMMA_LANES contiguous slices; each slice is hashed by an
    independent rate-2 overwrite-sponge chain from the zero state (one
    permutation per (slot, value) pair); the GAMMA_LANES digests (lanes
    0..1 of each final state) plus (n_rows, n_pairs) fill one COMBINE
    permutation whose output lanes 0..1 are the gammas.

    This shape exists because it is exactly what a VerifierAir trace
    recomputes: one 'w' row per pair, one cap row per sub-chain digest,
    one 'g' row for the combine (docs/SOUNDNESS.md "Recursion
    depth...") — while the derivation's serial depth is one slice, not
    the whole stream.  On `device` the whole padded stream moves once,
    the GAMMA_LANES chains step together through the chunk program
    (_chain_digests), and the digests come back once."""
    device = resolve_device(device)
    n_pairs = len(pairs)
    digests = _chain_digests(_gamma_stream(pairs, device))
    root_in = np.zeros((1, WIDTH), np.uint64)
    for k in range(GAMMA_LANES):
        root_in[0, 2 * k], root_in[0, 2 * k + 1] = digests[k][0], digests[k][1]
    root_in[0, 10], root_in[0, 11] = n_rows, n_pairs
    out = gl.to_u64_np(poseidon2_permute(gl.from_u64(root_in, device)))[0]
    # a zero lane would degenerate the binding accumulator; map to 1
    # (probability 2^-64 per lane — attest() would fail to build the
    # matching exposure row in that measure-zero case)
    return (int(out[0]) or 1, int(out[1]) or 1)


def derive_gammas(rows: List[VRow], device="cuda") -> Tuple[int, int]:
    return derive_gammas_from_pairs(len(rows), sequence_pairs(rows), device)


def pair_exponents(rows: List[VRow]) -> List[int]:
    """Per-pair gamma exponent e_i = slot + 52*(R-1-row): the weight of
    pair i in the accumulator finals, acc_k = sum_i v_i * gamma_k^e_i
    (identical value to fold_accumulator's row-Horner form).  Depends
    only on the schedule's SLOT STRUCTURE, never on values — the
    compressed-recursion checker derives these from a shape template."""
    R = len(rows)
    return [s + SLOT_SHIFT * (R - 1 - ri)
            for ri, r in enumerate(rows)
            for s, _ in canonical_slots(r)]


ACC_REG = 10  # the fold register (digest captures use registers 0..4)


def build_compression_rows(n_rows: int, pairs: List[Tuple[int, int]],
                           exponents: List[int], gamma: Tuple[int, int],
                           acc: Tuple[int, int]) -> List[VRow]:
    """The in-trace recomputation of an INNER attestation's binding
    (docs/SOUNDNESS.md "Recursion depth..."): GAMMA_LANES parallel
    sub-chains re-hash the inner canonical pair stream exactly as
    derive_gammas_from_pairs (one 'w' row per pair), each digest is
    captured into register k by a cap row, and ONE 'g' combine row —
    lanes 0..9 register-bound, lanes 10..11 the canonical length header
    — exposes the root digest canonically equal to the inner
    (gamma1, gamma2).  Every 'w' row's same-row ext FMA also re-folds
    both accumulator finals,
        ACC = (v_i, 0) * (W1_i, W2_i) + ACC,
    (the fold is a plain sum, so the slice order is immaterial) with a
    terminal assert ACC == (acc1, acc2).  The pair values ride as
    PRIVATE lanes (hash-pinned); the weights W_k = gamma_k^e_i are
    canonical loads the checker recomputes from the slot template.

    Appended to an outer verification schedule, these rows replace the
    checker's host-side re-marshal of the inner schedule — the analogue
    of the reference folding the inner verification into the outer
    circuit (src/p3/verifier.rs:100-240)."""
    g1, g2 = gamma
    n_pairs = len(pairs)
    total = padded_pair_count(n_pairs)
    lane_len = total // GAMMA_LANES
    padded = list(pairs) + [(0, 0)] * (total - n_pairs)
    weights = []
    for i in range(total):
        if i < n_pairs:
            e = exponents[i]
            weights.append((pow(g1, e, P), pow(g2, e, P)))
        else:
            weights.append((0, 0))    # pad pairs contribute 0

    rows: List[VRow] = []
    first = True
    for k in range(GAMMA_LANES):
        # sub-chain start: an empty 'l' row (all-zero sponge state); the
        # FIRST one also initializes ACC = 0*0+0 from BOUND zero loads
        # (the prover cannot pick the fold's start)
        if first:
            rows.append(VRow(sel="l", la=ZERO2, lb=ZERO2, lc=ZERO2,
                             dst=ACC_REG))
            first = False
        else:
            rows.append(VRow(sel="l"))
        for i in range(k * lane_len, (k + 1) * lane_len):
            s, v = padded[i]
            rows.append(VRow(sel="w", priv=(s % P, v % P), lb=weights[i],
                             pd=ACC_REG, dst=ACC_REG))
        # capture the sub-chain digest into register k (cap: ua is the
        # previous row's out[0..1])
        rows.append(VRow(sel="a", cap=1, lb=ONE2, lc=ZERO2, dst=k))
    # combine: lanes 0..9 = registers 0..GAMMA_LANES-1 (prev row), lanes
    # 10..11 = the canonical length header; root digest exposed == gamma
    rows.append(VRow(sel="g",
                     absorbed=((10, n_rows % P), (11, n_pairs % P)),
                     exposed=((0, g1 % P), (1, g2 % P))))
    # terminal binding: ACC == (acc1, acc2)
    rows.append(VRow(sel="a", pa=ACC_REG, lb=ONE2, lc=ZERO2, dst=ACC_REG,
                     assert_val=(acc[0] % P, acc[1] % P)))
    return rows


def make_zero_proof(config) -> Proof:
    """A shape-true all-zeros Proof for `config`: the value-free template
    the compressed-recursion checker feeds build_verification_schedule to
    recover an inner schedule's SLOT STRUCTURE (slots, row boundaries,
    control bits) without the target proof's bytes.  Satisfies
    errors.check_proof_shape by construction."""
    from .proof import (BatchOpening, CommitPhaseProofStep, Commitment,
                        Commitments, FriProof, OpenedValues, Proof,
                        QueryProof, TwoAdicFriPcsProof)

    fc = config.fri_config
    W = config.trace_width
    s2w = config.stage2_width
    nchunks = 1 << config.log_quotient_degree
    n_phases = config.log_trace_height
    log_max = config.degree_bits + fc.log_blowup
    Z = (0, 0)

    def commit():
        return Commitment([0, 0, 0, 0])

    def path(depth):
        return [[0, 0, 0, 0] for _ in range(depth)]

    def batches():
        out = [BatchOpening(opened_values=[[0] * W],
                            opening_proof=path(log_max))]
        if s2w:
            out.append(BatchOpening(opened_values=[[0] * s2w],
                                    opening_proof=path(log_max)))
        out.append(BatchOpening(
            opened_values=[[0] * EXT_DEGREE for _ in range(nchunks)],
            opening_proof=path(log_max)))
        return out

    fri = FriProof(
        commit_phase_commits=[commit() for _ in range(n_phases)],
        query_proofs=[
            QueryProof(commit_phase_openings=[
                CommitPhaseProofStep(sibling_value=Z,
                                     opening_proof=path(n_phases - l))
                for l in range(n_phases)])
            for _ in range(fc.num_queries)],
        final_poly=Z,
        pow_witness=0,
    )
    return Proof(
        commitments=Commitments(
            trace=commit(), quotient_chunks=commit(),
            stage2=commit() if s2w else None),
        opened_values=OpenedValues(
            trace_local=[Z] * W, trace_next=[Z] * W,
            quotient_chunks=[[Z] * EXT_DEGREE for _ in range(nchunks)],
            stage2_local=[Z] * s2w if s2w else None,
            stage2_next=[Z] * s2w if s2w else None),
        opening_proof=TwoAdicFriPcsProof(
            fri_proof=fri,
            query_openings=[batches() for _ in range(fc.num_queries)]),
        degree_bits=config.degree_bits,
    )


def fold_accumulator(rows: List[VRow], gamma: Tuple[int, int]):
    """Checker-side canonical accumulator finals (host ints)."""
    finals = []
    for g in gamma:
        gp = [pow(g, s, P) for s in range(SLOT_SHIFT + 1)]
        acc = 0
        for r in rows:
            c = 0
            for s, v in canonical_slots(r):
                c += v * gp[s]
            acc = (acc * gp[SLOT_SHIFT] + c) % P
        finals.append(acc)
    return tuple(finals)


# ----------------------------------------------------------- trace build

def build_trace_cols(rows: List[VRow], gamma: Tuple[int, int],
                     log_n: Optional[int] = None, device="cuda") -> GL:
    """Column-major GL (NUM_COLS, height) VerifierAir trace on `device`.

    Hash-chain states resolve level-synchronously: one Poseidon2 call over
    every live chain per chain level (one kernel launch on the card), its
    inputs built and its outputs read on the host, as the JAX builder does
    (its power-of-two batch buckets bound XLA's compiled shapes; eager
    PyTorch needs none, so each level permutes exactly its live chains).
    Algebra rows' lane states are zero (their Poseidon2 core witness is
    the permutation of the zero state, satisfying the always-on core
    constraints vacuously)."""
    device = resolve_device(device)
    R = len(rows)
    height = 1 << (max(R, 4) - 1).bit_length()
    if log_n is not None:
        assert height <= (1 << log_n), "schedule exceeds requested height"
        height = 1 << log_n

    def perm_host(states: np.ndarray) -> np.ndarray:
        """(n, 12) uint64 states permuted on `device`, back on the host."""
        return gl.to_u64_np(poseidon2_permute(gl.from_u64(states, device)))

    # --- static chain structure -------------------------------------------
    absorbed = np.zeros((R, WIDTH), np.uint64)
    m_arr = np.zeros((height, WIDTH), np.uint64)
    ov_arr = np.zeros((R, WIDTH), bool)          # preset-lane override
    sel_arr = np.zeros((height, 8), np.uint64)   # t, c, l, f, a, w, g, cap
    bcol = np.zeros((height,), np.uint64)
    chains: List[List[int]] = []
    for i, r in enumerate(rows):
        sel_arr[i, "tclfawg".index(r.sel)] = 1
        sel_arr[i, 7] = r.cap
        bcol[i] = r.b
        for lane, v in r.absorbed:
            absorbed[i, lane] = v % P
            m_arr[i, lane] = 1
        if r.sel == "w":
            # private pair on lanes 0..1 (NOT m-masked: chain-pinned)
            absorbed[i, 0] = r.priv[0] % P
            absorbed[i, 1] = r.priv[1] % P
            ov_arr[i, 0:2] = True
        if r.sel in ("l", "f", "g"):
            chains.append([i])
        elif r.sel in ("t", "c", "w"):
            assert chains, "schedule must open with a chain start"
            chains[-1].append(i)
        # 'a' rows join no chain; states stay zero

    states_np = np.zeros((height, WIDTH), np.uint64)
    out_np = np.zeros((R, WIDTH), np.uint64)

    def resolve(group: List[List[int]]):
        """Level-synchronous batched resolution of one chain group: level
        k permutes the k-th row of every chain longer than k."""
        maxlen = max((len(c) for c in group), default=0)
        for k in range(maxlen):
            live = [c for c in group if len(c) > k]
            idxs = np.asarray([c[k] for c in live])
            if k == 0:
                ins = absorbed[idxs].copy()
            else:
                pouts = out_np[np.asarray([c[k - 1] for c in live])]
                is_c = sel_arr[idxs, 1] == 1
                carries = ((sel_arr[idxs, 0] == 1)
                           | (sel_arr[idxs, 5] == 1))  # 't' and 'w' rows
                base = np.where(carries[:, None], pouts, 0)
                dig = pouts[:, :4]
                b_here = bcol[idxs] == 1
                left = np.where((is_c & ~b_here)[:, None], dig,
                                base[:, 0:4])
                right = np.where((is_c & b_here)[:, None], dig,
                                 base[:, 4:8])
                base = np.concatenate([left, right, base[:, 8:]], axis=1)
                ins = np.where((m_arr[idxs] == 1) | ov_arr[idxs],
                               absorbed[idxs], base)
            states_np[idxs] = ins
            out_np[idxs] = perm_host(ins)

    # Long all-'w' chains (the compression sub-chains: an empty 'l'
    # start + tens of thousands of private absorbs) resolve through the
    # gamma sponge's states program (_chain_states_fn), one replay per
    # GAMMA_CHUNK steps that also keeps every intermediate state, pulled
    # to the host once per chunk; the lanes step together (equal length
    # by construction).
    def _is_w_run(c):
        r0 = rows[c[0]]
        return (len(c) > 64 and r0.sel == "l" and not r0.absorbed
                and all(rows[j].sel == "w" for j in c[1:]))

    w_runs = [c for c in chains if _is_w_run(c)]
    if w_runs:
        assert len({len(c) for c in w_runs}) == 1, \
            "compression sub-chains must have equal length"
        wlen = len(w_runs[0]) - 1
        assert wlen % GAMMA_CHUNK == 0, \
            "compression sub-chains are whole GAMMA_CHUNKs (padded_pair_count)"
        starts = np.asarray([c[0] for c in w_runs])
        # the empty 'l' start: in = zeros, out = perm(zeros)
        p0 = perm_host(np.zeros((len(w_runs), WIDTH), np.uint64))
        states_np[starts] = 0
        out_np[starts] = p0
        # pair stream per chain, (wlen, n_runs, 2)
        prs = np.zeros((wlen, len(w_runs), 2), np.uint64)
        for ci, c in enumerate(w_runs):
            for t, j in enumerate(c[1:]):
                prs[t, ci, 0] = rows[j].priv[0] % P
                prs[t, ci, 1] = rows[j].priv[1] % P
        stream = gl.from_u64(prs, device)
        state = gl.from_u64(p0, device)
        prog = _chain_states_fn(len(w_runs), device)
        with prog.lock:
            for off in range(0, wlen, GAMMA_CHUNK):
                prog.load(state, stream[off:off + GAMMA_CHUNK])
                state, ins_c, outs_c = prog.run()
                ins_h = gl.to_u64_np(ins_c)    # (C, n_runs, 12)
                outs_h = gl.to_u64_np(outs_c)
                for ci, c in enumerate(w_runs):
                    rows_idx = np.asarray(c[1 + off:1 + off + GAMMA_CHUNK])
                    states_np[rows_idx] = ins_h[:, ci]
                    out_np[rows_idx] = outs_h[:, ci]

    # Round A: remaining chains with static inputs ('l'-started)
    group_a = [c for c in chains
               if rows[c[0]].sel == "l" and not _is_w_run(c)]
    resolve(group_a)

    cap_inputs = {
        i: (int(out_np[i - 1][0]), int(out_np[i - 1][1]))
        for i, r in enumerate(rows) if r.cap
    }
    reg_rows, operands, f_lanes = execute_program(rows, cap_inputs)

    # Round B: register-dependent chains — 'f' starts (lanes 0..3 from
    # E0/E1 of the previous row) and 'g' combines (lanes 0..9 from
    # registers 0..GAMMA_LANES-1 of the previous row)
    for i, r in enumerate(rows):
        if r.sel == "f":
            absorbed[i, :4] = f_lanes[i]       # preset (NOT m-masked)
        elif r.sel == "g":
            prev = reg_rows[i - 1]
            for kreg in range(GAMMA_LANES):
                absorbed[i, 2 * kreg] = prev[kreg][0]
                absorbed[i, 2 * kreg + 1] = prev[kreg][1]
            ov_arr[i, 0:10] = True
    group_b = [c for c in chains if rows[c[0]].sel in ("f", "g")]
    resolve(group_b)

    core = poseidon2_core_rows(gl.from_u64(states_np, device))

    # --- control / program / register columns ----------------------------
    blk = np.zeros((height, NUM_COLS - CORE_W), np.uint64)

    def col(c):
        return c - CORE_W

    blk[:, col(SEL_T):col(SEL_T) + 5] = sel_arr[:, :5]
    blk[:, col(SEL_W)] = sel_arr[:, 5]
    blk[:, col(SEL_G)] = sel_arr[:, 6]
    blk[:, col(CAP_COL)] = sel_arr[:, 7]
    blk[:, col(B_COL)] = bcol
    blk[:, col(M_OFF):col(M_OFF) + WIDTH] = m_arr
    for i, r in enumerate(rows):
        for lane, _ in r.exposed:
            blk[i, col(MO_OFF) + lane] = 1
        if r.dst >= 0:
            if r.pa >= 0:
                blk[i, col(PA_OFF) + r.pa] = 1
            if r.pb >= 0:
                blk[i, col(PB_OFF) + r.pb] = 1
            if r.pd >= 0:
                blk[i, col(PD_OFF) + r.pd] = 1
            blk[i, col(PC_OFF) + r.dst] = 1
            if r.la is not None and r.pa < 0:
                blk[i, col(MLA_COL)] = 1
            if r.lb is not None and r.pb < 0 and r.free_b is None:
                blk[i, col(MLB_COL)] = 1
            if r.lc is not None and r.pd < 0:
                blk[i, col(MLC_COL)] = 1
            if r.assert_val is not None:
                blk[i, col(MR_OFF) + r.dst] = 1
        ua, ub, uc = operands[i]
        blk[i, col(UA_OFF)], blk[i, col(UA_OFF) + 1] = ua
        blk[i, col(UB_OFF)], blk[i, col(UB_OFF) + 1] = ub
        blk[i, col(UC_OFF)], blk[i, col(UC_OFF) + 1] = uc
        for kreg in range(NUM_REGS):
            blk[i, col(R_OFF) + 2 * kreg] = reg_rows[i][kreg][0]
            blk[i, col(R_OFF) + 2 * kreg + 1] = reg_rows[i][kreg][1]
        p1, p2 = _control_bits(r)
        blk[i, col(PACK1_COL)] = p1
        blk[i, col(PACK2_COL)] = p2
    # registers copy through padding rows (pc = 0 there)
    if R < height and R > 0:
        for kreg in range(NUM_REGS):
            blk[R:, col(R_OFF) + 2 * kreg] = reg_rows[-1][kreg][0]
            blk[R:, col(R_OFF) + 2 * kreg + 1] = reg_rows[-1][kreg][1]

    # accumulator columns
    for gi, g in enumerate(gamma):
        gp = [pow(g, s, P) for s in range(SLOT_SHIFT + 1)]
        acc = 0
        for i in range(height):
            if i < R:
                c = 0
                for s, v in canonical_slots(rows[i]):
                    c += v * gp[s]
                acc = (acc * gp[SLOT_SHIFT] + c) % P
            blk[i, col(ACC_OFF) + gi] = acc

    full = gl.concatenate([core, gl.from_u64(blk, device)], dim=-1)
    return GL(full.lo.T.contiguous(), full.hi.T.contiguous())


def build_trace_rowmajor(rows: List[VRow], gamma,
                         log_n: Optional[int] = None,
                         device="cuda") -> np.ndarray:
    """Row-major host uint64 (height, NUM_COLS) trace (int-oracle prover
    ingest)."""
    return np.ascontiguousarray(
        gl.to_u64_np(build_trace_cols(rows, gamma, log_n, device)).T)
