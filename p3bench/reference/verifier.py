"""Full Plonky3 STARK verifier on plain Python ints and NumPy (a frozen
copy of the port's int oracle, plonky25_torch/refimpl/verifier.py).

The executable specification of src/p3/verifier.rs: the same algorithm,
with circuit `connect`s replaced by boolean equality checks.  A proof
verifies iff `verify(...).ok` is True.  Two changes from the oracle, both
exact in the field: every Merkle-path check of every proof given to
`verify_many` is gathered and run at once on NumPy lanes (npgl.py), and a
query's reduced opening sums each matrix's columns as
inv(x - z) * (sum_j a_j p_j(x) - sum_j a_j p_j(z)) rather than one
division per column.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .air import Air, VerifierConstraintFolder
from .constants import GOLDILOCKS_P as P
from .proof import FriConfig, InvalidProofShape, Proof, derive_config
from .bits import log2_strict, reverse_bits_len
from .challenger import DuplexChallenger
from .npgl import MerkleChecks, U, mul as np_mul, sum_mod
from .domains import TwoAdicMultiplicativeCoset
from .field import Gl, Gl2, ext_ops


class IntExtOps:
    """Extension-field ops adapter handed to the AIR folder (plain-int
    backend), degree-generic: `ext` is Gl2 (default) or Gl3
    (refimpl.field.ext_ops).

    Values are D-tuples whose components are python ints or numpy OBJECT
    arrays of python ints - the ext formulas are plain +,*,% so they work
    elementwise on object arrays, which is how wide AIRs (Keccak)
    evaluate thousands of constraints without python-level per-bit loops.

    point_ndim: trailing axes that index evaluation points (0 when folding
    at a single zeta, 1 when the prover folds over a whole domain)."""

    def __init__(self, point_ndim: int = 0, ext=Gl2):
        self.point_ndim = point_ndim
        self.E = ext

    def add(self, x, y):
        return self.E.add(x, y)

    def sub(self, x, y):
        return self.E.sub(x, y)

    def mul(self, x, y):
        return self.E.mul(x, y)

    def zero(self):
        return self.E.ZERO

    def one(self):
        return self.E.ONE

    def from_base(self, b):
        return self.E.from_base(b)

    def from_parts(self, a, b, c=None):
        """a + X*b (+ X^2*c): base trace columns as one ext value (see
        fields.extension.Ops.from_parts — valid at every point)."""
        out = self.E.add(a, self.E.mul(self.E.X, b))
        if c is not None:
            x2 = self.E.mul(self.E.X, self.E.X)
            out = self.E.add(out, self.E.mul(x2, c))
        return out

    # ---- vector helpers (constraint axis = axis 0) ----------------------
    def stack(self, vals):
        import numpy as _np

        return tuple(
            _np.asarray([v[k] for v in vals], dtype=object)
            for k in range(self.E.D))

    @staticmethod
    def take(vec, idx):
        import numpy as _np

        idx = _np.asarray(idx)
        return tuple(comp[idx] for comp in vec)

    @staticmethod
    def concat(vals):
        """Concatenate along the constraint axis (axis 0)."""
        import numpy as _np

        return tuple(
            _np.concatenate([v[k] for v in vals], axis=0)
            for k in range(len(vals[0])))

    def const_base(self, ints):
        import numpy as _np

        from .constants import GOLDILOCKS_P as _P

        c0 = _np.asarray([int(v) % _P for v in ints], dtype=object)
        c0 = c0.reshape(c0.shape + (1,) * self.point_ndim)
        return (c0,) + (c0 * 0,) * (self.E.D - 1)

    def fold_constraints(self, alpha, constraints):
        """acc = acc*alpha + c, flattening vector constraints in order."""
        import numpy as _np

        E = self.E
        acc = E.ZERO
        for c in constraints:
            nd = _np.ndim(c[0])
            if nd <= self.point_ndim:
                acc = E.add(E.mul(acc, alpha), c)
            else:
                # leading constraint axes: fold rows in index order
                comps = [
                    comp.reshape((-1,) + comp.shape[nd - self.point_ndim:])
                    if self.point_ndim else comp.reshape(-1)
                    for comp in c
                ]
                for i in range(len(comps[0])):
                    acc = E.add(E.mul(acc, alpha),
                                tuple(comp[i] for comp in comps))
        return acc


@dataclass
class VerifyTrace:
    ok: bool = False
    # individual check outcomes
    pow_ok: bool = False
    merkle_ok: bool = False
    fold_ok: bool = False
    quotient_ok: bool = False
    shape_ok: bool = False
    # transcript values (for cross-backend bit-exactness tests)
    alpha: tuple = (0, 0)
    zeta: tuple = (0, 0)
    alpha_fri: tuple = (0, 0)
    betas: List[tuple] = field(default_factory=list)
    query_indices: List[int] = field(default_factory=list)
    reduced_openings: List[List[tuple]] = field(default_factory=list)
    folded_evals: List[tuple] = field(default_factory=list)
    folded_constraints: tuple = (0, 0)
    quotient: tuple = (0, 0)
    # per query, per fold level: the two leaf evals [e0, e1] in hash order
    # (recorded for the attestation builder and checker, attest.py)
    fold_leaves: List[List[tuple]] = field(default_factory=list)


def verify(proof: Proof, air: Air, fri_config: FriConfig,
           check_merkle: bool = True) -> VerifyTrace:
    """Full verification of one proof (verify_many of one)."""
    return verify_many([proof], air, fri_config, check_merkle)[0]


def verify_many(proofs: List[Proof], air: Air, fri_config: FriConfig,
                check_merkle: bool = True) -> List[VerifyTrace]:
    """Full verification of each proof; their Merkle paths are checked
    together at the end.  With check_merkle=False no path is hashed and
    merkle_ok stays True: that verifier trusts every opening, which no
    sound verifier may do (the benchmark's control)."""
    merkle = MerkleChecks() if check_merkle else None
    runs = [_verify(p, air, fri_config, merkle) for p in proofs]
    ok = merkle.run() if merkle is not None else []
    out = []
    for tr, handles in runs:
        if tr.shape_ok:
            tr.merkle_ok = all(ok[h] for h in handles)
        tr.ok = (tr.shape_ok and tr.pow_ok and tr.merkle_ok and tr.fold_ok
                 and tr.quotient_ok)
        out.append(tr)
    return out


def _verify(proof: Proof, air: Air, fri_config: FriConfig,
            merkle: Optional[MerkleChecks]):
    """The algebra of one verification; the Merkle checks go to `merkle`
    (their handles returned beside the trace)."""
    handles: List[int] = []
    try:
        config = derive_config(proof, fri_config)
    except InvalidProofShape:
        return VerifyTrace(), handles
    tr = VerifyTrace(merkle_ok=True)
    ch = DuplexChallenger()
    E = ext_ops(config.ext_degree)
    D = E.D

    degree = 1 << proof.degree_bits
    quotient_degree = 1 << config.log_quotient_degree

    trace_domain = TwoAdicMultiplicativeCoset.natural_domain_for_degree(
        config.log_trace_height, degree
    )
    quotient_domain = trace_domain.create_disjoint_domain(
        1 << (proof.degree_bits + config.log_quotient_degree)
    )
    quotient_chunks_domains = quotient_domain.split_domains(quotient_degree)

    ov = proof.opened_values
    air_width = air.width()
    s2w = air.stage2_width()
    tr.shape_ok = (
        len(ov.trace_local) == air_width
        and len(ov.trace_next) == air_width
        and len(ov.quotient_chunks) == quotient_degree
        and all(len(qc) == D for qc in ov.quotient_chunks)
        and len(ov.stage2_local or []) == s2w
        and len(ov.stage2_next or []) == s2w
        and (proof.commitments.stage2 is not None) == bool(s2w)
    )
    if not tr.shape_ok:
        return tr, handles

    # -- transcript head (verifier.rs:135-140) ------------------------------
    ch.observe_many(proof.commitments.trace.value)
    challenges = [ch.sample_ext(D) for _ in range(air.num_challenges())]
    if s2w:
        ch.observe_many(proof.commitments.stage2.value)
    alpha = ch.sample_ext(D)
    ch.observe_many(proof.commitments.quotient_chunks.value)
    zeta = ch.sample_ext(D)
    zeta_next = trace_domain.next_point(zeta, ext=E)
    tr.alpha, tr.zeta = alpha, zeta

    # -- PCS opening proof (verifier.rs:242-355) ----------------------------
    commits_and_points = [
        (
            proof.commitments.trace.value,
            [(trace_domain, [(zeta, ov.trace_local), (zeta_next, ov.trace_next)])],
        ),
    ]
    if s2w:
        commits_and_points.append((
            proof.commitments.stage2.value,
            [(trace_domain,
              [(zeta, ov.stage2_local), (zeta_next, ov.stage2_next)])],
        ))
    commits_and_points.append(
        (
            proof.commitments.quotient_chunks.value,
            [
                (dom, [(zeta, vals)])
                for dom, vals in zip(quotient_chunks_domains, ov.quotient_chunks)
            ],
        ),
    )

    fri_proof = proof.opening_proof.fri_proof
    alpha_fri = ch.sample_ext(D)
    tr.alpha_fri = alpha_fri

    # shape & challenges (verifier.rs:357-388)
    betas = []
    for comm in fri_proof.commit_phase_commits:
        ch.observe_many(comm.value)
        betas.append(ch.sample_ext(D))
    tr.betas = betas

    Q = fri_config.num_queries
    if (len(fri_proof.query_proofs) != Q
            or len(proof.opening_proof.query_openings) != Q
            or any(len(qo) != len(commits_and_points)
                   for qo in proof.opening_proof.query_openings)):
        tr.shape_ok = False
        return tr, handles

    tr.pow_ok = ch.check_witness(fri_config.proof_of_work_bits, fri_proof.pow_witness)

    log_max_height = len(fri_proof.commit_phase_commits) + fri_config.log_blowup
    query_indices = [ch.sample_bits(log_max_height) for _ in range(Q)]
    tr.query_indices = query_indices

    # reduced openings per query (verifier.rs:266-344): for each matrix and
    # point, sum_j alpha_fri^(e+j) (p_j(x) - p_j(z)) / (x - z), with the
    # exponents e running per log-height in the oracle's order
    reduced_openings = [[E.ZERO] * 32 for _ in range(Q)]
    exps = [0] * 32
    for b, (batch_commit, mats) in enumerate(commits_and_points):
        openings = [qo[b] for qo in proof.opening_proof.query_openings]
        if merkle is not None:
            base_dims = [(0, dom.size()) for dom, _ in mats]
            for opening, index in zip(openings, query_indices):
                handles.append(merkle.add(
                    batch_commit, base_dims, index, opening.opened_values,
                    opening.opening_proof))
        for m, (mat_domain, mat_points_and_values) in enumerate(mats):
            log_height = log2_strict(mat_domain.size()) + fri_config.log_blowup
            bits_reduced = log_max_height - log_height
            g = Gl.two_adic_generator(log_height)
            xs = [Gl.mul(7, pow(g, reverse_bits_len(index >> bits_reduced,
                                                     log_height), P))
                  for index in query_indices]
            rows = [o.opened_values[m] for o in openings]
            if any(len(r) != len(rows[0]) for r in rows):
                tr.shape_ok = False
                return tr, handles
            p_x = _canonical(np.asarray(rows, dtype=object))        # (Q, w)
            for z, ps_at_z in mat_points_and_values:
                w = min(p_x.shape[1], len(ps_at_z))
                coef = _powers(E, alpha_fri, exps[log_height], w)
                exps[log_height] += w
                s_z = E.ZERO
                for a, pz in zip(coef, ps_at_z):
                    s_z = E.add(s_z, E.mul(a, pz))
                s_x = [sum_mod(np_mul(p_x[:, :w], np.asarray(
                    [a[k] for a in coef], dtype=U)[None]), axis=1)
                    for k in range(D)]
                for q in range(Q):
                    num = E.sub(tuple(int(s[q]) for s in s_x), s_z)
                    den = E.add_base(E.neg(z), xs[q])
                    reduced_openings[q][log_height] = E.add(
                        reduced_openings[q][log_height], E.div(num, den))
    tr.reduced_openings = reduced_openings

    # FRI fold per query (verifier.rs:390-519)
    fold_ok = True
    for index, qproof, ro in zip(
        query_indices, fri_proof.query_proofs, reduced_openings
    ):
        if len(qproof.commit_phase_openings) != len(betas):
            tr.shape_ok = False
            return tr, handles
        folded_eval, leaves = _verify_query(
            fri_proof.commit_phase_commits, index, qproof, betas, ro,
            log_max_height, merkle, handles, E=E
        )
        tr.fold_leaves.append(leaves)
        tr.folded_evals.append(folded_eval)
        fold_ok &= folded_eval == fri_proof.final_poly
    tr.fold_ok = fold_ok

    # -- quotient reconstruction (verifier.rs:169-219) ----------------------
    zps = []
    for i, domain in enumerate(quotient_chunks_domains):
        acc = E.ONE
        for j, other in enumerate(quotient_chunks_domains):
            if j == i:
                continue
            other_zeta = other.zp_at_point(zeta, ext=E)
            other_first = other.zp_at_single_point(domain.first_point())
            acc = E.mul(acc, E.mul_base(other_zeta, Gl.inv(other_first)))
        zps.append(acc)

    monomials = ([(1, 0), (0, 1)] if D == 2
                 else [(1, 0, 0), (0, 1, 0), (0, 0, 1)])
    quotient = E.ZERO
    for ch_i, chunk in enumerate(ov.quotient_chunks):
        for e_i, c in enumerate(chunk):
            quotient = E.add(quotient,
                             E.mul(zps[ch_i], E.mul(monomials[e_i], c)))
    tr.quotient = quotient

    # -- AIR constraint folding (verifier.rs:221-239) ------------------------
    sels = trace_domain.selectors_at_point(zeta, ext=E)
    folder = VerifierConstraintFolder(
        ops=IntExtOps(ext=E),
        main=ov,
        is_first_row=sels.is_first_row,
        is_last_row=sels.is_last_row,
        is_transition=sels.is_transition,
        alpha=alpha,
        publics={k: E.from_base(v % P)
                 for k, v in air.public_values().items()},
        challenges=list(challenges),
    )
    air.eval(folder)
    folded_constraints = folder.accumulator
    tr.folded_constraints = folded_constraints

    tr.quotient_ok = E.mul(folded_constraints, sels.inv_zeroifier) == quotient
    return tr, handles


def _canonical(a: np.ndarray) -> np.ndarray:
    """Opened values (Python ints, object array) as canonical uint64: the
    oracle reduces every value mod p as it computes."""
    return np.asarray(a % P, dtype=U)


def _powers(E, x, start: int, n: int) -> list:
    """x^start, ..., x^(start + n - 1) in the extension."""
    acc = E.ONE
    base = x
    e = start
    while e:                                  # x^start by squaring
        if e & 1:
            acc = E.mul(acc, base)
        base = E.mul(base, base)
        e >>= 1
    out = []
    for _ in range(n):
        out.append(acc)
        acc = E.mul(acc, x)
    return out


def _verify_query(commit_phase_commits, index, qproof, betas, ro,
                  log_max_height, merkle, handles, E=Gl2):
    """verifier.rs:419-519.  Also returns the per-level [e0, e1] leaf
    pairs in hash order."""
    leaves = []
    folded_eval = E.ZERO
    g = Gl.two_adic_generator(log_max_height)
    x = E.from_base(pow(g, reverse_bits_len(index, log_max_height), P))

    g1 = E.from_base(Gl.two_adic_generator(1))  # order-2 generator = -1

    for i, (commit, step, beta) in enumerate(
        zip(commit_phase_commits, qproof.commit_phase_openings, betas)
    ):
        log_folded_height = log_max_height - 1 - i
        folded_eval = E.add(ro[log_folded_height + 1], folded_eval)

        index_sibling = index ^ 1
        index_pair = index >> 1
        is_odd = index_sibling & 1

        if is_odd:
            evals = [folded_eval, step.sibling_value]
        else:
            evals = [step.sibling_value, folded_eval]

        leaves.append((evals[0], evals[1]))
        if merkle is not None:
            dims = [(2 * E.D, 1 << log_folded_height)]
            leaf_row = [v % P for e in evals for v in e]
            handles.append(merkle.add(
                commit.value, dims, index_pair, [leaf_row], step.opening_proof))

        if is_odd:
            xs = [x, E.mul(x, g1)]
        else:
            xs = [E.mul(x, g1), x]

        # folded = evals[0] + (beta - xs[0]) * (evals[1]-evals[0]) / (xs[1]-xs[0])
        num = E.mul(E.sub(evals[1], evals[0]), E.sub(beta, xs[0]))
        folded_eval = E.add(evals[0], E.div(num, E.sub(xs[1], xs[0])))

        index = index_pair
        x = E.mul(x, x)

    return folded_eval, leaves
