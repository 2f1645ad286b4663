"""Full Plonky3 STARK verifier on plain Python ints (a copy of
plonky25_tpu/refimpl/verifier.py).

The executable specification of src/p3/verifier.rs: the same algorithm,
with circuit `connect`s replaced by boolean equality checks.  A proof
verifies iff `verify(...).ok` is True.  The returned `VerifyTrace` also
exposes every Fiat-Shamir challenge, and `verify(..., challenger=)` runs
the transcript through any object with the DuplexChallenger interface:
attestation records the samples that way (attest.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..air import Air, VerifierConstraintFolder
from ..constants import GOLDILOCKS_P as P
from ..proof import FriConfig, Proof, derive_config
from ..utils.bits import log2_strict, reverse_bits_len
from .challenger import DuplexChallenger
from .commit import verify_batch
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

        from ..constants import GOLDILOCKS_P as _P

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


# back-compat alias (used by the prover and older call sites)
_Gl2Ops = IntExtOps()


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
           challenger=None, check_merkle: bool = True) -> VerifyTrace:
    """Full verification when called plain; with `challenger` (any object
    with the DuplexChallenger interface) the transcript is driven by that
    object instead, and with check_merkle=False the Merkle path hashing is
    skipped — the hash-free algebra re-execution the attestation checker
    runs (attest.py; the hashes are covered by the STARK)."""
    config = derive_config(proof, fri_config)
    tr = VerifyTrace()
    ch = challenger if challenger is not None else DuplexChallenger()
    # extension degree follows the proof family (D=2: the reference's;
    # D=3: refimpl-only, src/p3/extension.rs degree-3 formula arms)
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
        return tr

    # -- transcript head (verifier.rs:135-140; multi-stage: challenges are
    # sampled from the main-trace commitment, then the stage-2 commitment
    # is observed before alpha) --------------------------------------------
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

    if len(fri_proof.query_proofs) != fri_config.num_queries:
        tr.shape_ok = False
        return tr

    tr.pow_ok = ch.check_witness(fri_config.proof_of_work_bits, fri_proof.pow_witness)

    log_max_height = len(fri_proof.commit_phase_commits) + fri_config.log_blowup
    query_indices = [
        ch.sample_bits(log_max_height) for _ in range(fri_config.num_queries)
    ]
    tr.query_indices = query_indices

    # reduced openings per query (verifier.rs:266-344)
    merkle_ok = True
    reduced_openings = []
    for query_opening, index in zip(proof.opening_proof.query_openings, query_indices):
        ro = [E.ZERO] * 32
        alpha_pow = [E.ONE] * 32
        for batch_opening, (batch_commit, mats) in zip(query_opening, commits_and_points):
            batch_dims = [(0, dom.size()) for dom, _ in mats]
            base_dims = [(w * D, h) for w, h in batch_dims]
            if check_merkle:
                merkle_ok &= verify_batch(
                    batch_commit,
                    base_dims,
                    index,
                    batch_opening.opened_values,
                    batch_opening.opening_proof,
                )
            for mat_opening, (mat_domain, mat_points_and_values) in zip(
                batch_opening.opened_values, mats
            ):
                log_height = log2_strict(mat_domain.size()) + fri_config.log_blowup
                bits_reduced = log_max_height - log_height
                rev_reduced_index = reverse_bits_len(index >> bits_reduced, log_height)
                g = Gl.two_adic_generator(log_height)
                x = Gl.mul(7, pow(g, rev_reduced_index, P))
                for z, ps_at_z in mat_points_and_values:
                    for p_at_x, p_at_z in zip(mat_opening, ps_at_z):
                        # (p(x) - p(z)) / (x - z), built exactly as the
                        # reference: (-p_at_z + p_at_x) / (-z + x)
                        num = E.add_base(E.neg(p_at_z), p_at_x)
                        den = E.add_base(E.neg(z), x)
                        quot = E.div(num, den)
                        ro[log_height] = E.add(
                            ro[log_height], E.mul(alpha_pow[log_height], quot)
                        )
                        alpha_pow[log_height] = E.mul(alpha_pow[log_height], alpha_fri)
        reduced_openings.append(ro)
    tr.reduced_openings = reduced_openings

    # FRI fold per query (verifier.rs:390-519)
    fold_ok = True
    for index, qproof, ro in zip(
        query_indices, fri_proof.query_proofs, reduced_openings
    ):
        folded_eval, q_merkle_ok, leaves = _verify_query(
            fri_proof.commit_phase_commits, index, qproof, betas, ro,
            log_max_height, check_merkle, E=E
        )
        merkle_ok &= q_merkle_ok
        tr.fold_leaves.append(leaves)
        tr.folded_evals.append(folded_eval)
        fold_ok &= folded_eval == fri_proof.final_poly
    tr.fold_ok = fold_ok
    tr.merkle_ok = merkle_ok

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

    tr.ok = (
        tr.shape_ok and tr.pow_ok and tr.merkle_ok and tr.fold_ok and tr.quotient_ok
    )
    return tr


def _verify_query(commit_phase_commits, index, qproof, betas, ro,
                  log_max_height, check_merkle: bool = True, E=Gl2):
    """verifier.rs:419-519.  Also returns the per-level [e0, e1] leaf
    pairs in hash order (attestation support)."""
    leaves = []
    folded_eval = E.ZERO
    g = Gl.two_adic_generator(log_max_height)
    x = E.from_base(pow(g, reverse_bits_len(index, log_max_height), P))
    merkle_ok = True

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
        if check_merkle:
            dims = [(2 * E.D, 1 << log_folded_height)]
            leaf_row = [v for e in evals for v in e]
            merkle_ok &= verify_batch(
                commit.value, dims, index_pair, [leaf_row], step.opening_proof
            )

        if is_odd:
            xs = [x, E.mul(x, g1)]
        else:
            xs = [E.mul(x, g1), x]

        # folded = evals[0] + (beta - xs[0]) * (evals[1]-evals[0]) / (xs[1]-xs[0])
        num = E.mul(E.sub(evals[1], evals[0]), E.sub(beta, xs[0]))
        folded_eval = E.add(evals[0], E.div(num, E.sub(xs[1], xs[0])))

        index = index_pair
        x = E.mul(x, x)

    return folded_eval, merkle_ok, leaves
