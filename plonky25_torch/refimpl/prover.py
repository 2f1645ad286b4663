"""Plonky3-compatible STARK prover on plain Python ints (uni-batch
TwoAdicFriPcs; a copy of plonky25_tpu/refimpl/prover.py).

Produces proofs with exactly the shape of artifacts/proof_fibonacci.json
(serde/proof.rs tree) that the verifier - validated bit-exactly against the
Rust-produced artifact - accepts.  Conventions (pinned by the verifier's
algebra, src/p3/verifier.rs):

  * every committed matrix is the LDE of its native-domain evaluations onto
    the coset 7*<g_(k+log_blowup)>, stored in BIT-REVERSED row order (so
    that a query index addresses x = 7 * g^rev(index), verifier.rs:306-311,
    and FRI siblings are adjacent);
  * quotient chunks are ext-valued polynomials committed as EXT_DEGREE base
    columns each;
  * FRI commit phase l commits the (2^l, 2*EXT) matrix of sibling pairs of
    the current fold vector, then folds at beta via the same interpolation
    the verifier replays (verifier.rs:483-511);
  * the PoW grind searches witnesses 0,1,2,... (challenger.rs:159-169).

It is the executable specification of prover/prove.py, and the prover of
`attest(..., use_device_prover=False)`.
"""

from __future__ import annotations

from typing import List

from ..air import Air, VerifierConstraintFolder
from ..constants import GOLDILOCKS_P as P
from ..proof import (
    BatchOpening,
    Commitment,
    Commitments,
    CommitPhaseProofStep,
    FriConfig,
    FriProof,
    OpenedValues,
    Proof,
    QueryProof,
    TwoAdicFriPcsProof,
)
from ..utils.bits import log2_ceil, log2_strict, reverse_bits_len
from .challenger import DuplexChallenger
from .commit import compress, hash_iter_slices
from .domains import TwoAdicMultiplicativeCoset
from .field import Gl, Gl2, ext_ops
from .ntt import coset_intt, coset_ntt


class MerkleTree:
    """Poseidon2 MMCS tree over the rows of one base-field matrix."""

    def __init__(self, rows: List[List[int]]):
        n = len(rows)
        assert n & (n - 1) == 0
        self.levels = [[hash_iter_slices([r]) for r in rows]]
        while len(self.levels[-1]) > 1:
            prev = self.levels[-1]
            self.levels.append(
                [compress(prev[2 * i], prev[2 * i + 1]) for i in range(len(prev) // 2)]
            )

    @property
    def root(self) -> List[int]:
        return self.levels[-1][0]

    def open(self, index: int) -> List[List[int]]:
        """Sibling digests bottom-up (the opening_proof)."""
        path = []
        for lvl in self.levels[:-1]:
            path.append(list(lvl[index ^ 1]))
            index >>= 1
        return path


def commit_matrix(evals_cols: List[List[int]], native_shift: int, log_blowup: int):
    """LDE-commit a matrix given per-column evals on native_shift*<g_k>.

    Returns (tree, lde_rows_bitrev): rows of the committed matrix in
    bit-reversed order (leaf i = evaluations at 7 * g_(k+b)^rev(i))."""
    k = log2_strict(len(evals_cols[0]))
    n_lde = 1 << (k + log_blowup)
    lde_cols = []
    for col in evals_cols:
        coeffs = coset_intt(col, native_shift)
        coeffs = coeffs + [0] * (n_lde - len(coeffs))
        lde_cols.append(coset_ntt(coeffs, 7))
    rows = [
        [lde_cols[c][reverse_bits_len(i, k + log_blowup)] for c in range(len(lde_cols))]
        for i in range(n_lde)
    ]
    return MerkleTree(rows), rows


def _eval_poly_ext(coeffs: List[int], z, E=Gl2) -> tuple:
    """Horner evaluation of a base-coefficient poly at an ext point."""
    acc = E.ZERO
    for c in reversed(coeffs):
        acc = E.add_base(E.mul(acc, z), c)
    return acc


def prove(air: Air, trace: List[List[int]], fri_config: FriConfig,
          ext_degree: int = 2) -> Proof:
    """trace: row-major list of rows (height x width), height a power of 2.

    Numeric numpy arrays are accepted and converted to python ints (numpy
    uint64 scalars overflow silently in this module's bigint math).

    ext_degree selects the proof family's extension field: 2 (default,
    the reference's GF(p^2) family, bit-exact vs the golden artifact) or
    3 (GF(p^3), X^3-7; refimpl-only — the device pipeline implements
    D=2, so D=3 proofs verify via refimpl.verifier.verify)."""
    import numpy as _np

    E = ext_ops(ext_degree)
    D = E.D

    if isinstance(trace, _np.ndarray):
        trace = trace.tolist()
    height = len(trace)
    width = len(trace[0])
    log_n = log2_strict(height)
    log_blowup = fri_config.log_blowup
    log_quotient_degree = log2_ceil(_constraint_degree_excess(air, width))
    quotient_degree = 1 << log_quotient_degree

    ch = DuplexChallenger()

    # ---- commit trace ---------------------------------------------------
    trace_cols = [[trace[r][c] % P for r in range(height)] for c in range(width)]
    trace_tree, trace_lde_rows = commit_matrix(trace_cols, 1, log_blowup)
    trace_commit = trace_tree.root

    ch.observe_many(trace_commit)

    # ---- stage 2 (multi-stage AIRs): sample challenges, commit the
    # challenge-dependent second matrix (air.py Air.build_stage2)
    from ..air import check_multistage_consistency

    check_multistage_consistency(air)
    s2w = air.stage2_width()
    challenges = [ch.sample_ext(D) for _ in range(air.num_challenges())]
    s2_tree = s2_lde_rows = None
    s2_cols: List[List[int]] = []
    if s2w:
        s2_cols = [[v % P for v in col]
                   for col in air.build_stage2(trace, challenges)]
        assert len(s2_cols) == s2w and len(s2_cols[0]) == height
        s2_tree, s2_lde_rows = commit_matrix(s2_cols, 1, log_blowup)
        ch.observe_many(s2_tree.root)

    alpha = ch.sample_ext(D)

    # ---- quotient -------------------------------------------------------
    trace_domain = TwoAdicMultiplicativeCoset(log_n=log_n, shift=1)
    q_log_n = log_n + log_quotient_degree
    quotient_domain = TwoAdicMultiplicativeCoset(log_n=q_log_n, shift=7)
    g_q = Gl.two_adic_generator(q_log_n)
    g_t = trace_domain.gen()

    # trace evals on the quotient domain and its g-shift
    q_size = 1 << q_log_n
    local_cols, next_cols = [], []
    for col in trace_cols:
        coeffs = coset_intt(col, 1) + [0] * (q_size - height)
        local_cols.append(coset_ntt(coeffs, 7))
        next_cols.append(coset_ntt(coeffs, 7 * g_t % P))
    s2_local_cols, s2_next_cols = [], []
    for col in s2_cols:
        coeffs = coset_intt(col, 1) + [0] * (q_size - height)
        s2_local_cols.append(coset_ntt(coeffs, 7))
        s2_next_cols.append(coset_ntt(coeffs, 7 * g_t % P))

    sels = [
        trace_domain.selectors_at_point(
            E.from_base(7 * pow(g_q, i, P) % P), ext=E)
        for i in range(q_size)
    ]

    # vectorized constraint evaluation over the whole quotient domain:
    # point axis = trailing axis of numpy OBJECT arrays (IntExtOps works
    # elementwise on them), one AIR eval instead of q_size
    import numpy as _np

    from .verifier import IntExtOps

    def _vec(vals):  # list of ints -> ext over points
        z = _np.asarray([0] * len(vals), dtype=object)
        return (_np.asarray(vals, dtype=object),) + (z,) * (D - 1)

    main = _MainRow(
        [_vec(local_cols[c]) for c in range(width)],
        [_vec(next_cols[c]) for c in range(width)],
    )
    main.local_vec = ((_np.asarray(local_cols, dtype=object),)
                      + (_np.zeros((width, q_size), dtype=object),) * (D - 1))
    main.next_vec = ((_np.asarray(next_cols, dtype=object),)
                     + (_np.zeros((width, q_size), dtype=object),) * (D - 1))
    if s2w:
        main.stage2_local = [_vec(s2_local_cols[c]) for c in range(s2w)]
        main.stage2_next = [_vec(s2_next_cols[c]) for c in range(s2w)]
        main.stage2_local_vec = (
            (_np.asarray(s2_local_cols, dtype=object),)
            + (_np.zeros((s2w, q_size), dtype=object),) * (D - 1))
        main.stage2_next_vec = (
            (_np.asarray(s2_next_cols, dtype=object),)
            + (_np.zeros((s2w, q_size), dtype=object),) * (D - 1))
    def _sel_vec(attr):
        return tuple(
            _np.asarray([getattr(s, attr)[k] for s in sels], dtype=object)
            for k in range(D))

    folder = VerifierConstraintFolder(
        ops=IntExtOps(point_ndim=1, ext=E),
        main=main,
        is_first_row=_sel_vec("is_first_row"),
        is_last_row=_sel_vec("is_last_row"),
        is_transition=_sel_vec("is_transition"),
        alpha=alpha,
        publics={k: E.from_base(v % P)
                 for k, v in air.public_values().items()},
        challenges=list(challenges),
    )
    air.eval(folder)
    acc_comps = folder.accumulator
    quotient_evals = [
        E.mul(tuple(int(comp[i]) for comp in acc_comps),
              sels[i].inv_zeroifier)
        for i in range(q_size)
    ]

    # split into chunks: chunk c takes points with index = c (mod num_chunks)?
    # split_domains (two_adic.rs:73-90): chunk i is the coset
    # (shift * g_q^i) * <g_(q_log_n - log_chunks)>, i.e. indices i + j*chunks.
    chunk_cols: List[List[List[int]]] = []  # [chunk][ext_coeff] -> evals
    for ci in range(quotient_degree):
        vals = [quotient_evals[ci + j * quotient_degree] for j in range(q_size // quotient_degree)]
        chunk_cols.append([[v[e] for v in vals] for e in range(D)])

    # commit all chunks as one batch matrix?  plonky3 commits the quotient
    # chunks as SEPARATE matrices in one MMCS batch; with equal heights the
    # leaf row is the concatenation of the chunks' rows.
    q_chunk_shifts = [7 * pow(g_q, ci, P) % P for ci in range(quotient_degree)]
    chunk_ldes = []
    for ci in range(quotient_degree):
        _, rows = commit_matrix(chunk_cols[ci], q_chunk_shifts[ci], log_blowup)
        chunk_ldes.append(rows)
    # concatenated rows across chunk matrices (same height)
    q_rows = [sum((chunk_ldes[ci][i] for ci in range(quotient_degree)), [])
              for i in range(len(chunk_ldes[0]))]
    quotient_tree = MerkleTree(q_rows)
    quotient_commit = quotient_tree.root

    ch.observe_many(quotient_commit)
    zeta = ch.sample_ext(D)
    zeta_next = (E.mul_base(zeta, g_t))

    # ---- opened values ---------------------------------------------------
    trace_coeffs = [coset_intt(col, 1) for col in trace_cols]
    s2_coeffs = [coset_intt(col, 1) for col in s2_cols]
    opened = OpenedValues(
        trace_local=[_eval_poly_ext(c, zeta, E) for c in trace_coeffs],
        trace_next=[_eval_poly_ext(c, zeta_next, E) for c in trace_coeffs],
        quotient_chunks=[
            [
                _eval_poly_ext(
                    coset_intt(chunk_cols[ci][e], q_chunk_shifts[ci]),
                    zeta, E)
                for e in range(D)
            ]
            for ci in range(quotient_degree)
        ],
        stage2_local=([_eval_poly_ext(c, zeta, E) for c in s2_coeffs]
                      if s2w else None),
        stage2_next=([_eval_poly_ext(c, zeta_next, E) for c in s2_coeffs]
                     if s2w else None),
    )

    # ---- FRI ---------------------------------------------------------------
    alpha_fri = ch.sample_ext(D)
    log_max_height = log_n + log_blowup
    n_max = 1 << log_max_height

    # reduced-opening input vector at max height (bit-rev order), built with
    # the verifier's exact term order (verifier.rs:296-344)
    ro = [E.ZERO] * n_max
    alpha_pow = E.ONE
    terms = []
    for c in range(width):
        terms.append((lambda i, c=c: trace_lde_rows[i][c], zeta, opened.trace_local[c]))
    for c in range(width):
        terms.append((lambda i, c=c: trace_lde_rows[i][c], zeta_next, opened.trace_next[c]))
    for c in range(s2w):
        terms.append((lambda i, c=c: s2_lde_rows[i][c], zeta, opened.stage2_local[c]))
    for c in range(s2w):
        terms.append((lambda i, c=c: s2_lde_rows[i][c], zeta_next, opened.stage2_next[c]))
    for ci in range(quotient_degree):
        for e in range(D):
            col = ci * D + e
            terms.append((lambda i, col=col: q_rows[i][col], zeta,
                          opened.quotient_chunks[ci][e]))

    xs = [7 * pow(Gl.two_adic_generator(log_max_height),
                  reverse_bits_len(i, log_max_height), P) % P
          for i in range(n_max)]
    for getter, z, p_at_z in terms:
        for i in range(n_max):
            num = E.add_base(E.neg(p_at_z), getter(i))
            den = E.add_base(E.neg(z), xs[i])
            ro[i] = E.add(ro[i], E.mul(alpha_pow, E.div(num, den)))
        alpha_pow = E.mul(alpha_pow, alpha_fri)

    # fold loop (verifier.rs:440-516 mirrored)
    commit_phase_commits: List[Commitment] = []
    commit_phase_trees: List[MerkleTree] = []
    commit_phase_vectors: List[List[tuple]] = []
    betas = []
    u = ro
    g1 = Gl.two_adic_generator(1)  # == p - 1 == -1
    for log_folded in range(log_max_height - 1, log_blowup - 1, -1):
        rows = [
            list(u[2 * j]) + list(u[2 * j + 1])
            for j in range(1 << log_folded)
        ]
        tree = MerkleTree(rows)
        commit_phase_trees.append(tree)
        commit_phase_vectors.append(list(u))
        commit_phase_commits.append(Commitment(value=list(tree.root)))
        ch.observe_many(tree.root)
        beta = ch.sample_ext(D)
        betas.append(beta)

        g_cur = Gl.two_adic_generator(log_folded + 1)
        nxt = []
        for j in range(1 << log_folded):
            e0, e1 = u[2 * j], u[2 * j + 1]
            x0 = pow(g_cur, reverse_bits_len(2 * j, log_folded + 1), P)
            x1 = x0 * g1 % P
            num = E.mul(E.sub(e1, e0), E.sub_base(beta, x0))
            den_inv = Gl.inv((x1 - x0) % P)
            nxt.append(E.add(e0, E.mul_base(num, den_inv)))
        u = nxt
        # fold in lower-height reduced openings (none for a single batch
        # height, but keep the hook for generality)

    final_poly = u[0]
    for v in u:
        assert v == final_poly, "FRI input was not low-degree"

    # ---- PoW grind (challenger.rs:159-169: sequential witnesses 0,1,...) --
    # State before the grind: input buffer empty, so observing w and
    # sampling equals one permutation of [w, state[1:]] and reading lane 11.
    from .poseidon2 import poseidon2 as _perm

    assert not ch.input_buffer
    bits = fri_config.proof_of_work_bits
    mask = (1 << bits) - 1
    pow_witness = None
    for w in range(1 << (bits + 8)):
        st = [w] + ch.state[1:]
        if _perm(st)[11] & mask == 0:
            pow_witness = w
            break
    assert pow_witness is not None
    ch.observe(pow_witness)
    assert ch.sample_bits(bits) == 0

    # ---- queries ----------------------------------------------------------
    query_indices = [ch.sample_bits(log_max_height) for _ in range(fri_config.num_queries)]

    query_openings = []
    query_proofs = []
    for idx in query_indices:
        batches = [
            BatchOpening(
                opened_values=[list(trace_lde_rows[idx])],
                opening_proof=trace_tree.open(idx),
            ),
        ]
        if s2w:
            batches.append(BatchOpening(
                opened_values=[list(s2_lde_rows[idx])],
                opening_proof=s2_tree.open(idx),
            ))
        batches.append(
            BatchOpening(
                # one row per chunk matrix (serde/proof.rs BatchOpening)
                opened_values=[list(chunk_ldes[ci][idx])
                               for ci in range(quotient_degree)],
                opening_proof=quotient_tree.open(idx),
            ),
        )
        query_openings.append(batches)

        steps = []
        i = idx
        for l, tree in enumerate(commit_phase_trees):
            vec = commit_phase_vectors[l]
            sib = vec[i ^ 1]
            steps.append(
                CommitPhaseProofStep(
                    sibling_value=sib,
                    opening_proof=tree.open(i >> 1),
                )
            )
            i >>= 1
        query_proofs.append(QueryProof(commit_phase_openings=steps))

    return Proof(
        commitments=Commitments(
            trace=Commitment(value=list(trace_commit)),
            quotient_chunks=Commitment(value=list(quotient_commit)),
            stage2=(Commitment(value=list(s2_tree.root)) if s2w else None),
        ),
        opened_values=opened,
        opening_proof=TwoAdicFriPcsProof(
            fri_proof=FriProof(
                commit_phase_commits=commit_phase_commits,
                query_proofs=query_proofs,
                final_poly=final_poly,
                pow_witness=pow_witness,
            ),
            query_openings=query_openings,
        ),
        degree_bits=log_n,
    )


class _MainRow:
    def __init__(self, trace_local, trace_next):
        self.trace_local = trace_local
        self.trace_next = trace_next
        self.quotient_chunks = []


def _constraint_degree_excess(air: Air, width: int) -> int:
    """Quotient degree multiplier.  For the AIRs shipped here the folded
    constraint degree is <= 2*(n-1) + n selector parts, giving
    deg(Q) < n, i.e. one chunk (matches the golden artifact's shape).
    AIRs with higher-degree constraints can override `quotient_degree`."""
    return getattr(air, "quotient_degree", lambda: 1)()
