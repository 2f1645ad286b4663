"""Typed error surface (reference: FriError, src/p3/serde/fri.rs:16-21); a
copy of plonky25_tpu/errors.py.

The reference's verifier panics on malformed proofs except for one typed
path — `FriError::InvalidProofShape` when the query count disagrees with
the config (src/p3/verifier.rs:372-374).  Here, shape problems raise
`InvalidProofShape` from `check_proof_shape` (host-side, before any device
work), and proof-VALUE problems never raise: they turn into a False verdict
with per-stage flags on `VerifyResult` (soundness checks must not be
bypassable by exceptions).
"""

from __future__ import annotations


class P25Error(Exception):
    """Base class for plonky2.5 errors."""


class FriError(P25Error):
    """FRI-level verification errors (serde/fri.rs:16-21)."""


class InvalidProofShape(FriError):
    """Proof tree shape disagrees with the derived config
    (verifier.rs:126-133, 372-374)."""


class InvalidPowWitness(FriError):
    """Proof-of-work witness fails the grind check (challenger.rs:159-169).

    Only raised by strict APIs; the batched verifier reports it in
    VerifyResult.pow_ok instead."""


def _want(cond: bool, msg: str) -> None:
    if not cond:
        raise InvalidProofShape(msg)


def check_proof_shape(proof, config) -> None:
    """Raise InvalidProofShape unless `proof` matches `config` EXHAUSTIVELY.

    Mirrors and extends the reference's shape validation — the panic block
    at verifier.rs:126-133 (opened-value widths vs. AIR/quotient shape) and
    the typed query-count check at verifier.rs:372-374 — to every structure
    the witness packer and the device stages rely on: digest lengths,
    commit-phase count vs degree_bits, Merkle path depths per batch and per
    fold level, sibling-value and final-poly arity.  A proof that passes
    this check cannot crash pack_witness; any deeper disagreement is a
    VALUE problem and becomes a False verdict, never an exception."""
    from .constants import DIGEST_ELEMS

    # extension degree is config-carried (D=2 reference family; D=3 on
    # the refimpl path); every ext-arity check below follows it
    EXT_DEGREE = getattr(config, "ext_degree", 2)

    ov = proof.opened_values
    op = proof.opening_proof
    fp = op.fri_proof
    fc = config.fri_config

    # ---- top-level counts (verifier.rs:126-133, 372-374)
    q = len(fp.query_proofs)
    _want(q == fc.num_queries,
          f"proof has {q} query proofs, config expects {fc.num_queries}")
    _want(len(op.query_openings) == fc.num_queries,
          f"{len(op.query_openings)} query openings, "
          f"expected {fc.num_queries}")
    _want(len(ov.trace_local) == config.trace_width,
          f"trace_local width {len(ov.trace_local)} != AIR width "
          f"{config.trace_width}")
    _want(len(ov.trace_next) == config.trace_width,
          f"trace_next width {len(ov.trace_next)} != AIR width "
          f"{config.trace_width}")
    n_chunks = 1 << config.log_quotient_degree
    _want(len(ov.quotient_chunks) == n_chunks,
          f"{len(ov.quotient_chunks)} quotient chunks, expected {n_chunks}")
    for i, qc in enumerate(ov.quotient_chunks):
        _want(len(qc) == EXT_DEGREE,
              f"quotient chunk {i} has {len(qc)} values, expected "
              f"{EXT_DEGREE}")

    # ---- stage-2 (multi-stage AIRs): all-present or all-absent, and the
    # widths must match the config
    s2w = getattr(config, "stage2_width", 0)
    if s2w:
        _want(proof.commitments.stage2 is not None
              and ov.stage2_local is not None and ov.stage2_next is not None,
              "config expects a stage-2 matrix but the proof has none")
        _want(len(ov.stage2_local) == s2w and len(ov.stage2_next) == s2w,
              f"stage2 opened width {len(ov.stage2_local)} != {s2w}")
        _want(len(proof.commitments.stage2.value) == DIGEST_ELEMS,
              "stage2 commitment is not a 4-element digest")
    else:
        _want(proof.commitments.stage2 is None and ov.stage2_local is None
              and ov.stage2_next is None,
              "proof carries a stage-2 matrix but the config expects none")

    # ---- commitments: 4-element digests everywhere
    _want(len(proof.commitments.trace.value) == DIGEST_ELEMS,
          "trace commitment is not a 4-element digest")
    _want(len(proof.commitments.quotient_chunks.value) == DIGEST_ELEMS,
          "quotient commitment is not a 4-element digest")
    for i, c in enumerate(fp.commit_phase_commits):
        _want(len(c.value) == DIGEST_ELEMS,
              f"commit-phase commitment {i} is not a 4-element digest")

    # ---- commit-phase count: FRI folds log_max -> log_blowup, one phase
    # per trace-height bit, so n_phases must equal degree_bits
    n_phases = len(fp.commit_phase_commits)
    _want(n_phases == proof.degree_bits,
          f"{n_phases} commit-phase commitments but degree_bits="
          f"{proof.degree_bits}")
    _want(config.log_trace_height == n_phases,
          f"config.log_trace_height {config.log_trace_height} != "
          f"{n_phases} commit phases")
    log_max = proof.degree_bits + fc.log_blowup
    _want(config.opening_matrix_log_max_height == log_max,
          f"opening path depth {config.opening_matrix_log_max_height} != "
          f"degree_bits + log_blowup = {log_max}")
    _want(0 < log_max <= 32, f"log_max_height {log_max} out of range")
    _want(len(fp.final_poly) == EXT_DEGREE,
          "final_poly is not an extension element")

    # ---- per-query batch openings: [trace, (stage2), quotient], rectangular
    n_batches = 3 if s2w else 2
    for qi, batches in enumerate(op.query_openings):
        _want(len(batches) == n_batches,
              f"query {qi} has {len(batches)} batch openings, "
              f"expected {n_batches}")
        tb, qb = batches[0], batches[-1]
        _want(len(tb.opened_values) == 1
              and len(tb.opened_values[0]) == config.trace_width,
              f"query {qi} trace batch rows/width mismatch")
        _want(len(qb.opened_values) == n_chunks
              and all(len(r) == EXT_DEGREE for r in qb.opened_values),
              f"query {qi} quotient batch rows/width mismatch")
        if s2w:
            sb = batches[1]
            _want(len(sb.opened_values) == 1
                  and len(sb.opened_values[0]) == s2w,
                  f"query {qi} stage2 batch rows/width mismatch")
        for b, batch in enumerate(batches):
            _want(len(batch.opening_proof) == log_max,
                  f"query {qi} batch {b} path depth "
                  f"{len(batch.opening_proof)} != {log_max}")
            for sib in batch.opening_proof:
                _want(len(sib) == DIGEST_ELEMS,
                      f"query {qi} batch {b} has a non-4-element "
                      "path sibling")

    # ---- per-query fold openings: shrinking depths, ext siblings
    for qi, qp in enumerate(fp.query_proofs):
        _want(len(qp.commit_phase_openings) == n_phases,
              f"query {qi} has {len(qp.commit_phase_openings)} fold "
              f"openings, expected {n_phases}")
        for l, step in enumerate(qp.commit_phase_openings):
            _want(len(step.sibling_value) == EXT_DEGREE,
                  f"query {qi} level {l} sibling_value is not an "
                  "extension element")
            want_depth = n_phases - l
            _want(len(step.opening_proof) == want_depth,
                  f"query {qi} level {l} fold path depth "
                  f"{len(step.opening_proof)} != {want_depth}")
            for sib in step.opening_proof:
                _want(len(sib) == DIGEST_ELEMS,
                      f"query {qi} level {l} has a non-4-element "
                      "path sibling")
