"""Proof containers mirroring the reference JSON schema (a frozen copy of
plonky25_torch/proof.py).

Same tree as src/p3/serde/proof.rs, with the plonky3 `{"value": ...}` wrapper
and ignored `_marker` fields handled by the loader.  Values are plain Python
ints (canonical Goldilocks); the verifier packs them into padded tensors
separately (see plonky25_torch.witness).

Shape-derived config mirrors P3Config (serde/proof.rs:402-411) and the
derivation in p3_verify_proof (p3/mod.rs:74-87).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .bits import log2_ceil


class InvalidProofShape(ValueError):
    """A proof tree that lacks the structure the parser or the config
    derivation indexes into."""

Ext = Tuple[int, ...]  # extension element: (c0, c1) for D=2, (c0, c1, c2) for D=3


@dataclass
class FriConfig:
    """serde/fri.rs:4-8"""
    log_blowup: int = 1
    num_queries: int = 100
    proof_of_work_bits: int = 16


@dataclass
class FriChallenges:
    """Sampled FRI challenges (serde/fri.rs:10-13): the per-phase folding
    betas and the query indices.  Returned by the verifiers for
    debugging/introspection parity with the reference."""
    query_indices: List[int]
    betas: List[Ext]


@dataclass
class Commitment:
    value: List[int]  # DIGEST_ELEMS = 4


@dataclass
class Commitments:
    trace: Commitment
    quotient_chunks: Commitment
    # Second-stage trace commitment (multi-stage AIRs): committed AFTER the
    # main trace so its columns may depend on transcript challenges sampled
    # from the main-trace commitment (gamma).  Absent (None) for ordinary
    # single-stage proofs — the reference's uni-stark (serde/proof.rs:73-77)
    # has no such field and the JSON schema stays byte-identical without it.
    stage2: Optional[Commitment] = None


@dataclass
class OpenedValues:
    trace_local: List[Ext]
    trace_next: List[Ext]
    quotient_chunks: List[List[Ext]]
    # stage-2 matrix openings at zeta / zeta*g (multi-stage AIRs only)
    stage2_local: Optional[List[Ext]] = None
    stage2_next: Optional[List[Ext]] = None


@dataclass
class CommitPhaseProofStep:
    sibling_value: Ext
    opening_proof: List[List[int]]  # [depth][4]


@dataclass
class QueryProof:
    commit_phase_openings: List[CommitPhaseProofStep]


@dataclass
class FriProof:
    commit_phase_commits: List[Commitment]
    query_proofs: List[QueryProof]
    final_poly: Ext
    pow_witness: int


@dataclass
class BatchOpening:
    opened_values: List[List[int]]  # [rows][cols] base-field values
    opening_proof: List[List[int]]  # [depth][4]


@dataclass
class TwoAdicFriPcsProof:
    fri_proof: FriProof
    query_openings: List[List[BatchOpening]]  # [query][batch]


@dataclass
class Proof:
    commitments: Commitments
    opened_values: OpenedValues
    opening_proof: TwoAdicFriPcsProof
    degree_bits: int


@dataclass
class P3Config:
    """Proof-shape-derived verifier config (p3/mod.rs:74-87)."""
    fri_config: FriConfig
    log_quotient_degree: int
    log_trace_height: int
    trace_width: int
    opening_matrix_log_max_height: int
    quotient_opened_values_len: int
    degree_bits: int
    stage2_width: int = 0
    # extension degree of the proof family: 2 (the reference's, and the
    # only degree the DEVICE pipeline implements) or 3 (refimpl
    # prove/verify path; src/p3/extension.rs carries both formula sets)
    ext_degree: int = 2


# ---------------------------------------------------------------- JSON loading

def _val(node) -> int:
    """Unwrap the plonky3 serde `Value<F>` wrapper {"value": n}."""
    if isinstance(node, dict):
        return int(node["value"])
    return int(node)


def _ext(node) -> Ext:
    vs = node["value"]
    return tuple(_val(v) for v in vs)


def _commitment(node) -> Commitment:
    return Commitment(value=[_val(v) for v in node["value"]])


def proof_from_json(obj: dict) -> Proof:
    """Parse the reference JSON schema; malformed trees raise the typed
    InvalidProofShape instead of accidental KeyError/IndexError (the
    parser fails closed)."""
    try:
        return _proof_from_json(obj)
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise InvalidProofShape(f"malformed proof JSON: {type(e).__name__} {e}")


def _proof_from_json(obj: dict) -> Proof:
    ov = obj["opened_values"]
    op = obj["opening_proof"]
    fp = op["fri_proof"]
    return Proof(
        commitments=Commitments(
            trace=_commitment(obj["commitments"]["trace"]),
            quotient_chunks=_commitment(obj["commitments"]["quotient_chunks"]),
            stage2=(_commitment(obj["commitments"]["stage2"])
                    if obj["commitments"].get("stage2") is not None else None),
        ),
        opened_values=OpenedValues(
            trace_local=[_ext(e) for e in ov["trace_local"]],
            trace_next=[_ext(e) for e in ov["trace_next"]],
            quotient_chunks=[[_ext(e) for e in chunk] for chunk in ov["quotient_chunks"]],
            stage2_local=([_ext(e) for e in ov["stage2_local"]]
                          if ov.get("stage2_local") is not None else None),
            stage2_next=([_ext(e) for e in ov["stage2_next"]]
                         if ov.get("stage2_next") is not None else None),
        ),
        opening_proof=TwoAdicFriPcsProof(
            fri_proof=FriProof(
                commit_phase_commits=[_commitment(c) for c in fp["commit_phase_commits"]],
                query_proofs=[
                    QueryProof(
                        commit_phase_openings=[
                            CommitPhaseProofStep(
                                sibling_value=_ext(s["sibling_value"]),
                                opening_proof=[[_val(v) for v in sib] for sib in s["opening_proof"]],
                            )
                            for s in q["commit_phase_openings"]
                        ]
                    )
                    for q in fp["query_proofs"]
                ],
                final_poly=_ext(fp["final_poly"]),
                pow_witness=_val(fp["pow_witness"]),
            ),
            query_openings=[
                [
                    BatchOpening(
                        opened_values=[[_val(v) for v in row] for row in b["opened_values"]],
                        opening_proof=[[_val(v) for v in sib] for sib in b["opening_proof"]],
                    )
                    for b in batches
                ]
                for batches in op["query_openings"]
            ],
        ),
        degree_bits=int(obj["degree_bits"]),
    )


def derive_config(proof: Proof, fri_config: FriConfig) -> P3Config:
    """Shape-derived config, exactly as p3/mod.rs:74-87.

    A proof missing the structure the derivation indexes into (no query
    openings, no batches, empty rows) raises InvalidProofShape rather than
    an accidental IndexError — shape failures must stay on the typed path
    (the parser fails closed)."""
    try:
        return P3Config(
            fri_config=fri_config,
            log_quotient_degree=log2_ceil(len(proof.opened_values.quotient_chunks)),
            log_trace_height=len(proof.opening_proof.fri_proof.commit_phase_commits),
            trace_width=len(proof.opened_values.trace_local),
            opening_matrix_log_max_height=len(
                proof.opening_proof.query_openings[0][0].opening_proof
            ),
            # quotient is always the LAST batch ([trace, (stage2), quotient])
            quotient_opened_values_len=len(
                proof.opening_proof.query_openings[0][-1].opened_values[0]
            ),
            degree_bits=proof.degree_bits,
            stage2_width=len(proof.opened_values.stage2_local or []),
            ext_degree=len(proof.opened_values.trace_local[0]),
        )
    except (IndexError, TypeError) as e:
        raise InvalidProofShape(
            f"proof lacks the structure config derivation needs: {e}")
