"""Witness packing: proof (host ints) -> padded, shape-static tensors.

The counterpart of plonky25_tpu/witness.py and of the reference's
`Proof::add_virtual_to` / `set_witness` (serde/proof.rs:357-383): the proof's
canonical u64 values become GL/GL2 limb tensors whose shapes depend only on
the shape-derived config.  Ragged FRI fold paths (depth n_phases - l,
serde/proof.rs:204-211) are zero-padded to the largest depth; the verifier
masks the padding with `fold_valid_mask`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .constants import DIGEST_ELEMS
from .device import resolve_device
from .fields import gl, gl2
from .fields.extension import GL2
from .proof import P3Config, Proof


def _gl2_list(pairs, device) -> GL2:
    """List of (c0, c1) -> GL2 with a leading axis."""
    return gl2.from_u64_pair([p[0] for p in pairs], [p[1] for p in pairs],
                             device)


def pack_witness(proof: Proof, config: P3Config, device="cuda") -> Dict:
    """The proof's values as a dict of GL/GL2 tensors on `device`, with the
    keys and shapes of plonky25_tpu.witness.pack_witness."""
    device = resolve_device(device)
    fp = proof.opening_proof.fri_proof
    Q = config.fri_config.num_queries
    n_phases = config.log_trace_height

    # observations in transcript order (verifier.rs:135-139, 363-376):
    # trace commit, quotient commit, per-phase commits, pow witness
    obs: List[int] = []
    obs += proof.commitments.trace.value
    if proof.commitments.stage2 is not None:
        obs += proof.commitments.stage2.value
    obs += proof.commitments.quotient_chunks.value
    for c in fp.commit_phase_commits:
        obs += c.value
    obs.append(fp.pow_witness)

    # batch openings: values (Q, n_rows, row_len), siblings (Q, D, 4)
    n_batches = len(proof.opening_proof.query_openings[0])
    batch_values, batch_sibs = [], []
    for b in range(n_batches):
        openings = [proof.opening_proof.query_openings[q][b] for q in range(Q)]
        batch_values.append(gl.from_u64(
            np.asarray([o.opened_values for o in openings], dtype=object),
            device))
        batch_sibs.append(gl.from_u64(
            np.asarray([o.opening_proof for o in openings], dtype=object),
            device))

    # fold phase: sibling values (L, Q) ext, padded paths (L, Q, L, 4)
    steps = [[fp.query_proofs[q].commit_phase_openings[l] for q in range(Q)]
             for l in range(n_phases)]
    fold_sibs = np.zeros((n_phases, Q, n_phases, DIGEST_ELEMS), dtype=object)
    for l in range(n_phases):
        for q in range(Q):
            path = steps[l][q].opening_proof
            if len(path) != n_phases - l:
                raise ValueError(f"fold level {l} path depth {len(path)}")
            if path:
                fold_sibs[l, q, :len(path)] = np.asarray(path, dtype=object)

    ov = proof.opened_values
    out = {
        "obs": gl.from_u64(obs, device),
        "trace_local": _gl2_list(ov.trace_local, device),
        "trace_next": _gl2_list(ov.trace_next, device),
        "quotient_chunks": gl2.from_u64_pair(
            [[c[0] for c in ch] for ch in ov.quotient_chunks],
            [[c[1] for c in ch] for ch in ov.quotient_chunks], device),
        "batch_values": batch_values,   # list of GL (Q, n_rows, row_len)
        "batch_sibs": batch_sibs,       # list of GL (Q, path_len, 4)
        "fold_sibling_values": gl2.from_u64_pair(
            [[s.sibling_value[0] for s in row] for row in steps],
            [[s.sibling_value[1] for s in row] for row in steps],
            device),                    # (L, Q)
        "fold_sibs": gl.from_u64(fold_sibs, device),  # (L, Q, L, 4)
        "final_poly": gl2.from_u64_pair(fp.final_poly[0], fp.final_poly[1],
                                        device),
    }
    if ov.stage2_local is not None:
        out["stage2_local"] = _gl2_list(ov.stage2_local, device)
        out["stage2_next"] = _gl2_list(ov.stage2_next, device)
    return out


def fold_valid_mask(config: P3Config) -> np.ndarray:
    """Static (L, L) mask of the real steps of the padded fold paths."""
    L = config.log_trace_height
    return np.arange(L)[None, :] < (L - np.arange(L))[:, None]
