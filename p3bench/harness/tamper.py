"""Tampered proofs for the verify cells: the four kinds of chip_smoke.py's
`tamper` (pow, merkle_sibling, fold_sibling, final_poly), applied to a
proof's JSON tree at a position drawn from the seed.

A tamper adds a nonzero delta mod p to one value, so the value stays
canonical and always changes.  The tree is copied only along the path to
that value: a Keccak proof's tree holds about a million nodes, and every
other subtree is shared with the original, which is never written."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

P = 0xFFFFFFFF00000001
KINDS = ("pow", "merkle_sibling", "fold_sibling", "final_poly")


def _set(tree, path, fn):
    """A copy of `tree` with fn applied at `path`, copied along the path."""
    if not path:
        return fn(tree)
    key = path[0]
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[key] = _set(tree[key], path[1:], fn)
    return out


def position(proof: Dict, kind: str, rng: np.random.Generator) -> List:
    """A path to one value of `kind` in the proof's tree, drawn by rng."""
    fri = ["opening_proof", "fri_proof"]
    if kind == "pow":
        return fri + ["pow_witness", "value"]
    if kind == "final_poly":
        return fri + ["final_poly", "value", int(rng.integers(2)), "value"]
    queries = proof["opening_proof"]["query_openings"]
    q = int(rng.integers(len(queries)))
    if kind == "merkle_sibling":
        depth = len(queries[q][0]["opening_proof"])
        return ["opening_proof", "query_openings", q, 0, "opening_proof",
                int(rng.integers(depth)), int(rng.integers(4)), "value"]
    if kind == "fold_sibling":
        steps = proof["opening_proof"]["fri_proof"]["query_proofs"][q][
            "commit_phase_openings"]
        return fri + ["query_proofs", q, "commit_phase_openings",
                      int(rng.integers(len(steps))), "sibling_value", "value",
                      int(rng.integers(2)), "value"]
    raise ValueError(f"unknown tamper kind {kind!r}")


def tamper(proof: Dict, kind: str, rng: np.random.Generator) -> Dict:
    """The proof's tree with one value of `kind` changed; rng draws the
    position and the delta."""
    path = position(proof, kind, rng)
    delta = int(rng.integers(1, P, dtype=np.uint64))
    return _set(proof, path, lambda v: (int(v) + delta) % P)
