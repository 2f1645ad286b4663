"""MMCS sponge and Merkle primitives (reference: src/p3/commit.rs), batched
over leading lane axes; the counterpart of plonky25_tpu/ops/sponge.py.

Every permutation goes through `poseidon2_permute`, so on the card each
sponge chunk and each path level is one kernel launch over all lanes.
"""

from __future__ import annotations

import torch

from ..constants import DIGEST_ELEMS, RATE, WIDTH
from ..fields import gl
from ..fields.goldilocks import GL
from .poseidon2 import poseidon2_permute


def hash_rows(rows: GL) -> GL:
    """Overwrite-mode sponge over rows of static width (commit.rs:23-46).

    rows: GL (..., L) -> digest GL (..., 4).  Each chunk of RATE values
    overwrites the front of the state, then the state is permuted; the last
    chunk may be shorter and overwrites only its own lanes."""
    batch = rows.shape[:-1]
    width = rows.shape[-1]
    state = gl.zeros((*batch, WIDTH), rows.device)
    for off in range(0, width, RATE):
        k = min(RATE, width - off)
        state = gl.concatenate([rows[..., off:off + k], state[..., k:]], dim=-1)
        state = poseidon2_permute(state)
    return state[..., :DIGEST_ELEMS]


def compress(left: GL, right: GL) -> GL:
    """2-to-1: permute [left || right || 0^4], keep 4 (commit.rs:48-60).

    left/right: GL (..., 4)."""
    batch = left.shape[:-1]
    zeros = gl.zeros((*batch, WIDTH - 2 * DIGEST_ELEMS), left.device)
    state = gl.concatenate([left, right, zeros], dim=-1)
    return poseidon2_permute(state)[..., :DIGEST_ELEMS]


def merkle_path(leaf_digest: GL, index: torch.Tensor, siblings: GL,
                valid: torch.Tensor = None):
    """Walk a batch of Merkle paths (commit.rs:92-123, single-matrix case).

    leaf_digest: GL (N, 4); index: int64 (N,); siblings: GL (N, D, 4);
    valid: optional bool (D,) or (D, N) mask of padded depths (a masked step
    leaves the root and the index as they are).  Returns (root GL (N, 4),
    index after the walk (N,))."""
    root, idx = leaf_digest, index
    for d in range(siblings.shape[-2]):
        sib = siblings[..., d, :]
        is_odd = (idx & 1).bool()[..., None]
        new_root = compress(gl.select(is_odd, sib, root),
                            gl.select(is_odd, root, sib))
        if valid is None:
            root, idx = new_root, idx >> 1
        else:
            v = valid[d]
            root = gl.select(v[..., None], new_root, root)
            idx = torch.where(v, idx >> 1, idx)
    return root, idx


def verify_batch_single(commit: GL, leaf_rows: GL, index: torch.Tensor,
                        siblings: GL, valid: torch.Tensor = None):
    """verify_batch for openings whose matrices all have the tallest
    height (the Fibonacci proof family's case).

    commit: GL (4,) or (N, 4); leaf_rows: GL (N, L); index (N,);
    siblings (N, D, 4).  Returns ok: bool (N,)."""
    root, _ = merkle_path(hash_rows(leaf_rows), index, siblings, valid)
    return gl.eq(root, gl.broadcast_to(commit, root.shape)).all(dim=-1)
