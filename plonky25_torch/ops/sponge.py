"""MMCS sponge and Merkle primitives (reference: src/p3/commit.rs), batched
over leading lane axes; the counterpart of plonky25_tpu/ops/sponge.py.

The verifier's row-major functions (`hash_rows`, `compress`) go through
`poseidon2_permute`, so on the card each sponge chunk and each path level
is one kernel launch over all lanes.  The prover's lane-major counterparts
(`hash_rows_planes`, `compress_planes`) take columns and digest planes with
the lane axis second to last and go through `poseidon2_permute_soa`: one
launch per sponge chunk or tree level, whatever the leading axes.
"""

from __future__ import annotations

import torch

from ..constants import DIGEST_ELEMS, RATE, WIDTH
from ..fields import gl
from ..fields.goldilocks import GL
from .poseidon2 import poseidon2_permute, poseidon2_permute_soa


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


def verify_batch(commit: GL, group_rows, group_log_heights, index: torch.Tensor,
                 siblings: GL):
    """General multi-height MMCS verify_batch (commit.rs:62-129), batched
    over a lane axis; the counterpart of plonky25_tpu.ops.sponge.verify_batch.

    The path climbs from the tallest matrices' leaves; when the climbing
    node reaches a shorter group's padded height, that group's leaf digest
    folds in with one extra compression (commit.rs:105-123).  Which level
    folds which group depends only on the heights, so the walk is a static
    schedule: `merkle_path` over the sibling levels between fold-ins, one
    `compress` at each fold-in.

    commit: GL (4,) or (N, 4).
    group_rows: per height group, tallest first, the group's matrices'
        opened rows side by side, GL (N, L_g); matrices of equal padded
        height are one group, in batch order (commit.rs:72-76, 114-117).
    group_log_heights: the groups' padded log-heights, strictly
        decreasing; group 0's equals the path depth.
    index: int64 (N,); siblings: GL (N, D, 4).  Returns ok: bool (N,)."""
    D = siblings.shape[-2]
    lh0 = group_log_heights[0]
    if lh0 != D:
        raise ValueError(f"path depth {D} != tallest log height {lh0}")
    if (list(group_log_heights) != sorted(group_log_heights, reverse=True)
            or len(set(group_log_heights)) != len(group_log_heights)):
        raise ValueError("group heights must be strictly decreasing (merge "
                         "matrices of equal padded height into one group)")
    digests = [hash_rows(r) for r in group_rows]
    # group g folds in after compression number lh0 - lh_g (commit.rs:107-117)
    fold_at = {lh0 - lh: gi
               for gi, lh in enumerate(group_log_heights[1:], start=1)}
    root, idx, t0 = digests[0], index, 0
    for t in sorted(set(fold_at) | {D}):
        if t > t0:
            root, idx = merkle_path(root, idx, siblings[..., t0:t, :])
        if t in fold_at:
            root = compress(root, digests[fold_at[t]])
        t0 = t
    return gl.eq(root, gl.broadcast_to(commit, root.shape)).all(dim=-1)


def _lanes_first(x: GL) -> GL:
    """View planes (..., k, n) as (k, ..., n)."""
    return GL(x.lo.movedim(-2, 0), x.hi.movedim(-2, 0))


def _lanes_back(x: GL) -> GL:
    """View planes (k, ..., n) as (..., k, n)."""
    return GL(x.lo.movedim(0, -2), x.hi.movedim(0, -2))


def hash_rows_planes(cols: GL) -> GL:
    """`hash_rows` on columns: cols (..., W, N) -> digest planes (..., 4, N),
    the digest of row i in [..., :, i].  Each sponge state is built
    lane-leading, (12, ..., N), by one concatenation: the layout the kernel
    takes, with the leading axes folded into its N."""
    rows = _lanes_first(cols)                                  # (W, ..., N)
    state = None
    for off in range(0, rows.shape[0], RATE):
        k = min(RATE, rows.shape[0] - off)
        tail = (gl.zeros((WIDTH - k, *rows.shape[1:]), cols.device)
                if state is None else state[k:])
        state = poseidon2_permute_soa(
            gl.concatenate([rows[off:off + k], tail]))
    return _lanes_back(state[:DIGEST_ELEMS])


def compress_planes(left: GL, right: GL) -> GL:
    """`compress` on digest planes: left/right (..., 4, n) -> (..., 4, n).
    The state is built lane-leading by one concatenation into a fresh
    tensor, so strided views (a tree level's even and odd nodes) are fine
    as inputs."""
    zeros = gl.zeros((WIDTH - 2 * DIGEST_ELEMS, *left.shape[:-2],
                      left.shape[-1]), left.device)
    state = gl.concatenate([_lanes_first(left), _lanes_first(right), zeros])
    return _lanes_back(poseidon2_permute_soa(state)[:DIGEST_ELEMS])
