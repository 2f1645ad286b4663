"""The port's multi-height MMCS verify_batch (plonky25_torch.ops.sponge)
against plonky25_tpu.ops.sponge.verify_batch and the int oracle
refimpl.commit.verify_batch (src/p3/commit.rs:62-129), bit for bit: the
cases of tests/test_mmcs_multi.py at heights 8, 8, 2, 1, where one group
folds in mid-path and one at the very last level (t == depth)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky25_torch.fields import gl
from plonky25_torch.ops.sponge import verify_batch, verify_batch_single
from plonky25_tpu.constants import GOLDILOCKS_P as P
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.ops.sponge import verify_batch as j_verify_batch
from plonky25_tpu.refimpl.commit import build_mmcs_tree, open_mmcs
from plonky25_tpu.refimpl.commit import verify_batch as int_verify_batch

HEIGHTS = [8, 8, 2, 1]
WIDTHS = [3, 2, 4, 5]
INDICES = list(range(8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(mats, levels, indices):
    """Opened rows grouped tallest first (equal heights merged in batch
    order), as numpy uint64 arrays, with the oracle's openings."""
    opened, proofs = zip(*(open_mmcs(mats, levels, ix) for ix in indices))
    by_height = {}
    for i in sorted(range(len(mats)), key=lambda i: -len(mats[i])):
        by_height.setdefault(len(mats[i]), []).append(i)
    rows = [np.asarray([[v for i in by_height[h] for v in o[i]] for o in opened],
                       dtype=np.uint64)
            for h in sorted(by_height, reverse=True)]
    logs = [h.bit_length() - 1 for h in sorted(by_height, reverse=True)]
    return rows, logs, np.asarray(proofs, dtype=np.uint64), opened, proofs


@pytest.fixture(scope="module")
def commitment():
    rng = random.Random(404)
    mats = [[[rng.randrange(P) for _ in range(w)] for _ in range(h)]
            for h, w in zip(HEIGHTS, WIDTHS)]
    root, levels = build_mmcs_tree(mats)
    return (root,) + _pack(mats, levels, INDICES)


def _port(root, rows, logs, sibs):
    return verify_batch(gl.from_u64(np.asarray(root, dtype=np.uint64), "cpu"),
                        [gl.from_u64(r, "cpu") for r in rows], logs,
                        torch.tensor(INDICES), gl.from_u64(sibs, "cpu")).tolist()


def _jax(root, rows, logs, sibs):
    return np.asarray(j_verify_batch(
        jgl.from_u64(root), [jgl.from_u64(r) for r in rows], logs,
        jnp.asarray(INDICES, jnp.uint32), jgl.from_u64(sibs))).tolist()


def _oracle(root, rows, sibs):
    """refimpl verify_batch on the grouped rows, split back per matrix."""
    dims = [(w, h) for h, w in zip(HEIGHTS, WIDTHS)]
    out = []
    for q, ix in enumerate(INDICES):
        flat = [int(v) for r in rows for v in r[q]]
        per_mat, off = [], 0
        for w in WIDTHS:
            per_mat.append(flat[off:off + w])
            off += w
        out.append(int_verify_batch(root, dims, ix, per_mat,
                                    sibs[q].tolist()))
    return out


def _tampered(commitment, kind):
    """(root, rows, sibs, the lane tampered or None for all lanes)."""
    root, rows, logs, sibs, _, _ = commitment
    rows = [r.copy() for r in rows]
    sibs = sibs.copy()
    lane = None
    if kind == "mid_path_row":          # the height-2 group, query 1
        rows[1][1, 0] = (int(rows[1][1, 0]) + 1) % P
        lane = 1
    elif kind == "sibling":             # query 2, level 1
        sibs[2, 1, 3] = (int(sibs[2, 1, 3]) + 1) % P
        lane = 2
    elif kind == "last_level_row":      # the height-1 group, query 0
        rows[2][0, 2] = (int(rows[2][0, 2]) + 1) % P
        lane = 0
    elif kind == "sibling_below_last_fold":
        sibs[5, 2, 0] = (int(sibs[5, 2, 0]) + 1) % P
        lane = 5
    elif kind == "commitment":
        root = [(root[0] + 1) % P] + list(root[1:])
    return root, rows, sibs, lane


def test_accepts_like_both_references(commitment):
    root, rows, logs, sibs, opened, proofs = commitment
    assert logs == [3, 1, 0]
    assert _port(root, rows, logs, sibs) == [True] * 8
    assert _jax(root, rows, logs, sibs) == [True] * 8
    assert _oracle(root, rows, sibs) == [True] * 8


@pytest.mark.parametrize("kind", ["mid_path_row", "sibling", "last_level_row",
                                  "sibling_below_last_fold", "commitment"])
def test_tamper_rejected_like_both_references(commitment, kind):
    root, rows, sibs, lane = _tampered(commitment, kind)
    logs = commitment[2]
    want = [lane is not None and q != lane for q in range(8)]
    assert _port(root, rows, logs, sibs) == want
    assert _jax(root, rows, logs, sibs) == want
    assert _oracle(root, rows, sibs) == want


def test_one_group_is_verify_batch_single():
    rng = random.Random(406)
    mats = [[[rng.randrange(P) for _ in range(3)] for _ in range(8)]]
    root, levels = build_mmcs_tree(mats)
    rows, logs, sibs, _, _ = _pack(mats, levels, INDICES)
    args = (gl.from_u64(np.asarray(root, dtype=np.uint64), "cpu"),
            gl.from_u64(rows[0], "cpu"))
    idx, s = torch.tensor(INDICES), gl.from_u64(sibs, "cpu")
    assert verify_batch(args[0], [args[1]], logs, idx, s).all()
    assert verify_batch_single(*args, idx, s).all()


@pytest.mark.parametrize("logs", [[2, 1, 0], [3, 1, 1], [3, 0, 1]])
def test_heights_are_checked(commitment, logs):
    """Group 0's height must be the path depth, and heights must fall."""
    root, rows, _, sibs, _, _ = commitment
    with pytest.raises(ValueError):
        _port(root, rows, logs, sibs)
