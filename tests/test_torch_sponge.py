"""The port's sponge and Merkle primitives (plonky25_torch.ops.sponge)
against the JAX package's (plonky25_tpu.ops.sponge), bit for bit."""

import numpy as np
import pytest
import torch

from plonky25_torch.fields import gl as tgl
from plonky25_torch.ops import sponge as ts
from plonky25_tpu.constants import GOLDILOCKS_P as P
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.ops import sponge as js


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


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _ints(x):
    return np.asarray(x, dtype=object).tolist()


@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 9])
def test_hash_rows_matches_jax(width):
    rows = _vals((6, width), width)
    got = ts.hash_rows(tgl.from_u64(rows, "cpu"))
    want = js.hash_rows(jgl.from_u64(rows))
    assert _ints(tgl.to_u64(got)) == _ints(jgl.to_u64(want))


def test_compress_matches_jax():
    left, right = _vals((2, 3, 4), 1), _vals((2, 3, 4), 2)
    got = ts.compress(tgl.from_u64(left, "cpu"), tgl.from_u64(right, "cpu"))
    want = js.compress(jgl.from_u64(left), jgl.from_u64(right))
    assert got.shape == (2, 3, 4)
    assert _ints(tgl.to_u64(got)) == _ints(jgl.to_u64(want))


@pytest.mark.parametrize("masked", [False, True])
def test_merkle_path_matches_jax(masked):
    q, d = 7, 5
    leaf, sibs = _vals((q, 4), 3), _vals((q, d, 4), 4)
    index = np.random.default_rng(5).integers(0, 1 << d, size=q)
    valid = None
    if masked:  # per-lane depths, as the fold stage's padded paths
        valid = np.arange(d)[:, None] < (np.arange(q) % d + 1)[None, :]
    root, idx = ts.merkle_path(
        tgl.from_u64(leaf, "cpu"), torch.from_numpy(index.astype(np.int64)),
        tgl.from_u64(sibs, "cpu"),
        None if valid is None else torch.from_numpy(valid))
    jroot, jidx = js.merkle_path(
        jgl.from_u64(leaf), index.astype(np.uint32), jgl.from_u64(sibs),
        None if valid is None else np.asarray(valid))
    assert _ints(tgl.to_u64(root)) == _ints(jgl.to_u64(jroot))
    assert idx.tolist() == np.asarray(jidx).tolist()


def test_verify_batch_single_accepts_its_own_root_and_rejects_others():
    q, d, width = 5, 4, 3
    rows, sibs = _vals((q, width), 6), _vals((q, d, 4), 7)
    index = np.random.default_rng(8).integers(0, 1 << d, size=q)
    t_index = torch.from_numpy(index.astype(np.int64))
    root, _ = ts.merkle_path(ts.hash_rows(tgl.from_u64(rows, "cpu")),
                             t_index, tgl.from_u64(sibs, "cpu"))
    commit = root[0]
    ok = ts.verify_batch_single(commit, tgl.from_u64(rows, "cpu"), t_index,
                                tgl.from_u64(sibs, "cpu"))
    jok = js.verify_batch_single(
        jgl.from_u64(_ints(tgl.to_u64(commit))), jgl.from_u64(rows),
        index.astype(np.uint32), jgl.from_u64(sibs))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert ok[0] and not ok[1:].any()
