"""KeccakAir proved with every memory strategy of the port's prover at
once, on the CPU: the one-keccak-f trace of tests/test_keccak.py:137-155
(32 rows x 2,633 columns, seed 21, FriConfig(1, 20, 8)) with the quotient
in S=4 strided segments (above its two quotient chunks), G=2 column groups
of the segments' transforms, the LDE commit in 3 column chunks and both
column slabs at 256 columns, byte-equal to the int oracle's proof in
tests/fixtures/proof_keccak32_refimpl.json (tolerance 0).

Its own file so that the test run's workers, which take whole files,
prove it beside tests/test_torch_keccak.py: one 2,633-column proof costs
about a minute on the CPU (659 sponge chunks of the plain Poseidon2 per
leaf hash).
"""

import importlib
import json
import os
import random

import pytest
import torch

from plonky25_torch.models import KeccakAir, keccak_trace_np
from plonky25_torch.proof import FriConfig, proof_to_json
from plonky25_torch.prover import TorchProver

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FC = FriConfig(log_blowup=1, num_queries=20, proof_of_work_bits=8)
prove_mod = importlib.import_module("plonky25_torch.prover.prove")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run shares the CPU between worker
    processes (see tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chunked():
    """The proof, and the column counts each strategy split the work
    into (recorded on the way)."""
    rng = random.Random(21)
    inp = [rng.getrandbits(64) for _ in range(25)]
    p = TorchProver(KeccakAir(), 5, FC, "cpu", quotient_eval_chunks=4,
                    quotient_col_groups=2)
    p.commit_col_chunks = 3
    p._ro_col_slab = p._bary_col_slab = 256
    seen = {"lde": [], "eval": [], "groups": []}
    real_lde, real_fold = p._commit_trace_fn, p._fold
    p._commit_trace_fn = lambda c: (seen["lde"].append(c.shape[1]),
                                    real_lde(c))[1]
    p._fold = lambda main, shape, *a: (seen["eval"].append(shape),
                                       real_fold(main, shape, *a))[1]
    real_by = prove_mod._by_columns
    try:
        prove_mod._by_columns = lambda x, fn, n, step: (
            seen["groups"].append((x.shape[1], step)),
            real_by(x, fn, n, step))[1]
        proof = p.prove(keccak_trace_np([inp]))
    finally:
        prove_mod._by_columns = real_by
    return proof, seen


def test_keccak_with_every_strategy_is_the_oracle_proof(chunked):
    proof, _ = chunked
    with open(os.path.join(FIXTURES, "proof_keccak32_refimpl.json")) as f:
        want = f.read()
    assert json.dumps(proof_to_json(proof), separators=(",", ":")) == want


def test_every_strategy_engaged(chunked):
    _, seen = chunked
    assert seen["lde"] == [878, 878, 877]             # 2,633 in 3 chunks
    assert seen["eval"] == [(1, 16)] * 4               # 64 points, S = 4
    # the commit's chunks, then the coefficients and 2 folds per segment
    # in groups: 2,633 is prime, so G = 2 leaves 1,317 + 1,316 columns
    assert seen["groups"] == [(2633, 878)] + [(2633, 1317)] * 9
