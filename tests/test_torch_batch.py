"""The port's BatchVerifier (plonky25_torch.parallel.batch) against the JAX
package's, at B=3 with one tampered lane, on the fixture proof."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import plonky25_torch.proof as tproof
import plonky25_tpu.proof as jproof
from plonky25_torch.fields import gl as tgl
from plonky25_torch.models import FibonacciAir as TFib
from plonky25_torch.parallel.batch import BatchVerifier as TBatch
from plonky25_torch.parallel.batch import (stack_witnesses, tile_witness,
                                          verify_proof_batch)
from plonky25_torch.witness import pack_witness as t_pack
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.models.fibonacci import FibonacciAir as JFib
from plonky25_tpu.parallel.batch import BatchVerifier as JBatch
from plonky25_tpu.parallel.batch import stack_witnesses as j_stack
from plonky25_tpu.witness import pack_witness as j_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC = dict(log_blowup=1, num_queries=100, proof_of_work_bits=16)


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


def _tampered(proof):
    p = copy.deepcopy(proof)
    s = p.opening_proof.fri_proof.query_proofs[5].commit_phase_openings[1]
    s.sibling_value = (s.sibling_value[0] ^ 1, s.sibling_value[1])
    return p


@pytest.fixture(scope="module")
def proofs():
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "proof_fibonacci_refimpl.json")) as f:
        obj = json.load(f)
    t, j = tproof.proof_from_json(obj), jproof.proof_from_json(obj)
    return {"t": [t, _tampered(t), t], "j": [j, _tampered(j), j]}


@pytest.fixture(scope="module")
def port_batch(proofs):
    cfg = tproof.derive_config(proofs["t"][0], tproof.FriConfig(**FC))
    return TBatch(TFib(), cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def jax_batch(proofs):
    """The JAX BatchVerifier's (ok, samples) on the three lanes."""
    j_cfg = jproof.derive_config(proofs["j"][0], jproof.FriConfig(**FC))
    ok, samples = JBatch(JFib(), j_cfg).verify_witnesses(
        j_stack([j_pack(p, j_cfg) for p in proofs["j"]]), with_samples=True)
    return np.asarray(ok).tolist(), jgl.to_u64(samples).tolist()


def test_batch_verdicts_match_jax(proofs, port_batch, jax_batch):
    bv, _ = port_batch
    got = bv.verify(proofs["t"])
    want = jax_batch[0]
    assert got.tolist() == want == [True, False, True]


def test_with_samples_matches_jax(proofs, port_batch, jax_batch):
    """with_samples: (ok, samples), samples the (B, n) array of every
    Fiat-Shamir sample in JAX's order."""
    bv, cfg = port_batch
    ws = stack_witnesses([t_pack(p, cfg, "cpu") for p in proofs["t"]])
    ok, samples = bv.verify_witnesses(ws, with_samples=True)
    assert ok.tolist() == jax_batch[0]
    assert tgl.to_u64(samples).tolist() == jax_batch[1]
    assert samples.shape[0] == 3 and len(jax_batch[1]) == 3
    assert torch.equal(bv.verify_witnesses(ws), ok)


def test_verify_proof_batch(proofs):
    from plonky25_torch import parallel

    got = parallel.verify_proof_batch(proofs["t"], TFib(),
                                      tproof.FriConfig(**FC), device="cpu")
    assert got.tolist() == [True, False, True]
    assert parallel.verify_proof_batch is verify_proof_batch


def test_batch_fields_match_single_proof_runs(proofs, port_batch):
    """Each lane of a batch run equals the same proof verified alone."""
    bv, cfg = port_batch
    ws = [t_pack(p, cfg, "cpu") for p in proofs["t"]]
    r = bv.base.verify_witnesses(stack_witnesses(ws))
    for b, w in enumerate(ws):
        one = bv.base.verify_witness(w)
        for k in ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok"):
            assert bool(r[k][b]) == bool(getattr(one, k)), (b, k)
        assert torch.equal(r["index"][b], one.query_indices)
        assert torch.equal(r["alpha"].c0.lo[b], one.alpha.c0.lo)


def test_tile_witness_repeats_one_proof(proofs, port_batch):
    bv, cfg = port_batch
    w = t_pack(proofs["t"][0], cfg, "cpu")
    tiled = tile_witness(w, 2)
    assert tiled["fold_sibs"].shape == (2,) + w["fold_sibs"].shape
    assert torch.equal(tiled["obs"].lo[1], w["obs"].lo)
    assert bv.verify_witnesses(tiled).tolist() == [True, True]
