"""attest_many and check_attestations in the port on the CPU, against
artifacts/attestation_small.json's `multi` bundle (fib(8) + fib(16), made
by the JAX package): the bundle byte for byte, the batched sample
recorder against the single one, and the JAX package's verdict
(tests/test_attest.py::test_attest_many_aggregates) on the artifact
through the int oracle; test_torch_attest_many_check.py holds the port's
verifier and the tampers.  The 468-row schedule's gamma derivation is 768
sequential plain permutations of 5 states on the CPU (30-60 s);
attest_many and the check run one each.
"""

import copy
import json
import os

import pytest
import torch

import plonky25_torch.attest as A
from plonky25_torch.models import FibonacciAir
from plonky25_torch.proof import FriConfig, proof_from_json

P = 0xFFFFFFFF00000001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (the test run
    shares the CPU between several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        d = json.load(f)
    d["fc_t"] = FriConfig(**d["fc"])
    d["att_t"] = FriConfig(**d["att_fc"])
    d["p"] = [proof_from_json(p) for p in d["proofs"]]
    return d


def test_attest_many_reproduces_the_multi_bundle(small):
    multi = A.attest_many(small["p"], FibonacciAir(), small["fc_t"],
                          att_fri_config=small["att_t"], device="cpu")
    assert json.dumps(A.bundle_to_json(multi)) == json.dumps(small["multi"])


def test_batched_recorder_matches_the_single_one(small):
    """Same-shape proofs go through one BatchVerifier pass with_samples;
    its samples equal the single verification's, and a failing proof in
    the batch raises CannotAttest naming it."""
    p1 = small["p"][0]
    fc = small["fc_t"]
    batched = A._record_verifications_device([p1, p1], FibonacciAir(), fc,
                                             "cpu")
    ok, single = A._device_instrumented_verify(p1, FibonacciAir(), fc, "cpu")
    assert ok and batched == [single, single]
    assert single == small["multi"]["samples"][0]
    bad = copy.deepcopy(p1)
    bad.opening_proof.fri_proof.pow_witness += 1
    with pytest.raises(A.CannotAttest, match="proof 1"):
        A._record_verifications_device([p1, bad], FibonacciAir(), fc, "cpu")
    with pytest.raises(A.CannotAttest):
        A.attest_many([p1, bad], FibonacciAir(), fc,
                      att_fri_config=small["att_t"], device="cpu")


def test_check_attestations_accepts_the_artifact_int_oracle(small):
    """JAX's verdict: True.  One gamma derivation; the STARK through the
    int oracle (the port's verifier: test_torch_attest_many_check.py)."""
    multi = A.bundle_from_json(small["multi"])
    assert A.check_attestations(multi, small["p"], FibonacciAir(),
                                small["fc_t"], use_device_verifier=False,
                                att_fri_config=small["att_t"], device="cpu")
