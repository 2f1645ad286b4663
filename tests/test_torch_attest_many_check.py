"""check_attestations of artifacts/attestation_small.json's `multi`
bundle (fib(8) + fib(16), made by the JAX package) on the CPU through the
port's verifier: the JAX package's verdicts
(tests/test_attest.py::test_attest_many_aggregates) on the artifact and
its tampers.  The 468-row schedule's gamma derivation is 768 sequential
plain permutations of 5 states on the CPU (30-60 s); each check that gets
past the structural gate runs one."""

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


def test_check_attestations_accepts_the_artifact(small):
    multi = A.bundle_from_json(small["multi"])
    assert A.check_attestations(multi, small["p"], FibonacciAir(),
                                small["fc_t"], att_fri_config=small["att_t"],
                                device="cpu")


def test_check_attestations_refuses_the_tampers(small):
    """The wrong order, a missing proof and the weak config fail before
    the gammas; one proof's flipped sample fails at them."""
    multi = A.bundle_from_json(small["multi"])
    p1, p2 = small["p"]

    def chk(b, ps):
        return A.check_attestations(b, ps, FibonacciAir(), small["fc_t"],
                                    att_fri_config=small["att_t"],
                                    device="cpu")

    assert not chk(multi, [p2, p1])
    assert not chk(multi, [p1])
    weak = copy.deepcopy(multi)
    weak.att_fri_config = FriConfig(1, 0, 0)
    assert not chk(weak, [p1, p2])
    flipped = copy.deepcopy(multi)
    flipped.samples[1][0] = (flipped.samples[1][0] + 1) % P
    assert not chk(flipped, [p1, p2])
