"""check_attestation of artifacts/attestation_small.json's single bundle
on the CPU, through the port's verifier and the int oracle: the JAX
package's verdicts (tests/test_attest.py) on the artifact, on a flipped
sample and on a changed opening of the attestation STARK; and the cached
verifier taking each bundle's publics.  Each check that gets past the
structural gate re-derives the gammas: 256 sequential plain permutations
of 5 states on the CPU, 10-20 s.
"""

import json
import os

import pytest
import torch

import plonky25_torch.attest as A
from plonky25_torch.models import FibonacciAir
from plonky25_torch.models.verifier_air import VerifierAir
from plonky25_torch.proof import FriConfig, proof_from_json
from plonky25_torch.verifier import verify_proof

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


@pytest.mark.parametrize("use_device_verifier", [True, False],
                         ids=["port_verifier", "int_oracle"])
def test_check_accepts_the_small_bundle(small, use_device_verifier):
    """JAX's verdict (tests/test_attest.py): True.  One gamma derivation."""
    bundle = A.bundle_from_json(small["bundle"])
    assert A.check_attestation(bundle, small["p"][0], FibonacciAir(),
                               small["fc_t"], use_device_verifier,
                               att_fri_config=small["att_t"], device="cpu")


def test_check_refuses_a_flipped_sample(small):
    """The sample tamper passes the structural gate and the statement
    (which pins the proof, not the samples): the rebuilt schedule's gammas
    differ.  One gamma derivation."""
    bad = A.bundle_from_json(small["bundle"])
    bad.samples[0] = (bad.samples[0] + 1) % P
    assert not A.check_attestation(bad, small["p"][0], FibonacciAir(),
                                   small["fc_t"], att_fri_config=small["att_t"],
                                   device="cpu")


def test_cached_verifier_takes_each_bundles_publics(small):
    """The verifier cache keys on the AIR class and the proof's shape, and
    a hit takes the caller's AIR: after the accepted check above built the
    cached verifier with this bundle's publics, the same STARK checked
    against another bundle's publics and then its own gives False, True."""
    bundle = A.bundle_from_json(small["bundle"])
    att = small["att_t"]
    own = VerifierAir({"gamma": bundle.gamma, "acc": bundle.acc})
    other = VerifierAir({"gamma": bundle.gamma,
                         "acc": ((bundle.acc[0] + 1) % P, bundle.acc[1])})
    verdicts = [bool(verify_proof(bundle.stark, air, att, "cpu").ok)
                for air in (other, own)]
    assert verdicts == [False, True]


def test_check_refuses_a_changed_stark_opening(small):
    """A changed opened value of the attestation STARK: the schedule and
    gammas still match, the STARK verification fails.  One gamma
    derivation."""
    bad = A.bundle_from_json(small["bundle"])
    ov = bad.stark.opened_values
    ov.trace_local[0] = ((ov.trace_local[0][0] + 1) % P, ov.trace_local[0][1])
    assert not A.check_attestation(bad, small["p"][0], FibonacciAir(),
                                   small["fc_t"], att_fri_config=small["att_t"],
                                   device="cpu")
