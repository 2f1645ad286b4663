"""Attestation of a multi-stage target proof in the port on the CPU:
tests/test_attest_multistage.py's 16-row RlcAir proof (seed 11,
FriConfig(1, 2, 1)) by the port's int oracle, byte-equal to the JAX
oracle's (its sha256 in tests/fixtures/attest_expected.json).  Its
schedule's sample layout and rows equal JAX's, the port attests it with
the JAX gammas and accumulators, the bundle checks, and a flipped
stage-2 challenge sample is refused.  The attestation STARK runs at
FriConfig(1, 2, 1) to keep the CPU proof small; each gamma derivation is
512 sequential plain permutations of 5 states (20-40 s).
"""

import copy
import hashlib
import json
import os
import random

import pytest
import torch

import plonky25_torch.attest as A
import plonky25_torch.attest_program as ap
from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.proof import FriConfig, derive_config, proof_to_json
from plonky25_torch.refimpl.prover import prove as ref_prove
from plonky25_torch.refimpl.verifier import verify as ref_verify
import plonky25_tpu.attest_program as jap
from plonky25_tpu.models.rlc_air import RlcAir as JRlcAir
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import derive_config as j_derive_config
from plonky25_tpu.proof import proof_from_json as j_proof_from_json

P = 0xFFFFFFFF00000001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC = FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=1)
ATT_FC = FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (the test run
    shares the CPU between several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "attest_expected.json")) as f:
        return json.load(f)["rlc"]


@pytest.fixture(scope="module")
def rlc_proof():
    rng = random.Random(11)
    trace = [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
             for _ in range(16)]
    return ref_prove(RlcAir(), trace, FC)


@pytest.fixture(scope="module")
def rlc_bundle(rlc_proof):
    return A.attest(rlc_proof, RlcAir(), FC, att_fri_config=ATT_FC,
                    device="cpu")


def test_proof_equals_the_jax_oracles(rlc_proof, expected):
    blob = json.dumps(proof_to_json(rlc_proof), separators=(",", ":"))
    assert hashlib.sha256(blob.encode()).hexdigest() == \
        expected["proof_sha256"]


def test_schedule_sample_layout(rlc_proof, expected):
    """The sample count includes the stage-2 challenges, the rows equal
    JAX's, the program executes, and every query has a third Merkle
    batch."""
    ch = A._RecordingChallenger()
    assert ref_verify(rlc_proof, RlcAir(), FC, challenger=ch).ok
    assert ch.samples == expected["samples"][0]
    config = derive_config(rlc_proof, FC)
    n_ch = RlcAir().num_challenges()
    assert len(ch.samples) == ap.expected_sample_count(config, n_ch)
    assert ap.n_presamples(config, n_ch) == ap.n_presamples(config) + 2
    rows = ap.build_verification_schedule(rlc_proof, config, RlcAir(),
                                          ch.samples)
    jproof = j_proof_from_json(proof_to_json(rlc_proof))
    jrows = jap.build_verification_schedule(
        jproof, j_derive_config(jproof, JFriConfig(1, 2, 1)), JRlcAir(),
        ch.samples)
    assert [vars(r) for r in rows] == [vars(r) for r in jrows]
    assert len(rows) == expected["n_rows"]
    ap.execute_program(rows)   # raises on any in-program assert failure
    assert sum(1 for r in rows if r.sel == "l") >= 1 + 3 * FC.num_queries


def test_attest_and_check_multistage(rlc_proof, rlc_bundle, expected):
    assert list(rlc_bundle.gamma) == expected["gamma"]
    assert list(rlc_bundle.acc) == expected["acc"]
    assert rlc_bundle.samples == expected["samples"][0]
    assert A.check_attestation(rlc_bundle, rlc_proof, RlcAir(), FC,
                               att_fri_config=ATT_FC, device="cpu")


def test_challenge_sample_tamper_rejected(rlc_proof, rlc_bundle):
    """A flipped stage-2 challenge sample changes the schedule, so its
    gammas no longer match the bundle's; a single-stage AIR is refused
    by the structural gate."""
    bad = copy.deepcopy(rlc_bundle)
    bad.samples[0] = (bad.samples[0] + 1) % P
    assert not A.check_attestation(bad, rlc_proof, RlcAir(), FC,
                                   att_fri_config=ATT_FC, device="cpu")
    assert not A.check_attestation(rlc_bundle, rlc_proof, FibonacciAir(), FC,
                                   att_fri_config=ATT_FC, device="cpu")
