"""Composed (depth-2) attestation in the port, on the CPU, against the JAX
package: the composed bundle's JSON, composed_statement_digest and
_target_shape_of, and the outer schedules (the verification of the inner
STARK, plus the compression rows that re-derive the inner binding) of
the small composition (artifacts/attestation_small.json's fib(8) proof and
`bundle`), of attest_attestation of that bundle, and of the golden
composition (the fib(64) fixture proof and artifacts/
attestation_fibonacci.json): row counts, slot and pair-stream digests,
and the accumulator under the JAX package's gammas.

No test derives an outer gamma (about 45k and 450k sequential plain
permutations of 5 states on the CPU): the JAX values, gammas included,
are in tests/fixtures/composed_expected.json
(scripts/make_torch_fixtures.py composed), and the derivation is held on
the card (chip_smoke.py [compose-small], [compose-golden]).  The golden
outer schedule is built from the fixture's outer samples; the small one
records its samples with the port's int oracle.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import plonky25_torch.attest as A
import plonky25_torch.attest_program as ap
import plonky25_tpu.attest as JA
import plonky25_tpu.proof as JP
from plonky25_torch.models import FibonacciAir
from plonky25_torch.proof import (FriConfig, derive_config, load_proof,
                                  proof_from_json, proof_to_json)

P = 0xFFFFFFFF00000001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (the test run
    shares the CPU between several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schedule_digests(rows):
    """sha256 of the canonical slots, each row as its slot count then its
    (slot, value) pairs, and of the pair stream, both as little-endian u64
    (make_torch_fixtures.schedule_digests over the JAX rows)."""
    slots = []
    for r in rows:
        sl = ap.canonical_slots(r)
        slots.append(len(sl))
        for s, v in sl:
            slots += (s, v)
    pairs = [x for s, v in ap.sequence_pairs(rows) for x in (s, v)]

    def sha(xs):
        return hashlib.sha256(np.asarray(xs, dtype="<u8").tobytes()).hexdigest()

    return {"slots_sha256": sha(slots), "pairs_sha256": sha(pairs)}


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXTURES, "composed_expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small():
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        d = json.load(f)
    fc, att = FriConfig(**d["fc"]), FriConfig(**d["att_fc"])
    proof = proof_from_json(d["proofs"][0])
    return {"fc": fc, "att": att, "proof": proof,
            "inner": A.bundle_from_json(d["bundle"]),
            "cfg": derive_config(proof, fc)}


@pytest.fixture(scope="module")
def golden():
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    fc = FriConfig(1, 100, 16)
    return {"fc": fc, "proof": proof, "cfg": derive_config(proof, fc),
            "inner": A.load_bundle(os.path.join(
                ROOT, "artifacts", "attestation_fibonacci.json"))}


def outer_rows(case, samples, compose=True):
    """The prover's outer schedule: the inner STARK's verification at
    `samples`, plus the compression rows of the target's schedule."""
    inner = case["inner"]
    rows = ap.build_verification_schedule(
        inner.stark, derive_config(inner.stark, inner.att_fri_config),
        A._verifier_air_of(inner), samples)
    if not compose:
        return rows
    target = ap.build_verification_schedule(
        case["proof"], case["cfg"], FibonacciAir(), inner.samples)
    return rows + ap.build_compression_rows(
        len(target), ap.sequence_pairs(target), ap.pair_exponents(target),
        inner.gamma, inner.acc)


@pytest.fixture(scope="module")
def small_samples(small):
    """The port's int oracle's recording of the inner STARK's verification
    (attest_composed's record step, use_device_prover=False)."""
    inner = small["inner"]
    return A._record_verification(inner.stark, A._verifier_air_of(inner),
                                  inner.att_fri_config, False)


@pytest.fixture(scope="module")
def small_rows(small, small_samples):
    return outer_rows(small, small_samples)


@pytest.fixture(scope="module")
def golden_rows(golden, expected):
    return outer_rows(golden, expected["golden"]["outer_samples"])


def composed_of(case, values):
    """A ComposedAttestation with the JAX values' outer binding (its outer
    STARK a stand-in: the inner one)."""
    inner = case["inner"]
    outer = A.AttestationBundle(
        stark=inner.stark, samples=list(values["outer_samples"]),
        gamma=tuple(values["gamma"]), acc=tuple(values["acc"]),
        att_fri_config=FriConfig(**values["att_fri_config"]),
        n_rows=values["n_rows"])
    c = A.ComposedAttestation(
        outer=outer, inner_stark=inner.stark,
        inner_gamma=tuple(inner.gamma), inner_acc=tuple(inner.acc),
        inner_samples=list(inner.samples), inner_n_rows=inner.n_rows,
        target_shape=A._target_shape_of(case["cfg"]))
    c.statement = A.composed_statement_digest(c)
    return c


def test_small_outer_samples_equal_jax(small_samples, expected):
    assert small_samples == expected["small"]["outer_samples"]


def test_small_outer_schedule_equals_jax(small, small_rows, expected):
    """39,463 rows: the verification of the 2^8 inner STARK and 1,292
    compression rows over the fib(8) schedule's 1,220 pairs."""
    want = expected["small"]
    assert len(small_rows) == want["n_rows"] == 39_463
    assert small["inner"].n_rows == want["inner_n_rows"]
    assert sum(r.sel == "w" for r in small_rows) == 1_280
    assert len(ap.sequence_pairs(small_rows)) == want["n_pairs"]
    digests = schedule_digests(small_rows)
    assert digests == {k: want[k] for k in digests}


def test_attest_attestation_schedule_equals_jax(small, small_samples,
                                                expected):
    """attest_attestation of the small bundle attests the verification of
    its STARK alone: 38,171 rows, no compression."""
    rows = outer_rows(small, small_samples, compose=False)
    want = expected["attest_attestation"]
    assert small_samples == want["outer_samples"]
    assert len(rows) == want["n_rows"] == 38_171
    digests = schedule_digests(rows)
    assert digests == {k: want[k] for k in digests}
    assert (list(ap.fold_accumulator(rows, tuple(want["gamma"])))
            == want["acc"])


def test_golden_outer_schedule_equals_jax(golden, golden_rows, expected):
    """403,335 rows (327,803 of the 2^14 inner STARK's verification and
    75,532 compression rows), the outer STARK 2^19 x 620, built from the
    JAX recording's samples."""
    want = expected["golden"]
    assert len(golden_rows) == want["n_rows"] == 403_335
    assert want["n_verification_rows"] == 327_803
    assert want["n_compression_rows"] == 75_532
    assert (max(len(golden_rows) - 1, 3).bit_length()) == 19
    digests = schedule_digests(golden_rows)
    assert digests == {k: want[k] for k in digests}


@pytest.mark.parametrize("case", ["small", "golden"])
def test_accumulator_under_jax_gammas(case, small_rows, golden_rows,
                                      expected):
    """fold_accumulator of the port's outer schedule under the JAX
    package's outer gammas gives its accumulator."""
    rows = small_rows if case == "small" else golden_rows
    want = expected[case]
    assert list(ap.fold_accumulator(rows, tuple(want["gamma"]))) == want["acc"]


@pytest.mark.parametrize("case", ["small", "golden"])
def test_statement_and_target_shape_equal_jax(case, small, golden,
                                              expected):
    """composed_statement_digest and _target_shape_of: equal to the JAX
    fixture's and to the JAX functions on the same composed bundle."""
    case_ = small if case == "small" else golden
    c = composed_of(case_, expected[case])
    assert c.target_shape == expected[case]["target_shape"]
    assert c.statement == expected[case]["statement"]
    jc = JA.composed_from_json(json.loads(json.dumps(A.composed_to_json(c))))
    assert JA.composed_statement_digest(jc) == c.statement
    j_cfg = JP.derive_config(JP.proof_from_json(proof_to_json(case_["proof"])),
                             JP.FriConfig(**vars(case_["fc"])))
    assert JA._target_shape_of(j_cfg) == c.target_shape


def test_attest_attestation_statement_equals_jax(small, expected):
    """attest_attestation's statement: statement_digest of the outer
    bundle over the inner STARK's bytes."""
    want = expected["attest_attestation"]
    bundle = A.AttestationBundle(
        stark=small["inner"].stark, samples=want["outer_samples"],
        gamma=tuple(want["gamma"]), acc=tuple(want["acc"]),
        att_fri_config=FriConfig(**want["att_fri_config"]),
        n_rows=want["n_rows"])
    assert A.statement_digest(bundle, small["inner"].stark) == want["statement"]


def test_composed_json_roundtrip(small, expected):
    """composed_to_json / composed_from_json: the JAX package's text, both
    ways, and the statement kept; other protocols and kinds refused."""
    c = composed_of(small, expected["small"])
    text = json.dumps(A.composed_to_json(c))
    again = A.composed_from_json(json.loads(text))
    assert json.dumps(A.composed_to_json(again)) == text
    assert A.composed_statement_digest(again) == c.statement
    assert again.outer.samples == c.outer.samples
    jc = JA.composed_from_json(json.loads(text))
    assert json.dumps(JA.composed_to_json(jc)) == text
    for key, value in (("protocol", 2), ("kind", "bundle")):
        bad = dict(json.loads(text), **{key: value})
        with pytest.raises(ValueError, match="protocol-3 composed"):
            A.composed_from_json(bad)


def test_checker_outer_schedule_equals_prover_outer_schedule(
        small, small_samples, small_rows):
    """The checker's outer schedule (the zero-proof template's compression
    rows beside the inner STARK's verification) is canonically the
    prover's: the same slots and control bits, so both derive the same
    gammas (held here by the pair stream; no gamma is derived)."""
    cfg, inner = small["cfg"], small["inner"]
    template = ap.build_verification_schedule(
        ap.make_zero_proof(cfg), cfg, FibonacciAir(), inner.samples)
    checker_rows = outer_rows(small, small_samples, compose=False) + \
        ap.build_compression_rows(
            len(template), ap.sequence_pairs(template),
            ap.pair_exponents(template), inner.gamma, inner.acc)
    assert len(checker_rows) == len(small_rows)
    assert ([ap.canonical_slots(r) for r in checker_rows]
            == [ap.canonical_slots(r) for r in small_rows])
    # the private pairs differ (the template's values are zero); the
    # canonical stream does not carry them
    w = [i for i, r in enumerate(small_rows) if r.sel == "w"]
    assert any(small_rows[i].priv != checker_rows[i].priv for i in w)


def test_composed_tampers_change_the_outer_stream(small, small_samples,
                                                  small_rows):
    """What makes [compose-small]'s inner gamma and inner acc tampers fail
    at the gammas: each changes the checker's compression rows' canonical
    values, so its outer pair stream is not the bundle's."""
    cfg, inner = small["cfg"], small["inner"]
    template = ap.build_verification_schedule(
        ap.make_zero_proof(cfg), cfg, FibonacciAir(), inner.samples)
    base = outer_rows(small, small_samples, compose=False)
    want = ap.sequence_pairs(small_rows)
    for gamma, acc in (((inner.gamma[0] + 1) % P, inner.gamma[1]),
                       inner.acc), (inner.gamma,
                                    ((inner.acc[0] + 1) % P, inner.acc[1])):
        rows = base + ap.build_compression_rows(
            len(template), ap.sequence_pairs(template),
            ap.pair_exponents(template), gamma, acc)
        assert len(rows) == len(small_rows)
        assert ap.sequence_pairs(rows) != want
