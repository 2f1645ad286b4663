"""The composed checkers' refusals on the CPU: check_composed refuses
every tamper that JAX's order of checks catches before the outer gammas
without deriving them (attest_program.derive_gammas patched to raise),
and check_attested_attestation's inner-binding arm refuses an inner
bundle whose accumulator is off by one (one derivation of the fib(8)
schedule's gammas: 256 sequential plain permutations of 5 states).
check_composed binds the values of the bundle's inner samples only
through their count, the proof-of-work gate, the schedule's structure
(the query indices) and the optional target proof, in the port as in the
JAX package (ROADMAP.md Queue C).

The composed bundle is the small composition of
tests/fixtures/composed_expected.json (the JAX package's outer samples,
gammas and accumulator; its outer STARK a stand-in that no refusal here
reaches).
"""

import copy
import json
import os

import pytest
import torch

import plonky25_torch.attest as A
import plonky25_torch.attest_program as ap
import plonky25_tpu.attest_program as jap
import plonky25_tpu.proof as JP
from plonky25_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky25_torch.models import FibonacciAir
from plonky25_torch.proof import (FriConfig, derive_config, proof_from_json,
                                  proof_to_json)

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


class ReachedGammas(Exception):
    pass


class ReachedStark(Exception):
    pass


@pytest.fixture(scope="module")
def small():
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        d = json.load(f)
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "composed_expected.json")) as f:
        want = json.load(f)["small"]
    fc, att = FriConfig(**d["fc"]), FriConfig(**d["att_fc"])
    proof = proof_from_json(d["proofs"][0])
    inner = A.bundle_from_json(d["bundle"])
    outer = A.AttestationBundle(
        stark=inner.stark, samples=list(want["outer_samples"]),
        gamma=tuple(want["gamma"]), acc=tuple(want["acc"]), att_fri_config=att,
        n_rows=want["n_rows"])
    c = A.ComposedAttestation(
        outer=outer, inner_stark=inner.stark,
        inner_gamma=tuple(inner.gamma), inner_acc=tuple(inner.acc),
        inner_samples=list(inner.samples), inner_n_rows=inner.n_rows,
        target_shape=A._target_shape_of(derive_config(proof, fc)))
    c.statement = A.composed_statement_digest(c)
    assert c.statement == want["statement"]
    return {"fc": fc, "att": att, "proof": proof, "inner": inner,
            "composed": c, "cfg": derive_config(proof, fc)}


@pytest.fixture
def no_gammas(monkeypatch):
    def refuse(*args, **kwargs):
        raise ReachedGammas
    monkeypatch.setattr(ap, "derive_gammas", refuse)


def mutate(c, restate=True, **fields):
    out = copy.deepcopy(c)
    for k, v in fields.items():
        setattr(out, k, v)
    if restate:
        out.statement = A.composed_statement_digest(out)
    return out


def tampered(small, kind):
    c = small["composed"]
    if kind == "stale_statement":
        return mutate(c, restate=False, inner_gamma=(
            (c.inner_gamma[0] + 1) % P, c.inner_gamma[1]))
    if kind == "statement_stripped":
        return mutate(c, restate=False, statement=None)
    if kind == "trace_width_99":
        return mutate(c, target_shape=dict(c.target_shape, trace_width=99))
    if kind == "inner_rows_plus_1":
        return mutate(c, inner_n_rows=c.inner_n_rows + 1)
    if kind == "pow_gate":
        samples = list(c.inner_samples)
        samples[ap.n_presamples(small["cfg"], 0) - 1] |= 1
        return mutate(c, inner_samples=samples)
    if kind == "sample_count":
        return mutate(c, inner_samples=c.inner_samples[:-1])
    if kind == "attestation_config":
        out = copy.deepcopy(c)
        out.outer.att_fri_config = FriConfig(1, 0, 1)
        return out
    raise ValueError(kind)


def check(small, c, **kw):
    return A.check_composed(c, FibonacciAir(), small["fc"],
                            att_fri_config=small["att"], device="cpu", **kw)


def test_untampered_composed_reaches_the_gammas(small, no_gammas):
    """The control: the fixture's composed bundle passes every check before
    the outer gammas."""
    with pytest.raises(ReachedGammas):
        check(small, small["composed"])


@pytest.mark.parametrize("kind", [
    "stale_statement", "statement_stripped", "trace_width_99",
    "inner_rows_plus_1", "pow_gate", "sample_count", "attestation_config"])
def test_check_composed_refuses_before_the_gammas(small, no_gammas, kind):
    assert check(small, tampered(small, kind)) is False


def test_attested_attestation_refuses_an_inner_acc_plus_1(small,
                                                          monkeypatch):
    """The inner-binding arm: the fib(8) schedule's gammas are re-derived
    and its accumulator folded; the untampered inner bundle gets past them
    to the outer STARK's check, the +1 accumulator does not."""
    def reached(*args, **kwargs):
        raise ReachedStark
    monkeypatch.setattr(A, "check_attestation", reached)

    def check_attested(inner):
        return A.check_attested_attestation(
            small["inner"], inner, small["proof"], FibonacciAir(),
            small["fc"], att_fri_config=small["att"], device="cpu",
            inner_att_fri_config=small["att"])

    with pytest.raises(ReachedStark):
        check_attested(small["inner"])
    bad = copy.deepcopy(small["inner"])
    bad.acc = ((bad.acc[0] + 1) % P, bad.acc[1])
    assert check_attested(bad) is False


def test_attested_attestation_pins_the_inner_config(small, no_gammas):
    """Without inner_att_fri_config the inner bundle's config is held to
    the library default, as the JAX package holds it: the small bundle's
    FriConfig(1, 2, 1) is refused before any gamma."""
    assert A.check_attested_attestation(
        small["inner"], small["inner"], small["proof"], FibonacciAir(),
        small["fc"], att_fri_config=small["att"], device="cpu") is False


def checker_compression_slots(small, samples, attp=ap, cfg=None, air=None):
    """The canonical slots of the compression rows check_composed builds
    from the zero-proof template at `samples` (with the JAX package's
    attest_program, config and AIR, the JAX checker's)."""
    c = small["composed"]
    cfg, air = cfg or small["cfg"], air or FibonacciAir()
    template = attp.build_verification_schedule(
        attp.make_zero_proof(cfg), cfg, air, samples)
    rows = attp.build_compression_rows(
        len(template), attp.sequence_pairs(template),
        attp.pair_exponents(template), c.inner_gamma, c.inner_acc)
    return [attp.canonical_slots(r) for r in rows]


def test_inner_sample_values_are_bound_by_structure_and_target_only(
        small, monkeypatch):
    """A changed inner sample that does not steer the schedule (index 2,
    tests/test_composed.py's tamper) leaves the checker's outer pair
    stream as it was, in the port and in the JAX package, so the outer
    gammas and the outer STARK accept it: that test's refusal comes from
    its stand-in outer STARK.  A changed query-index sample (the last)
    changes the stream; the target arm refuses both."""
    c = small["composed"]
    base = checker_compression_slots(small, c.inner_samples)
    j_cfg = JP.derive_config(JP.proof_from_json(
        proof_to_json(small["proof"])), JP.FriConfig(**vars(small["fc"])))
    for i, steers in ((2, False), (len(c.inner_samples) - 1, True)):
        samples = list(c.inner_samples)
        samples[i] = (samples[i] + 1) % P
        assert (checker_compression_slots(small, samples) != base) is steers
        assert (checker_compression_slots(small, samples, jap, j_cfg,
                                          JFibonacciAir()) != base) is steers
    # the target arm, past a stand-in outer check: one derivation each
    monkeypatch.setattr(A, "_check_one_schedule", lambda *a, **k: True)
    samples = list(c.inner_samples)
    samples[2] = (samples[2] + 1) % P
    assert check(small, c, target_proof=small["proof"]) is True
    assert check(small, mutate(c, inner_samples=samples),
                 target_proof=small["proof"]) is False
