"""Recursive attestation in the port (attest.py, attest_program.py,
models/verifier_air.py, models/poseidon2_air.py) and the int oracle it
verifies and proves through (refimpl/): the port against the JAX package,
bit for bit (tolerance 0, exact arithmetic), on the CPU.

  * the int Poseidon2, DuplexChallenger, MMCS, NTT, verifier (its recorded
    samples and every VerifyTrace field, on the fib(64) fixture and on
    four tampers) and prover against plonky25_tpu.refimpl;
  * poseidon2_core_rows against the JAX builder and the permutation;
  * for artifacts/attestation_small.json's fib(8) proof: the schedule row
    by row, sequence_pairs, fold_accumulator and execute_program against
    the JAX functions; derive_gammas and build_trace_rowmajor against the
    JAX values of tests/fixtures/attest_expected.json (the JAX versions
    compile XLA modules; scripts/make_torch_fixtures.py writes them);
  * VerifierAir's constraints on that trace, whole and tampered;
  * attest(device="cpu") byte-equal to the artifact's bundle, and
    check_attestation's verdicts, through the port's verifier and the int
    oracle, on the artifact and tests/test_attest.py's tamper battery;
  * the golden bundle's samples, schedule, accumulator and statement;
  * CannotAttest, the D=3 refusal, and the bundle JSON.

A CPU gamma derivation of the small schedule is 256 sequential plain
permutations (about 20 s); the tests that run one say so.
"""

import copy
import dataclasses
import hashlib
import json
import os
import random

import numpy as np
import pytest
import torch

import plonky25_torch.attest as A
import plonky25_torch.attest_program as ap
from plonky25_torch.air import Main, VerifierConstraintFolder
from plonky25_torch.fields import gl, gl2
from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.models.poseidon2_air import OUT_OFF, poseidon2_core_rows
from plonky25_torch.models.verifier_air import (ACC_OFF, PACK1_COL, R_OFF,
                                                UA_OFF, VerifierAir)
from plonky25_torch.ops.poseidon2 import poseidon2_permute
from plonky25_torch.proof import (FriConfig, derive_config, load_proof,
                                  proof_from_json, proof_to_json)
from plonky25_torch.refimpl import commit, ntt
from plonky25_torch.refimpl.challenger import DuplexChallenger
from plonky25_torch.refimpl.poseidon2 import poseidon2
from plonky25_torch.refimpl.prover import prove as ref_prove
from plonky25_torch.refimpl.verifier import verify as ref_verify
from plonky25_torch.verifier import _publics, verify_proof
import plonky25_tpu.attest as JA
import plonky25_tpu.attest_program as jap
from plonky25_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import derive_config as j_derive_config
from plonky25_tpu.proof import load_proof as j_load_proof
from plonky25_tpu.proof import proof_from_json as j_proof_from_json
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.refimpl import commit as jcommit
from plonky25_tpu.refimpl import ntt as jntt
from plonky25_tpu.refimpl.challenger import DuplexChallenger as JChallenger
from plonky25_tpu.refimpl.poseidon2 import poseidon2 as j_poseidon2
from plonky25_tpu.refimpl.prover import prove as j_ref_prove
from plonky25_tpu.refimpl.verifier import verify as j_ref_verify

P = 0xFFFFFFFF00000001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
GOLDEN_FC = FriConfig(1, 100, 16)
VERDICT_FIELDS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok",
                  "shape_ok")


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
    """artifacts/attestation_small.json: the configs, both proofs (port
    and JAX objects) and the JSON of both bundles."""
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        d = json.load(f)
    d["fc_t"] = FriConfig(**d["fc"])
    d["att_t"] = FriConfig(**d["att_fc"])
    d["fc_j"] = JFriConfig(**d["fc"])
    d["p"] = [proof_from_json(p) for p in d["proofs"]]
    d["jp"] = [j_proof_from_json(p) for p in d["proofs"]]
    return d


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXTURES, "attest_expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fib64():
    path = os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")
    return load_proof(path), j_load_proof(path)


@pytest.fixture(scope="module")
def schedules(small):
    """The fib(8) schedule of both packages from the oracle's samples."""
    ch = A._RecordingChallenger()
    assert ref_verify(small["p"][0], FibonacciAir(), small["fc_t"],
                      challenger=ch).ok
    rows = ap.build_verification_schedule(
        small["p"][0], derive_config(small["p"][0], small["fc_t"]),
        FibonacciAir(), ch.samples)
    jrows = jap.build_verification_schedule(
        small["jp"][0], j_derive_config(small["jp"][0], small["fc_j"]),
        JFibonacciAir(), ch.samples)
    return ch.samples, rows, jrows


@pytest.fixture(scope="module")
def small_trace(schedules, small):
    """The port's trace of the fib(8) schedule, at the artifact's gammas."""
    _, rows, _ = schedules
    gamma = tuple(small["bundle"]["gamma"])
    return ap.build_trace_rowmajor(rows, gamma, device="cpu")


@pytest.fixture(scope="module")
def small_bundle(small):
    """attest(device="cpu") of the fib(8) proof (one gamma derivation and
    one 2^8 x 620 proof on the CPU)."""
    return A.attest(small["p"][0], FibonacciAir(), small["fc_t"],
                    att_fri_config=small["att_t"], device="cpu")


def _sha(a) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.uint64).tobytes()).hexdigest()


def _compact(obj) -> str:
    return json.dumps(obj, separators=(",", ":"))


# ------------------------------------------------------------ the int oracle

def test_int_poseidon2_matches_jax():
    rng = random.Random(3)
    for _ in range(20):
        s = [rng.randrange(P) for _ in range(12)]
        assert poseidon2(s) == j_poseidon2(s)


def test_int_challenger_matches_jax():
    rng = random.Random(4)
    ours, theirs = DuplexChallenger(), JChallenger()
    out = []
    for step in range(60):
        if rng.random() < 0.5:
            v = rng.randrange(P)
            ours.observe(v)
            theirs.observe(v)
        else:
            out.append((ours.sample_ext(), theirs.sample_ext()))
            out.append((ours.sample_bits(9), theirs.sample_bits(9)))
    assert all(a == b for a, b in out) and len(out) > 20
    assert ours.check_witness(1, 5) == theirs.check_witness(1, 5)


def test_int_mmcs_and_ntt_match_jax():
    rng = random.Random(5)
    mats = [[[rng.randrange(P) for _ in range(w)] for _ in range(h)]
            for w, h in ((3, 16), (5, 16), (2, 4), (1, 1))]
    root, levels = commit.build_mmcs_tree(mats)
    jroot, jlevels = jcommit.build_mmcs_tree(mats)
    assert root == jroot and levels == jlevels
    dims = [(len(m[0]), len(m)) for m in mats]
    for index in (0, 5, 15):
        opened, path = commit.open_mmcs(mats, levels, index)
        assert (opened, path) == jcommit.open_mmcs(mats, jlevels, index)
        assert commit.verify_batch(root, dims, index, opened, path)
        bad = copy.deepcopy(path)
        bad[1][0] = (bad[1][0] + 1) % P
        assert not commit.verify_batch(root, dims, index, opened, bad)
        assert not jcommit.verify_batch(root, dims, index, opened, bad)
    vec = [rng.randrange(P) for _ in range(32)]
    assert ntt.coset_intt(vec, 7) == jntt.coset_intt(vec, 7)
    assert ntt.coset_ntt(vec, 7) == jntt.coset_ntt(vec, 7)


def _trace_fields(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)}


def test_int_verify_records_the_jax_samples(fib64):
    """verify(..., challenger=) of the fib(64) fixture: every VerifyTrace
    field and the recorded sample list equal the JAX oracle's."""
    proof, jproof = fib64
    ch, jch = A._RecordingChallenger(), JA._RecordingChallenger()
    tr = ref_verify(proof, FibonacciAir(), GOLDEN_FC, challenger=ch)
    jtr = j_ref_verify(jproof, JFibonacciAir(), JFriConfig(1, 100, 16),
                       challenger=jch)
    assert tr.ok and _trace_fields(tr) == _trace_fields(jtr)
    assert ch.samples == jch.samples and len(ch.samples) == 119


def _tamper(proof, kind):
    fp = proof.opening_proof.fri_proof
    if kind == "pow":
        fp.pow_witness += 1
    elif kind == "merkle_sibling":
        sib = proof.opening_proof.query_openings[0][0].opening_proof[0]
        sib[0] = (sib[0] + 1) % P
    elif kind == "fold_sibling":
        st = fp.query_proofs[0].commit_phase_openings[0]
        st.sibling_value = ((st.sibling_value[0] + 1) % P,
                            st.sibling_value[1])
    else:
        fp.final_poly = ((fp.final_poly[0] + 1) % P, fp.final_poly[1])
    return proof


@pytest.mark.parametrize(
    "kind", ["pow", "merkle_sibling", "fold_sibling", "final_poly"])
def test_int_verify_tamper_flags_match_jax(fib64, kind):
    proof, jproof = fib64
    tr = ref_verify(_tamper(copy.deepcopy(proof), kind), FibonacciAir(),
                    GOLDEN_FC)
    jtr = j_ref_verify(_tamper(copy.deepcopy(jproof), kind),
                       JFibonacciAir(), JFriConfig(1, 100, 16))
    flags = [getattr(tr, k) for k in VERDICT_FIELDS]
    assert flags == [getattr(jtr, k) for k in VERDICT_FIELDS]
    assert not tr.ok


def test_int_prover_matches_jax():
    fc = FriConfig(1, 2, 1)
    p = ref_prove(FibonacciAir(), fibonacci_trace(8), fc)
    jp = j_ref_prove(JFibonacciAir(), fibonacci_trace(8), JFriConfig(1, 2, 1))
    assert _compact(proof_to_json(p)) == _compact(j_proof_to_json(jp))
    p3 = ref_prove(FibonacciAir(), fibonacci_trace(8), fc, ext_degree=3)
    jp3 = j_ref_prove(JFibonacciAir(), fibonacci_trace(8),
                      JFriConfig(1, 2, 1), ext_degree=3)
    assert _compact(proof_to_json(p3)) == _compact(j_proof_to_json(jp3))


# ------------------------------------------------------ the Poseidon2 AIR

def test_core_rows_match_jax_and_the_permutation(expected):
    rng = np.random.default_rng(expected["core_rows"]["seed"])
    states = rng.integers(0, P, size=(16, 12), dtype=np.uint64)
    core = poseidon2_core_rows(gl.from_u64(states, "cpu"))
    assert core.shape == (16, 490)
    assert _sha(gl.to_u64_np(core)) == expected["core_rows"]["sha256"]
    out = core[:, OUT_OFF:OUT_OFF + 12]
    perm = poseidon2_permute(gl.from_u64(states, "cpu"))
    assert gl.eq(out, perm).all()
    assert [int(v) for v in gl.to_u64_np(out)[3]] == \
        poseidon2([int(v) for v in states[3]])


# ------------------------------------------------------- the schedule

def test_schedule_matches_jax_row_by_row(schedules, small, expected):
    samples, rows, jrows = schedules
    assert samples == expected["small"]["samples"][0]
    assert len(rows) == len(jrows) == expected["small"]["n_rows"] == 213
    assert [vars(r) for r in rows] == [vars(r) for r in jrows]
    assert ap.sequence_pairs(rows) == jap.sequence_pairs(jrows)
    assert ap.pair_exponents(rows) == jap.pair_exponents(jrows)
    gamma = tuple(small["bundle"]["gamma"])
    acc = ap.fold_accumulator(rows, gamma)
    assert acc == jap.fold_accumulator(jrows, gamma)
    assert list(acc) == expected["small"]["acc"] == small["bundle"]["acc"]
    assert ap.execute_program(rows) == jap.execute_program(jrows)


def test_derive_gammas_matches_jax(schedules, expected, small):
    """One CPU gamma derivation (256 steps of 5 chains)."""
    _, rows, _ = schedules
    gamma = ap.derive_gammas(rows, "cpu")
    assert list(gamma) == expected["small"]["gamma"] == small["bundle"]["gamma"]


def test_trace_matches_jax(schedules, small, small_trace, expected):
    _, rows, _ = schedules
    assert small_trace.shape == (256, 620)
    assert _sha(small_trace) == expected["small"]["trace_sha256"]
    cols = ap.build_trace_cols(rows, tuple(small["bundle"]["gamma"]),
                               device="cpu")
    assert cols.shape == (620, 256)
    assert np.array_equal(gl.to_u64_np(cols).T, small_trace)


def _violations(air, trace: np.ndarray):
    """Rows where any constraint of `air` is nonzero, every row at once:
    the port's vector Ops over the whole trace (local row i, next row
    i + 1 cyclically), selectors as on the trace domain."""
    h = trace.shape[0]

    def ext(a):
        return gl2.from_base(gl.from_u64(np.ascontiguousarray(a.T), "cpu"))

    def sel(vals):
        return gl2.from_base(gl.from_u64(np.asarray(vals, np.uint64), "cpu"))

    folder = VerifierConstraintFolder(
        ops=gl2.Ops((h,), "cpu"),
        main=Main(ext(trace), ext(np.roll(trace, -1, axis=0))),
        is_first_row=sel([1] + [0] * (h - 1)),
        is_last_row=sel([0] * (h - 1) + [1]),
        is_transition=sel([1] * (h - 1) + [0]),
        alpha=gl2.zeros((), "cpu"),
        publics=_publics(air, "cpu"))
    air.eval(folder)
    bad = torch.zeros(h, dtype=torch.bool)
    for c in folder._constraints:
        nz = ((c.c0.lo != 0) | (c.c0.hi != 0) | (c.c1.lo != 0)
              | (c.c1.hi != 0))
        nz = nz.reshape(-1, h).any(0) if nz.dim() > 1 else nz.expand(h)
        bad |= nz
    return set(torch.nonzero(bad).reshape(-1).tolist())


def test_verifier_air_constraints_vanish_and_bind(schedules, small,
                                                  small_trace):
    """VerifierAir's constraints hold on every row of the trace, and
    flipping a bound value breaks one where tests/test_attest.py expects:
    a hashed lane, the final accumulator, a written register, an FMA
    operand, a pack column, a register not carried across a hash row."""
    _, rows, _ = schedules
    air = VerifierAir({"gamma": tuple(small["bundle"]["gamma"]),
                       "acc": tuple(small["bundle"]["acc"])})
    assert _violations(air, small_trace) == set()
    a_row = next(i for i, r in enumerate(rows) if r.sel == "a")
    h = small_trace.shape[0]
    for r, c in ((3, 2), (h - 1, ACC_OFF), (a_row, R_OFF + 2 * rows[a_row].dst),
                 (a_row, UA_OFF), (a_row, PACK1_COL), (2, R_OFF)):
        t = small_trace.copy()
        t[r, c] = (int(t[r, c]) + 1) % P
        bad = _violations(air, t)
        # the row itself, or the transitions into and out of it
        assert bad and bad <= {r - 1, r, r + 1}, (r, c, bad)


# --------------------------------------------------- attest and check

def test_attest_reproduces_the_small_bundle(small, small_bundle):
    assert _compact(A.bundle_to_json(small_bundle)) == \
        _compact(small["bundle"])


def _battery(small):
    """tests/test_attest.py's tampers, each False in the JAX package,
    that the checker refuses before recomputing the gammas."""
    good = A.bundle_from_json(small["bundle"])
    p1, p2 = small["p"]
    out = {}
    weak = copy.deepcopy(good)
    weak.att_fri_config = FriConfig(1, 0, 0)
    out["weak_att_config"] = (weak, p1)
    forged = copy.deepcopy(good)
    forged.att_fri_config = FriConfig(1, 3, 1)
    out["forged_att_config"] = (forged, p1)
    extra = copy.deepcopy(good)
    extra.samples.append(12345)
    out["extra_sample"] = (extra, p1)
    acc = copy.deepcopy(good)
    acc.acc = (acc.acc[0] ^ 1, acc.acc[1])
    out["acc"] = (acc, p1)
    out["other_proof"] = (good, p2)
    wrong = copy.deepcopy(good)
    wrong.statement = A.statement_digest(wrong, p2)
    out["wrong_statement"] = (wrong, p1)
    stripped = copy.deepcopy(good)
    stripped.statement = None
    out["stripped_statement"] = (stripped, p1)
    pow_bit = copy.deepcopy(good)
    pow_bit.samples[ap.n_presamples(derive_config(p1, small["fc_t"])) - 1] |= 1
    out["pow_bit"] = (pow_bit, p1)
    mangled = copy.deepcopy(p1)
    mangled.opening_proof.fri_proof.query_proofs = []
    out["mangled_proof"] = (good, mangled)
    return out


@pytest.mark.parametrize("kind", [
    "weak_att_config", "forged_att_config", "extra_sample", "acc",
    "other_proof", "wrong_statement", "stripped_statement", "pow_bit",
    "mangled_proof", "wrong_air"])
def test_check_refuses_the_tamper_battery(small, kind):
    if kind == "wrong_air":
        bundle, proof, air = (A.bundle_from_json(small["bundle"]),
                              small["p"][0], RlcAir())
    else:
        (bundle, proof), air = _battery(small)[kind], FibonacciAir()
    for use_dev in (True, False):
        assert not A.check_attestation(bundle, proof, air, small["fc_t"],
                                       use_dev, att_fri_config=small["att_t"],
                                       device="cpu")


def test_cannot_attest_a_failed_or_d3_proof(small):
    bad = copy.deepcopy(small["p"][0])
    bad.opening_proof.fri_proof.pow_witness += 1
    for use_dev in (True, False):
        with pytest.raises(A.CannotAttest):
            A.attest(bad, FibonacciAir(), small["fc_t"],
                     att_fri_config=small["att_t"],
                     use_device_prover=use_dev, device="cpu")
    d3 = ref_prove(FibonacciAir(), fibonacci_trace(8), small["fc_t"],
                   ext_degree=3)
    with pytest.raises(A.CannotAttest, match="GF\\(p\\^2\\)"):
        A.attest(d3, FibonacciAir(), small["fc_t"], device="cpu")
    bundle = A.bundle_from_json(small["bundle"])
    assert not A.check_attestation(bundle, d3, FibonacciAir(), small["fc_t"],
                                   att_fri_config=small["att_t"],
                                   device="cpu")


def test_bundle_json_round_trips(small, tmp_path):
    for key in ("bundle", "multi"):
        b = A.bundle_from_json(small[key])
        assert isinstance(b, A.MultiAttestationBundle) == (key == "multi")
        assert _compact(A.bundle_to_json(b)) == _compact(small[key])
        path = str(tmp_path / f"{key}.json")
        A.save_bundle(b, path)
        assert _compact(A.bundle_to_json(A.load_bundle(path))) == \
            _compact(small[key])
    with pytest.raises(ValueError, match="protocol"):
        A.bundle_from_json(dict(small["bundle"], protocol=2))


def test_golden_bundle_binds_the_fixture_proof(fib64):
    """artifacts/attestation_fibonacci.json against the fib(64) fixture,
    without its 2^14 STARK: the port's verifier on the CPU records the
    bundle's 119 samples, the schedule equals JAX's row by row, and the
    accumulator and statement equal the bundle's.  The gamma derivation
    and the STARK run on the card (chip_smoke.py [check-golden])."""
    proof, jproof = fib64
    bundle = A.load_bundle(os.path.join(ROOT, "artifacts",
                                        "attestation_fibonacci.json"))
    ok, samples = A._device_instrumented_verify(proof, FibonacciAir(),
                                                GOLDEN_FC, "cpu")
    assert ok and samples == bundle.samples
    rows = ap.build_verification_schedule(
        proof, derive_config(proof, GOLDEN_FC), FibonacciAir(), samples)
    jrows = jap.build_verification_schedule(
        jproof, j_derive_config(jproof, JFriConfig(1, 100, 16)),
        JFibonacciAir(), samples)
    assert len(rows) == bundle.n_rows == 13477
    assert [vars(r) for r in rows] == [vars(r) for r in jrows]
    assert len(ap.sequence_pairs(rows)) == 75408
    assert ap.fold_accumulator(rows, bundle.gamma) == bundle.acc
    assert A.statement_digest(bundle, proof) == bundle.statement
    assert bundle.stark.degree_bits == 14
