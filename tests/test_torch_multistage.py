"""Multi-stage AIRs in the port, RlcAir: the port against the JAX package
and its int oracle, bit for bit (tolerance 0, exact arithmetic), on the
CPU, at the shape of tests/test_multistage.py (16 rows, FriConfig(1, 8, 4)):

  * RlcAir.build_stage2_device (an affine prefix scan) against the JAX
    builder (a lax.scan) and the host build_stage2;
  * prove(device="cpu") and BatchProver byte-equal to refimpl.prover.prove;
  * verify_proof's VerifyResult against plonky25_tpu.verifier.verify_proof,
    on the proof and on the tamper battery of tests/test_multistage.py;
  * BatchVerifier on mixed lanes against the JAX BatchVerifier's verdicts
    (computed once by scripts/make_torch_fixtures.py);
  * the multi-stage consistency check.
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch

import plonky25_torch.proof as tproof
from plonky25_torch.fields import gl, gl2
from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.parallel.batch import BatchVerifier
from plonky25_torch.prover import BatchProver, TorchProver, prove
from plonky25_torch.verifier import TorchVerifier, verify_proof
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields.extension import GL2 as JGL2
from plonky25_tpu.models.rlc_air import RlcAir as JRlcAir
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import proof_from_json as j_proof_from_json
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.refimpl.prover import prove as ref_prove
from plonky25_tpu.refimpl.verifier import verify as ref_verify
from plonky25_tpu.verifier import verify_proof as j_verify_proof

P = 0xFFFFFFFF00000001
FC = (1, 8, 4)
FLAGS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok", "shape_ok")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it many times
    over, which slows a CPU proof by well over an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(seed, height=16):
    rng = random.Random(seed)
    return [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
            for _ in range(height)]


def _compact(obj):
    return json.dumps(obj, separators=(",", ":"))


@pytest.fixture(scope="module")
def rlc():
    """The trace of tests/test_multistage.py and the oracle's proof."""
    trace = _trace(7)
    oracle = ref_prove(JRlcAir(), trace, JFriConfig(*FC))
    return trace, oracle, j_proof_to_json(oracle)


def _fields(r):
    """A VerifyResult of either package as plain Python values."""
    def ints(x):
        return np.asarray(x).astype(np.uint64).tolist()

    out = {k: bool(np.asarray(getattr(r, k))) for k in FLAGS}
    if r.shape_ok:
        for k in ("alpha", "zeta"):
            v = getattr(r, k)
            out[k] = (int(gl.to_u64(v.c0)) if isinstance(v.c0, gl.GL)
                      else int(jgl.to_u64_np(v.c0)),
                      int(gl.to_u64(v.c1)) if isinstance(v.c1, gl.GL)
                      else int(jgl.to_u64_np(v.c1)))
        out["query_indices"] = ints(r.query_indices)
    return out


def _both(proof_json):
    """The port's and the JAX package's VerifyResult fields."""
    t = verify_proof(tproof.proof_from_json(proof_json), RlcAir(),
                     tproof.FriConfig(*FC), device="cpu")
    j = j_verify_proof(j_proof_from_json(proof_json), JRlcAir(),
                       JFriConfig(*FC))
    return _fields(t), _fields(j)


# ------------------------------------------------------------ stage 2


@pytest.mark.parametrize("height", [1, 2, 16, 64])
def test_build_stage2_device_matches_jax_and_host(height):
    trace = _trace(height, height)
    gamma = (random.Random(-height).randrange(P),
             random.Random(height).randrange(P))
    host = RlcAir().build_stage2(trace, [gamma])
    assert host == JRlcAir().build_stage2(trace, [gamma])
    cols = np.asarray(trace, dtype=np.uint64).T.copy()
    got = RlcAir().build_stage2_device(
        gl.from_u64(cols, "cpu"), [gl2.from_u64_pair(*gamma, "cpu")])
    assert gl.to_u64(got).tolist() == host
    want = JRlcAir().build_stage2_device(
        jgl.from_u64(cols), [JGL2(jgl.from_u64([gamma[0]])[0],
                                  jgl.from_u64([gamma[1]])[0])])
    assert jgl.to_u64_np(want).tolist() == host


def test_stage2_builders_run_lanes_of_a_batch_apart():
    """A leading proof axis: each lane equals its own build, and the host
    builder (for AIRs without a device one) gives the same columns."""
    traces = [_trace(s) for s in (1, 2, 3)]
    cols = gl.from_u64(np.asarray(traces, dtype=np.uint64).transpose(0, 2, 1)
                       .copy(), "cpu")
    rng = random.Random(5)
    gammas = [(rng.randrange(P), rng.randrange(P)) for _ in traces]
    ch = [gl2.from_u64_pair([g[0] for g in gammas], [g[1] for g in gammas],
                            "cpu")]
    got = gl.to_u64(RlcAir().build_stage2_device(cols, ch)).tolist()
    assert got == [RlcAir().build_stage2(t, [g])
                   for t, g in zip(traces, gammas)]

    class HostRlc(RlcAir):
        build_stage2_device = None

    tp = TorchProver(HostRlc(), 4, tproof.FriConfig(*FC), device="cpu")
    s2, zero = tp._stage2_cols(cols, ch)
    assert gl.to_u64(s2).tolist() == got and zero is None


# ------------------------------------------------------------ proofs


def test_prove_is_byte_equal_to_refimpl(rlc):
    trace, _, want = rlc
    got = prove(RlcAir(), trace, tproof.FriConfig(*FC), device="cpu")
    assert _compact(tproof.proof_to_json(got)) == _compact(want)


def test_batch_prover_equals_single_proofs(rlc):
    """B=3 in lockstep: each lane byte-equal to the oracle's single proof
    of its trace (the port's single proof is, by the test above)."""
    traces = [rlc[0], _trace(23), _trace(24)]
    got = BatchProver(RlcAir(), 4, tproof.FriConfig(*FC),
                      device="cpu").prove(traces)
    for trace, proof in zip(traces, got):
        want = ref_prove(JRlcAir(), trace, JFriConfig(*FC))
        assert _compact(tproof.proof_to_json(proof)) == \
            _compact(j_proof_to_json(want))


# ------------------------------------------------------------ verifier


def test_verify_result_matches_jax(rlc):
    ours, theirs = _both(rlc[2])
    assert ours == theirs
    assert ours["ok"] and len(ours["query_indices"]) == FC[1]


def _tamper(rlc, kind):
    trace, proof, _ = rlc
    bad = copy.deepcopy(proof)
    if kind == "stage2_opened":
        c0, c1 = bad.opened_values.stage2_local[0]
        bad.opened_values.stage2_local[0] = ((c0 + 1) % P, c1)
    elif kind == "stage2_commitment":
        bad.commitments.stage2.value = list(bad.commitments.stage2.value)
        bad.commitments.stage2.value[0] ^= 1
    elif kind == "stage2_leaf":
        row = bad.opening_proof.query_openings[0][1].opened_values[0]
        row[0] = (row[0] + 1) % P
    elif kind == "stage2_missing":
        bad.commitments.stage2 = None
    elif kind == "wrong_gamma":
        # stage-2 openings of a proof whose gamma differs (another trace)
        other = ref_prove(JRlcAir(), [[(a + 1) % 97, b] for a, b in trace],
                          JFriConfig(*FC))
        bad.opened_values.stage2_local = other.opened_values.stage2_local
        bad.opened_values.stage2_next = other.opened_values.stage2_next
    return bad


@pytest.mark.parametrize("kind, flag", [
    ("stage2_opened", "ok"), ("stage2_commitment", "ok"),
    ("stage2_leaf", "merkle_ok"), ("stage2_missing", "shape_ok"),
    ("wrong_gamma", "ok")])
def test_tamper_rejected_like_jax_and_the_oracle(rlc, kind, flag):
    """tests/test_multistage.py:56-127's battery: every VerifyResult field
    equal in the port and the JAX verifier, the verdict in the oracle."""
    bad = _tamper(rlc, kind)
    ours, theirs = _both(j_proof_to_json(bad))
    assert ours == theirs
    assert not ours["ok"] and not ours[flag]
    # the oracle stops at its first failed check, so only its verdict and
    # shape flag are comparable
    oracle = ref_verify(bad, JRlcAir(), JFriConfig(*FC))
    assert (oracle.ok, oracle.shape_ok) == (ours["ok"], ours["shape_ok"])


def test_batch_verifier_matches_jax(rlc):
    """Mixed lanes (an honest proof, a tampered stage-2 opening); the JAX
    BatchVerifier's verdicts on the same lanes are computed once by
    scripts/make_torch_fixtures.py (tests/fixtures/
    torch_tests_jax_values.json, "rlc_batch")."""
    proof = rlc[1]
    lanes = [proof, _tamper(rlc, "stage2_opened")]
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_tests_jax_values.json")) as f:
        want = json.load(f)["rlc_batch"]
    tlanes = [tproof.proof_from_json(j_proof_to_json(p)) for p in lanes]
    cfg = tproof.derive_config(tlanes[0], tproof.FriConfig(*FC))
    got = BatchVerifier(RlcAir(), cfg, device="cpu").verify(tlanes)
    assert got.tolist() == want == [True, False]


def test_challenges_without_stage2_are_refused():
    """tests/test_multistage.py:333: an AIR with challenges and no stage-2
    matrix would give the provers and the verifier different transcripts,
    so both refuse it when they are built."""

    class BadAir(FibonacciAir):
        def num_challenges(self):
            return 1

    rlc_proof = tproof.proof_from_json(j_proof_to_json(
        ref_prove(JRlcAir(), _trace(7, 8), JFriConfig(1, 2, 1))))
    cfg = tproof.derive_config(rlc_proof, tproof.FriConfig(1, 2, 1))
    with pytest.raises(ValueError):
        TorchProver(BadAir(), 3, tproof.FriConfig(*FC), device="cpu")
    with pytest.raises(ValueError):
        TorchVerifier(BadAir(), cfg, device="cpu")
    assert TorchVerifier(RlcAir(), cfg, device="cpu").n_challenges == 1
