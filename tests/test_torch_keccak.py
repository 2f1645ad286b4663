"""Keccak in the port against the JAX package and its int oracle, bit for bit
(tolerance 0: the arithmetic is exact), on the CPU:

  * ops/keccak.py's batched keccak-f[1600] against refimpl.keccak_f_flat,
    the JAX keccak_f_jit and the zero-state known answer;
  * the AIR's tables, trace generators and constraint fold against the JAX
    KeccakAir's, and Ops' vector helpers (take, const_base, the vector
    fold) against the JAX Ops at the port's point shapes (B,) and (B, q);
  * the one-keccak-f proof of tests/test_keccak.py:58-64 (32 rows, seed
    21, FriConfig(1, 20, 8)): the port's CPU prover byte-equal to the int
    oracle's proof in tests/fixtures/proof_keccak32_refimpl.json, accepted
    by verify_proof with the transcript of proof_keccak32_expected.json,
    and by BatchVerifier beside its a_prime-bit tamper, which is rejected
    with the flags that the JAX verify_proof and the oracle gave it.

The JAX package keeps its Keccak proofs in the slow tier; here they come
from the fixtures (scripts/make_torch_fixtures.py), so no JAX verifier or
prover is compiled.  Each proof or verification of the 2,633-column AIR
pays 659 sponge chunks per leaf hash through the plain Poseidon2 on the
CPU, so each is made once per module.
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch

from plonky25_torch.air import Main, VerifierConstraintFolder
from plonky25_torch.fields import gl, gl2
from plonky25_torch.fields.extension import GL2, Ops
from plonky25_torch.models import KeccakAir, keccak_trace, keccak_trace_np
from plonky25_torch.models import keccak_air as t_air
from plonky25_torch.ops.keccak import from_u64, keccak_f, to_u64
from plonky25_torch.parallel.batch import BatchVerifier, stack_witnesses
from plonky25_torch.proof import (FriConfig, derive_config, load_proof,
                                  proof_to_json)
from plonky25_torch.prover import prove
from plonky25_torch.refimpl import keccak as t_ref
from plonky25_torch.verifier import verify_proof
from plonky25_torch.witness import pack_witness
from plonky25_tpu.air import VerifierConstraintFolder as JFolder
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields import gl2 as jgl2
from plonky25_tpu.models import keccak_air as j_air
from plonky25_tpu.ops.keccak import from_u64 as j_from_u64
from plonky25_tpu.ops.keccak import keccak_f_jit
from plonky25_tpu.ops.keccak import to_u64 as j_to_u64
from plonky25_tpu.refimpl import keccak as j_ref

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FC = FriConfig(log_blowup=1, num_queries=20, proof_of_work_bits=8)
FLAGS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok", "shape_ok")
TAMPERED = 865 + 77      # an a_prime bit column (tests/test_keccak.py:91-99)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run shares the CPU between worker
    processes (see tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(FIXTURES, "proof_keccak32_expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fixture_text():
    with open(os.path.join(FIXTURES, "proof_keccak32_refimpl.json")) as f:
        return f.read()


def _inputs(seed, n):
    rng = random.Random(seed)
    return [[rng.getrandbits(64) for _ in range(25)] for _ in range(n)]


# ------------------------------------------------------------ keccak-f

def test_refimpl_tables_are_the_jax_tables():
    assert (t_ref.R, t_ref.RC, t_ref.NUM_ROUNDS, t_ref.MASK64) == \
        (j_ref.R, j_ref.RC, j_ref.NUM_ROUNDS, j_ref.MASK64)
    for s in _inputs(3, 2):
        assert t_ref.keccak_f_flat(s) == j_ref.keccak_f_flat(s)


def test_keccak_f_zero_known_answer():
    out = to_u64(keccak_f(from_u64([0] * 25, "cpu")))
    assert int(out[0]) == 0xF1258F7940E1DDE7
    assert int(out[1]) == 0x84D5CCF933C0478A
    assert int(out[24]) == 0xEAF1FF7B5CECA249


def test_keccak_f_matches_oracle_and_jax():
    states = _inputs(5, 8)
    states[0] = [0] * 25
    states[1] = [(1 << 64) - 1] * 25
    got = to_u64(keccak_f(from_u64(states, "cpu"))).tolist()
    assert got == [t_ref.keccak_f_flat(s) for s in states]
    assert got == j_to_u64(keccak_f_jit(j_from_u64(states))).tolist()


def test_keccak_f_keeps_leading_axes():
    states = np.asarray(_inputs(6, 6), dtype=np.uint64).reshape(2, 3, 25)
    got = to_u64(keccak_f(from_u64(states, "cpu")))
    assert got.shape == (2, 3, 25)
    assert got.reshape(6, 25).tolist() == [
        t_ref.keccak_f_flat(s) for s in states.reshape(6, 25).tolist()]


# ------------------------------------------------------------ the AIR

def test_air_tables_match_jax():
    for a, b in zip(t_air._build_tables(), j_air._build_tables()):
        assert np.array_equal(a, b)
    assert (t_air.NUM_KECCAK_COLS, t_air.OFF_A_PRIME, t_air.OFF_APPP00_LIMBS) \
        == (j_air.NUM_KECCAK_COLS, j_air.OFF_A_PRIME, j_air.OFF_APPP00_LIMBS)
    assert KeccakAir().width() == 2633 and KeccakAir().quotient_degree() == 2


@pytest.mark.parametrize("n_inputs, min_height", [(1, 0), (2, 0), (3, 128)])
def test_trace_generators_match_jax(n_inputs, min_height):
    inputs = _inputs(77 + n_inputs, n_inputs)
    got = keccak_trace_np(inputs, min_height)
    assert np.array_equal(got, j_air.keccak_trace_np(inputs, min_height))
    if min_height == 0:
        assert np.array_equal(np.asarray(keccak_trace(inputs), np.int64), got)
    # round 23 of each permutation holds keccak-f of its input
    for p, inp in enumerate(inputs):
        row = got[24 * p + 23]
        want = t_ref.keccak_f_flat(inp)
        out = [sum(int(row[t_air.OFF_APP + 4 * i + l]) << (16 * l)
                   for l in range(4)) for i in range(25)]
        out[0] = sum(int(row[t_air.OFF_APPP00_LIMBS + l]) << (16 * l)
                     for l in range(4))
        assert out == want


def _rand_ext(rng, shape):
    return (rng.integers(0, P, size=shape, dtype=np.uint64),
            rng.integers(0, P, size=shape, dtype=np.uint64))


class _JMain:
    def __init__(self, local_vec, next_vec):
        self.local_vec, self.next_vec = local_vec, next_vec
        self.trace_local = self.trace_next = None
        self.quotient_chunks = []


def test_air_fold_matches_jax_at_random_points():
    """KeccakAir.eval folded at random openings of two proofs: the port's
    folder at point shape (2,) against the JAX folder at the same shape."""
    rng = np.random.default_rng(2633)
    w = t_air.NUM_KECCAK_COLS
    vals = {k: _rand_ext(rng, shape) for k, shape in (
        ("local", (w, 2)), ("next", (w, 2)), ("first", (2,)), ("last", (2,)),
        ("trans", (2,)), ("alpha", (2,)))}

    def t_ext(v):
        return GL2(gl.from_u64(v[0], "cpu"), gl.from_u64(v[1], "cpu"))

    def j_ext(v):
        return jgl2.GL2(jgl.from_u64(v[0]), jgl.from_u64(v[1]))

    t_folder = VerifierConstraintFolder(
        Ops((2,), "cpu"), Main(t_ext(vals["local"]), t_ext(vals["next"])),
        t_ext(vals["first"]), t_ext(vals["last"]), t_ext(vals["trans"]),
        t_ext(vals["alpha"]))
    KeccakAir().eval(t_folder)
    j_folder = JFolder(
        jgl2.Ops((2,)), _JMain(j_ext(vals["local"]), j_ext(vals["next"])),
        j_ext(vals["first"]), j_ext(vals["last"]), j_ext(vals["trans"]),
        j_ext(vals["alpha"]))
    j_air.KeccakAir().eval(j_folder)
    got, want = t_folder.accumulator, j_folder.accumulator
    assert gl.to_u64(got.c0).tolist() == jgl.to_u64(want.c0).tolist()
    assert gl.to_u64(got.c1).tolist() == jgl.to_u64(want.c1).tolist()
    n = sum(int(np.prod(c.shape[:max(len(c.shape) - 1, 0)] or (1,)))
            for c in t_folder._constraints)
    assert n == 3501 and len(t_folder._constraints) == 17


# ------------------------------------------------------------ Ops

@pytest.mark.parametrize("point_shape, alpha_shape", [
    ((3,), (3,)),          # the verifier: one point per proof
    ((2, 4), (2, 1)),      # the prover: a quotient coset per proof
])
@pytest.mark.parametrize("kind", ["vectors", "scalars"])
def test_vector_fold_matches_the_jax_scan_fold(point_shape, alpha_shape,
                                               kind):
    rng = np.random.default_rng(len(point_shape) * 10 + len(kind))
    if kind == "vectors":
        shapes = [(7,) + point_shape, point_shape, (2, 3) + point_shape,
                  (1,) + point_shape, (5,) + (1,) * len(point_shape)]
    else:
        shapes = [point_shape] * 6
    cs = [_rand_ext(rng, s) for s in shapes]
    alpha = _rand_ext(rng, alpha_shape)
    got = Ops(point_shape, "cpu").fold_constraints(
        GL2(gl.from_u64(alpha[0], "cpu"), gl.from_u64(alpha[1], "cpu")),
        [GL2(gl.from_u64(a, "cpu"), gl.from_u64(b, "cpu")) for a, b in cs])
    want = jgl2.Ops(point_shape).fold_constraints(
        jgl2.GL2(jgl.from_u64(alpha[0]), jgl.from_u64(alpha[1])),
        [jgl2.GL2(jgl.from_u64(a), jgl.from_u64(b)) for a, b in cs])
    assert got.shape == point_shape
    assert gl.to_u64(got.c0).tolist() == jgl.to_u64(want.c0).tolist()
    assert gl.to_u64(got.c1).tolist() == jgl.to_u64(want.c1).tolist()


@pytest.mark.parametrize("point_shape", [(3,), (2, 4)])
def test_take_and_const_base_shapes(point_shape):
    ops = Ops(point_shape, "cpu")
    assert ops.point_ndim == len(point_shape)
    rng = np.random.default_rng(9)
    vec = GL2(*(gl.from_u64(a, "cpu")
                for a in _rand_ext(rng, (10,) + point_shape)))
    const = ops.const_base([1, 2, P + 3])
    assert const.shape == (3,) + (1,) * len(point_shape)
    assert gl.to_u64(const.c0).reshape(-1).tolist() == [1, 2, 3]
    assert ops.const_base([1, 2, P + 3]) is const         # made once
    for idx in (np.arange(2, 6), [4], np.array([9, 0, 0, 3]),
                torch.tensor([1, 8])):
        got = ops.take(vec, idx)
        want = np.asarray(idx)
        assert got.shape == (len(want),) + point_shape
        assert torch.equal(got.c1.hi, vec.c1.hi[torch.as_tensor(want)])
    both = ops.mul(ops.take(vec, np.arange(3)), const)
    assert both.shape == (3,) + point_shape
    assert ops.concat([vec, ops.take(vec, [0])]).shape == \
        (11,) + point_shape


def test_power_stack_and_sum_dim():
    rng = np.random.default_rng(4)
    a = GL2(*(gl.from_u64(v, "cpu") for v in _rand_ext(rng, (3,))))
    pw = gl2.power_stack(a, 11)
    acc = gl2.ones((3,), "cpu")
    for k in range(11):
        assert torch.equal(pw[k].c0.lo, acc.c0.lo) and \
            torch.equal(pw[k].c1.hi, acc.c1.hi)
        acc = gl2.mul(acc, a)
    x = GL2(*(gl.from_u64(v, "cpu") for v in _rand_ext(rng, (2, 13, 3))))
    want = x[:, 0]
    for i in range(1, 13):
        want = gl2.add(want, x[:, i])
    got = gl2.sum_dim(x, 1)
    assert torch.equal(got.c0.lo, want.c0.lo) and torch.equal(got.c1.hi,
                                                              want.c1.hi)


# ------------------------------------------------------------ the proof

@pytest.fixture(scope="module")
def port_proof():
    rng = random.Random(21)
    inp = [rng.getrandbits(64) for _ in range(25)]
    return prove(KeccakAir(), keccak_trace_np([inp]), FC, device="cpu")


def test_prover_is_byte_equal_to_the_oracle(port_proof, fixture_text,
                                            expected):
    text = json.dumps(proof_to_json(port_proof), separators=(",", ":"))
    assert len(text) == expected["bytes"]
    assert text == fixture_text
    assert len(port_proof.opened_values.quotient_chunks) == 2
    assert len(port_proof.opened_values.trace_local) == 2633


def _fields(r):
    return {k: bool(getattr(r, k)) for k in FLAGS}


def test_verify_proof_accepts_with_the_expected_transcript(expected):
    proof = load_proof(os.path.join(FIXTURES, "proof_keccak32_refimpl.json"))
    r = verify_proof(proof, KeccakAir(), FC, device="cpu")
    assert _fields(r) == expected["verdict"]
    assert [int(gl.to_u64(r.alpha.c0)), int(gl.to_u64(r.alpha.c1))] == \
        expected["alpha"]
    assert [int(gl.to_u64(r.zeta.c0)), int(gl.to_u64(r.zeta.c1))] == \
        expected["zeta"]
    assert r.query_indices.tolist() == expected["query_indices"]


@pytest.fixture(scope="module")
def batch_result():
    """BatchVerifier on [the fixture, its a_prime-bit tamper]: every stage
    flag of both lanes."""
    proof = load_proof(os.path.join(FIXTURES, "proof_keccak32_refimpl.json"))
    bad = copy.deepcopy(proof)
    c0, c1 = bad.opened_values.trace_local[TAMPERED]
    bad.opened_values.trace_local[TAMPERED] = ((c0 + 1) % P, c1)
    cfg = derive_config(proof, FC)
    bv = BatchVerifier(KeccakAir(), cfg, device="cpu")
    ws = stack_witnesses([pack_witness(p, cfg, "cpu") for p in (proof, bad)])
    return bv.base.verify_witnesses(ws)


def test_batch_verifier_accepts_the_proof(batch_result, expected):
    assert {k: bool(batch_result[k][0]) for k in FLAGS if k != "shape_ok"} \
        == {k: v for k, v in expected["verdict"].items() if k != "shape_ok"}


def test_tamper_rejected_with_the_oracle_flags(batch_result, expected):
    want = expected["tamper_a_prime_bit"]
    assert want["index"] == TAMPERED
    got = {k: bool(batch_result[k][1]) for k in FLAGS if k != "shape_ok"}
    assert got == {k: v for k, v in want["verdict"].items()
                   if k != "shape_ok"}
    assert got["ok"] == want["oracle_ok"] is False
