"""The benchmark's plain reference on the CPU: it accepts the golden proof
and rejects each tamper kind, agrees with the port's int oracle check by
check, and its NumPy Poseidon2 and trace evaluation agree with the plain
int versions.

    python -m pytest p3bench/tests -q
"""

import json
import random

import numpy as np
import pytest

from p3bench.harness import core, tamper
from p3bench.reference import fibonacci, keccak_air, lde, npgl
from p3bench.reference import proof as rp
from p3bench.reference.field import Gl, Gl2
from p3bench.reference.poseidon2 import poseidon2
from p3bench.reference.verifier import verify, verify_many

GOLDEN = core.load_json("p3bench/data/proof_fibonacci_refimpl.json")
FC = rp.FriConfig(1, 100, 16)
FLAGS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok")


def test_numpy_poseidon2_matches_the_int_permutation():
    rng = random.Random(1)
    p = npgl.GOLDILOCKS_P
    states = [[rng.randrange(p) for _ in range(12)] for _ in range(64)]
    states += [[p - 1] * 12, [0] * 12, list(range(12))]
    assert npgl.permute_states(states) == [poseidon2(s) for s in states]


def test_numpy_field_ops_match_python_ints():
    rng = random.Random(2)
    p = npgl.GOLDILOCKS_P
    a = [rng.randrange(p) for _ in range(2000)] + [p - 1, 0, 1, p - 1]
    b = [rng.randrange(p) for _ in range(2000)] + [p - 1, p - 1, 0, 1]
    x, y = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    assert npgl.mul(x, y).tolist() == [u * v % p for u, v in zip(a, b)]
    assert npgl.add(x, y).tolist() == [(u + v) % p for u, v in zip(a, b)]
    assert npgl.sub(x, y).tolist() == [(u - v) % p for u, v in zip(a, b)]
    m = np.asarray([a, b], np.uint64)
    assert npgl.sum_mod(m, axis=1).tolist() == [sum(a) % p, sum(b) % p]


def test_reference_accepts_the_golden_proof():
    tr = verify(rp.proof_from_json(GOLDEN), fibonacci.FibonacciAir(), FC)
    assert all(getattr(tr, f) for f in FLAGS)


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_reference_rejects_each_tamper_kind(kind):
    rng = np.random.default_rng(11)
    for _ in range(3):
        bad = rp.proof_from_json(tamper.tamper(GOLDEN, kind, rng))
        assert not verify(bad, fibonacci.FibonacciAir(), FC).ok


def test_without_merkle_checks_a_sibling_tamper_passes():
    """The control of the verify cells: a verifier that trusts every
    opening accepts a proof with a changed Merkle sibling."""
    bad = rp.proof_from_json(
        tamper.tamper(GOLDEN, "merkle_sibling", np.random.default_rng(4)))
    assert not verify(bad, fibonacci.FibonacciAir(), FC).ok
    assert verify(bad, fibonacci.FibonacciAir(), FC, check_merkle=False).ok


def _oracle_case(fixture, air_ref, air_port, fc_args, kinds):
    from chip_smoke import tamper as smoke_tamper
    from plonky25_torch.models import fibonacci as port_fib  # noqa: F401
    from plonky25_torch.proof import FriConfig, proof_from_json, proof_to_json
    from plonky25_torch.refimpl.verifier import verify as oracle

    d = json.load(open(f"tests/fixtures/{fixture}"))
    p = proof_from_json(d)
    ps = [p] + [smoke_tamper(p, k) for k in kinds]
    mine = verify_many([rp.proof_from_json(proof_to_json(x)) for x in ps],
                       air_ref, rp.FriConfig(*fc_args))
    for x, tr in zip(ps, mine):
        o = oracle(x, air_port, FriConfig(*fc_args))
        assert [getattr(o, f) for f in FLAGS] == [getattr(tr, f)
                                                 for f in FLAGS]
        assert o.reduced_openings == tr.reduced_openings
        assert o.folded_evals == tr.folded_evals
        assert o.query_indices == tr.query_indices


def test_reference_agrees_with_the_int_oracle_on_fibonacci():
    from plonky25_torch.models.fibonacci import FibonacciAir

    _oracle_case("proof_fibonacci_refimpl.json", fibonacci.FibonacciAir(),
                 FibonacciAir(), (1, 100, 16),
                 ("pow", "merkle_sibling", "fold_sibling", "final_poly"))


def test_reference_agrees_with_the_int_oracle_on_keccak():
    from plonky25_torch.models.keccak_air import KeccakAir

    _oracle_case("proof_keccak32_refimpl.json", keccak_air.KeccakAir(),
                 KeccakAir(), (1, 20, 8),
                 ("merkle_sibling", "a_prime_bit", "trace_leaf"))


def test_trace_evaluation_gives_the_golden_openings():
    p = rp.proof_from_json(GOLDEN)
    tr = verify(p, fibonacci.FibonacciAir(), FC)
    t = fibonacci.seeded_trace(None, 6)
    assert lde.evaluate(t, tr.zeta) == [tuple(v) for v in
                                        p.opened_values.trace_local]
    z_next = Gl2.mul_base(tr.zeta, Gl.two_adic_generator(6))
    assert lde.evaluate(t, z_next) == [tuple(v) for v in
                                       p.opened_values.trace_next]


def test_keccak_trace_builder_matches_the_program_one():
    from plonky25_torch.models.keccak_air import keccak_trace_np

    rng = np.random.default_rng(9)
    t = keccak_air.seeded_trace(rng, 6)
    rng = np.random.default_rng(9)
    inputs = rng.integers(0, 1 << 64, size=(64 // 24, 25), dtype=np.uint64)
    assert (t == keccak_trace_np(inputs.tolist(), 64)).all()
