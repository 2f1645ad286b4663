"""The provers' warmup (TorchProver.warmup, BatchProver.warmup): every
stage once on zero-filled inputs of the prover's shape, the results
discarded.  A warmed prover proves the same bytes as a fresh one: the
fib(64) fixture (tests/fixtures/proof_fibonacci_refimpl.json), and an
RLC proof through the multi-stage branch and the segmented quotient.
Both signatures are the JAX package's."""

import inspect
import json
import os

import pytest
import torch

from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.proof import FriConfig, proof_to_json
from plonky25_torch.prover import BatchProver, TorchProver
from plonky25_tpu.prover.batch_prove import BatchProver as JBatchProver
from plonky25_tpu.prover.prove import TpuProver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "proof_fibonacci_refimpl.json")
FC = FriConfig(1, 100, 16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_verifier.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text(proof):
    return json.dumps(proof_to_json(proof), separators=(",", ":"))


@pytest.fixture(scope="module")
def fixture_text():
    with open(FIXTURE) as f:
        return f.read()


def test_warmed_prover_proves_the_fixture(fixture_text):
    p = TorchProver(FibonacciAir(), 6, FC, device="cpu")
    p.warmup()
    assert p._selectors is not None and p._ro_xs is not None
    assert sorted(p._fold_cache) == list(range(FC.log_blowup, p.log_max))
    assert _text(p.prove(fibonacci_trace(64))) == fixture_text


def test_warmed_batch_prover_proves_the_fixture(fixture_text):
    bp = BatchProver(FibonacciAir(), 6, FC, device="cpu")
    bp.warmup(2)
    proofs = bp.prove([fibonacci_trace(64)] * 2)
    assert [_text(p) for p in proofs] == [fixture_text] * 2


def test_warmed_multistage_segmented_prover_proves_the_same_bytes():
    """RlcAir at 16 rows (tests/test_torch_multistage.py's shape) with two
    quotient segments: stage-2 trees and segments warmed, then the same
    proof as an unwarmed prover's."""
    fc = FriConfig(1, 8, 4)
    trace = [[(7 * i + 3) % 97, (5 * i + 1) % 89] for i in range(16)]
    fresh = TorchProver(RlcAir(), 4, fc, device="cpu",
                        quotient_eval_chunks=2).prove(trace)
    warmed = TorchProver(RlcAir(), 4, fc, device="cpu",
                         quotient_eval_chunks=2)
    warmed.warmup()
    assert _text(warmed.prove(trace)) == _text(fresh)


@pytest.mark.parametrize("mine,theirs", [
    (TorchProver.warmup, TpuProver.warmup),
    (BatchProver.warmup, JBatchProver.warmup)],
    ids=["TorchProver", "BatchProver"])
def test_warmup_signatures_are_jax(mine, theirs):
    def params(f):
        return [(p.name, p.default)
                for p in inspect.signature(f).parameters.values()]
    assert params(mine) == params(theirs)
