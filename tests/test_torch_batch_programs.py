"""BatchVerifier's five stage programs (plonky25_torch/parallel/batch.py:
`_t`, `_b`, `_r`, `_f`, `_fin`, utils/graphs.py StaticPrograms of one
stacked witness signature) against the staged path (the base verifier's
verify_witnesses) and the JAX package's values, bit for bit (tolerance 0:
every value is an integer).

On the CPU `verify_witnesses(fused=True)` runs each stage function on its
program's static buffers, one program's outputs loaded into the next, so
these tests hold that protocol: the values of every lane, stale inputs
across batches, the stage-2 fields of a multi-stage AIR, the programs of
one signature held at a time.  Where `fused_default` holds (patched here
to stand for the card) a signature's first batch is staged, its second
captures, later ones replay.  The JAX samples of the fixture proof and of
its PoW tamper are committed under `fused` in
tests/fixtures/torch_tests_jax_values.json, the JAX BatchVerifier's RLC
verdicts under `rlc_batch`, so this file imports no JAX.  The cases marked
`cuda` replay the graphs on a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_programs.py
"""

import copy
import inspect
import json
import os
import random
import weakref

import pytest
import torch

from plonky25_torch.fields import gl
from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.parallel import batch
from plonky25_torch.parallel.batch import BatchVerifier, stack_witnesses
from plonky25_torch.proof import FriConfig, derive_config, load_proof
from plonky25_torch.refimpl.prover import prove as ref_prove
from plonky25_torch.utils import profiling
from plonky25_torch.utils.tree import tree_leaves
from plonky25_torch.witness import pack_witness

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FC = FriConfig(1, 100, 16)
TAMPERS = ("pow", "merkle_sibling", "fold_sibling", "final_poly")
STAGES = ["transcript", "merkle", "reduced_openings", "fold", "final"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_verifier.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_values():
    with open(os.path.join(FIXTURES, "torch_tests_jax_values.json")) as f:
        return json.load(f)


def _tamper(proof, kind):
    """tests/test_torch_verifier.py's tamper battery."""
    p = copy.deepcopy(proof)
    fp = p.opening_proof.fri_proof
    if kind == "pow":
        fp.pow_witness += 1
    elif kind == "merkle_sibling":
        p.opening_proof.query_openings[17][0].opening_proof[3][2] ^= 1
    elif kind == "fold_sibling":
        s = fp.query_proofs[5].commit_phase_openings[1]
        s.sibling_value = (s.sibling_value[0] ^ 1, s.sibling_value[1])
    elif kind == "final_poly":
        fp.final_poly = (fp.final_poly[0] + 1, fp.final_poly[1])
    elif kind == "stage2_local":
        c0, c1 = p.opened_values.stage2_local[0]
        p.opened_values.stage2_local[0] = ((c0 + 1) % P, c1)
    elif kind == "stage2_sibling":
        p.opening_proof.query_openings[3][1].opening_proof[1][2] ^= 1
    return p


def _equal(a, b):
    """Two verify_witnesses dicts hold the same keys and values."""
    assert a.keys() == b.keys()
    for k in a:
        la, lb = tree_leaves(a[k]), tree_leaves(b[k])
        assert len(la) == len(lb) and all(
            torch.equal(x, y) for x, y in zip(la, lb)), k


@pytest.fixture(scope="module")
def fib():
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    cfg = derive_config(proof, FC)
    return proof, cfg, BatchVerifier(FibonacciAir(), cfg, device="cpu")


def _stack(proofs, cfg):
    return stack_witnesses([pack_witness(p, cfg, "cpu") for p in proofs])


def _size(bv):
    """The batch size of the programs `bv` holds."""
    return bv.programs()["_t"].inputs[0].shape[0]


@pytest.mark.parametrize("lane", range(len(TAMPERS)))
def test_programs_equal_staged_and_jax(fib, lane):
    """Four copies of the fixture, lane `lane` tampered with TAMPERS[lane]:
    the programs' flags, alpha, zeta, indices and samples are the staged
    path's; the samples are the JAX verifier's (the PoW tamper's its own);
    one set of programs serves every batch of this signature."""
    proof, cfg, bv = fib
    kind = TAMPERS[lane]
    lanes = [_tamper(proof, kind) if i == lane else proof for i in range(4)]
    ws = _stack(lanes, cfg)
    marks = []
    got = bv._verify(ws, marks.append, fused=True)
    _equal(got, bv.base.verify_witnesses(ws))
    assert marks == STAGES
    assert got["ok"].tolist() == [i != lane for i in range(4)]
    want = _jax_values()["fused"]
    assert bv.plan(ws, fused=True) == "replay"
    ok, samples = bv.verify_witnesses(ws, with_samples=True, fused=True)
    assert torch.equal(ok, got["ok"])
    for i in range(4):
        name = "pow" if (i == lane and kind == "pow") else "fixture"
        assert gl.to_u64(samples[i]).tolist() == want[name]["samples"]
    assert len(bv.programs()) == 5 and _size(bv) == 4


def test_a_second_batch_size_gets_programs_of_its_own(fib):
    """A capture for B=2 drops the B=4 programs: one signature is held."""
    proof, cfg, bv = fib
    bv._verify(_stack([proof] * 4, cfg), fused=True)
    old = weakref.ref(bv._held)
    ws = _stack([_tamper(proof, "final_poly"), proof], cfg)
    got = bv._verify(ws, fused=True)
    _equal(got, bv.base.verify_witnesses(ws))
    assert got["ok"].tolist() == [False, True]
    assert old() is None and _size(bv) == 2
    # a held result is the caller's: the next batch leaves it alone
    before = [x.clone() for x in tree_leaves(got)]
    bv._verify(_stack([proof, proof], cfg), fused=True)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), before))


def test_the_cpu_takes_the_staged_path_by_default(fib):
    proof, cfg, bv = fib
    ws = _stack([proof] * 3, cfg)
    held = bv._held
    marks = []
    for _ in range(2):
        assert bv.plan(ws) == "staged"
        assert bv.verify_witnesses(ws, marks.append).tolist() == [True] * 3
    assert marks == STAGES * 2
    assert bv._held is held


def test_a_signature_is_captured_at_its_second_batch(fib, monkeypatch):
    """Where fused_default holds: the first batch of a signature is staged,
    the second captures its programs, later ones replay them; a batch of
    another signature is staged and leaves them, its second batch drops
    them for its own.  Every call gives the staged values."""
    monkeypatch.setattr(batch, "fused_default", lambda device: True)
    proof, cfg, _ = fib
    bv = BatchVerifier(FibonacciAir(), cfg, device="cpu")
    a = _stack([proof, _tamper(proof, "pow"), proof], cfg)
    b = _stack([_tamper(proof, "merkle_sibling"), proof], cfg)
    want = {3: bv.base.verify_witnesses(a), 2: bv.base.verify_witnesses(b)}
    plans, held = [], []
    for ws in (a, a, a, b, a, b, b):
        plans.append(bv.plan(ws))
        _equal(bv._verify(ws), want[ws["obs"].shape[0]])
        held.append(weakref.ref(bv._held) if bv._held else None)
    assert plans == ["staged", "capture", "replay", "staged", "replay",
                     "capture", "replay"]
    assert held[1]() is None and held[5]() is bv._held and _size(bv) == 2


def test_rlc_batch_carries_the_stage2_fields():
    """RlcAir (a stage-2 matrix and a challenge) at 16 rows: the programs
    equal the staged path lane for lane, and the first two lanes get the
    JAX BatchVerifier's verdicts."""
    rng = random.Random(7)   # tests/test_torch_multistage.py's _trace(7)
    trace = [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
             for _ in range(16)]
    fc = FriConfig(1, 8, 4)
    proof = ref_prove(RlcAir(), trace, fc)
    cfg = derive_config(proof, fc)
    bv = BatchVerifier(RlcAir(), cfg, device="cpu")
    lanes = [proof, _tamper(proof, "stage2_local"),
             _tamper(proof, "stage2_sibling"), proof]
    ws = _stack(lanes, cfg)
    assert "stage2_local" in ws
    got = bv._verify(ws, fused=True)
    _equal(got, bv.base.verify_witnesses(ws))
    assert got["ok"].tolist() == [True, False, False, True]
    assert got["ok"][:2].tolist() == _jax_values()["rlc_batch"]
    assert not got["quotient_ok"][1] and not got["merkle_ok"][2]
    assert bv.verify(lanes).tolist() == [True, False, False, True]


def test_verify_witnesses_signature():
    names = [p.name for p in inspect.signature(
        BatchVerifier.verify_witnesses).parameters.values()]
    assert names == ["self", "ws", "on_stage", "with_samples", "fused"]


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph of the kernels)")
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    cfg = derive_config(proof, FC)
    return proof, cfg, BatchVerifier(FibonacciAir(), cfg, device="cuda")


@pytest.mark.cuda
def test_programs_replay_on_the_card():
    """B=4 with every tamper kind in a lane: the graphs give the staged
    values; each replay of the five counts the staged path's launches."""
    proof, cfg, bv = _card()
    ws = stack_witnesses([pack_witness(_tamper(proof, k), cfg, "cuda")
                          for k in TAMPERS])
    staged = bv.base.verify_witnesses(ws)
    assert bv.plan(ws) == "staged"
    _equal(bv._verify(ws), staged)
    assert bv.plan(ws) == "capture"
    _equal(bv._verify(ws), staged)
    aos = profiling.AOS
    counts = []
    for fused in (True, False):
        ok, got = profiling.counted(
            lambda: bv.verify_witnesses(ws, fused=fused).tolist())
        assert ok == [False] * 4
        counts.append((got[aos], got[aos + ".states"]))
    assert counts[0] == counts[1] and counts[0][0] > 0
    assert all(p.stats["capture_ms"] > 0 for p in bv.programs().values())


@pytest.mark.cuda
def test_memory_stays_flat_across_batch_sizes():
    """Captures at B = 4, 2, 3, then 4 again: each drops the programs
    before it, so the card's reserved memory with B=4's programs held is
    what it was the first time, short of what B=2's and B=3's pools would
    add had they been kept."""
    proof, cfg, bv = _card()
    reserved, pools = [], []
    for b in (4, 2, 3, 4):
        ws = stack_witnesses([pack_witness(proof, cfg, "cuda")] * b)
        assert bv.plan(ws, fused=True) == "capture"
        assert bv.verify_witnesses(ws, fused=True).tolist() == [True] * b
        pools.append(sum(p.stats["pool_bytes"]
                         for p in bv.programs().values()))
        del ws
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[3] - reserved[0] < (pools[1] + pools[2]) / 2, (
        reserved, pools)
