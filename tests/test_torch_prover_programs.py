"""The provers' stage programs (plonky25_torch/prover/prove.py:
`ProverPrograms`, utils/graphs.py StaticPrograms of one prover signature,
the counterparts of the JAX prover's jitted stages) against the staged
path and the JAX package's values, byte for byte (tolerance 0: every
value is an integer).

On the CPU `prove_columns(fused=True)` runs each stage function on its
program's buffers, the LDEs and trees passed on as shared buffers, so
these tests hold that protocol: the fib(64) fixture (whose witness lies
past the first grind window), RlcAir and MultisetAir proofs with their
device stage 2, a BatchProver batch of four; the plan rule where
`fused_default` holds (patched here to stand for the card); one set of
programs held per device; the stage-2 builder's zero flag; an
attestation's STARK, which never captures.
The RLC and multiset proofs are held to the JAX package's int oracle
(plonky25_tpu.refimpl.prover) at tests/test_torch_multistage.py's and
tests/test_torch_multiset.py's shapes.  The cases marked `cuda` capture
and replay the graphs on a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_prover_programs.py
"""

import importlib
import json
import os
import random
import weakref

import pytest
import torch

from plonky25_torch import attest as attest_mod
from plonky25_torch import attest_program
from plonky25_torch.fields import GL, gl2
from plonky25_torch.models import FibonacciAir, MultisetAir, RlcAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.models.multiset_air import pad_pairs
from plonky25_torch.models.verifier_air import VerifierAir
from plonky25_torch.proof import FriConfig, load_proof, proof_to_json
from plonky25_torch.prover import BatchProver, TorchProver
from plonky25_torch.prover.prove import trace_columns
from plonky25_torch.utils import graphs, profiling
from plonky25_tpu.models.multiset_air import MultisetAir as JMultisetAir
from plonky25_tpu.models.rlc_air import RlcAir as JRlcAir
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.refimpl.prover import prove as ref_prove

# the module (the package exports its function `prove` under that name)
prove_mod = importlib.import_module("plonky25_torch.prover.prove")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "proof_fibonacci_refimpl.json")
FC = FriConfig(1, 100, 16)
RLC_FC = (1, 8, 4)           # tests/test_torch_multistage.py's shape
MS_FC = (1, 4, 2)            # tests/test_torch_multiset.py's shape


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


def _jtext(proof):
    return json.dumps(j_proof_to_json(proof), separators=(",", ":"))


def _rlc_trace(seed, height=16):
    """tests/test_torch_multistage.py's _trace."""
    rng = random.Random(seed)
    return [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
            for _ in range(height)]


def _multiset_trace():
    """tests/test_torch_multiset.py's permutation trace (13 pairs)."""
    rng = random.Random(3)
    side_a = [(tag + 1, rng.randrange(1 << 63)) for tag in range(13)]
    side_b = list(side_a)
    rng.shuffle(side_b)
    return pad_pairs(side_a, side_b)


def _cols(traces):
    return trace_columns(traces, "cpu")


@pytest.fixture(scope="module")
def fib_runs():
    """The fib(64) fixture proved three times through one prover with
    fused=None where fused_default holds: each proof's plan, text and the
    programs held after it."""
    with open(FIXTURE) as f:
        fixture = f.read()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prove_mod, "fused_default", lambda device: True)
        p = TorchProver(FibonacciAir(), 6, FC, device="cpu")
        cols = _cols([fibonacci_trace(64)])
        runs = []
        for _ in range(3):
            how = p.plan(cols)
            runs.append((how, _text(p.prove_columns(cols)[0]),
                         sorted(p.programs())))
    return fixture, p, runs


def test_fib_fixture_staged_capture_replay(fib_runs):
    """A signature's first proof is staged, its second captures, its third
    replays; all three are the fixture's bytes."""
    fixture, _, runs = fib_runs
    assert [how for how, _, _ in runs] == ["staged", "capture", "replay"]
    assert all(text == fixture for _, text, _ in runs)
    assert runs[0][2] == [] and runs[1][2] == runs[2][2]


def test_fib_programs_are_the_jax_jits(fib_runs):
    """One program per JAX prover jit: the trace commit and its tree, the
    quotient, its chunks' commit and tree, the openings, the reduced
    openings, three per FRI phase, the grind window, the queries."""
    _, p, runs = fib_runs
    phases = range(FC.log_blowup, p.log_max)
    want = {"commit_trace", "tree_trace", "quotient", "commit_chunks",
            "tree_quotient", "opened", "reduced_openings", "grind",
            "queries"}
    want |= {f"fold_{k}_{lf}" for k in ("rows", "tree", "step")
             for lf in phases}
    assert set(runs[2][2]) == want


def test_grind_program_searches_past_the_first_window(fib_runs):
    """The fixture's witness lies in the second window: the grind program
    was loaded with each window's first witness."""
    _, p, _ = fib_runs
    wit = load_proof(FIXTURE).opening_proof.fri_proof.pow_witness
    assert wit >= prove_mod.grind_window(p.fc)
    base = p.programs()["grind"].inputs[1]
    assert int(base) == prove_mod.grind_window(p.fc)


def test_cpu_plan_is_staged_by_default():
    p = TorchProver(RlcAir(), 4, FriConfig(*RLC_FC), device="cpu")
    cols = _cols([_rlc_trace(7)])
    assert p.plan(cols) == "staged"
    p.prove_columns(cols)
    assert p.plan(cols) == "staged" and p.programs() == {}
    assert p.plan(cols, fused=True) == "capture"


@pytest.mark.parametrize("air,jair,trace,fc", [
    (RlcAir, JRlcAir, _rlc_trace(7), RLC_FC),
    (MultisetAir, JMultisetAir, _multiset_trace(), MS_FC)],
    ids=["rlc", "multiset"])
def test_multistage_programs_equal_staged_and_jax(air, jair, trace, fc):
    """A device stage-2 builder through its program: the captured and the
    replayed proof equal the staged one and the JAX oracle's."""
    log_n = len(trace).bit_length() - 1
    p = TorchProver(air(), log_n, FriConfig(*fc), device="cpu")
    cols = _cols([trace])
    want = _jtext(ref_prove(jair(), trace, JFriConfig(*fc)))
    assert _text(p.prove_columns(cols, fused=False)[0]) == want
    assert p.plan(cols, fused=True) == "capture"
    assert _text(p.prove_columns(cols, fused=True)[0]) == want
    assert p.plan(cols, fused=True) == "replay"
    assert _text(p.prove_columns(cols, fused=True)[0]) == want
    assert {"stage2", "commit_stage2", "tree_stage2"} <= set(p.programs())


def test_batch_programs_equal_staged_and_jax():
    """BatchProver at B=4 distinct RLC traces: programs and staged path
    give each lane the JAX oracle's proof."""
    traces = [_rlc_trace(s) for s in (7, 8, 9, 10)]
    bp = BatchProver(RlcAir(), 4, FriConfig(*RLC_FC), device="cpu")
    want = [_jtext(ref_prove(JRlcAir(), t, JFriConfig(*RLC_FC)))
            for t in traces]
    assert [_text(x) for x in bp.prove(traces, fused=False)] == want
    for _ in range(2):
        assert [_text(x) for x in bp.prove(traces, fused=True)] == want
    assert bp.programs()["commit_trace"].inputs[0].shape[0] == 4
    bp.release_programs()
    assert bp.programs() == {}


def test_one_set_of_programs_per_device():
    """A second signature's capture drops the first set, a staged proof of
    another prover drops it too, and so do release_programs and dropping
    the prover (weak references: nothing else holds the programs)."""
    fc = FriConfig(*RLC_FC)
    one, two = _cols([_rlc_trace(7)]), _cols([_rlc_trace(7), _rlc_trace(8)])
    a = TorchProver(RlcAir(), 4, fc, device="cpu")
    a.prove_columns(one, fused=True)
    first = weakref.ref(a._programs)
    a.prove_columns(two, fused=True)
    assert first() is None and a.plan(two, fused=True) == "replay"
    second = weakref.ref(a._programs)
    b = TorchProver(RlcAir(), 4, fc, device="cpu")
    b.prove_columns(one, fused=False)
    assert second() is None and a.programs() == {}
    # a staged proof of the holder's own signature keeps its programs
    a.prove_columns(two, fused=True)
    a.prove_columns(two, fused=False)
    assert a.plan(two) == "staged" and a.plan(two, fused=True) == "replay"
    held = weakref.ref(a._programs)
    a.release_programs()
    assert held() is None
    b.prove_columns(one, fused=True)
    held = weakref.ref(b._programs)
    del b
    assert held() is None


def test_signatures_proved_in_turns_run_staged(monkeypatch):
    """Where fused_default holds, a proof captures only where the device's
    last proof was of its prover and signature: two batch sizes proved in
    turns run staged, and the next proof of the same size captures."""
    monkeypatch.setattr(prove_mod, "fused_default", lambda device: True)
    one, two = _cols([_rlc_trace(7)]), _cols([_rlc_trace(7), _rlc_trace(8)])
    p = TorchProver(RlcAir(), 4, FriConfig(*RLC_FC), device="cpu")
    plans = []
    for cols in (one, two, one, two, two):
        plans.append(p.plan(cols))
        p.prove_columns(cols)
    assert plans == ["staged"] * 4 + ["capture"]


def test_stage2_zero_denominator_raises_through_the_program():
    """A multiset builder whose gamma equals row 3's compressed side-B pair:
    the flag made inside the stage-2 program raises ZeroDivisionError at
    the proof's first sync, staged or not, as the int oracle raises."""

    class ZeroAtRow3(MultisetAir):
        def build_stage2_device_flagged(self, cols, challenges):
            delta = challenges[1]
            gamma = gl2.add_base(gl2.mul_base(delta, cols[..., 3, 3]),
                                 cols[..., 2, 3])
            return super().build_stage2_device_flagged(cols, [gamma, delta])

    p = TorchProver(ZeroAtRow3(), 4, FriConfig(*MS_FC), device="cpu")
    cols = _cols([_multiset_trace()])
    for fused in (False, True, True):
        with pytest.raises(ZeroDivisionError):
            p.prove_columns(cols, fused=fused)
    assert "stage2" in p.programs()
    # the one-sync form of the builder still raises at once
    chs = [gl2.from_u64_pair([5], [6], "cpu"), gl2.from_u64_pair([7], [8],
                                                                 "cpu")]
    z, zero = MultisetAir().build_stage2_device_flagged(cols, chs)
    assert not bool(zero) and z.shape == (1, 2, 16)


def test_cache_sizes_cover_the_prover_tables():
    p = TorchProver(FibonacciAir(), 4, FriConfig(1, 2, 1), device="cpu")
    before = graphs._cache_sizes(p.table_sizes)
    assert before["tables.fold"] == 0 and not before["tables.selectors"]
    p._fold_phase_raw(2)
    p.selectors()
    after = graphs._cache_sizes(p.table_sizes)
    assert after["tables.fold"] == 1 and after["tables.selectors"] == 1
    assert set(graphs._cache_sizes()) < set(after)


def test_mesh_provers_run_staged():
    p = TorchProver(FibonacciAir(), 4, FriConfig(1, 2, 1), device="cpu")
    p.lde_mesh = object()            # the plan reads only its presence
    cols = _cols([fibonacci_trace(16)])
    assert p.plan(cols) == "staged" and p.plan(cols, fused=False) == "staged"
    with pytest.raises(ValueError):
        p.plan(cols, fused=True)
    bp = BatchProver(FibonacciAir(), 4, FriConfig(1, 2, 1), device="cpu")
    with pytest.raises(ValueError):
        bp.prove([fibonacci_trace(16)], mesh=object(), fused=True)


def test_an_attestation_stark_proves_staged(monkeypatch):
    """attest's VerifierAir STARK (attest._prove_schedule) proves staged
    even where the plan rule would capture, the device's last proof being
    of its signature: two attestation proofs in a row hold no programs,
    and both are the int prover's bytes."""
    monkeypatch.setattr(prove_mod, "fused_default", lambda device: True)
    fc, gamma, acc = FriConfig(1, 2, 1), (5, 6), (0, 0)
    want = _text(attest_mod._prove_schedule([], gamma, acc, fc, False,
                                            device="cpu"))
    cols = attest_program.build_trace_cols([], gamma, device="cpu")
    log_n = cols.shape[1].bit_length() - 1
    p = prove_mod.get_prover(VerifierAir(), log_n, fc, "cpu",
                             prove_mod.quotient_eval_chunks_for(
                                 VerifierAir(), log_n))
    plans = []
    for _ in range(2):
        plans.append(p.plan(GL(cols.lo[None], cols.hi[None])))
        assert _text(attest_mod._prove_schedule([], gamma, acc, fc, True,
                                                device="cpu")) == want
    assert plans == ["staged", "capture"] and p.programs() == {}


# ------------------------------------------------------------ on the card

def _card_prover(b=1):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph of the kernels)")
    with open(FIXTURE) as f:
        fixture = f.read()
    p = TorchProver(FibonacciAir(), 6, FC, device="cuda")
    cols = trace_columns([fibonacci_trace(64)] * b, "cuda")
    return fixture, p, cols


@pytest.mark.cuda
def test_replays_launch_what_staged_proofs_launch():
    """The fixture at B=2: captured and replayed proofs are its bytes, and
    a replay counts the staged proof's launches of each kernel."""
    fixture, p, cols = _card_prover(2)
    counts, states = {}, {}
    for how in ("staged", "capture", "replay"):
        assert p.plan(cols, fused=how != "staged") == how
        proofs, got = profiling.counted(
            lambda: p.prove_columns(cols, fused=how != "staged"))
        counts[how] = (got[profiling.AOS], got[profiling.SOA])
        states[how] = (got[profiling.AOS + ".states"],
                       got[profiling.SOA + ".states"])
        assert [_text(x) for x in proofs] == [fixture] * 2
    assert counts["replay"] == counts["staged"] and counts["staged"][1] > 0
    assert states["replay"] == states["staged"]
    # at the capture each program runs twice (its eager warm-up, then its
    # first replay), but the transcript's duplexes run once, between the
    # programs, and so does the grind's second window (the fixture's
    # witness lies there), a replay
    assert counts["capture"] == (counts["staged"][0],
                                 2 * counts["staged"][1] - 1)
    assert all(prog.stats["capture_ms"] > 0
               for prog in p.programs().values())
    p.release_programs()


@pytest.mark.cuda
def test_a_capture_raises_when_a_prover_table_grows():
    """A program whose function makes a prover table at every call: the
    capture sees the table grow and raises (nothing runs in its place)."""
    _, p, _ = _card_prover()

    def grows(x):
        p._fold_cache[100 + len(p._fold_cache)] = None
        return x + 1

    prog = graphs.StaticProgram(grows, (torch.zeros(4, device="cuda"),),
                                "cuda", tables=p.table_sizes)
    prog.load(torch.zeros(4, device="cuda"))
    with pytest.raises(RuntimeError, match="grew during the capture"):
        prog.run()


@pytest.mark.cuda
def test_reserved_memory_comes_back_after_the_drop():
    """Capture the fixture's programs and drop them: the card's reserved
    memory returns to within 0.5 GiB of its level before the capture."""
    fixture, p, cols = _card_prover()
    assert _text(p.prove_columns(cols, fused=False)[0]) == fixture
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    assert _text(p.prove_columns(cols, fused=True)[0]) == fixture
    pools = sum(prog.stats["pool_bytes"] for prog in p.programs().values())
    p.release_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() - before < 0.5 * 2**30, pools
