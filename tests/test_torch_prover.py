"""The port's prover path against the JAX package and its int oracle, bit
for bit (tolerance 0: the arithmetic is exact), on the CPU:

  * Merkle trees (plonky25_torch.ops.mmcs) against JAX's DeviceMerkleTree;
  * the device challenger against JAX's, on a seeded schedule;
  * every TorchProver stage against the JAX TpuProver stage method at
    fib(16), fed the same columns and challenges through convert.from_jax;
  * the shape tables the port builds on the device against host lists;
  * whole proofs: fib(64) byte-equal to the fixture, and live against
    plonky25_tpu.refimpl.prover at fib(16) and fib(32);
  * BatchProver with a tampered lane against the oracle's proofs and the
    verdicts of both packages' verifiers.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields.extension import GL2 as JGL2
from plonky25_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky25_tpu.models.fibonacci import fibonacci_trace
from plonky25_tpu.ops.mmcs import DeviceMerkleTree as JTree
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import proof_to_json as j_proof_to_json
from plonky25_tpu.prover.device_challenger import DeviceChallenger as JChallenger
from plonky25_tpu.prover.prove import TpuProver
from plonky25_tpu.refimpl.field import Gl
from plonky25_tpu.refimpl.prover import prove as ref_prove
from plonky25_tpu.refimpl.verifier import verify as ref_verify
from plonky25_tpu.utils.bits import reverse_bits_len
from plonky25_torch.convert import from_jax
from plonky25_torch.fields import gl
from plonky25_torch.models import FibonacciAir
from plonky25_torch.ops.mmcs import DeviceMerkleTree, _build_tree
from plonky25_torch.proof import FriConfig, proof_to_json
from plonky25_torch.prover import BatchProver, TorchProver, prove
from plonky25_torch.prover.device_challenger import DeviceChallenger
from plonky25_torch.verifier import verify_proof

P = 0xFFFFFFFF00000001
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "proof_fibonacci_refimpl.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(x):
    """A port GL / GL2 or a JAX GL / GL2 -> nested Python ints."""
    if hasattr(x, "c0"):
        return [_ints(x.c0), _ints(x.c1)]
    if isinstance(x, gl.GL):
        return np.asarray(gl.to_u64(x), dtype=object).tolist()
    return np.asarray(jgl.to_u64_np(x), dtype=object).tolist()


def _compact(proof_json):
    return json.dumps(proof_json, separators=(",", ":"))


def _jext(r):
    return JGL2(jgl.from_u64([r.randrange(P)])[0],
                jgl.from_u64([r.randrange(P)])[0])


# ------------------------------------------------------------ Merkle trees


@pytest.mark.parametrize("width", [3, 4, 10])
def test_tree_matches_jax(width):
    """Levels, root and opening paths; width 10 takes two sponge chunks."""
    rng = np.random.default_rng(width)
    rows = rng.integers(0, P, size=(16, width), dtype=np.uint64)
    jt = JTree(jgl.from_u64(rows))
    tt = DeviceMerkleTree(gl.from_u64(rows.T.copy(), "cpu"))
    assert len(tt.levels) == len(jt.levels) == 5
    for ours, theirs in zip(tt.levels, jt.levels):
        assert np.asarray(_ints(ours), dtype=object).T.tolist() == _ints(theirs)
    assert _ints(tt.root) == _ints(jt.root)
    idx = rng.integers(0, 16, size=7)
    assert (_ints(tt.open_paths(torch.from_numpy(idx)))
            == _ints(jt.open_paths(idx.astype(np.uint32))))


def test_batched_trees_equal_separate_trees():
    """A leading proof axis builds B trees in the same calls as one tree."""
    rng = np.random.default_rng(1)
    cols = rng.integers(0, P, size=(3, 5, 8), dtype=np.uint64)
    levels = _build_tree(gl.from_u64(cols, "cpu"))
    idx = torch.from_numpy(rng.integers(0, 8, size=(3, 4)))
    paths = DeviceMerkleTree(gl.from_u64(cols, "cpu")).open_paths(idx)
    for b in range(3):
        one = DeviceMerkleTree(gl.from_u64(cols[b], "cpu"))
        assert [_ints(lv[b]) for lv in levels] == [_ints(lv) for lv in one.levels]
        assert _ints(paths[b]) == _ints(one.open_paths(idx[b]))


# ------------------------------------------------------------ challenger


def test_device_challenger_matches_jax_on_seeded_schedule():
    r = random.Random(0xC0FFEE)
    jc, tc = JChallenger(), DeviceChallenger((), "cpu")
    for step in range(40):
        op = r.choice(["obs1", "obs4", "sample", "ext", "bits"])
        if op == "obs1":
            v = r.randrange(P)
            jc.observe(jgl.from_u64([v])[0])
            tc.observe(gl.from_u64(v, "cpu"))
        elif op == "obs4":
            vs = [r.randrange(P) for _ in range(4)]
            jc.observe_many(jgl.from_u64(vs))
            tc.observe_many(gl.from_u64(vs, "cpu"))
        elif op == "sample":
            assert _ints(tc.sample()) == _ints(jc.sample()), step
        elif op == "ext":
            assert _ints(tc.sample_ext()) == _ints(jc.sample_ext()), step
        else:
            assert int(tc.sample_bits(9)) == int(np.asarray(jc.sample_bits(9)))
    if tc.input_buffer:
        assert _ints(tc.sample()) == _ints(jc.sample())
    assert (tc.sample_many_bits(30, 7).tolist()
            == np.asarray(jc.sample_many_bits(30, 7)).tolist())
    assert _ints(tc.sample()) == _ints(jc.sample())


def test_batched_challenger_equals_separate_transcripts():
    r = random.Random(3)
    values = [[r.randrange(P) for _ in range(3)] for _ in range(7)]
    batched = DeviceChallenger((3,), "cpu")
    singles = [DeviceChallenger((), "cpu") for _ in range(3)]
    for vs in values:
        batched.observe(gl.from_u64(vs, "cpu"))
        for c, v in zip(singles, vs):
            c.observe(gl.from_u64(v, "cpu"))
    got = [_ints(batched.sample_ext())] + [batched.sample_many_bits(13, 5).tolist()]
    for b, c in enumerate(singles):
        e = c.sample_ext()
        assert [got[0][0][b], got[0][1][b]] == _ints(e)
        assert got[1][b] == c.sample_many_bits(13, 5).tolist()


# ------------------------------------------------------------ prover stages

STAGE_FC = (1, 8, 2)


@pytest.fixture(scope="module")
def stages():
    """The JAX TpuProver's stage outputs at fib(16), on seeded challenges,
    beside the port's TorchProver of the same shape."""
    r = random.Random(16)
    jp = TpuProver(JFibonacciAir(), 4, JFriConfig(*STAGE_FC))
    tp = TorchProver(FibonacciAir(), 4, FriConfig(*STAGE_FC), device="cpu")
    cols = jgl.from_u64(np.asarray(fibonacci_trace(16), dtype=np.uint64).T)
    s = {"jp": jp, "tp": tp, "cols": cols, "alpha": _jext(r),
         "zeta": _jext(r), "alpha_fri": _jext(r), "beta": _jext(r)}
    from plonky25_tpu.verifier import _publics_device

    s["trace_rows"] = jp._commit_trace_fn(cols)                   # (N, W)
    s["q_evals"] = jp._quotient_fn(cols, s["alpha"], _publics_device(jp.air))
    s["q_rows"] = jp._commit_chunks_fn(s["q_evals"])
    s["opened"] = jp._opened_fn(cols, s["q_evals"], s["zeta"])
    s["ro"] = jp._ro_fn(s["trace_rows"], s["q_rows"], *s["opened"],
                        s["zeta"], s["alpha_fri"])
    return s


def _b1(x):
    """A JAX value as a port value with a leading proof axis of 1."""
    return from_jax(x, "cpu")[None]


def _rows(x):
    """The port's column-major (1, C, N) as JAX's row-major (N, C)."""
    return np.asarray(_ints(x[0]), dtype=object).T.tolist()


def test_stage_commit_trace(stages):
    got = stages["tp"]._commit_trace_fn(_b1(stages["cols"]))
    assert _rows(got) == _ints(stages["trace_rows"])


def test_stage_quotient(stages):
    got = stages["tp"]._quotient_fn(_b1(stages["cols"]), _b1(stages["alpha"]))
    assert _ints(got[0]) == _ints(stages["q_evals"])


def test_stage_commit_chunks(stages):
    got = stages["tp"]._commit_chunks_fn(_b1(stages["q_evals"]))
    assert _rows(got) == _ints(stages["q_rows"])


def test_stage_opened(stages):
    got = stages["tp"]._opened_fn(_b1(stages["cols"]), _b1(stages["q_evals"]),
                                  _b1(stages["zeta"]))
    assert [_ints(g[0]) for g in got] == [_ints(w) for w in stages["opened"]]


def test_stage_reduced_openings(stages):
    tl, tn, qc = (_b1(v) for v in stages["opened"])
    trace = from_jax(stages["trace_rows"], "cpu")
    q = from_jax(stages["q_rows"], "cpu")
    got = stages["tp"]._ro_fn(
        gl.GL(trace.lo.T[None], trace.hi.T[None]),
        gl.GL(q.lo.T[None], q.hi.T[None]), tl, tn, qc,
        _b1(stages["zeta"]), _b1(stages["alpha_fri"]))
    assert _ints(got[0]) == _ints(stages["ro"])


@pytest.mark.parametrize("log_folded", [4, 1])
def test_stage_fold_phase(stages, log_folded):
    u = stages["ro"][:2 << log_folded]
    j_rows, j_e0, j_e1 = stages["jp"]._fold_phase_raw(log_folded)[0](u)
    j_next = stages["jp"]._fold_phase_raw(log_folded)[1](j_e0, j_e1,
                                                         stages["beta"])
    rows_fn, step_fn = stages["tp"]._fold_phase_raw(log_folded)
    rows, e0, e1 = rows_fn(_b1(u))
    assert _rows(rows) == _ints(j_rows)
    assert _ints(step_fn(e0, e1, _b1(stages["beta"]))[0]) == _ints(j_next)


def test_stage_grind_window(stages):
    """JAX TpuProver._grind_fn's (found, offset) on this window is computed
    once by scripts/make_torch_fixtures.py (tests/fixtures/
    torch_tests_jax_values.json, "grind")."""
    base = 1 << 16
    rest = [random.Random(base).randrange(P) for _ in range(11)]
    with open(os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_tests_jax_values.json")) as f:
        want = json.load(f)["grind"]
    assert (want["base"], want["rest"]) == (base, rest)
    found, off = want["found"], want["offset"]
    t_found, t_off = stages["tp"]._grind_fn(gl.from_u64([rest], "cpu"), base)
    assert bool(t_found[0]) == bool(found) and int(t_off[0]) == int(off)


# ------------------------------------------------------------ device tables


def test_selector_tables_match_host_lists():
    tp = TorchProver(FibonacciAir(), 5, FriConfig(1, 2, 1), device="cpu")
    h, g_t = 32, Gl.two_adic_generator(5)
    xs = [7 * pow(tp.g_q, j, P) % P for j in range(32)]
    zh = [(pow(x, h, P) - 1) % P for x in xs]
    first = [z * Gl.inv((x - 1) % P) % P for x, z in zip(xs, zh)]
    last = [z * Gl.inv((x - Gl.inv(g_t)) % P) % P for x, z in zip(xs, zh)]
    trans = [(x - Gl.inv(g_t)) % P for x in xs]
    got = [_ints(t) for t in tp.selectors()]
    assert got == [first, last, trans, [Gl.inv(z) for z in zh]]


def test_ro_points_match_host_list():
    tp = TorchProver(FibonacciAir(), 5, FriConfig(1, 2, 1), device="cpu")
    g = Gl.two_adic_generator(6)
    assert _ints(tp.ro_points()) == [7 * pow(g, reverse_bits_len(i, 6), P) % P
                                     for i in range(64)]


@pytest.mark.parametrize("log_folded", [1, 5])
def test_fold_tables_match_host_lists(log_folded):
    tp = TorchProver(FibonacciAir(), 5, FriConfig(1, 2, 1), device="cpu")
    tp._fold_phase_raw(log_folded)
    _, _, x0, den_inv = tp._fold_cache[log_folded]
    g = Gl.two_adic_generator(log_folded + 1)
    want = [pow(g, reverse_bits_len(2 * j, log_folded + 1), P)
            for j in range(1 << log_folded)]
    assert _ints(x0) == want
    assert _ints(den_inv) == [Gl.inv((P - 2 * x) % P) for x in want]


# ------------------------------------------------------------ whole proofs


def test_prove_fib64_is_byte_equal_to_fixture():
    proof = prove(FibonacciAir(), fibonacci_trace(64), FriConfig(1, 100, 16),
                  device="cpu")
    with open(FIXTURE) as f:
        assert _compact(proof_to_json(proof)) == f.read()


@pytest.mark.parametrize("height, fc", [(16, (1, 8, 2)), (32, (1, 16, 4))])
def test_prove_matches_refimpl_live(height, fc):
    trace = fibonacci_trace(height)
    want = ref_prove(JFibonacciAir(), trace, JFriConfig(*fc))
    got = prove(FibonacciAir(), trace, FriConfig(*fc), device="cpu")
    assert _compact(proof_to_json(got)) == _compact(j_proof_to_json(want))


def test_batch_prover_with_a_tampered_lane():
    """B=3, lane 1's trace tampered (tests/test_batch_prover.py:34-49):
    every lane's proof equals the oracle's for its trace (the single
    prover's, by test_prove_matches_refimpl_live); the valid lanes verify,
    the tampered one fails its quotient check only, in the port's verifier
    and the oracle's."""
    fc = (1, 8, 2)
    bad = [list(r) for r in fibonacci_trace(16)]
    bad[10][2] = (bad[10][2] + 1) % P
    traces = [fibonacci_trace(16), bad, fibonacci_trace(16)]
    proofs = BatchProver(FibonacciAir(), 4, FriConfig(*fc),
                         device="cpu").prove(traces)
    for trace, proof in zip(traces, proofs):
        oracle = ref_prove(JFibonacciAir(), trace, JFriConfig(*fc))
        assert _compact(proof_to_json(proof)) == _compact(j_proof_to_json(oracle))
    verdicts = [verify_proof(p, FibonacciAir(), FriConfig(*fc), device="cpu")
                for p in proofs]
    assert [bool(v.ok) for v in verdicts] == [True, False, True]
    assert [bool(verdicts[1].pow_ok), bool(verdicts[1].merkle_ok),
            bool(verdicts[1].fold_ok), bool(verdicts[1].quotient_ok)] == \
        [True, True, True, False]
    from plonky25_tpu.proof import proof_from_json

    assert [ref_verify(proof_from_json(proof_to_json(p)), JFibonacciAir(),
                       JFriConfig(*fc)).ok for p in proofs] == [True, False, True]
