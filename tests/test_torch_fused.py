"""The port's fused single-proof verification (TorchVerifier._verify_all_fn
run as one utils/graphs.py StaticProgram: `verify(proof, fused=True)`,
`verify_witness_fused`, `_s_all`) against its staged path
(`verify_witnesses`) and the JAX package's values, bit for bit (tolerance
0: every value is an integer).

On the CPU the program calls the function on its static buffers, so these
tests exercise the load, run and clone protocol: stale inputs, held
results and publics through the buffers.  The JAX verifier's fused values
(its verify_witness_fused and `_s_all` samples on the fixture proof and
its PoW tamper) are committed under `fused` in
tests/fixtures/torch_tests_jax_values.json (`python
scripts/make_torch_fixtures.py fused`, ~40 s), so this file imports no
JAX; the cases marked `cuda` capture and replay the graph on a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_fused.py
"""

import copy
import hashlib
import inspect
import json
import os

import pytest
import torch

import plonky25_torch.attest as attest_mod
from plonky25_torch.constants import GOLDILOCKS_P as P
from plonky25_torch.fields import gl
from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.ops import poseidon2
from plonky25_torch.proof import (FriConfig, derive_config, load_proof,
                                  proof_to_json)
from plonky25_torch.prover import prove
from plonky25_torch.utils import graphs, profiling
from plonky25_torch.utils.tree import tree_map
from plonky25_torch.verifier import (TorchVerifier, _publics, fused_default,
                                     get_verifier)
from plonky25_torch.witness import pack_witness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FC = FriConfig(1, 100, 16)
FLAGS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok")
TAMPERS = ("pow", "merkle_sibling", "fold_sibling", "final_poly")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_verifier.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def _ext(x):
    return [int(gl.to_u64(x.c0)), int(gl.to_u64(x.c1))]


def _fields(r):
    """A VerifyResult as plain values: the flags, alpha, zeta, indices."""
    out = {k: bool(getattr(r, k)) for k in FLAGS}
    out.update(alpha=_ext(r.alpha), zeta=_ext(r.zeta),
               query_indices=r.query_indices.tolist())
    return out


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
    return p


def _staged(v, proof):
    """The staged path's fields and samples of one proof."""
    w = pack_witness(proof, v.config, v.device)
    r = tree_map(lambda a: a[0],
                 v.verify_witnesses(tree_map(lambda a: a[None], w)))
    fields = {k: bool(r[k]) for k in FLAGS}
    fields.update(alpha=_ext(r["alpha"]), zeta=_ext(r["zeta"]),
                  query_indices=r["index"].tolist())
    return fields, gl.to_u64(r["samples"]).tolist()


def _fused_samples(v, proof, air):
    w = pack_witness(proof, v.config, v.device)
    return gl.to_u64(v._s_all(w, _publics(air, v.device))["samples"]).tolist()


class PublicFibonacciAir(FibonacciAir):
    """FibonacciAir with its first-row value a public value: the same
    constraints, and so the same quotient, when the public is 1.  (The
    port's FibonacciAir has no public values.)"""

    def __init__(self, first: int):
        self.first = first

    def public_values(self):
        return {"first": self.first}

    def eval(self, folder):
        ops = folder.ops
        a, b, c = folder.main.trace_local[:3]
        na, nb, _ = folder.main.trace_next[:3]
        folder.assert_eq(ops.add(a, b), c)
        folder.when_first_row().assert_eq(folder.publics["first"], a)
        folder.when_first_row().assert_eq(ops.one(), b)
        folder.when_transition().assert_eq(na, b)
        folder.when_transition().assert_eq(nb, c)


@pytest.fixture(scope="module")
def fib():
    """The fixture proof, its config, and a verifier of its own (not the
    shared cache's) on the CPU."""
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    cfg = derive_config(proof, FC)
    return proof, cfg, TorchVerifier(FibonacciAir(), cfg, "cpu")


@pytest.fixture(scope="module")
def fib_runs(fib):
    """The fixture proof, then its PoW tamper, through one verifier: the
    fused result (held by the caller), its plain values at the time, the
    fused samples, and the staged fields and samples."""
    proof, _, v = fib
    runs = {}
    for name in ("fixture", "pow"):
        p = proof if name == "fixture" else _tamper(proof, "pow")
        held = v.verify(p, fused=True)
        runs[name] = {"held": held, "fused": _fields(held),
                      "samples": _fused_samples(v, p, FibonacciAir()),
                      "staged": _staged(v, p)}
    return runs


@pytest.mark.parametrize("name", ["fixture", "pow"])
def test_fused_equals_staged_and_jax(fib_runs, name):
    run = fib_runs[name]
    want = _json("torch_tests_jax_values.json")["fused"][name]
    staged_fields, staged_samples = run["staged"]
    assert run["fused"] == staged_fields
    assert run["fused"] == {k: want[k] for k in run["fused"]}
    assert run["samples"] == staged_samples == want["samples"]
    if name == "fixture":
        exp = _json("proof_fibonacci_expected.json")
        assert run["fused"]["alpha"] == exp["alpha"]
        assert run["fused"]["zeta"] == exp["zeta"]
        assert run["fused"]["query_indices"] == exp["query_indices"]


def test_stale_inputs_and_held_results(fib, fib_runs):
    """golden -> the tamper battery -> golden in one program: each verdict
    is the JAX verifier's, and a result held from the first call keeps
    its values."""
    proof, _, v = fib
    jax_tamper = _json("torch_tests_jax_values.json")["verifier_tamper"]
    for kind in TAMPERS:
        got = _fields(v.verify(_tamper(proof, kind), fused=True))
        assert got == {k: jax_tamper[kind][k] for k in got}, kind
        assert not got["ok"]
    again = _fields(v.verify(proof, fused=True))
    assert again == fib_runs["fixture"]["fused"] and again["ok"]
    assert _fields(fib_runs["fixture"]["held"]) == fib_runs["fixture"]["fused"]
    assert v._program is not None


def test_publics_reach_the_program(fib):
    """Two instances of one AIR class, with different public values,
    through one cached verifier: each gets its own verdict, the staged
    path's."""
    proof, cfg, _ = fib
    verdicts = []
    for first in (1, 2, 1):
        air = PublicFibonacciAir(first)
        v = get_verifier(air, cfg, "cpu")
        assert v.air is air
        fused = _fields(v.verify(proof, fused=True))
        assert fused == _staged(v, proof)[0]
        verdicts.append((fused["ok"], fused["quotient_ok"]))
    assert verdicts == [(True, True), (False, False), (True, True)]
    assert get_verifier(PublicFibonacciAir(1), cfg, "cpu")._program is not None


def test_module_caches_do_not_grow_at_a_second_call(fib, fib_runs):
    proof, _, v = fib
    before = graphs._cache_sizes()
    assert _fields(v.verify(proof, fused=True)) == fib_runs["fixture"]["fused"]
    assert graphs._cache_sizes() == before


def test_rlc64_fused_equals_staged_and_jax():
    """The multi-stage RLC proof of tests/fixtures/proof_rlc64_expected.json
    (the port's CPU proof of its trace, byte-equal to the fixture's
    digest): fused equals staged, and alpha, zeta and the indices equal
    the JAX values."""
    exp = _json("proof_rlc64_expected.json")
    fc = FriConfig(**exp["fri_config"])
    proof = prove(RlcAir(), exp["trace"], fc, device="cpu")
    text = json.dumps(proof_to_json(proof), separators=(",", ":"))
    assert hashlib.sha256(text.encode()).hexdigest() == exp["sha256"]
    v = TorchVerifier(RlcAir(), derive_config(proof, fc), "cpu")
    fused = _fields(v.verify(proof, fused=True))
    staged, samples = _staged(v, proof)
    assert fused == staged and fused["ok"]
    assert _fused_samples(v, proof, RlcAir()) == samples
    assert fused["alpha"] == exp["alpha"] and fused["zeta"] == exp["zeta"]
    assert fused["query_indices"] == exp["query_indices"]
    assert [[samples[i], samples[j]] for i, j in v.challenge_idx] \
        == exp["challenges"]


def test_device_instrumented_verify_same_on_both_paths(fib, monkeypatch):
    """The attester's sample-recording verification: staged on the CPU,
    and the fused program where fused_default says so (forced here)."""
    proof = fib[0]
    staged = attest_mod._device_instrumented_verify(proof, FibonacciAir(),
                                                    FC, "cpu")
    monkeypatch.setattr(attest_mod, "fused_default", lambda device: True)
    fused = attest_mod._device_instrumented_verify(proof, FibonacciAir(), FC,
                                                   "cpu")
    want = _json("torch_tests_jax_values.json")["fused"]["fixture"]
    assert fused == staged == (True, want["samples"])


def test_fused_default_and_signatures():
    from plonky25_tpu.verifier import TpuVerifier

    assert fused_default("cuda") and fused_default(torch.device("cuda", 0))
    assert not fused_default("cpu") and not fused_default(torch.device("cpu"))
    for name in ("verify", "verify_witness_fused", "_verify_all_fn"):
        mine = inspect.signature(getattr(TorchVerifier, name)).parameters
        theirs = inspect.signature(getattr(TpuVerifier, name)).parameters
        assert [(p.name, p.default) for p in mine.values()] == \
            [(p.name, p.default) for p in theirs.values()], name


def test_static_program_protocol():
    """StaticProgram on the CPU: inputs copied into its own buffers, the
    outputs cloned, a template of another shape refused."""
    calls = []

    def fn(x, d):
        calls.append((x, d["y"]))
        return {"s": x + d["y"], "x": x}

    a = torch.arange(4)
    prog = graphs.StaticProgram(fn, (a, {"y": a}), "cpu")
    out1 = prog(a, {"y": torch.ones(4, dtype=a.dtype)})
    out2 = prog(a * 10, {"y": a})
    assert out1["s"].tolist() == [1, 2, 3, 4] and out1["x"].tolist() == a.tolist()
    assert out2["s"].tolist() == [0, 11, 22, 33]
    assert all(x is prog.inputs[0] for x, _ in calls)
    assert out2["x"] is not prog.inputs[0]
    with pytest.raises(ValueError):
        prog(torch.arange(5), {"y": a})
    with pytest.raises(ValueError):
        prog(a, {"z": a})


# ------------------------------------------------------------ on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph of the kernels)")


@pytest.mark.cuda
def test_graph_replay_matches_staged_on_the_card():
    _card()
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    v = TorchVerifier(FibonacciAir(), derive_config(proof, FC), "cuda")
    exp = _json("proof_fibonacci_expected.json")
    for p in (proof, _tamper(proof, "pow"), proof):
        fused = _fields(v.verify(p, fused=True))
        assert fused == _staged(v, p)[0]
        assert fused["ok"] == (p is proof)
        if p is proof:
            assert fused["query_indices"] == exp["query_indices"]
    assert _fused_samples(v, proof, FibonacciAir()) == _staged(v, proof)[1]
    stats = v._program.stats
    assert stats["capture_ms"] > 0 and stats["pool_bytes"] >= 0


@pytest.mark.cuda
def test_launches_per_replay_on_the_card():
    """Each replay counts the state-major launches the capture saw: the
    transcript's duplexes, the fused Merkle walk, the fold's hash and
    walk (32 for the fixture proof, 5,817 states: chip_smoke.py's
    verify_path_shapes(v, 1)), as the staged path does, none of them
    lane-major."""
    _card()
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    v = TorchVerifier(FibonacciAir(), derive_config(proof, FC), "cuda")
    v.verify(proof, fused=True)                    # warm-up and capture
    aos, soa = profiling.AOS, profiling.SOA
    ok, staged = profiling.counted(
        lambda: bool(v.verify(proof, fused=False).ok))
    assert ok and (staged[aos], staged[aos + ".states"]) == (32, 5817)
    for _ in range(2):
        ok, got = profiling.counted(
            lambda: bool(v.verify(proof, fused=True).ok))
        assert ok and got == staged
        assert got[soa] == got[soa + ".states"] == 0


@pytest.mark.cuda
def test_no_host_copy_or_build_during_a_capture():
    _card()
    from plonky25_torch.ops import build

    poseidon2.load_kernels()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(g):
            gl.from_u64([1, 2, P + 3], "cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(g):
            build.build_many(["poseidon2"])
