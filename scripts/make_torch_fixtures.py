"""Write the fixtures that hold the PyTorch port against the JAX package.

    python scripts/make_torch_fixtures.py [group ...]

Writes, into tests/fixtures/ (every group by default):

  proof_fibonacci_refimpl.json   the fib(64) proof of the pure-int prover,
      prove(FibonacciAir(), fibonacci_trace(64), FriConfig(1, 100, 16)) —
      the output that tests/test_refimpl_prover.py holds byte-equal to the
      reference's Rust artifact;
  proof_fibonacci_expected.json  what the JAX package (on the CPU) and its
      int oracle derive from that proof: alpha, zeta, the FRI betas, the
      query indices and the verdict fields, plus Poseidon2 known answers;
  proof_fibonacci8192_expected.json  the pure-int prover's fib(2^13) proof
      at the same FriConfig (its LDE has 2^14 points, the JAX package's
      six-step threshold), held by its digest: the sha256 of its compact
      JSON, the trace, quotient and FRI phase commitments, alpha, zeta, the
      PoW witness and the query indices (tests/test_tpu_prover.py and
      tests/test_refimpl_prover.py hold the JAX device prover and the
      pure-int one byte-equal).  Proving fib(2^13) in pure Python took
      176 s of the script's 263 s on the CPU (PoW grind included);
  proof_rlc64_expected.json, proof_multiset64_expected.json  the
      pure-int prover's proofs of RlcAir and MultisetAir on seeded 64-row
      traces (kept in the files) at FriConfig(1, 100, 16), cross-checked
      against the JAX device prover (TpuProver) and verifier: the sha256 of
      the compact JSON, the trace, stage-2, quotient and FRI phase
      commitments, the stage-2 challenges, alpha, zeta, the PoW witness,
      the query indices and the verdict (398 s of the script's time on
      the CPU, the JAX device prover's check included);
  mmcs_multi_height.json  a mixed-height MMCS commitment of the int
      oracle (refimpl.commit.build_mmcs_tree) over five seeded matrices of
      heights 2^12, 2^12, 2^6, 2^3, 1 and widths 3, 2, 4, 5, 1, with the
      openings (open_mmcs) at 100 seeded indices, each accepted by
      refimpl.commit.verify_batch;
  proof_keccak32_refimpl.json  (group `keccak`) the int oracle's
      one-keccak-f KeccakAir proof of tests/test_keccak.py:58-64 (32 rows
      x 2,633 columns, seed 21, FriConfig(1, 20, 8)), written by
      save_proof (2,067,930 bytes);
  proof_keccak32_expected.json  what the JAX verify_proof and the oracle
      derive from it (alpha, zeta, the FRI betas, the query indices, the
      verdict) and from its a_prime-bit tamper (the verdict fields, the
      oracle's verdict); 1,773 bytes.  The group took 292.8 s on the CPU
      sandbox, most of it the oracle's proof;
  proof_keccak_expected.json  (group `keccak_digest`) the JAX device
      prover's (TpuProver) KeccakAir proof at FriConfig(1, 100, 16) of
      2^12 rows x 2,633 columns (170 seeded permutations), held by its
      digest: the seeded inputs, the
      sha256 of its compact JSON, the commitments, alpha, zeta, the PoW
      witness and the query indices (from the JAX verifier's transcript);
      89,069 bytes.  TpuProver took 3,255.8 s for it on the CPU sandbox
      (shared with other jobs; most of it XLA compiling the reduced-
      opening stage), above the 20 minutes aimed at, and the full height
      was kept (a trial at 2^8 rows took 741 s);
  attest_expected.json  (group `attest`) what the JAX attestation
      machinery derives where it runs JAX code (XLA would compile in the
      port's tests): poseidon2_core_rows of 16 seeded states (seed 16, as
      sha256 of the row-major uint64 bytes), and for the schedules of
      artifacts/attestation_small.json's proofs (fib(8) alone, fib(8) +
      fib(16)) and of tests/test_attest_multistage.py's 16-row RlcAir
      proof (seed 11, FriConfig(1, 2, 1)): derive_gammas, fold_accumulator,
      the recorded samples and the sha256 of build_trace_rowmajor;
  composed_expected.json  (group `composed`) what the JAX package derives,
      on the CPU and without proving any STARK, for the composed (depth-2)
      attestations: for the small composition (artifacts/
      attestation_small.json's fib(8) proof and its `bundle` as the inner
      attestation), for attest_attestation of that bundle, and for the
      golden composition (the fib(64) fixture proof and artifacts/
      attestation_fibonacci.json): the outer samples (the int oracle's
      recording of the inner STARK's verification), n_rows, the sha256 of
      the outer schedule's canonical slots and of its pair stream
      (schedule_digests), the outer gammas and accumulator, the statement
      (composed_statement_digest, or statement_digest at the outer
      config for attest_attestation) and the target shape;
  torch_tests_jax_values.json  (group `jax_values`) JAX results that
      tests/test_torch_verifier.py, test_torch_multistage.py and
      test_torch_prover.py compare with (see jax_values below); 13,638
      bytes, 202.4 s.  Group `parallel` adds, in the same file, the JAX
      package's multi-device results on 8 virtual CPU devices that
      tests/test_torch_parallel.py and test_torch_four_step.py compare
      with (see parallel below), group `api_gaps` the JAX values of
      tests/test_torch_api_gaps.py (see api_gaps below), and group `fused`
      those of the JAX one-dispatch fused verification that
      tests/test_torch_fused.py compares with (see fused below), group
      `gamma_programs` the JAX gammas of tests/test_torch_gamma_programs.py's
      seeded pair streams (see gamma_programs below).

`chip_smoke.py` and the port's tests read these files, so the port can be
checked on a machine without JAX.  This script may import plonky25_tpu; the
port never does.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import os
import random
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# 8 virtual CPU devices for the `parallel` group's meshes (tests/conftest.py
# gives the JAX tests the same); the other groups use one device
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

from plonky25_tpu.constants import GOLDILOCKS_P as P  # noqa: E402
from plonky25_tpu.fields import gl  # noqa: E402
from plonky25_tpu.models.fibonacci import (  # noqa: E402
    FibonacciAir,
    fibonacci_trace,
)
from plonky25_tpu.models.keccak_air import (  # noqa: E402
    KeccakAir,
    keccak_trace,
    keccak_trace_np,
)
from plonky25_tpu.models.multiset_air import (  # noqa: E402
    MultisetAir,
    pad_pairs,
)
from plonky25_tpu.models.rlc_air import RlcAir  # noqa: E402
from plonky25_tpu.parallel.batch import BatchVerifier  # noqa: E402
from plonky25_tpu.proof import (  # noqa: E402
    FriConfig,
    derive_config,
    proof_from_json,
    proof_to_json,
    save_proof,
)
from plonky25_tpu.prover.prove import TpuProver  # noqa: E402
from plonky25_tpu.refimpl.commit import (  # noqa: E402
    build_mmcs_tree,
    open_mmcs,
)
from plonky25_tpu.refimpl.commit import (  # noqa: E402
    verify_batch as commit_verify_batch,
)
from plonky25_tpu.refimpl.poseidon2 import poseidon2  # noqa: E402
from plonky25_tpu.refimpl.prover import prove  # noqa: E402
from plonky25_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plonky25_tpu.verifier import get_verifier, verify_proof  # noqa: E402
from plonky25_tpu.witness import pack_witness  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures")
FC = FriConfig(log_blowup=1, num_queries=100, proof_of_work_bits=16)


def _known_answer_states():
    """Poseidon2 inputs: zero, counting, edge values and seeded randoms."""
    rng = random.Random(0x5EED)
    edge = [0, 1, P - 1, 1 << 32, 0xFFFFFFFF, (0xFFFFFFFF << 32) % P]
    return [
        [0] * 12,
        list(range(12)),
        [edge[i % len(edge)] for i in range(12)],
        [P - 1] * 12,
        [rng.randrange(P) for _ in range(12)],
        [rng.randrange(P) for _ in range(12)],
    ]


def fibonacci():
    air = FibonacciAir()
    proof = prove(air, fibonacci_trace(64), FC)
    proof_path = os.path.join(OUT, "proof_fibonacci_refimpl.json")
    with open(proof_path, "w") as f:
        json.dump(proof_to_json(proof), f, separators=(",", ":"))

    ref = ref_verify(proof, air, FC)
    r = verify_proof(proof, air, FC)
    assert bool(r.ok) and ref.ok
    jax_indices = [int(v) for v in np.asarray(r.query_indices)]
    assert jax_indices == ref.query_indices
    assert (int(gl.to_u64(r.alpha.c0)), int(gl.to_u64(r.alpha.c1))) == ref.alpha
    assert (int(gl.to_u64(r.zeta.c0)), int(gl.to_u64(r.zeta.c1))) == ref.zeta

    states = _known_answer_states()
    expected = {
        "fri_config": {"log_blowup": FC.log_blowup,
                       "num_queries": FC.num_queries,
                       "proof_of_work_bits": FC.proof_of_work_bits},
        "alpha": list(ref.alpha),
        "zeta": list(ref.zeta),
        "alpha_fri": list(ref.alpha_fri),
        "betas": [list(b) for b in ref.betas],
        "query_indices": jax_indices,
        "verdict": {k: bool(np.asarray(getattr(r, k))) for k in
                    ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok",
                     "shape_ok")},
        "poseidon2_known_answers": [
            {"input": s, "output": poseidon2(s)} for s in states],
    }
    exp_path = os.path.join(OUT, "proof_fibonacci_expected.json")
    with open(exp_path, "w") as f:
        json.dump(expected, f, indent=1)
    t1 = time.time()
    big = prove(air, fibonacci_trace(1 << 13), FC)
    big_text = json.dumps(proof_to_json(big), separators=(",", ":"))
    ref_big = ref_verify(big, air, FC)
    assert ref_big.ok
    fp = big.opening_proof.fri_proof
    expected_8192 = {
        "height": 1 << 13,
        "fri_config": expected["fri_config"],
        "bytes": len(big_text),
        "sha256": hashlib.sha256(big_text.encode()).hexdigest(),
        "trace_commit": big.commitments.trace.value,
        "quotient_commit": big.commitments.quotient_chunks.value,
        "phase_commits": [c.value for c in fp.commit_phase_commits],
        "alpha": list(ref_big.alpha),
        "zeta": list(ref_big.zeta),
        "pow_witness": fp.pow_witness,
        "query_indices": ref_big.query_indices,
    }
    big_path = os.path.join(OUT, "proof_fibonacci8192_expected.json")
    with open(big_path, "w") as f:
        json.dump(expected_8192, f, indent=1)
    print(f"fib(2^13) took {time.time() - t1:.1f} s")
    return [proof_path, exp_path, big_path]


def rlc_trace():
    """The seeded 64-row RlcAir trace: two columns of field values."""
    rng = np.random.default_rng(0x41C)
    return rng.integers(0, P, size=(64, 2), dtype=np.uint64).tolist()


def multiset_trace():
    """The seeded 64-row MultisetAir trace: side A tags 1..64 with seeded
    values, side B a seeded permutation of side A."""
    rng = np.random.default_rng(0x5E7)
    values = rng.integers(0, P, size=64, dtype=np.uint64).tolist()
    side_a = [(i + 1, v) for i, v in enumerate(values)]
    side_b = [side_a[j] for j in rng.permutation(64).tolist()]
    return pad_pairs(side_a, side_b)


def _deep_eq(a, b):
    if dataclasses.is_dataclass(a):
        return all(_deep_eq(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_deep_eq(x, y) for x, y in zip(a, b))
    return a == b


def _ext(x):
    return [int(gl.to_u64(x.c0)), int(gl.to_u64(x.c1))]


def multistage_expected(air, trace, name):
    """Prove with the int oracle, cross-check with the JAX device prover
    and both verifiers, and write the digest file."""
    proof = prove(air, trace, FC)
    assert _deep_eq(TpuProver(air, 6, FC).prove(trace), proof)
    text = json.dumps(proof_to_json(proof), separators=(",", ":"))
    ref = ref_verify(proof, air, FC)
    r = verify_proof(proof, air, FC)
    assert ref.ok and bool(r.ok)
    indices = [int(v) for v in np.asarray(r.query_indices)]
    assert indices == ref.query_indices
    assert _ext(r.alpha) == list(ref.alpha) and _ext(r.zeta) == list(ref.zeta)
    v = get_verifier(air, derive_config(proof, FC))
    t = v._s_transcript(pack_witness(proof, v.config)["obs"])
    fp = proof.opening_proof.fri_proof
    expected = {
        "air": air.name(),
        "height": len(trace),
        "fri_config": {"log_blowup": FC.log_blowup,
                       "num_queries": FC.num_queries,
                       "proof_of_work_bits": FC.proof_of_work_bits},
        "trace": [[int(x) for x in row] for row in trace],
        "bytes": len(text),
        "sha256": hashlib.sha256(text.encode()).hexdigest(),
        "trace_commit": proof.commitments.trace.value,
        "stage2_commit": proof.commitments.stage2.value,
        "quotient_commit": proof.commitments.quotient_chunks.value,
        "phase_commits": [c.value for c in fp.commit_phase_commits],
        "challenges": [_ext(c) for c in t["challenges"]],
        "alpha": list(ref.alpha),
        "zeta": list(ref.zeta),
        "pow_witness": fp.pow_witness,
        "query_indices": indices,
        "verdict": {k: bool(np.asarray(getattr(r, k))) for k in
                    ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok",
                     "shape_ok")},
    }
    path = os.path.join(OUT, f"proof_{name}64_expected.json")
    with open(path, "w") as f:
        json.dump(expected, f, indent=1)
    return path


def multistage():
    return [multistage_expected(RlcAir(), rlc_trace(), "rlc"),
            multistage_expected(MultisetAir(), multiset_trace(), "multiset")]


MMCS_HEIGHTS = [1 << 12, 1 << 12, 1 << 6, 1 << 3, 1]
MMCS_WIDTHS = [3, 2, 4, 5, 1]


def mmcs():
    """A mixed-height commitment and 100 openings, all accepted."""
    rng = random.Random(0x3C5)
    mats = [[[rng.randrange(P) for _ in range(w)] for _ in range(h)]
            for h, w in zip(MMCS_HEIGHTS, MMCS_WIDTHS)]
    root, levels = build_mmcs_tree(mats)
    indices = [rng.randrange(MMCS_HEIGHTS[0]) for _ in range(100)]
    dims = [(w, h) for h, w in zip(MMCS_HEIGHTS, MMCS_WIDTHS)]
    opened, paths = [], []
    for ix in indices:
        o, pr = open_mmcs(mats, levels, ix)
        assert commit_verify_batch(root, dims, ix, o, pr)
        opened.append(o)
        paths.append(pr)
    path = os.path.join(OUT, "mmcs_multi_height.json")
    with open(path, "w") as f:
        json.dump({"heights": MMCS_HEIGHTS, "widths": MMCS_WIDTHS,
                   "root": root, "indices": indices, "opened": opened,
                   "paths": paths}, f, separators=(",", ":"))
    return [path]


FC_KECCAK = FriConfig(log_blowup=1, num_queries=20, proof_of_work_bits=8)
VERDICT_FIELDS = ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok",
                  "shape_ok")


def _verdict(r):
    return {k: bool(np.asarray(getattr(r, k))) for k in VERDICT_FIELDS}


def _fc_json(fc):
    return {"log_blowup": fc.log_blowup, "num_queries": fc.num_queries,
            "proof_of_work_bits": fc.proof_of_work_bits}


def keccak():
    """The int oracle's one-keccak-f proof of tests/test_keccak.py:58-64
    (32 rows, seed 21, FriConfig(1, 20, 8)), and what the JAX verifier and
    the oracle derive from it and from its a_prime-bit tamper."""
    air = KeccakAir()
    rng = random.Random(21)
    inp = [rng.getrandbits(64) for _ in range(25)]
    rows = keccak_trace([inp])
    assert np.array_equal(np.asarray(rows, dtype=np.int64),
                          keccak_trace_np([inp]))
    proof = prove(air, rows, FC_KECCAK)
    proof_path = os.path.join(OUT, "proof_keccak32_refimpl.json")
    save_proof(proof, proof_path)
    with open(proof_path) as f:
        text = f.read()
    assert text == json.dumps(proof_to_json(proof), separators=(",", ":"))
    ref = ref_verify(proof, air, FC_KECCAK)
    r = verify_proof(proof, air, FC_KECCAK)
    assert ref.ok and bool(r.ok)
    indices = [int(v) for v in np.asarray(r.query_indices)]
    assert indices == ref.query_indices
    assert _ext(r.alpha) == list(ref.alpha) and _ext(r.zeta) == list(ref.zeta)
    # tests/test_keccak.py:91-99: an a_prime bit column's opening at zeta
    bad = copy.deepcopy(proof)
    v = bad.opened_values.trace_local[865 + 77]
    bad.opened_values.trace_local[865 + 77] = ((v[0] + 1) % P, v[1])
    ref_bad = ref_verify(bad, air, FC_KECCAK)
    r_bad = verify_proof(bad, air, FC_KECCAK)
    assert not ref_bad.ok and not bool(r_bad.ok)
    expected = {
        "inputs": inp,
        "height": len(rows),
        "fri_config": _fc_json(FC_KECCAK),
        "bytes": len(text),
        "sha256": hashlib.sha256(text.encode()).hexdigest(),
        "alpha": list(ref.alpha),
        "zeta": list(ref.zeta),
        "alpha_fri": list(ref.alpha_fri),
        "betas": [list(b) for b in ref.betas],
        "query_indices": indices,
        "verdict": _verdict(r),
        "tamper_a_prime_bit": {"index": 865 + 77, "verdict": _verdict(r_bad),
                               "oracle_ok": ref_bad.ok},
    }
    exp_path = os.path.join(OUT, "proof_keccak32_expected.json")
    with open(exp_path, "w") as f:
        json.dump(expected, f, indent=1)
    return [proof_path, exp_path]


KECCAK_LOG_N = 12


def keccak_inputs(log_n):
    """The seeded inputs of the full-width Keccak proof: as many whole
    permutations as 2^log_n rows hold (170 at 2^12: 4,080 round rows and a
    truncated dummy permutation on the zero state as padding).  The
    fixture keeps them, and chip_smoke.py proves them."""
    rng = np.random.default_rng(0xCECC + log_n)
    n = (1 << log_n) // 24
    return rng.integers(0, 1 << 64, size=(n, 25), dtype=np.uint64,
                        endpoint=False).tolist()


def keccak_digest():
    """The JAX device prover's (TpuProver) KeccakAir proof of 2^12 rows at
    FriConfig(1, 100, 16), held by its digest: the sha256 of its compact
    JSON, the commitments, and the JAX verifier's transcript values."""
    air, log_n = KeccakAir(), KECCAK_LOG_N
    inputs = keccak_inputs(log_n)
    rows = keccak_trace_np(inputs, 1 << log_n)
    assert rows.shape == (1 << log_n, air.width())
    t0 = time.time()
    proof = TpuProver(air, log_n, FC).prove(rows)
    print(f"TpuProver proved 2^{log_n} x {air.width()} in "
          f"{time.time() - t0:.1f} s")
    text = json.dumps(proof_to_json(proof), separators=(",", ":"))
    cfg = derive_config(proof, FC)
    v = get_verifier(air, cfg)
    t = v._s_transcript(pack_witness(proof, cfg)["obs"])
    fp = proof.opening_proof.fri_proof
    expected = {
        "height": 1 << log_n,
        "fri_config": _fc_json(FC),
        "inputs": inputs,
        "bytes": len(text),
        "sha256": hashlib.sha256(text.encode()).hexdigest(),
        "trace_commit": proof.commitments.trace.value,
        "quotient_commit": proof.commitments.quotient_chunks.value,
        "phase_commits": [c.value for c in fp.commit_phase_commits],
        "alpha": _ext(t["alpha"]),
        "zeta": _ext(t["zeta"]),
        "pow_witness": fp.pow_witness,
        "query_indices": [int(i) for i in np.asarray(t["index"])],
    }
    path = os.path.join(OUT, "proof_keccak_expected.json")
    with open(path, "w") as f:
        json.dump(expected, f, separators=(",", ":"))
    return [path]


def _j_fields(r):
    out = _verdict(r)
    if r.shape_ok:
        out["alpha"] = _ext(r.alpha)
        out["zeta"] = _ext(r.zeta)
        out["query_indices"] = [int(i) for i in np.asarray(r.query_indices)]
    return out


def _fib_tamper(proof, kind):
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


def _rlc_trace_16():
    """tests/test_torch_multistage.py's _trace(7): 16 seeded rows."""
    rng = random.Random(7)
    return [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
            for _ in range(16)]


def jax_values():
    """JAX results that the port's tests compare with, computed once here
    instead of compiling JAX modules in every test run:

      verifier   tests/test_torch_verifier.py's three proofs (the fib(64)
                 fixture and artifacts/attestation_small.json's two): the
                 JAX verify_proof fields, the transcript's samples, pow_ok
                 and indices, the FRI betas and query indices, and the
                 verify_proof fields of the fixture's four tampers;
      rlc_batch  tests/test_torch_multistage.py's BatchVerifier lanes (the
                 oracle's RLC proof of _trace(7) at FriConfig(1, 8, 4),
                 then the same with stage2_local[0] changed): the JAX
                 BatchVerifier's verdicts;
      grind      tests/test_torch_prover.py's grind window (base 2^16,
                 FriConfig(1, 8, 2)): JAX TpuProver._grind_fn's (found,
                 first offset)."""
    out = {"verifier": {}, "verifier_tamper": {}}
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        blob = json.load(f)
    with open(os.path.join(OUT, "proof_fibonacci_refimpl.json")) as f:
        cases = {"fixture": (json.load(f), _fc_json(FC))}
    cases["small0"] = (blob["proofs"][0], blob["fc"])
    cases["small1"] = (blob["proofs"][1], blob["fc"])
    air = FibonacciAir()
    for name, (obj, fc) in cases.items():
        proof, fc = proof_from_json(obj), FriConfig(**fc)
        cfg = derive_config(proof, fc)
        v = get_verifier(air, cfg)
        t = v._s_transcript(pack_witness(proof, cfg)["obs"])
        chal = v.fri_challenges(proof)
        out["verifier"][name] = {
            "fields": _j_fields(verify_proof(proof, air, fc)),
            "samples": [int(x) for x in gl.to_u64(t["samples"])],
            "pow_ok": bool(t["pow_ok"]),
            "index": [int(i) for i in np.asarray(t["index"])],
            "betas": [list(b) for b in chal.betas],
            "query_indices": list(chal.query_indices),
        }
        if name == "fixture":
            for kind in ("pow", "merkle_sibling", "fold_sibling",
                         "final_poly"):
                out["verifier_tamper"][kind] = _j_fields(
                    verify_proof(_fib_tamper(proof, kind), air, fc))
    fc = FriConfig(1, 8, 4)
    proof = prove(RlcAir(), _rlc_trace_16(), fc)
    bad = copy.deepcopy(proof)
    c0, c1 = bad.opened_values.stage2_local[0]
    bad.opened_values.stage2_local[0] = ((c0 + 1) % P, c1)
    bv = BatchVerifier(RlcAir(), derive_config(proof, fc))
    out["rlc_batch"] = [bool(b) for b in np.asarray(bv.verify([proof, bad]))]
    base = 1 << 16
    rest = [random.Random(base).randrange(P) for _ in range(11)]
    jp = TpuProver(FibonacciAir(), 4, FriConfig(1, 8, 2))
    found, off = jp._grind_fn(gl.from_u64(rest), np.uint32(base))
    out["grind"] = {"base": base, "rest": rest, "found": bool(found),
                    "offset": int(off)}
    path = os.path.join(OUT, "torch_tests_jax_values.json")
    if os.path.exists(path):    # keep the other groups' values
        with open(path) as f:
            kept = json.load(f)
        for group in ("parallel", "api_gaps", "fused", "gamma_programs"):
            if group in kept:
                out[group] = kept[group]
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return [path]


def attest():
    """JAX values for tests/test_torch_attest*.py (see the docstring)."""
    import plonky25_tpu.attest as A
    import plonky25_tpu.attest_program as attp
    from plonky25_tpu.fields.goldilocks import to_u64_np
    from plonky25_tpu.models.poseidon2_air import poseidon2_core_rows

    def sha(a):
        return hashlib.sha256(
            np.ascontiguousarray(a, dtype=np.uint64).tobytes()).hexdigest()

    rng = np.random.default_rng(16)
    states = rng.integers(0, P, size=(16, 12), dtype=np.uint64)
    out = {"core_rows": {
        "seed": 16,
        "sha256": sha(to_u64_np(poseidon2_core_rows(gl.from_u64(states))))}}

    def schedule_values(proofs, air, fc):
        rows, samples = [], []
        for p in proofs:
            ch = A._RecordingChallenger()
            assert ref_verify(p, air, fc, challenger=ch).ok
            samples.append(ch.samples)
            rows += attp.build_verification_schedule(
                p, derive_config(p, fc), air, ch.samples)
        gamma = attp.derive_gammas(rows)
        return {"n_rows": len(rows), "samples": samples,
                "gamma": list(gamma),
                "acc": list(attp.fold_accumulator(rows, gamma)),
                "trace_sha256": sha(attp.build_trace_rowmajor(rows, gamma))}

    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        small = json.load(f)
    fc = FriConfig(**small["fc"])
    p1, p2 = [proof_from_json(p) for p in small["proofs"]]
    out["small"] = schedule_values([p1], FibonacciAir(), fc)
    out["multi"] = schedule_values([p1, p2], FibonacciAir(), fc)
    rng = random.Random(11)
    trace = [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
             for _ in range(16)]
    rlc_fc = FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=1)
    rlc = prove(RlcAir(), trace, rlc_fc)
    out["rlc"] = schedule_values([rlc], RlcAir(), rlc_fc)
    out["rlc"]["proof_sha256"] = hashlib.sha256(json.dumps(
        proof_to_json(rlc), separators=(",", ":")).encode()).hexdigest()
    path = os.path.join(OUT, "attest_expected.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return [path]


def schedule_digests(rows, attp):
    """sha256 of a schedule's canonical slots, each row as its slot count
    then its (slot, value) pairs, and of its pair stream, both as
    little-endian u64."""
    slots, pairs = [], []
    for r in rows:
        sl = attp.canonical_slots(r)
        slots.append(len(sl))
        for s, v in sl:
            slots += (s, v)
            pairs += (s, v)

    def sha(xs):
        return hashlib.sha256(np.asarray(xs, dtype="<u8").tobytes()).hexdigest()

    return {"slots_sha256": sha(slots), "pairs_sha256": sha(pairs)}


def composed():
    """JAX values for tests/test_torch_composed*.py and chip_smoke.py's
    composed phases (see the docstring); no STARK is proved."""
    import plonky25_tpu.attest as A
    import plonky25_tpu.attest_program as attp

    def outer_values(proof, air, fc, inner, att_fc, compose):
        t0 = time.time()
        v_air = A._verifier_air_of(inner)
        samples = A._record_verification(inner.stark, v_air,
                                         inner.att_fri_config,
                                         use_device=False)
        rows = attp.build_verification_schedule(
            inner.stark, derive_config(inner.stark, inner.att_fri_config),
            v_air, samples)
        out = {"outer_samples": samples}
        if compose:
            cfg = derive_config(proof, fc)
            inner_rows = attp.build_verification_schedule(proof, cfg, air,
                                                          inner.samples)
            comp = attp.build_compression_rows(
                len(inner_rows), attp.sequence_pairs(inner_rows),
                attp.pair_exponents(inner_rows), inner.gamma, inner.acc)
            out.update(inner_n_rows=len(inner_rows),
                       n_compression_rows=len(comp),
                       n_verification_rows=len(rows),
                       target_shape=A._target_shape_of(cfg))
            rows = rows + comp
        out["n_rows"] = len(rows)
        out["n_pairs"] = len(attp.sequence_pairs(rows))
        out.update(schedule_digests(rows, attp))
        t1 = time.time()
        gamma = attp.derive_gammas(rows)
        acc = attp.fold_accumulator(rows, gamma)
        out.update(gamma=list(gamma), acc=list(acc))
        bundle = A.AttestationBundle(
            stark=inner.stark, samples=list(samples), gamma=gamma, acc=acc,
            att_fri_config=att_fc, n_rows=len(rows))
        if compose:
            c = A.ComposedAttestation(
                outer=bundle, inner_stark=inner.stark,
                inner_gamma=tuple(inner.gamma), inner_acc=tuple(inner.acc),
                inner_samples=list(inner.samples),
                inner_n_rows=inner.n_rows, target_shape=out["target_shape"])
            out["statement"] = A.composed_statement_digest(c)
        else:
            out["statement"] = A.statement_digest(bundle, inner.stark)
        out["att_fri_config"] = _fc_json(att_fc)
        print(f"  {len(rows)} rows: schedule {t1 - t0:.1f} s, gammas and "
              f"accumulator {time.time() - t1:.1f} s")
        return out

    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        small = json.load(f)
    sfc, satt = FriConfig(**small["fc"]), FriConfig(**small["att_fc"])
    p1 = proof_from_json(small["proofs"][0])
    sb = A.bundle_from_json(small["bundle"])
    air = FibonacciAir()
    out = {"small": outer_values(p1, air, sfc, sb, satt, True),
           "attest_attestation": outer_values(p1, air, sfc, sb, satt, False)}
    with open(os.path.join(OUT, "proof_fibonacci_refimpl.json")) as f:
        golden_proof = proof_from_json(json.load(f))
    golden = A.load_bundle(os.path.join(ROOT, "artifacts",
                                        "attestation_fibonacci.json"))
    out["golden"] = outer_values(golden_proof, air, FC, golden,
                                 golden.att_fri_config, True)
    path = os.path.join(OUT, "composed_expected.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return [path]


def _batch_mesh_traces():
    """tests/torch_dist_worker.py's batch_traces(): four fib(64) traces,
    lanes 1 and 3 with one value changed each."""
    t = np.asarray([fibonacci_trace(64)] * 4, dtype=np.uint64)
    t[1, 10, 1] = (int(t[1, 10, 1]) + 1) % P
    t[3, 41, 0] = (int(t[3, 41, 0]) + 5) % P
    return t


def parallel():
    """The JAX package's multi-device results, on 8 virtual CPU devices,
    added to torch_tests_jax_values.json under `parallel`:

      sharded     ShardedVerifier over make_mesh(8) on the fixture proof:
                  Q_pad, the verdict fields, alpha, zeta and the 104 padded
                  query indices; the verdict of tests/test_sharded.py's
                  tamper (query 99's quotient sibling, ^4);
      multihost   MultiHostBatchVerifier on make_host_mesh(n_query=4) (b=2,
                  q=4) of [fixture, tamper, fixture, fixture] with
                  tests/test_multihost.py's tamper (query 7's trace sibling,
                  ^1): the mesh extents, Q_pad, ok and all_ok; BatchVerifier
                  on the same four;
      four_step   tests/test_ntt.py's four-step cases: ntt_four_step's
                  matrix and four_step_output's vector at (8, 16) seed 11,
                  forward and inverse; the jitted ntt_four_step over
                  make_mesh(8) at (8, 64) seed 12; coset_ntt_four_step at
                  256 seed 99 (log_rows 3); barycentric_eval seed 13 (its
                  evals and points too); coset_lde of 32 seeded values
                  (seed 14) at log_blowup 1 and 2, shifts 7 and 3;
      provers     at FriConfig(1, 20, 4) (a 256-witness grind window: the
                  port proves these on the CPU in its tests), the sha256 of
                  the compact JSON of TpuProver(lde_mesh=make_mesh(8))
                  .prove(fib(64)) and of the unmeshed TpuProver's proof, of
                  each lane of BatchProver.prove(_batch_mesh_traces(),
                  mesh=make_mesh(4)) and of TpuProver's proof of each of
                  those traces; and TpuProver(lde_mesh=make_mesh(8))'s
                  fib(64) at FriConfig(1, 100, 16), the fixture's bytes."""
    import hashlib
    import random as _random

    from jax.sharding import NamedSharding, PartitionSpec as Pspec

    from plonky25_tpu.ops import ntt as jntt
    from plonky25_tpu.parallel import (MultiHostBatchVerifier,
                                       ShardedVerifier, make_host_mesh,
                                       make_mesh)
    from plonky25_tpu.prover.batch_prove import BatchProver
    from plonky25_tpu.refimpl.field import Gl

    assert len(jax.devices()) >= 8, jax.devices()

    def ints(x):
        return [int(v) for v in np.asarray(gl.to_u64(x)).reshape(-1)]

    def sha(proof):
        return hashlib.sha256(json.dumps(proof_to_json(proof), separators=(
            ",", ":")).encode()).hexdigest()

    out = {}
    with open(os.path.join(OUT, "proof_fibonacci_refimpl.json")) as f:
        fixture_text = f.read()
    proof = proof_from_json(json.loads(fixture_text))
    cfg = derive_config(proof, FC)
    air = FibonacciAir()
    t0 = time.time()
    sv = ShardedVerifier(air, cfg, make_mesh(8))
    r = sv.verify(proof)
    bad = copy.deepcopy(proof)
    bad.opening_proof.query_openings[99][1].opening_proof[0][0] ^= 4
    out["sharded"] = {"Q_pad": sv.Q_pad, "fields": _j_fields(r),
                      "tamper": _verdict(sv.verify(bad))}
    print(f"  sharded {time.time() - t0:.1f} s")
    t0 = time.time()
    bad = copy.deepcopy(proof)
    bad.opening_proof.query_openings[7][0].opening_proof[2][1] ^= 1
    lanes = [proof, bad, proof, proof]
    mv = MultiHostBatchVerifier(air, cfg, make_host_mesh(
        n_query=4, devices=jax.devices()[:8]))
    ok, all_ok = mv.verify(lanes)
    out["multihost"] = {
        "n_batch": mv.n_batch, "n_query": mv.n_query, "Q_pad": mv.Q_pad,
        "ok": [bool(b) for b in np.asarray(ok)], "all_ok": bool(all_ok),
        "batch_verifier": [bool(b) for b in np.asarray(
            BatchVerifier(air, cfg).verify(lanes))]}
    print(f"  multihost {time.time() - t0:.1f} s")

    fs = {}
    rng = _random.Random(11)
    vec = [rng.randrange(P) for _ in range(8 * 16)]
    for inverse in (False, True):
        m = jntt.ntt_four_step(gl.from_u64(vec).reshape(8, 16),
                               inverse=inverse)
        fs[f"8x16_{'inverse' if inverse else 'forward'}"] = {
            "matrix": ints(m), "output": ints(jntt.four_step_output(m))}
    fs["8x16_input"] = vec
    rng = _random.Random(12)
    vec = [rng.randrange(P) for _ in range(8 * 64)]
    mesh = make_mesh(8)
    xs = gl.from_u64(vec).reshape(8, 64)
    xs = gl.GL(*(jax.device_put(a, NamedSharding(mesh, Pspec("q", None)))
                 for a in xs))
    fs["8x64_sharded"] = ints(jntt.four_step_output(
        jax.jit(jntt.ntt_four_step)(xs)))
    rng = _random.Random(99)
    coeffs = [rng.randrange(P) for _ in range(256)]
    fs["coset_256"] = ints(jntt.coset_ntt_four_step(gl.from_u64(coeffs), 7,
                                                    log_rows=3))
    rng = _random.Random(13)
    log_n = 5
    bary_coeffs = [rng.randrange(P) for _ in range(1 << log_n)]
    g = Gl.two_adic_generator(log_n)
    evals = [sum(c * pow(7 * pow(g, k, P) % P, i, P)
                 for i, c in enumerate(bary_coeffs)) % P
             for k in range(1 << log_n)]
    zs = [rng.randrange(P) for _ in range(4)]
    fs["barycentric"] = {"evals": evals, "z": zs, "shift": 7,
                         "output": ints(jntt.barycentric_eval(
                             gl.from_u64(evals), 7, gl.from_u64(zs)))}
    rng = _random.Random(14)
    ev = [rng.randrange(P) for _ in range(32)]
    fs["coset_lde"] = {"evals": ev, "cases": [
        {"log_blowup": lb, "shift": sh,
         "output": ints(jntt.coset_lde(gl.from_u64(ev), lb, sh))}
        for lb, sh in ((1, 7), (2, 7), (1, 3))]}
    out["four_step"] = fs

    t0 = time.time()
    fc = FriConfig(1, 20, 4)
    traces = _batch_mesh_traces()
    single = TpuProver(air, 6, fc)
    meshed = TpuProver(air, 6, fc, lde_mesh=make_mesh(8))
    out["provers"] = {
        "fri_config": _fc_json(fc),
        "lde_mesh": sha(meshed.prove(fibonacci_trace(64))),
        "unmeshed": sha(single.prove(fibonacci_trace(64))),
        "batch_mesh": [sha(q) for q in BatchProver(air, 6, fc).prove(
            list(traces), mesh=make_mesh(4))],
        "single": [sha(single.prove(t)) for t in traces]}
    assert out["provers"]["lde_mesh"] == out["provers"]["unmeshed"]
    assert out["provers"]["batch_mesh"] == out["provers"]["single"]
    p = TpuProver(air, 6, FC, lde_mesh=make_mesh(8)).prove(fibonacci_trace(64))
    assert sha(p) == hashlib.sha256(fixture_text.encode()).hexdigest()
    print(f"  provers {time.time() - t0:.1f} s")

    path = os.path.join(OUT, "torch_tests_jax_values.json")
    with open(path) as f:
        values = json.load(f)
    values["parallel"] = out
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return [path]


def api_gaps():
    """The JAX package's values of the names the port added last, on
    seeded inputs (stored beside them), added to torch_tests_jax_values.json
    under `api_gaps`; ~16 s, most of it compiling the Merkle tree and
    keccak-f:

      gl     goldilocks constant, mul_add, is_zero and div (b with zeros:
             JAX's div is mul(a, inv(b)), so a / 0 == 0);
      gl2    extension mul_add, div (y with a zero), frobenius, concat;
      tree   DeviceMerkleTree(rows).root_host() of a seeded (8, 5) matrix
             (the port takes the same matrix as columns (5, 8));
      keccak keccak_f_jit of seeded states, as u64 ints."""
    from plonky25_tpu.fields import gl2
    from plonky25_tpu.ops import keccak as jk
    from plonky25_tpu.ops.mmcs import DeviceMerkleTree

    rng = np.random.default_rng(0xA91)
    edge = [0, 1, P - 1, 1 << 32, (1 << 32) - 1, P - 2]

    def vals(n, zeros=0):
        v = [int(x) for x in rng.integers(0, P, size=n - len(edge),
                                          dtype=np.uint64)] + edge
        for i in range(zeros):
            v[3 * i] = 0
        return v

    def ints(x):
        return [int(v) for v in
                np.asarray(gl.to_u64(x), dtype=object).reshape(-1)]

    a, b, c = vals(16), vals(16, zeros=2), vals(16)
    ga, gb, gc = (gl.from_u64(np.asarray(v, dtype=object)) for v in (a, b, c))
    consts = [0, 1, P - 1, P, P + 5, (1 << 64) - 1, 12345]
    out = {"gl": {"a": a, "b": b, "c": c, "consts": consts,
                  "constant": [ints(gl.constant(v)) for v in consts],
                  "mul_add": ints(gl.mul_add(ga, gb, gc)),
                  "is_zero": [bool(z) for z in np.asarray(gl.is_zero(gb))],
                  "div": ints(gl.div(ga, gb))}}
    x = gl2.GL2(ga, gc)
    y = gl2.GL2(gb, gl.from_u64(np.asarray(b, dtype=object)))  # y[0] == 0
    z = gl2.GL2(gc, ga)

    def ints2(v):
        return [ints(v.c0), ints(v.c1)]

    out["gl2"] = {"mul_add": ints2(gl2.mul_add(x, y, z)),
                  "div": ints2(gl2.div(x, y)),
                  "frobenius": ints2(gl2.frobenius(x)),
                  "concat": ints2(gl2.concat([x, z]))}
    rows = [[int(v) for v in r] for r in
            rng.integers(0, P, size=(8, 5), dtype=np.uint64)]
    out["tree"] = {"rows": rows, "root": DeviceMerkleTree(
        gl.from_u64(np.asarray(rows, dtype=object))).root_host()}
    states = [[int(v) for v in r] for r in
              rng.integers(0, 1 << 64, size=(3, 25), dtype=np.uint64)]
    st = jk.keccak_f_jit(jk.from_u64(states))
    out["keccak"] = {"states": states, "out": [
        [int(v) for v in r] for r in np.asarray(jk.to_u64(st), dtype=object)]}
    path = os.path.join(OUT, "torch_tests_jax_values.json")
    with open(path) as f:
        values = json.load(f)
    values["api_gaps"] = out
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return [path]


def fused():
    """The JAX verifier's one-dispatch fused verification of the fib(64)
    fixture proof and of its PoW tamper, added to torch_tests_jax_values.json
    under `fused`: verify_witness_fused's fields (the verdict flags, alpha,
    zeta, the query indices) and the samples of its `_s_all` program; ~40 s
    on the CPU, most of it XLA compiling that program."""
    from plonky25_tpu.verifier import _publics_device

    with open(os.path.join(OUT, "proof_fibonacci_refimpl.json")) as f:
        proof = proof_from_json(json.load(f))
    air = FibonacciAir()
    cfg = derive_config(proof, FC)
    v = get_verifier(air, cfg)
    out = {}
    for name, p in (("fixture", proof), ("pow", _fib_tamper(proof, "pow"))):
        w = pack_witness(p, cfg)
        r = v._s_all(w, _publics_device(air))
        out[name] = {**_j_fields(v.verify_witness_fused(w)),
                     "samples": [int(x) for x in gl.to_u64(r["samples"])]}
    path = os.path.join(OUT, "torch_tests_jax_values.json")
    with open(path) as f:
        values = json.load(f)
    values["fused"] = out
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return [path]


def gamma_pairs(chunks):
    """tests/test_torch_gamma_programs.py's seeded pair stream of `chunks`
    GAMMA_CHUNKs per lane (37 pairs short of whole chunks, so the padding
    runs): (n_rows, pairs as a uint64 (n, 2) array)."""
    n = 5 * 256 * chunks - 37
    rng = np.random.default_rng(1000 + chunks)
    return n // 3, rng.integers(0, P, size=(n, 2), dtype=np.uint64)


def gamma_programs():
    """The JAX package's derive_gammas_from_pairs (its jitted lax.scan
    chunks) on gamma_pairs(1, 2, 3), added to torch_tests_jax_values.json
    under `gamma_programs`: per stream the row count, the pair count, the
    sha256 of the pairs' uint64 bytes and the two gammas; ~1 min on the
    CPU, most of it XLA compiling the chunk."""
    from plonky25_tpu.attest_program import derive_gammas_from_pairs

    out = {}
    for chunks in (1, 2, 3):
        n_rows, pairs = gamma_pairs(chunks)
        gammas = derive_gammas_from_pairs(
            n_rows, [(int(a), int(b)) for a, b in pairs])
        out[str(chunks)] = {
            "n_rows": n_rows, "n_pairs": len(pairs),
            "sha256": hashlib.sha256(pairs.tobytes()).hexdigest(),
            "gammas": [int(g) for g in gammas]}
    path = os.path.join(OUT, "torch_tests_jax_values.json")
    with open(path) as f:
        values = json.load(f)
    values["gamma_programs"] = out
    with open(path, "w") as f:
        json.dump(values, f, indent=1)
    return [path]


GROUPS = {"fibonacci": fibonacci, "multistage": multistage, "mmcs": mmcs,
          "keccak": keccak, "keccak_digest": keccak_digest,
          "jax_values": jax_values, "attest": attest, "composed": composed,
          "parallel": parallel, "api_gaps": api_gaps, "fused": fused,
          "gamma_programs": gamma_programs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("groups", nargs="*", default=list(GROUPS),
                    choices=list(GROUPS), metavar="group",
                    help=f"fixture groups to write (all by default): "
                         f"{', '.join(GROUPS)}")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    for name in args.groups:
        t0 = time.time()
        for path in GROUPS[name]():
            print(f"wrote {os.path.relpath(path, ROOT)} "
                  f"({os.path.getsize(path)} bytes)")
        print(f"{name} took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
