"""Write the fixtures that hold the PyTorch port against the JAX package.

    python scripts/make_torch_fixtures.py

Writes, into tests/fixtures/:

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
      refimpl.commit.verify_batch.

`chip_smoke.py` and the port's tests read these files, so the port can be
checked on a machine without JAX.  This script may import plonky25_tpu; the
port never does.
"""

from __future__ import annotations

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

import numpy as np  # noqa: E402

from plonky25_tpu.constants import GOLDILOCKS_P as P  # noqa: E402
from plonky25_tpu.fields import gl  # noqa: E402
from plonky25_tpu.models.fibonacci import (  # noqa: E402
    FibonacciAir,
    fibonacci_trace,
)
from plonky25_tpu.models.multiset_air import (  # noqa: E402
    MultisetAir,
    pad_pairs,
)
from plonky25_tpu.models.rlc_air import RlcAir  # noqa: E402
from plonky25_tpu.proof import (  # noqa: E402
    FriConfig,
    derive_config,
    proof_to_json,
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


def main():
    os.makedirs(OUT, exist_ok=True)
    for group in (fibonacci, multistage, mmcs):
        t0 = time.time()
        for path in group():
            print(f"wrote {os.path.relpath(path, ROOT)} "
                  f"({os.path.getsize(path)} bytes)")
        print(f"{group.__name__} took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
