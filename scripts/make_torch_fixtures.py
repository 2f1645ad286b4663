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
      176 s of the script's 263 s on the CPU (PoW grind included).

`chip_smoke.py` and the port's tests read these files, so the port can be
checked on a machine without JAX.  This script may import plonky25_tpu; the
port never does.
"""

from __future__ import annotations

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
from plonky25_tpu.proof import FriConfig, proof_to_json  # noqa: E402
from plonky25_tpu.refimpl.poseidon2 import poseidon2  # noqa: E402
from plonky25_tpu.refimpl.prover import prove  # noqa: E402
from plonky25_tpu.refimpl.verifier import verify as ref_verify  # noqa: E402
from plonky25_tpu.verifier import verify_proof  # noqa: E402

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


def main():
    t0 = time.time()
    os.makedirs(OUT, exist_ok=True)
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
    for path in (proof_path, exp_path, big_path):
        print(f"wrote {os.path.relpath(path, ROOT)} "
              f"({os.path.getsize(path)} bytes)")
    print(f"took {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
