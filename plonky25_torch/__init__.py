"""plonky25_torch: the Plonky3 STARK verifier of plonky25_tpu, ported to
PyTorch and CUDA for NVIDIA Hopper.

It verifies proofs of single-stage GF(p^2) AIRs (FibonacciAir), one at a
time (`verify_proof`) or in batches (`parallel.BatchVerifier`).  Field
arithmetic is PyTorch on int64 limb tensors; every Poseidon2 permutation on
a CUDA tensor runs the hand-written kernel csrc/poseidon2.cu.  Entry points
take `device=` ("cuda" by default) and never move to the CPU on their own.

The package imports torch, numpy and the standard library only: nothing of
JAX and nothing of plonky25_tpu, whose modules it mirrors by name.
"""

from .proof import (  # noqa: F401
    FriConfig,
    P3Config,
    Proof,
    derive_config,
    load_proof,
    proof_from_json,
    proof_to_json,
)
from .verifier import VerifyResult, get_verifier, verify_proof  # noqa: F401
