"""plonky25_torch: the Plonky3 STARK verifier and prover of plonky25_tpu,
ported to PyTorch and CUDA for NVIDIA Hopper.

It verifies proofs of GF(p^2) AIRs, single-stage (FibonacciAir, and
KeccakAir: 2,633 columns, its constraints as vectors) and multi-stage
(RlcAir, MultisetAir: a second matrix committed after challenges drawn
from the trace commitment), one at a time
(`verify_proof`) or in batches (`parallel.BatchVerifier`), and proves
them, one at a time (`prover.prove`) or in batches (`prover.BatchProver`);
`parallel` also splits a proof's queries or a batch over the devices of
a torch.distributed group (`ShardedVerifier`, `MultiHostBatchVerifier`),
as `TorchProver(lde_mesh=)` and `BatchProver.prove(mesh=)` split proving.
Field elements are int64 limb tensors; on a CUDA tensor every Goldilocks
and GF(p^2) add, sub and mul is one launch of csrc/goldilocks.cu (on the
CPU, a chain of PyTorch limb ops), and every Poseidon2
permutation runs a hand-written kernel: csrc/poseidon2.cu
on state-major states (the verifier, the transcripts), csrc/poseidon2_soa.cu
on lane-major ones (the prover's Merkle trees and PoW grind).  `attest`
proves, in one 620-column VerifierAir STARK, that a proof verified, and
checks such attestations (depth 1); `attest_composed` and
`attest_attestation` prove such a verification of an attestation's own
STARK (depth 2), verifying and proving through the port or through the
int oracle of `refimpl`.  `utils.profiling` times stages and traces runs
(CUDA events, torch.profiler); `utils.roofline` counts a function's
integer work and gives the H100's bound for it.  On the card a single
verification replays one captured CUDA graph of its five stages
(`TorchVerifier.verify(proof, fused=None)`, `utils.graphs`), as the JAX
package runs one jitted program on a TPU; a `BatchVerifier` captures its
five stages as programs at the second batch of a shape and replays them
from then on.  Entry points take `device=`
("cuda" by default) and never move to the CPU on their own.

The package imports torch, numpy and the standard library only: nothing of
JAX and nothing of plonky25_tpu, whose modules it mirrors by name.
"""

__version__ = "0.1.0"

from .proof import (  # noqa: F401
    FriConfig,
    P3Config,
    Proof,
    derive_config,
    load_proof,
    proof_from_json,
    proof_to_json,
    save_proof,
)
from .air import Air, FilteredAirBuilder, VerifierConstraintFolder  # noqa: F401
from .errors import (  # noqa: F401
    FriError,
    InvalidPowWitness,
    InvalidProofShape,
    P25Error,
    check_proof_shape,
)
from .verifier import VerifyResult, get_verifier, verify_proof  # noqa: F401
