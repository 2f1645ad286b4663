"""The int oracle: field, domain, Poseidon2, challenger, MMCS, NTT,
verifier and prover on plain Python ints.

Copies of plonky25_tpu/refimpl (the executable specification the JAX
package is tested against); the port's verifier constructor uses the
field and domain math, and attestation verifies and proves through the
rest (attest.py).  The port imports nothing of the JAX package."""

from .field import Gl, Gl2, Gl3, ext_ops  # noqa: F401
from .poseidon2 import poseidon2  # noqa: F401
from .challenger import DuplexChallenger  # noqa: F401
