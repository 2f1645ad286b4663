"""Host-side field and domain math on plain Python ints.

Copies of the parts of plonky25_tpu/refimpl that the verifier's constructor
uses (Goldilocks, GF(p^2), two-adic cosets); the port imports nothing of
the JAX package."""

from .field import Gl, Gl2  # noqa: F401
