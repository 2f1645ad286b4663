"""Host-side field and domain math on plain Python ints.

Copies of the parts of plonky25_tpu/refimpl that the verifier's constructor
uses (Goldilocks, GF(p^2), two-adic cosets), and GF(p^3) for the tests;
the port imports nothing of the JAX package."""

from .field import Gl, Gl2, Gl3, ext_ops  # noqa: F401
