"""The benchmark's plain reference: a Plonky3 STARK verifier on Python ints
and NumPy, the Fibonacci and Keccak AIRs' constraint evaluation, the proof
parser and the Keccak trace builder.  Frozen copies of the port's int
oracle (plonky25_torch/refimpl), AIR models and proof parser with their
imports rewritten; nothing here imports the port, the JAX package or JAX,
so that a change to the program cannot move what it is judged against."""
