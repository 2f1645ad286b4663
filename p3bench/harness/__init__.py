"""The benchmark's harness (core), the traced window's reader (timeline),
the shape arithmetic and Poseidon2 bound (shapes) and the tamper kinds
(tamper)."""
