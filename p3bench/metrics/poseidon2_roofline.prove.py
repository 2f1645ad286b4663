"""The lane-major Poseidon2 kernels' (csrc/poseidon2_soa.cu) share of their
least time over the prover's states, %."""

from p3bench.harness.readers import roofline


def read(run):
    return roofline(run, "poseidon2_soa")
