"""The state-major Poseidon2 kernels' (csrc/poseidon2.cu) share of their
least time over the verifier's states, %."""

from p3bench.harness.readers import roofline


def read(run):
    return roofline(run, "poseidon2_w12")
