"""Device kernels per proof in the traced window."""

from p3bench.harness.readers import kernels_per_proof


def read(run):
    return kernels_per_proof(run)
