"""The share of the state-major Poseidon2 states the verifier permuted in
the traced calls that the calls needed (the program's counter against the
shapes' count)."""

from p3bench.harness.spans import useful_share


def read(run):
    return useful_share(run)
