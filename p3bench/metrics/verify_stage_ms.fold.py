"""Device ms of the verifier's fold stage per call."""

from p3bench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "fold")
