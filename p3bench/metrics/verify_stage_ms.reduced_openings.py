"""Device ms of the verifier's reduced_openings stage per call."""

from p3bench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "reduced_openings")
