"""Device ms of the prover's commit_trace stage per proof."""

from p3bench.harness.readers import stage_ms


def read(run):
    return stage_ms(run, "commit_trace")
