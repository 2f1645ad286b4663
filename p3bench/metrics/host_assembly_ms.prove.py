"""Host ms a traced proof spends assembling the proof from the pulled
arrays: the program's prove.assemble span."""

from p3bench.harness.spans import span_ms


def read(run):
    return span_ms(run, "prove.call", "prove.assemble", sum(run.proofs))
