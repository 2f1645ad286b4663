"""Lanes verified in the window over the window's seconds."""

from p3bench.harness.readers import rate


def read(run):
    return rate(run)
