"""Seconds of set-up spent making the captured programs."""

from p3bench.harness.readers import capture_s


def read(run):
    return capture_s(run)
