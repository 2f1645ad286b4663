"""Process start to the first timed call: imports, inputs, kernel
loading (and building, in a checkout's first run), warm-up and capture."""


def read(run):
    return run.setup_s
