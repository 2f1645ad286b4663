"""Run one cell of the benchmark once:

    python3 p3bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result (one JSON object);
the numbers its correctness was judged by, each beside its limit, are the
last lines of standard error.  It needs the CUDA devices the cell asks for
and exits non-zero, printing no result, without them."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from p3bench.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
