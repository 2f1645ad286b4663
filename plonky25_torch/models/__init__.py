from .fibonacci import FibonacciAir  # noqa: F401
from .multiset_air import MultisetAir, pad_pairs  # noqa: F401
from .rlc_air import RlcAir  # noqa: F401
