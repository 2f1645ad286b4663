from .fibonacci import FibonacciAir  # noqa: F401
from .multiset_air import MultisetAir, pad_pairs  # noqa: F401
from .rlc_air import RlcAir  # noqa: F401
from .keccak_air import KeccakAir, keccak_trace, keccak_trace_np  # noqa: F401
