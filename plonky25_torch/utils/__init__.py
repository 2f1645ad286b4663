from .bits import (  # noqa: F401
    log2_ceil,
    log2_strict,
    reverse_bits,
    reverse_bits_len,
    reverse_slice_index_bits,
)
from .profiling import StageTimer, measure_throughput, sync, trace  # noqa: F401
