"""Bit and log helpers (semantics of src/p3/utils.rs).

Frozen copies of the port's plain-int log and bit-reversal helpers.
"""


def log2_strict(n: int) -> int:
    """log2 of a power of two; raises otherwise (utils.rs:3-8)."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"Not a power of two: {n}")
    return n.bit_length() - 1


def log2_ceil(n: int) -> int:
    """ceil(log2(n)), with log2_ceil(0) == 0 (utils.rs:10-13)."""
    return max(n - 1, 0).bit_length()


def reverse_bits_len(x: int, bit_len: int) -> int:
    """Reverse the low `bit_len` bits of x (utils.rs:20-30)."""
    out = 0
    for _ in range(bit_len):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def reverse_bits(x: int, n: int) -> int:
    """utils.rs:15-18 (n must be a power of two)."""
    return reverse_bits_len(x, log2_strict(n))


def reverse_slice_index_bits(vals):
    """In-place bit-reversal permutation of a list (utils.rs:33-43)."""
    n = len(vals)
    if n == 0:
        return vals
    log_n = log2_strict(n)
    for i in range(n):
        j = reverse_bits_len(i, log_n)
        if i < j:
            vals[i], vals[j] = vals[j], vals[i]
    return vals
