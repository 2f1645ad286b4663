"""Bit and log helpers (semantics of src/p3/utils.rs).

The log helpers, `reverse_bits_len`, `reverse_bits` and
`reverse_slice_index_bits` are copies of plonky25_tpu/utils/bits.py;
`reverse_bits_len_u32` is the tensor form of plonky25_tpu/ops/u32.py's.
"""

import torch


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


def reverse_bits_len_u32(x: torch.Tensor, bit_len: int) -> torch.Tensor:
    """Reverse the low `bit_len` bits of each element of an int64 tensor
    holding values below 2^bit_len (reverse_p3_bits_len, p3/mod.rs:138-141).

    Five masked swap stages reverse all 32 bits, then the shift keeps the
    top `bit_len` of them; every intermediate stays below 2^32."""
    if bit_len == 0:
        return torch.zeros_like(x)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        x = ((x & mask) << shift) | ((x >> shift) & mask)
    x = ((x & 0xFFFF) << 16) | (x >> 16)
    return x >> (32 - bit_len)
