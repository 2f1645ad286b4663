"""u32/u64 integer ops: the counterpart of plonky25_tpu/ops/u32.py, with
the same names and semantics (the reference's u32 gadget library,
src/common/u32/gadgets/*, as plain integer ops).

PyTorch on the CPU has no add, sub, shift or compare for uint32, so a u32
value lives in an int64 tensor, in [0, 2^32), and every op masks its result
back into that range (so JAX's dtype name `U32` has no counterpart).  No
intermediate leaves the signed int64 range: the one product that could
(x * y in `mul_add_u32`) is taken on 16-bit halves.
u64 values are (lo, hi) pairs of such tensors.  Inputs may be Python ints,
lists, numpy arrays or tensors; results keep the device of a tensor input.
"""

from __future__ import annotations

import torch

from ..utils.bits import reverse_bits_len_u32  # noqa: F401  (part of this API)

M32 = 0xFFFFFFFF
M16 = 0xFFFF


def _u(x) -> torch.Tensor:
    """x as an int64 tensor of u32 values (wrapped mod 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64) & M32


# --------------------------------------------------------------- u32 ops
# reference: src/common/u32/gadgets/arithmetic_u32.rs

def mul_add_u32(x, y, z=None):
    """x*y + z on u32 -> (lo, hi) u32 (U32ArithmeticGate semantics,
    arithmetic_u32.rs:162-178).  The product is taken on 16-bit halves:
    the middle terms sum below 2^33 and the result below 2^64."""
    x, y = _u(x), _u(y)
    xl, xh = x & M16, x >> 16
    yl, yh = y & M16, y >> 16
    mid = xl * yh + xh * yl
    lo = xl * yl + ((mid & M16) << 16)
    hi = xh * yh + (mid >> 16) + (lo >> 32)
    lo = lo & M32
    if z is not None:
        lo = lo + _u(z)
        hi = hi + (lo >> 32)
        lo = lo & M32
    return lo, hi


def add_many_u32(xs):
    """Sum of u32 values -> (result u32, carry u32) (U32AddManyGate,
    add_many_u32.rs); the carry counts the 2^32 wraps."""
    total = _u(0)
    for x in xs:
        total = total + _u(x)
    return total & M32, total >> 32


def add_u32s_with_carry(to_add, carry):
    """Sum of u32 values plus an input carry -> (result u32, carry_out u32)
    (arithmetic_u32.rs:213-239)."""
    return add_many_u32(list(to_add) + [carry])


def select_u32(b, x, y):
    """b ? x : y (arithmetic_u32.rs:266-268)."""
    return torch.where(torch.as_tensor(b).bool(), _u(x), _u(y))


def sub_u32(x, y, borrow=0):
    """x - y - borrow -> (result u32, borrow_out in {0,1})
    (U32SubtractionGate, subtraction_u32.rs)."""
    d = _u(x) - _u(y) - _u(borrow)
    return d & M32, (d < 0).to(torch.int64)


def is_le_u32(x, y):
    """x <= y (ComparisonGate semantics, comparison.rs)."""
    return _u(x) <= _u(y)


def list_le(xs, ys):
    """Lexicographic (little-endian limb order) xs <= ys
    (multiple_comparison.rs:16-68)."""
    result = torch.tensor(True)
    for x, y in zip(xs, ys):  # limbs little-endian: later limbs dominate
        x, y = _u(x), _u(y)
        result = torch.where(x == y, result, x < y)
    return result


def range_check_u32(x, bits=32):
    """Value fits in `bits` bits (U32RangeCheckGate semantics)."""
    x = _u(x)
    if bits >= 32:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return x < (1 << bits)


# --------------------------------------------------------------- u64 ops
# reference: p3_and/p3_xor/p3_lsh/p3_rsh (src/p3/mod.rs:96-126)

def and_u64(a, b):
    return (a[0] & b[0], a[1] & b[1])


def xor_u64(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def not_u32(x):
    """0xFFFFFFFF - x (interleaved_u32.rs:60-64)."""
    return M32 - _u(x)


def lsh_u64(a, n: int):
    """Logical left shift by a static amount (interleaved_u32.rs:226-290)."""
    lo, hi = _u(a[0]), _u(a[1])
    if n == 0:
        return lo, hi
    if n >= 64:
        return torch.zeros_like(lo), torch.zeros_like(lo)
    if n >= 32:
        return torch.zeros_like(lo), (lo << (n - 32)) & M32
    return (lo << n) & M32, ((hi << n) | (lo >> (32 - n))) & M32


def rsh_u64(a, n: int):
    """Logical right shift by a static amount."""
    lo, hi = _u(a[0]), _u(a[1])
    if n == 0:
        return lo, hi
    if n >= 64:
        return torch.zeros_like(lo), torch.zeros_like(lo)
    if n >= 32:
        return hi >> (n - 32), torch.zeros_like(hi)
    return ((lo >> n) | (hi << (32 - n))) & M32, hi >> n


def rol_u64(a, n: int):
    n %= 64
    llo, lhi = lsh_u64(a, n)
    if not n:
        return llo, lhi
    rlo, rhi = rsh_u64(a, 64 - n)
    return llo | rlo, lhi | rhi


def reverse_u32(x):
    """Bit-reverse a u32 (Bin32 reverse semantics, binary_u32.rs:60-75) in
    five masked swap stages."""
    x = _u(x)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        x = ((x & mask) << shift) | ((x >> shift) & mask)
    return ((x & M16) << 16) | (x >> 16)


def reverse_u64(a):
    """Bit-reverse a u64 pair (reverse_p3, p3/mod.rs:128-136)."""
    return reverse_u32(a[1]), reverse_u32(a[0])


# ------------------------------------------------------- interleave parity
# The reference's bitwise engine spreads u32 bits to even positions of a u64
# so that an addition computes AND (odd bits) and XOR (even bits)
# (interleaved_u32.rs:193-224).

def interleave_u32(x):
    """Spread the bits of x to even positions -> u64 pair (B32 form)."""
    def spread16(v):
        v = v & M16
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555
    x = _u(x)
    return spread16(x), spread16(x >> 16)


def uninterleave_to_u32(d):
    """Inverse of interleave on a 'dirty' sum of two B32 values: per 2-bit
    group a+b has the XOR bit at the even position and the AND carry at the
    odd one (UninterleaveToU32Gate semantics) -> (and, xor)."""
    def collect(v):
        v = v & 0x55555555
        v = (v | (v >> 1)) & 0x33333333
        v = (v | (v >> 2)) & 0x0F0F0F0F
        v = (v | (v >> 4)) & 0x00FF00FF
        return (v | (v >> 8)) & M16
    lo, hi = _u(d[0]), _u(d[1])
    x_xor = collect(lo) | (collect(hi) << 16)
    x_and = collect(lo >> 1) | (collect(hi >> 1) << 16)
    return x_and, x_xor


def unsafe_xor_many_u32(xs):
    """Multi-input XOR (interleaved_u32.rs:157-191).  The reference's
    interleaved sums can alias a wrong XOR for three or more addends; here
    it is a plain xor-reduce, and the name is kept for parity."""
    if len(xs) == 0:
        return _u(0)
    acc = _u(xs[0])
    for x in xs[1:]:
        acc = acc ^ _u(x)
    return acc


def unsafe_xor_many_u64(xs):
    """Multi-input XOR on (lo, hi) u64 pairs (interleaved_u32.rs:237-250)."""
    return (unsafe_xor_many_u32([a[0] for a in xs]),
            unsafe_xor_many_u32([a[1] for a in xs]))


def and_xor_u32(x, y):
    """AND and XOR of two u32 by the interleave-add trick
    (interleaved_u32.rs:193-224) -> (and, xor)."""
    xi_lo, xi_hi = interleave_u32(x)
    yi_lo, yi_hi = interleave_u32(y)
    s_lo = xi_lo + yi_lo
    s_hi = (xi_hi + yi_hi + (s_lo >> 32)) & M32
    return uninterleave_to_u32((s_lo & M32, s_hi))
