"""Goldilocks field arithmetic on PyTorch tensors: two 32-bit limbs held in
int64.

A field element is a pair (lo, hi) of equally shaped int64 tensors whose
entries lie in [0, 2^32): value = hi * 2^32 + lo.  PyTorch on the CPU has no
add, shift or compare for uint32/uint64, and a 64-bit value does not fit a
signed int64, so the limbs carry 32 bits each and every intermediate below
stays inside the signed int64 range: no step relies on signed overflow.
(Steps do use `>>` and `&` on negative int64 values, which PyTorch computes
as the arithmetic shift and the two's-complement AND on every platform.)
Every op returns canonical values (in [0, p)), so equality is a limb
compare, as in plonky25_tpu/fields/goldilocks.py, whose public API this
module mirrors.  JAX's limb dtype `U32` (jnp.uint32) has no counterpart:
the limbs are int64 tensors, for the reason above; `MASK32` is its mask.

On CUDA tensors `add`, `sub` and `mul` launch one hand-written kernel each
(csrc/goldilocks.cu through ops/goldilocks.py, operands read through their
strides and broadcast as they are); the limb chains below are the CPU
implementation, which the kernels are held bit-equal to.  Every other op
here (`neg`, `square`, `inv`, `pow_*`, ...) is built from those three.

Identities used by the reduction (p = 2^64 - 2^32 + 1):
    2^64 ≡ 2^32 - 1 =: EPSILON  (mod p)
    2^96 ≡ -1                   (mod p)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import GOLDILOCKS_P as P
from ..ops import goldilocks as kernels

M32 = 0xFFFFFFFF
M16 = 0xFFFF
MASK32 = M32


class GL(NamedTuple):
    """A Goldilocks array: two equally shaped int64 limb tensors (lo, hi)."""

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def shape(self):
        return tuple(self.lo.shape)

    @property
    def device(self):
        return self.lo.device

    def __getitem__(self, idx):
        """Array indexing/slicing (NOT tuple-field access; unpack for that)."""
        return GL(self.lo[idx], self.hi[idx])

    def reshape(self, *shape):
        return GL(self.lo.reshape(*shape), self.hi.reshape(*shape))


# ------------------------------------------------------------ constructors

def zeros(shape, device) -> GL:
    z = torch.zeros(shape, dtype=torch.int64, device=device)
    return GL(z, z)


def ones(shape, device) -> GL:
    return GL(torch.ones(shape, dtype=torch.int64, device=device),
              torch.zeros(shape, dtype=torch.int64, device=device))


def full(shape, value: int, device) -> GL:
    """Constant array, reduced mod p.  torch.full enqueues a fill on the
    device; it does not wait for it, unlike a copy from host memory."""
    value %= P
    return GL(torch.full(shape, value & M32, dtype=torch.int64, device=device),
              torch.full(shape, value >> 32, dtype=torch.int64, device=device))


def constant(value: int, device) -> GL:
    """Scalar constant, reduced mod p (reference p3_constant,
    p3/mod.rs:51-56)."""
    return full((), value, device)


def from_u64(values, device) -> GL:
    """Host ints (int, nested list, or numpy integer array) -> canonical GL.
    Raises for a CUDA device during a CUDA graph capture: a copy from
    pageable host memory cannot be captured, and a tensor made there would
    live in the graph's memory pool (make such constants beforehand)."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("from_u64 copies host values to the card, which "
                           "a CUDA graph capture cannot hold")
    if (isinstance(values, np.ndarray) and values.dtype != object
            and np.issubdtype(values.dtype, np.integer)
            and not (np.issubdtype(values.dtype, np.signedinteger)
                     and values.size and values.min() < 0)):
        a = values.astype(np.uint64) % np.uint64(P)
        lo = (a & np.uint64(M32)).astype(np.int64)
        hi = (a >> np.uint64(32)).astype(np.int64)
    else:
        arr = np.asarray(values, dtype=object)
        flat = [int(v) % P for v in arr.reshape(-1)]
        lo = np.asarray([v & M32 for v in flat], np.int64).reshape(arr.shape)
        hi = np.asarray([v >> 32 for v in flat], np.int64).reshape(arr.shape)
    return GL(torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))


def to_u64(x: GL) -> np.ndarray:
    """GL -> numpy object array of Python ints (host side, for tests)."""
    lo = x.lo.cpu().numpy().astype(object)
    hi = x.hi.cpu().numpy().astype(object)
    return hi * (1 << 32) + lo


def to_u64_np(x: GL) -> np.ndarray:
    """GL -> numpy uint64 array of canonical values (host side; the bulk
    form of to_u64)."""
    lo = x.lo.cpu().numpy().astype(np.uint64)
    hi = x.hi.cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


# ------------------------------------------------------------ arithmetic

def _canonical(lo, hi) -> GL:
    """A value in [0, 2^64) as limbs -> the value mod p.

    value >= p exactly when hi == 2^32 - 1 and lo >= 1, and then
    value - p == lo - 1."""
    ge = (hi == M32) & (lo != 0)
    return GL(torch.where(ge, lo - 1, lo), torch.where(ge, 0, hi))


def _launch(op: str, a: GL, b: GL) -> GL:
    return GL(*kernels.launch(op, (a.lo, a.hi, b.lo, b.hi)))


def add(a: GL, b: GL) -> GL:
    if a.lo.is_cuda or b.lo.is_cuda:
        return _launch("gl_add", a, b)
    return add_limbs(a, b)


def add_limbs(a: GL, b: GL) -> GL:
    """a + b as a chain of limb ops: `add` on the CPU, and the plain
    version the kernel is held to."""
    lo = a.lo + b.lo
    hi = a.hi + b.hi + (lo >> 32)
    lo = lo & M32
    # value < 2p; value - p = (hi - (2^32 - 1)) * 2^32 + (lo - 1)
    tlo = lo - 1
    thi = hi - M32 + (tlo >> 32)
    ge = thi >= 0
    return GL(torch.where(ge, tlo & M32, lo), torch.where(ge, thi, hi))


def sub(a: GL, b: GL) -> GL:
    if a.lo.is_cuda or b.lo.is_cuda:
        return _launch("gl_sub", a, b)
    return sub_limbs(a, b)


def sub_limbs(a: GL, b: GL) -> GL:
    """a - b as a chain of limb ops (add_limbs)."""
    lo = a.lo - b.lo
    hi = a.hi - b.hi + (lo >> 32)
    lo = lo & M32
    # value in (-p, p); when negative, value + p = (hi + 2^32 - 1) * 2^32 + lo + 1
    plo = lo + 1
    phi = hi + M32 + (plo >> 32)
    neg_ = hi < 0
    return GL(torch.where(neg_, plo & M32, lo), torch.where(neg_, phi, hi))


def neg(a: GL) -> GL:
    return sub(GL(torch.zeros_like(a.lo), torch.zeros_like(a.hi)), a)


def _mul_words(a: GL, b: GL):
    """The 128-bit product a*b as four 32-bit words (x0, x1, x2, x3).

    b is cut into 16-bit pieces so each partial product a_limb * b_piece
    stays below 2^48; C_m sums the products at bit 16*m (each < 2^49)."""
    b0l, b0h = b.lo & M16, b.lo >> 16
    b1l, b1h = b.hi & M16, b.hi >> 16
    c0 = a.lo * b0l
    c1 = a.lo * b0h
    c2 = a.lo * b1l + a.hi * b0l
    c3 = a.lo * b1h + a.hi * b0h
    c4 = a.hi * b1l
    c5 = a.hi * b1h
    w0 = c0 + ((c1 & M16) << 16)
    w1 = c2 + (c1 >> 16) + ((c3 & M16) << 16) + (w0 >> 32)
    w2 = c4 + (c3 >> 16) + ((c5 & M16) << 16) + (w1 >> 32)
    x3 = (c5 >> 16) + (w2 >> 32)   # < 2^32: the product is below 2^128
    return w0 & M32, w1 & M32, w2 & M32, x3


def _reduce128(x0, x1, x2, x3) -> GL:
    """A 128-bit value as four 32-bit words -> canonical GL.

    x ≡ x0 + x1*2^32 + x2*(2^32 - 1) - x3  (2^64 ≡ 2^32 - 1, 2^96 ≡ -1),
    the identity of plonky25_tpu's _reduce128, taken on signed limbs."""
    lo = x0 - x2 - x3                   # (-2^33, 2^32)
    hi = x1 + x2 + (lo >> 32)           # [-2, 2^33 - 2]
    lo = lo & M32
    # fold the bits at 2^64 and up once more: c = floor(hi / 2^32) is in
    # {-1, 0, 1} and c * 2^64 ≡ c * (2^32 - 1); afterwards hi is in [0, 2^32)
    c = hi >> 32
    lo = lo - c
    hi = (hi & M32) + c + (lo >> 32)
    return _canonical(lo & M32, hi)


def mul(a: GL, b: GL) -> GL:
    if a.lo.is_cuda or b.lo.is_cuda:
        return _launch("gl_mul", a, b)
    return mul_limbs(a, b)


def mul_limbs(a: GL, b: GL) -> GL:
    """a * b as a chain of limb ops (add_limbs)."""
    return _reduce128(*_mul_words(a, b))


def square(a: GL) -> GL:
    return mul(a, a)


def mul_add(a: GL, b: GL, c: GL) -> GL:
    return add(mul(a, b), c)


def is_zero(a: GL) -> torch.Tensor:
    return (a.lo == 0) & (a.hi == 0)


def double(a: GL) -> GL:
    return add(a, a)


def scale_small(a: GL, k: int) -> GL:
    """Multiply by a tiny static constant via adds (k in {2,3,4})."""
    if k == 2:
        return add(a, a)
    if k == 3:
        return add(add(a, a), a)
    if k == 4:
        d = add(a, a)
        return add(d, d)
    raise ValueError(k)


def select(mask, a: GL, b: GL) -> GL:
    """mask ? a : b (mask: bool tensor broadcastable to the operands)."""
    return GL(torch.where(mask, a.lo, b.lo), torch.where(mask, a.hi, b.hi))


def eq(a: GL, b: GL) -> torch.Tensor:
    """Canonical equality -> bool tensor."""
    return (a.lo == b.lo) & (a.hi == b.hi)


def pow_const(a: GL, e: int) -> GL:
    """a^e for a static Python-int exponent (square-and-multiply)."""
    if e == 0:
        return ones(a.shape, a.device)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def _sqn(x: GL, n: int) -> GL:
    """x^(2^n)."""
    for _ in range(n):
        x = square(x)
    return x


def inv(a: GL) -> GL:
    """a^(p-2) (so inv(0) == 0); the addition chain of plonky25_tpu's inv,
    on p - 2 = (2^31 - 1)*2^33 + (2^32 - 1): 72 squarings and 9 muls."""
    a1 = a
    a2 = mul(square(a1), a1)                    # a^(2^2-1)
    a3 = mul(square(a2), a1)                    # a^(2^3-1)
    a6 = mul(_sqn(a3, 3), a3)                   # a^(2^6-1)
    a12 = mul(_sqn(a6, 6), a6)                  # a^(2^12-1)
    a24 = mul(_sqn(a12, 12), a12)               # a^(2^24-1)
    a30 = mul(_sqn(a24, 6), a6)                 # a^(2^30-1)
    a31 = mul(square(a30), a1)                  # a^(2^31-1)
    a32 = mul(square(a31), a1)                  # a^(2^32-1)
    return mul(_sqn(a31, 33), a32)              # a^((2^31-1)*2^33 + 2^32-1)


def div(a: GL, b: GL) -> GL:
    """a * inv(b); so a / 0 == 0, as in the JAX package."""
    return mul(a, inv(b))


def pow_u32(base_int: int, exp: torch.Tensor, nbits: int) -> GL:
    """base^exp for a static integer base and an int64 exponent tensor of
    at most `nbits` significant bits: a masked product over the table
    base^(2^k), as plonky25_tpu's pow_u32 (verifier.rs:309,433)."""
    acc = ones(exp.shape, exp.device)
    b = base_int % P
    for k in range(nbits):
        bit = ((exp >> k) & 1).bool()
        acc = select(bit, mul(acc, full((), b, exp.device)), acc)
        b = b * b % P
    return acc


# ------------------------------------------------------------ shaping

def stack(elems, dim=0) -> GL:
    return GL(torch.stack([e.lo for e in elems], dim),
              torch.stack([e.hi for e in elems], dim))


def concatenate(elems, dim=0) -> GL:
    return GL(torch.cat([e.lo for e in elems], dim),
              torch.cat([e.hi for e in elems], dim))


def broadcast_to(x: GL, shape) -> GL:
    return GL(x.lo.expand(shape), x.hi.expand(shape))
