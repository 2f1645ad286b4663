"""GF(p^2) = GF(p)[X]/(X^2 - 7) arithmetic over GL limb tensors.

Mirrors plonky25_tpu/fields/extension.py and the reference's quadratic
extension algebra (src/p3/extension.rs): W = 7, dth_root = p - 1, and the
degree-2 mul/inverse formulas (extension.rs:304-321, 458-471).

On CUDA tensors `add`, `sub`, `mul` and `mul_base` launch one kernel each
(csrc/goldilocks.cu through ops/goldilocks.py: the product in registers);
on the CPU they run the GL ops below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import (DTH_ROOT, EXT_W as W, GOLDILOCKS_P as P,
                         TWO_ADIC_GENERATOR_32, TWO_ADICITY)
from ..ops import goldilocks as kernels
from ..utils.tree import tree_map
from . import goldilocks as gl
from .goldilocks import GL


class GL2(NamedTuple):
    """A GF(p^2) array: two equally shaped GL arrays (c0, c1)."""

    c0: GL
    c1: GL

    @property
    def shape(self):
        return self.c0.shape

    def __getitem__(self, idx):
        return GL2(self.c0[idx], self.c1[idx])

    def reshape(self, *shape):
        return GL2(self.c0.reshape(*shape), self.c1.reshape(*shape))


def zeros(shape, device) -> GL2:
    return GL2(gl.zeros(shape, device), gl.zeros(shape, device))


def ones(shape, device) -> GL2:
    return GL2(gl.ones(shape, device), gl.zeros(shape, device))


def from_base(x: GL) -> GL2:
    """Embed the base field into c0 (p3_field_to_arr, p3/mod.rs:143-147)."""
    return GL2(x, GL(torch.zeros_like(x.lo), torch.zeros_like(x.hi)))


def from_u64_pair(c0, c1, device) -> GL2:
    return GL2(gl.from_u64(c0, device), gl.from_u64(c1, device))


def to_u64_pair(x: GL2):
    return gl.to_u64(x.c0), gl.to_u64(x.c1)


def _launch(op: str, *limbs) -> GL2:
    lo0, hi0, lo1, hi1 = kernels.launch(op, limbs)
    return GL2(GL(lo0, hi0), GL(lo1, hi1))


def add(x: GL2, y: GL2) -> GL2:
    if x.c0.lo.is_cuda or y.c0.lo.is_cuda:
        return _launch("gl2_add", *x.c0, *x.c1, *y.c0, *y.c1)
    return add_limbs(x, y)


def add_limbs(x: GL2, y: GL2) -> GL2:
    """x + y as chains of limb ops (gl.add_limbs): `add` on the CPU, and
    the plain version the kernel is held to."""
    return GL2(gl.add_limbs(x.c0, y.c0), gl.add_limbs(x.c1, y.c1))


def sub(x: GL2, y: GL2) -> GL2:
    if x.c0.lo.is_cuda or y.c0.lo.is_cuda:
        return _launch("gl2_sub", *x.c0, *x.c1, *y.c0, *y.c1)
    return sub_limbs(x, y)


def sub_limbs(x: GL2, y: GL2) -> GL2:
    """x - y as chains of limb ops (add_limbs)."""
    return GL2(gl.sub_limbs(x.c0, y.c0), gl.sub_limbs(x.c1, y.c1))


def neg(x: GL2) -> GL2:
    return GL2(gl.neg(x.c0), gl.neg(x.c1))


def add_base(x: GL2, b: GL) -> GL2:
    """x + b, b in the base field (p3_ext_add_single, extension.rs:393-401)."""
    return GL2(gl.add(x.c0, b), x.c1)


def sub_base(x: GL2, b: GL) -> GL2:
    return GL2(gl.sub(x.c0, b), x.c1)


def mul_base(x: GL2, b: GL) -> GL2:
    if x.c0.lo.is_cuda or b.lo.is_cuda:
        return _launch("gl2_mul_base", *x.c0, *x.c1, *b)
    return mul_base_limbs(x, b)


def mul_base_limbs(x: GL2, b: GL) -> GL2:
    """x * b as chains of limb ops (add_limbs)."""
    return GL2(gl.mul_limbs(x.c0, b), gl.mul_limbs(x.c1, b))


def _mul_w(x: GL) -> GL:
    """x * 7: on the card one field mul by a 0-d constant, made on the
    device once (cached, as Ops.const_base's), one launch where adds take
    four; on the CPU _mul_w_limbs."""
    if not x.lo.is_cuda:
        return _mul_w_limbs(x)
    key = ("W", str(x.lo.device))
    w = _CONSTS.get(key)
    if w is None:
        w = _CONSTS[key] = gl.constant(W, x.lo.device)
    return gl.mul(x, w)


def _mul_w_limbs(x: GL) -> GL:
    """x * 7 via limb adds (cheaper than a limb mul)."""
    x2 = gl.add_limbs(x, x)
    x4 = gl.add_limbs(x2, x2)
    return gl.add_limbs(gl.add_limbs(x4, x2), x)


def mul(x: GL2, y: GL2) -> GL2:
    """(a0 + a1 X)(b0 + b1 X) = (a0 b0 + 7 a1 b1) + (a0 b1 + a1 b0) X."""
    if x.c0.lo.is_cuda or y.c0.lo.is_cuda:
        return _launch("gl2_mul", *x.c0, *x.c1, *y.c0, *y.c1)
    return mul_limbs(x, y)


def mul_limbs(x: GL2, y: GL2) -> GL2:
    """x * y as chains of limb ops (add_limbs)."""
    a0b0 = gl.mul_limbs(x.c0, y.c0)
    a1b1 = gl.mul_limbs(x.c1, y.c1)
    a0b1 = gl.mul_limbs(x.c0, y.c1)
    a1b0 = gl.mul_limbs(x.c1, y.c0)
    return GL2(gl.add_limbs(a0b0, _mul_w_limbs(a1b1)),
               gl.add_limbs(a0b1, a1b0))


def square(x: GL2) -> GL2:
    return mul(x, x)


def mul_add(x: GL2, y: GL2, z: GL2) -> GL2:
    return add(mul(x, y), z)


def inv(x: GL2) -> GL2:
    """1/x = conj(x) / norm(x), norm = c0^2 - 7 c1^2 (extension.rs:304-321)."""
    n = gl.sub(gl.square(x.c0), _mul_w(gl.square(x.c1)))
    scalar = gl.inv(n)
    return GL2(gl.mul(x.c0, scalar), gl.mul(gl.neg(x.c1), scalar))


def div(x: GL2, y: GL2) -> GL2:
    """inv(y) * x; so x / 0 == 0, as in the JAX package."""
    return mul(inv(y), x)


def exp_power_of_2(x: GL2, power_log: int) -> GL2:
    """x^(2^power_log)."""
    for _ in range(power_log):
        x = square(x)
    return x


def frobenius(x: GL2) -> GL2:
    """x -> x^p: scale c1 by dth_root = p-1 (extension.rs:198-230)."""
    return GL2(x.c0, gl.mul(x.c1, gl.full(x.c1.shape, DTH_ROOT, x.c1.device)))


def select(mask, x: GL2, y: GL2) -> GL2:
    """p3_ext_if (extension.rs:185-196)."""
    return GL2(gl.select(mask, x.c0, y.c0), gl.select(mask, x.c1, y.c1))


def eq(x: GL2, y: GL2) -> torch.Tensor:
    return gl.eq(x.c0, y.c0) & gl.eq(x.c1, y.c1)


def monomial(exponent: int, shape, device) -> GL2:
    """1 or X (extension.rs:558-562)."""
    if exponent == 0:
        return ones(shape, device)
    if exponent == 1:
        return GL2(gl.zeros(shape, device), gl.ones(shape, device))
    raise ValueError("EXT_DEGREE == 2 supports monomials 0 and 1 only")


def two_adic_generator_int(bits: int) -> int:
    """Host-side base-field two-adic generator value."""
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"bits {bits} outside [0, {TWO_ADICITY}]")
    return pow(TWO_ADIC_GENERATOR_32, 1 << (TWO_ADICITY - bits), P)


def ext_two_adic_generator_int(bits: int) -> tuple:
    """GF(p^2) two-adic generator as (c0, c1) host ints; the extension
    field's two-adicity is 33.  For bits == 33 it is plonky3's
    ext_two_adic_generator constant (0, 15659105665374529263), a square
    root of g_32 / 7 on the X axis, as in the JAX package (the reference's
    `32 - bits` underflows there; refimpl.field.Gl2.two_adic_generator
    keeps the oracle's value, as the JAX oracle does)."""
    if not 0 <= bits <= TWO_ADICITY + 1:
        raise ValueError(f"bits {bits} outside [0, {TWO_ADICITY + 1}]")
    if bits == TWO_ADICITY + 1:
        return (0, 15659105665374529263)
    return (two_adic_generator_int(bits), 0)


def broadcast_to(x: GL2, shape) -> GL2:
    return GL2(gl.broadcast_to(x.c0, shape), gl.broadcast_to(x.c1, shape))


def stack(elems, dim=0) -> GL2:
    return GL2(gl.stack([e.c0 for e in elems], dim),
               gl.stack([e.c1 for e in elems], dim))


class Ops:
    """GF(p^2) ops for the AIR folder (air.VerifierConstraintFolder).

    `shape` is the evaluation-point shape: the proof axis (B,) in the
    verifier, which folds every proof of a batch at its own zeta, and
    (B, q) in the prover, which folds over the quotient coset.  A
    constraint may carry extra LEADING axes (the vector constraints of wide
    AIRs such as KeccakAir): a constraint of shape (k, *shape), or one
    that broadcasts to it, folds as k consecutive constraints in index
    order, the constraint axis being axis 0."""

    def __init__(self, shape, device):
        self._shape = tuple(shape)
        self._device = device

    @property
    def point_ndim(self):
        return len(self._shape)

    def add(self, x, y):
        return add(x, y)

    def sub(self, x, y):
        return sub(x, y)

    def mul(self, x, y):
        return mul(x, y)

    def zero(self):
        return zeros(self._shape, self._device)

    def one(self):
        return ones(self._shape, self._device)

    def from_base(self, b):
        if isinstance(b, GL):
            return from_base(b)
        return GL2(gl.full(self._shape, int(b), self._device),
                   gl.zeros(self._shape, self._device))

    @staticmethod
    def from_parts(a: GL2, b: GL2) -> GL2:
        """a + X*b: two base columns (a, b) viewed as one GF(p^2) value.
        On the quotient coset a and b have c1 = 0 and this is (a0, b0); at
        an extension point zeta the openings are full extension values and
        X*b = (7*b1, b0) keeps the algebra consistent."""
        return GL2(gl.add(a.c0, _mul_w(b.c1)), gl.add(a.c1, b.c0))

    # ---- vector helpers (constraint axis = axis 0) -----------------------
    @staticmethod
    def stack(vals):
        return stack(vals)

    @staticmethod
    def concat(vals):
        """Concatenate along the constraint axis (axis 0)."""
        return concatenate(vals)

    def take(self, vec: GL2, idx):
        """vec[idx] along the constraint axis.  idx: a slice, a sequence or
        numpy array of ints (an ascending run becomes a slice, a view;
        other tables become an index tensor on the device once, cached),
        or an int64 tensor on vec's device."""
        if not isinstance(idx, (slice, torch.Tensor)):
            idx = _index(idx, vec.c0.device)
        return vec[idx]

    def const_base(self, ints):
        """Base-field constants (k,) as GL2 of shape (k,) + (1,) *
        point_ndim, made on the device once per value list (cached)."""
        if isinstance(ints, np.ndarray):
            ints = ints.reshape(-1)
        key = (tuple(int(v) for v in ints), self.point_ndim,
               str(self._device))
        c = _CONSTS.get(key)
        if c is None:
            c0 = gl.from_u64(np.asarray(key[0], dtype=object), self._device)
            c0 = c0.reshape(len(key[0]), *(1,) * self.point_ndim)
            c = GL2(c0, gl.zeros(c0.shape, self._device))
            _CONSTS[key] = c
        return c

    def fold_constraints(self, alpha: GL2, constraints) -> GL2:
        """acc = acc*alpha + c_i over the flattened constraint sequence
        (air.rs:63-69), computed as sum_i c_i * alpha^(N-1-i): the field is
        exact, so this equals the Horner fold bit for bit.  The constraints
        are flattened and concatenated along axis 0, the powers are built
        in log2(N) doubling steps (`power_stack`), then one product and a
        tree sum (`sum_dim`): a few dozen tensor ops for any N, where a
        Horner loop over N thousand constraints would take N dependent
        multiply-adds."""
        if not constraints:
            return self.zero()
        cs = concatenate([self._flat(c) for c in constraints])  # (N, *shape)
        n = cs.shape[0]
        return sum_dim(mul(cs, _flip0(power_stack(alpha, n))), 0)

    def _flat(self, c: GL2) -> GL2:
        """A constraint as (k, *shape): its leading axes beyond the point
        shape flattened in C order, (1, *shape) for a point-shaped one."""
        extra = max(len(c.shape) - self.point_ndim, 0)
        lead = tuple(c.shape[:extra]) or (1,)
        return broadcast_to(c, lead + self._shape).reshape(-1, *self._shape)


_CONSTS: dict = {}
_INDEX: dict = {}


def _index(idx, device):
    """A static index table as a slice (an ascending run) or an int64
    tensor on `device`, converted once per (table, device)."""
    a = np.asarray(idx, dtype=np.int64).reshape(-1)
    key = (a.tobytes(), str(device))
    out = _INDEX.get(key)
    if out is None:
        if a.size and np.array_equal(a, np.arange(a[0], a[0] + a.size)):
            out = slice(int(a[0]), int(a[0]) + a.size)
        else:
            out = torch.as_tensor(a, device=device)
        _INDEX[key] = out
    return out


def _flip0(x: GL2) -> GL2:
    return GL2(GL(x.c0.lo.flip(0), x.c0.hi.flip(0)),
               GL(x.c1.lo.flip(0), x.c1.hi.flip(0)))


def concatenate(elems, dim=0) -> GL2:
    return GL2(gl.concatenate([e.c0 for e in elems], dim),
               gl.concatenate([e.c1 for e in elems], dim))


concat = concatenate    # the JAX package's name


def power_stack(alpha: GL2, n: int) -> GL2:
    """alpha^0, ..., alpha^(n-1) on a new leading axis, GL2 (n,
    *alpha.shape), in log2(n) doubling steps: the powers so far times
    alpha^len, alpha^len by repeated squaring."""
    pw, a_k = ones((1, *alpha.shape), alpha.c0.device), alpha
    while pw.shape[0] < n:
        pw = concatenate([pw, mul(pw, a_k[None])])
        a_k = square(a_k)
    return pw[:n]


def sum_dim(x: GL2, dim: int) -> GL2:
    """The sum along `dim` (any length) by halving: log2(n) additions of
    tensors, where an addition per element would take n."""
    x = tree_map(lambda a: a.movedim(dim, 0), x)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = add(x[:h], x[h:2 * h])
        x = s if x.shape[0] == 2 * h else concatenate([s, x[2 * h:]])
    return x[0]


def _shift_back(x: GL2, s: int, fill: GL2) -> GL2:
    """x[..., i - s] along the last axis, `fill` (broadcast) for i < s."""
    head = broadcast_to(fill[..., None], (*x.shape[:-1], s))
    return concatenate([head, x[..., :-s]], dim=-1)


def prefix_product(x: GL2) -> GL2:
    """Running products along the last axis, z[i] = x[0] * ... * x[i], in
    log2(n) Hillis-Steele steps: z[i] *= z[i - 2^k].  The field is exact,
    so this equals the sequential product bit for bit."""
    n, s = x.shape[-1], 1
    one = ones(x.shape[:-1], x.c0.device)
    while s < n:
        x = mul(x, _shift_back(x, s, one))
        s *= 2
    return x


def prefix_affine(gamma: GL2, r: GL2) -> GL2:
    """z[i] = gamma * z[i - 1] + r[i] along the last axis, z[-1] = 0, in
    log2(n) Hillis-Steele steps: z[i] += gamma^(2^k) * z[i - 2^k], with
    gamma^(2^k) by repeated squaring.  gamma: GL2 of r's leading shape.
    Equal to the sequential recurrence bit for bit (exact field)."""
    n, s = r.shape[-1], 1
    zero = zeros(r.shape[:-1], r.c0.device)
    g = gamma
    while s < n:
        r = add(r, mul(g[..., None], _shift_back(r, s, zero)))
        g = square(g)
        s *= 2
    return r
