"""GF(p^3) = GF(p)[X]/(X^3 - 7) arithmetic over GL limb tensors; the
counterpart of plonky25_tpu/fields/extension3.py.

The reference carries degree-3 mul and inverse formulas beside the
degree-2 ones (src/p3/extension.rs:330-390 Karatsuba-style mul, :473-532
adjugate inverse), selected by EXT_DEGREE.  The proofs this port verifies
and proves are degree 2, so this module serves API parity and is held to
the int oracle (refimpl.field.Gl3) and to the JAX module.  X^3 - 7 is
irreducible over Goldilocks: 7 is not a cube (7^((p-1)/3) != 1), so the
inverse is total on nonzero elements.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.tree import tree_map
from . import goldilocks as gl
from .extension import _index, _mul_w
from .goldilocks import GL


class GL3(NamedTuple):
    """A GF(p^3) array: three equally shaped GL arrays (c0, c1, c2)."""

    c0: GL
    c1: GL
    c2: GL

    @property
    def shape(self):
        return self.c0.shape

    def __getitem__(self, idx):
        return GL3(self.c0[idx], self.c1[idx], self.c2[idx])

    def reshape(self, *shape):
        return GL3(*(c.reshape(*shape) for c in self))


def zeros(shape, device) -> GL3:
    return GL3(*(gl.zeros(shape, device) for _ in range(3)))


def ones(shape, device) -> GL3:
    return GL3(gl.ones(shape, device), gl.zeros(shape, device),
               gl.zeros(shape, device))


def from_base(x: GL) -> GL3:
    z = gl.zeros(x.shape, x.device)
    return GL3(x, z, z)


def from_u64_triple(c0, c1, c2, device) -> GL3:
    return GL3(*(gl.from_u64(c, device) for c in (c0, c1, c2)))


def to_u64_triple(x: GL3):
    return tuple(gl.to_u64(c) for c in x)


def add(x: GL3, y: GL3) -> GL3:
    return GL3(*(gl.add(a, b) for a, b in zip(x, y)))


def sub(x: GL3, y: GL3) -> GL3:
    return GL3(*(gl.sub(a, b) for a, b in zip(x, y)))


def neg(x: GL3) -> GL3:
    return GL3(*(gl.neg(a) for a in x))


def mul(x: GL3, y: GL3) -> GL3:
    """Karatsuba-style product (extension.rs:330-390):

      c0 = a0 b0 + W ((a1+a2)(b1+b2) - a1 b1 - a2 b2)
      c1 = (a0+a1)(b0+b1) - a0 b0 - a1 b1 + W a2 b2
      c2 = (a0+a2)(b0+b2) - a0 b0 - a2 b2 + a1 b1
    """
    a0b0 = gl.mul(x.c0, y.c0)
    a1b1 = gl.mul(x.c1, y.c1)
    a2b2 = gl.mul(x.c2, y.c2)
    mid = gl.sub(gl.mul(gl.add(x.c1, x.c2), gl.add(y.c1, y.c2)),
                 gl.add(a1b1, a2b2))
    c0 = gl.add(a0b0, _mul_w(mid))
    c1 = gl.add(gl.sub(gl.mul(gl.add(x.c0, x.c1), gl.add(y.c0, y.c1)),
                       gl.add(a0b0, a1b1)),
                _mul_w(a2b2))
    c2 = gl.add(gl.sub(gl.mul(gl.add(x.c0, x.c2), gl.add(y.c0, y.c2)),
                       gl.add(a0b0, a2b2)),
                a1b1)
    return GL3(c0, c1, c2)


def square(x: GL3) -> GL3:
    return mul(x, x)


def inv(x: GL3) -> GL3:
    """Adjugate inverse (extension.rs:473-532):

      scalar = 1 / (a0^3 + W a1^3 + W^2 a2^3 - 3 W a0 a1 a2)
      result = scalar * [a0^2 - W a1 a2,  W a2^2 - a0 a1,  a1^2 - a0 a2]

    inv(0) = 0, as gl.inv."""
    a0, a1, a2 = x
    a0sq = gl.square(a0)
    a1sq = gl.square(a1)
    a2w = _mul_w(a2)
    a0a1 = gl.mul(a0, a1)
    det = gl.sub(
        gl.add(gl.add(gl.mul(a0sq, a0), _mul_w(gl.mul(a1, a1sq))),
               gl.mul(gl.square(a2w), a2)),
        gl.mul(gl.scale_small(a2w, 3), a0a1))
    scalar = gl.inv(det)
    return GL3(gl.mul(scalar, gl.sub(a0sq, gl.mul(a1, a2w))),
               gl.mul(scalar, gl.sub(gl.mul(a2w, a2), a0a1)),
               gl.mul(scalar, gl.sub(a1sq, gl.mul(a0, a2))))


def div(x: GL3, y: GL3) -> GL3:
    return mul(inv(y), x)


def eq(x: GL3, y: GL3):
    return gl.eq(x.c0, y.c0) & gl.eq(x.c1, y.c1) & gl.eq(x.c2, y.c2)


def mul_base(x: GL3, b: GL) -> GL3:
    return GL3(*(gl.mul(a, b) for a in x))


def monomial(exponent: int, shape, device) -> GL3:
    """1, X or X^2 (extension.rs:558-562, the D=3 arm)."""
    cs = [gl.zeros(shape, device) for _ in range(3)]
    cs[exponent] = gl.ones(shape, device)
    return GL3(*cs)


def stack(elems, dim=0) -> GL3:
    # zip iterates the three fields (indexing a GL3 indexes its arrays)
    return GL3(*(gl.stack(list(cs), dim) for cs in zip(*elems)))


def concatenate(elems, dim=0) -> GL3:
    return GL3(*(gl.concatenate(list(cs), dim) for cs in zip(*elems)))


def broadcast_to(x: GL3, shape) -> GL3:
    return GL3(*(gl.broadcast_to(c, shape) for c in x))


def power_stack(alpha: GL3, n: int) -> GL3:
    """alpha^0, ..., alpha^(n-1) on a new leading axis, in log2(n)
    doubling steps (extension.power_stack for GF(p^3))."""
    pw, a_k = ones((1, *alpha.shape), alpha.c0.device), alpha
    while pw.shape[0] < n:
        pw = concatenate([pw, mul(pw, a_k[None])])
        a_k = square(a_k)
    return pw[:n]


def sum_dim(x: GL3, dim: int) -> GL3:
    """The sum along `dim` by halving (extension.sum_dim for GF(p^3))."""
    x = tree_map(lambda a: a.movedim(dim, 0), x)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = add(x[:h], x[h:2 * h])
        x = s if x.shape[0] == 2 * h else concatenate([s, x[2 * h:]])
    return x[0]


class Ops:
    """GF(p^3) ops for the AIR folder: the D=3 counterpart of
    extension.Ops (same point shapes, vector constraints and fold)."""

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
        z = gl.zeros(self._shape, self._device)
        return GL3(gl.full(self._shape, int(b), self._device), z, z)

    @staticmethod
    def from_parts(a: GL3, b: GL3, c: GL3 = None) -> GL3:
        """a + X*b + X^2*c: base trace columns viewed as one GF(p^3)
        value (see extension.Ops.from_parts)."""
        x = monomial(1, a.c0.shape, a.c0.device)
        out = add(a, mul(x, b))
        if c is not None:
            out = add(out, mul(mul(x, x), c))
        return out

    @staticmethod
    def stack(vals):
        return stack(vals)

    @staticmethod
    def concat(vals):
        return concatenate(vals)

    def take(self, vec: GL3, idx):
        """vec[idx] along the constraint axis (extension.Ops.take)."""
        if not isinstance(idx, slice) and not hasattr(idx, "device"):
            idx = _index(idx, vec.c0.device)
        return vec[idx]

    def const_base(self, ints):
        """Base-field constants (k,) as GL3 of shape (k,) + (1,) *
        point_ndim."""
        c0 = gl.from_u64(np.asarray(ints, dtype=object).reshape(-1),
                         self._device)
        c0 = c0.reshape(c0.shape[0], *(1,) * self.point_ndim)
        return from_base(c0)

    def fold_constraints(self, alpha: GL3, constraints) -> GL3:
        """acc = acc*alpha + c_i over the flattened constraints
        (air.rs:63-69), as sum_i c_i alpha^(N-1-i) (extension.Ops.
        fold_constraints): equal to the Horner fold bit for bit."""
        if not constraints:
            return self.zero()
        cs = concatenate([self._flat(c) for c in constraints])
        pw = tree_map(lambda a: a.flip(0), power_stack(alpha, cs.shape[0]))
        return sum_dim(mul(cs, pw), 0)

    def _flat(self, c: GL3) -> GL3:
        extra = max(len(c.shape) - self.point_ndim, 0)
        lead = tuple(c.shape[:extra]) or (1,)
        return broadcast_to(c, lead + self._shape).reshape(-1, *self._shape)
