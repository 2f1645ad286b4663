"""The port's u32/u64 ops (plonky25_torch.ops.u32) against the JAX
package's (plonky25_tpu.ops.u32), function by function, on seeded random
and edge values (tolerance 0: integer ops), in the way tests/test_u32.py
holds the JAX functions to plain Python ints."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonky25_torch.ops import u32 as t
from plonky25_tpu.ops import u32 as j

EDGE = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFF, 0x10000, 0xFFFFFFFE,
        0xFFFFFFFF]


def _values(seed, n=48):
    rng = random.Random(seed)
    return EDGE + [rng.randrange(1 << 32) for _ in range(n - len(EDGE))]


def _args(seed, k):
    """k u32 columns: every pair of edge values, then seeded randoms."""
    cols = [_values(seed + i) for i in range(k)]
    if k >= 2:
        pairs = [(a, b) for a in EDGE for b in EDGE]
        cols[0] = [a for a, _ in pairs] + cols[0]
        cols[1] = [b for _, b in pairs] + cols[1]
        for c in cols[2:]:
            c[:0] = _values(seed + 99, len(pairs))
    return cols


def _both(cols):
    """The columns as port tensors and as JAX arrays."""
    return ([torch.tensor(c, dtype=torch.int64) for c in cols],
            [jnp.asarray(np.asarray(c, np.uint32)) for c in cols])


def _ints(x):
    if isinstance(x, (tuple, list)):
        return [_ints(v) for v in x]
    return np.asarray(x).astype(np.int64).tolist()


BINARY = {
    "mul_add_u32": lambda m, a: m.mul_add_u32(a[0], a[1], a[2]),
    "mul_add_u32_no_z": lambda m, a: m.mul_add_u32(a[0], a[1]),
    "add_many_u32": lambda m, a: m.add_many_u32(a),
    "add_u32s_with_carry": lambda m, a: m.add_u32s_with_carry(a[:2], a[2] & 1),
    "select_u32": lambda m, a: m.select_u32(a[2] & 1, a[0], a[1]),
    "sub_u32": lambda m, a: m.sub_u32(a[0], a[1]),
    "sub_u32_borrow": lambda m, a: m.sub_u32(a[0], a[1], a[2] & 1),
    "is_le_u32": lambda m, a: m.is_le_u32(a[0], a[1]),
    "list_le": lambda m, a: m.list_le(a[:2], a[2:]),
    "and_u64": lambda m, a: m.and_u64(a[:2], a[2:]),
    "xor_u64": lambda m, a: m.xor_u64(a[:2], a[2:]),
    "not_u32": lambda m, a: m.not_u32(a[0]),
    "reverse_u32": lambda m, a: m.reverse_u32(a[0]),
    "reverse_u64": lambda m, a: m.reverse_u64(a[:2]),
    "interleave_u32": lambda m, a: m.interleave_u32(a[0]),
    "uninterleave_to_u32": lambda m, a: m.uninterleave_to_u32(a[:2]),
    "unsafe_xor_many_u32": lambda m, a: m.unsafe_xor_many_u32(a),
    "unsafe_xor_many_u64": lambda m, a: m.unsafe_xor_many_u64(
        [a[:2], a[2:]]),
    "and_xor_u32": lambda m, a: m.and_xor_u32(a[0], a[1]),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_matches_jax(name):
    ours, theirs = _both(_args(len(name), 4))
    fn = BINARY[name]
    assert _ints(fn(t, ours)) == _ints(fn(j, theirs))


@pytest.mark.parametrize("bits", [0, 1, 7, 16, 31, 32])
def test_range_check_matches_jax(bits):
    ours, theirs = _both(_args(bits, 1))
    assert _ints(t.range_check_u32(ours[0], bits)) == \
        _ints(j.range_check_u32(theirs[0], bits))


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 36, 63, 64, 65, 100])
def test_shifts_and_rotates_match_jax(n):
    ours, theirs = _both(_args(n, 2))
    for fn in ("lsh_u64", "rsh_u64", "rol_u64"):
        assert _ints(getattr(t, fn)(ours, n)) == \
            _ints(getattr(j, fn)(theirs, n)), fn


@pytest.mark.parametrize("bit_len", [0, 1, 5, 16, 31, 32])
def test_reverse_bits_len_matches_jax(bit_len):
    vals = [v & ((1 << bit_len) - 1) for v in _values(bit_len)]
    ours, theirs = _both([vals])
    assert _ints(t.reverse_bits_len_u32(ours[0], bit_len)) == \
        _ints(j.reverse_bits_len_u32(theirs[0], bit_len))


def test_empty_xor_and_python_int_inputs():
    assert int(t.unsafe_xor_many_u32([])) == int(j.unsafe_xor_many_u32([]))
    assert _ints(t.mul_add_u32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF)) == \
        [0, 0xFFFFFFFF] == \
        _ints(j.mul_add_u32(0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF))
    assert set(n for n in dir(j) if not n.startswith("_")) - {"U32", "jnp"} \
        <= set(dir(t))
