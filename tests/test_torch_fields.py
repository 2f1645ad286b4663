"""The port's Goldilocks and GF(p^2) arithmetic (plonky25_torch.fields)
against the JAX package's (plonky25_tpu.fields) and the int oracle
(refimpl.field), bit for bit, on seeded random values and edge values."""

import numpy as np
import pytest
import torch

import plonky25_torch.constants as tc
import plonky25_tpu.constants as jc
from plonky25_torch.fields import gl as tgl
from plonky25_torch.fields import gl2 as tgl2
from plonky25_torch.refimpl.domains import TwoAdicMultiplicativeCoset as TCoset
from plonky25_torch.refimpl.field import Gl as TGl
from plonky25_torch.refimpl.field import Gl2 as TGl2
from plonky25_torch.utils import bits as tbits
from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields import gl2 as jgl2
from plonky25_tpu.ops.u32 import reverse_bits_len_u32 as j_reverse_bits
from plonky25_tpu.refimpl.domains import TwoAdicMultiplicativeCoset as JCoset
from plonky25_tpu.refimpl.field import Gl, Gl2
from plonky25_tpu.utils import bits as jbits

P = jc.GOLDILOCKS_P
EDGE = [0, 1, 2, P - 1, P - 2, 1 << 32, (1 << 32) - 1, 1 << 31,
        jc.GOLDILOCKS_EPSILON, (0xFFFFFFFF << 32) % P, P - (1 << 32),
        (1 << 63) % P]


def _values(n, seed):
    rng = np.random.default_rng(seed)
    rand = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
    return EDGE + rand


@pytest.fixture(scope="module")
def operands():
    """Every pair of edge values, then seeded random pairs."""
    a = [x for x in EDGE for _ in EDGE] + _values(400, 1)[len(EDGE):]
    b = [y for _ in EDGE for y in EDGE] + _values(400, 2)[len(EDGE):]
    return a, b


def _port(vals):
    return tgl.from_u64(vals, "cpu")


def _ints(x):
    return [int(v) for v in np.asarray(x, dtype=object).reshape(-1)]


def test_constants_equal_the_jax_tables():
    for name in ("GOLDILOCKS_P", "GOLDILOCKS_EPSILON", "TWO_ADIC_GENERATOR_32",
                 "TWO_ADICITY", "EXT_W", "DTH_ROOT", "WIDTH", "DIGEST_ELEMS",
                 "RATE", "N", "CHUNK", "EXT_DEGREE", "ROUND_F_BEGIN",
                 "ROUND_F_END", "ROUND_P", "MAT_DIAG_M_1", "RC", "RC_MID"):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax_and_oracle(op, operands):
    a, b = operands
    got = _ints(tgl.to_u64(getattr(tgl, op)(_port(a), _port(b))))
    want_jax = _ints(jgl.to_u64(getattr(jgl, op)(jgl.from_u64(a),
                                                 jgl.from_u64(b))))
    want_ref = [getattr(Gl, op)(x, y) for x, y in zip(a, b)]
    assert got == want_jax == want_ref


@pytest.mark.parametrize("op", ["neg", "square", "double", "inv"])
def test_unary_ops_match_jax_and_oracle(op, operands):
    a = operands[0][:600]
    got = _ints(tgl.to_u64(getattr(tgl, op)(_port(a))))
    want_jax = _ints(jgl.to_u64(getattr(jgl, op)(jgl.from_u64(a))))
    ref = {"neg": Gl.neg, "square": lambda x: Gl.mul(x, x),
           "double": lambda x: Gl.add(x, x),
           "inv": lambda x: pow(x, P - 2, P)}[op]
    assert got == want_jax == [ref(x) for x in a]


@pytest.mark.parametrize("e", [0, 1, 7, 2 ** 20 + 3, P - 2])
def test_pow_const_matches_jax(e):
    a = _values(40, 3)
    got = _ints(tgl.to_u64(tgl.pow_const(_port(a), e)))
    assert got == _ints(jgl.to_u64(jgl.pow_const(jgl.from_u64(a), e)))
    assert got == [pow(x, e, P) for x in a]


@pytest.mark.parametrize("nbits", [1, 7, 20, 32])
def test_pow_u32_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    exps = rng.integers(0, 1 << nbits, size=64, dtype=np.uint64)
    base = jc.TWO_ADIC_GENERATOR_32
    got = tgl.pow_u32(base, torch.from_numpy(exps.astype(np.int64)), nbits)
    want = jgl.pow_u32(base, exps.astype(np.uint32), nbits)
    assert _ints(tgl.to_u64(got)) == _ints(jgl.to_u64(want))
    assert _ints(tgl.to_u64(got)) == [pow(base, int(x), P) for x in exps]


def test_eq_select_and_u64_round_trip(operands):
    a, b = operands
    ta, tb = _port(a), _port(b)
    assert tgl.eq(ta, tb).tolist() == [x == y for x, y in zip(a, b)]
    mask = torch.tensor([i % 3 == 0 for i in range(len(a))])
    sel = _ints(tgl.to_u64(tgl.select(mask, ta, tb)))
    assert sel == [x if m else y for x, y, m in zip(a, b, mask.tolist())]
    assert _ints(tgl.to_u64(ta)) == [x % P for x in a]
    arr = np.asarray(a[:50], dtype=np.uint64)
    assert _ints(tgl.to_u64(tgl.from_u64(arr, "cpu"))) == a[:50]
    # from_u64 reduces non-canonical inputs, as the JAX package does
    assert _ints(tgl.to_u64(tgl.from_u64([P, P + 5, 2 ** 64 - 1], "cpu"))) \
        == [0, 5, (2 ** 64 - 1) % P]


def _pairs(n, seed):
    v = _values(2 * n, seed)
    return list(zip(v[0::2], v[1::2]))


def _port2(pairs):
    return tgl2.from_u64_pair([p[0] for p in pairs], [p[1] for p in pairs],
                              "cpu")


def _jax2(pairs):
    return jgl2.from_u64_pair([p[0] for p in pairs], [p[1] for p in pairs])


def _pairs_of(x):
    c0, c1 = x
    return list(zip(_ints(c0), _ints(c1)))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ext_binary_ops_match_jax_and_oracle(op):
    x, y = _pairs(200, 4), _pairs(200, 5)
    got = _pairs_of(tgl2.to_u64_pair(getattr(tgl2, op)(_port2(x), _port2(y))))
    want = _pairs_of(jgl2.to_u64_pair(getattr(jgl2, op)(_jax2(x), _jax2(y))))
    assert got == want == [getattr(Gl2, op)(a, b) for a, b in zip(x, y)]


@pytest.mark.parametrize("op", ["neg", "square", "inv"])
def test_ext_unary_ops_match_jax_and_oracle(op):
    x = _pairs(200, 6)
    got = _pairs_of(tgl2.to_u64_pair(getattr(tgl2, op)(_port2(x))))
    want = _pairs_of(jgl2.to_u64_pair(getattr(jgl2, op)(_jax2(x))))
    assert got == want == [getattr(Gl2, op)(a) for a in x]


def test_ext_base_ops_and_powers_match_jax():
    x, b = _pairs(100, 7), _values(100, 8)[:len(_pairs(100, 7))]
    tb, jb = _port(b), jgl.from_u64(b)
    for op in ("add_base", "sub_base", "mul_base"):
        got = _pairs_of(tgl2.to_u64_pair(getattr(tgl2, op)(_port2(x), tb)))
        want = _pairs_of(jgl2.to_u64_pair(getattr(jgl2, op)(_jax2(x), jb)))
        assert got == want == [getattr(Gl2, op)(a, c) for a, c in zip(x, b)]
    got = _pairs_of(tgl2.to_u64_pair(tgl2.exp_power_of_2(_port2(x), 5)))
    assert got == _pairs_of(jgl2.to_u64_pair(jgl2.exp_power_of_2(_jax2(x), 5)))
    assert got == [Gl2.exp_power_of_2(a, 5) for a in x]
    mask = torch.tensor([i % 2 == 0 for i in range(len(x))])
    sel = _pairs_of(tgl2.to_u64_pair(tgl2.select(mask, _port2(x),
                                                 tgl2.zeros((len(x),), "cpu"))))
    assert sel == [a if i % 2 == 0 else (0, 0) for i, a in enumerate(x)]
    assert tgl2.eq(_port2(x), _port2(x)).all()


@pytest.mark.parametrize("bit_len", [0, 1, 5, 7, 16, 31, 32])
def test_reverse_bits_len_u32_matches_jax(bit_len):
    rng = np.random.default_rng(bit_len)
    x = rng.integers(0, 1 << bit_len, size=100, dtype=np.uint64)
    got = tbits.reverse_bits_len_u32(torch.from_numpy(x.astype(np.int64)),
                                     bit_len).tolist()
    want = np.asarray(j_reverse_bits(x.astype(np.uint32), bit_len)).tolist()
    assert got == want == [jbits.reverse_bits_len(int(v), bit_len) for v in x]


def test_host_math_copies_match_the_jax_package():
    for bits in range(33):
        assert TGl.two_adic_generator(bits) == Gl.two_adic_generator(bits)
    for x in _pairs(20, 9):
        assert TGl2.inv(x) == Gl2.inv(x)
        assert TGl2.mul(x, x) == Gl2.mul(x, x)
    for n in (1, 8, 64, 1 << 20):
        assert tbits.log2_strict(n) == jbits.log2_strict(n)
        assert tbits.log2_ceil(n + 1) == jbits.log2_ceil(n + 1)
    td = TCoset.natural_domain_for_degree(6, 64)
    jd = JCoset.natural_domain_for_degree(6, 64)
    tq = td.create_disjoint_domain(128).split_domains(2)
    jq = jd.create_disjoint_domain(128).split_domains(2)
    assert [(d.log_n, d.shift) for d in tq] == [(d.log_n, d.shift) for d in jq]
    assert [d.zp_at_single_point(7) for d in tq] == \
        [d.zp_at_single_point(7) for d in jq]
