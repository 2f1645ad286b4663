"""The JAX package's names that the port added last, against the JAX
package's values on the same inputs, with tolerance 0 (integer
arithmetic: equal or broken):

  * fields/goldilocks.py: constant, mul_add, is_zero, div (by zero too);
  * fields/extension.py: mul_add, div (by zero too), frobenius, concat,
    two_adic_generator_int (bits 0-32), ext_two_adic_generator_int (bits
    0-33: plonky3's (0, 15659105665374529263) at 33);
  * fields/extension3.py: from_u64_triple, to_u64_triple;
  * utils/bits.py: reverse_bits, reverse_slice_index_bits (lengths 0, 1,
    8 and 16);
  * ops/mmcs.py: DeviceMerkleTree.root_host; ops/poseidon2.py:
    poseidon2_permute_auto; ops/keccak.py: keccak_f_jit.

Values that would cost a JAX compile here (the field ops, the Merkle tree,
keccak-f) come with their seeded inputs from
tests/fixtures/torch_tests_jax_values.json (`python
scripts/make_torch_fixtures.py api_gaps`); the host-int functions are
called in the JAX package directly.
"""

import json
import os

import numpy as np
import pytest
import torch

from plonky25_torch.fields import gl, gl2, gl3
from plonky25_torch.fields.extension import GL2
from plonky25_torch.ops import keccak, poseidon2
from plonky25_torch.ops.mmcs import DeviceMerkleTree
from plonky25_torch.refimpl.field import Gl2
from plonky25_torch.utils import bits
from plonky25_tpu.fields import extension as jgl2
from plonky25_tpu.fields import extension3 as jgl3
from plonky25_tpu.utils import bits as jbits

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jv():
    with open(os.path.join(FIXTURES, "torch_tests_jax_values.json")) as f:
        return json.load(f)["api_gaps"]


def _gl(values):
    return gl.from_u64(np.asarray(values, dtype=object), "cpu")


def _ints(x):
    return [int(v) for v in np.asarray(gl.to_u64(x), dtype=object).reshape(-1)]


def _ints2(x):
    return [_ints(x.c0), _ints(x.c1)]


def test_goldilocks_names(jv):
    g = jv["gl"]
    a, b, c = _gl(g["a"]), _gl(g["b"]), _gl(g["c"])
    assert [_ints(gl.constant(v, "cpu")) for v in g["consts"]] == g["constant"]
    assert _ints(gl.mul_add(a, b, c)) == g["mul_add"]
    assert gl.is_zero(b).tolist() == g["is_zero"]
    assert sum(g["is_zero"]) == 3          # b has zeros: div by zero below
    assert _ints(gl.div(a, b)) == g["div"]
    assert [q for q, z in zip(g["div"], g["is_zero"]) if z] == [0, 0, 0]
    assert gl.MASK32 == 0xFFFFFFFF


def test_extension_names(jv):
    g, e = jv["gl"], jv["gl2"]
    a, b, c = _gl(g["a"]), _gl(g["b"]), _gl(g["c"])
    x, y, z = GL2(a, c), GL2(b, _gl(g["b"])), GL2(c, a)
    assert _ints2(gl2.mul_add(x, y, z)) == e["mul_add"]
    assert _ints2(gl2.div(x, y)) == e["div"]         # y[0] == 0
    assert _ints2(gl2.frobenius(x)) == e["frobenius"]
    assert gl2.concat is gl2.concatenate
    assert _ints2(gl2.concat([x, z])) == e["concat"]


def test_two_adic_generators():
    for bits_ in range(33):
        assert gl2.two_adic_generator_int(bits_) == \
            jgl2.two_adic_generator_int(bits_)
    for bits_ in range(34):
        assert gl2.ext_two_adic_generator_int(bits_) == \
            jgl2.ext_two_adic_generator_int(bits_)
    assert gl2.ext_two_adic_generator_int(33) == (0, 15659105665374529263)
    # the oracle keeps its own value at 33, as the JAX oracle does
    assert Gl2.two_adic_generator(33) != (0, 15659105665374529263)
    with pytest.raises(ValueError):
        gl2.ext_two_adic_generator_int(34)


def test_extension3_triples(jv):
    g = jv["gl"]
    port = gl3.from_u64_triple(g["a"], g["b"], g["c"], "cpu")
    jax = jgl3.from_u64_triple(g["a"], g["b"], g["c"])
    got = [[int(v) for v in c] for c in gl3.to_u64_triple(port)]
    want = [[int(v) for v in c] for c in jgl3.to_u64_triple(jax)]
    assert got == want == [[v % (2**64 - 2**32 + 1) for v in g[k]]
                           for k in ("a", "b", "c")]


@pytest.mark.parametrize("n", [0, 1, 8, 16])
def test_reverse_slice_index_bits(n):
    vals = list(range(100, 100 + n))
    want = jbits.reverse_slice_index_bits(list(vals))
    got = bits.reverse_slice_index_bits(vals)
    assert got == want and got is vals          # in place
    for x in range(n):
        assert bits.reverse_bits(x, n) == jbits.reverse_bits(x, n)


def test_root_host(jv):
    t = jv["tree"]
    cols = _gl(np.asarray(t["rows"], dtype=object).T)
    root = DeviceMerkleTree(cols).root_host()
    assert root == t["root"] and all(type(v) is int for v in root)


def test_poseidon2_permute_auto():
    rng = np.random.default_rng(0xA92)
    s = gl.from_u64(rng.integers(0, 2**64 - 2**32 + 1, size=(6, 12),
                                 dtype=np.uint64), "cpu")
    want = poseidon2.poseidon2_permute(s)
    got = poseidon2.poseidon2_permute_auto(s)
    assert torch.equal(got.lo, want.lo) and torch.equal(got.hi, want.hi)
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        kat = json.load(f)["poseidon2_known_answers"]
    out = poseidon2.poseidon2_permute_auto(
        gl.from_u64(np.asarray([k["input"] for k in kat], np.uint64), "cpu"))
    assert gl.to_u64(out).tolist() == [k["output"] for k in kat]


def test_keccak_f_jit(jv):
    k = jv["keccak"]
    assert keccak.keccak_f_jit is keccak.keccak_f
    out = keccak.keccak_f_jit(keccak.from_u64(k["states"], "cpu"))
    assert [[int(v) for v in r] for r in keccak.to_u64(out)] == k["out"]
