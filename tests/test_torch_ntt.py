"""The port's NTT, coset LDE and barycentric evaluation
(plonky25_torch.ops.ntt) against the JAX package's plonky25_tpu.ops.ntt and
the int oracle plonky25_tpu.refimpl.ntt, bit for bit (tolerance 0: the
arithmetic is exact).  Inputs are made from a seed with numpy and handed
to both packages; the port runs on the CPU."""

import random

import numpy as np
import pytest
import torch

from plonky25_tpu.fields import gl as jgl
from plonky25_tpu.fields.extension import GL2 as JGL2
from plonky25_tpu.ops import ntt as jntt
from plonky25_tpu.refimpl import ntt as rntt
from plonky25_tpu.refimpl.field import Gl
from plonky25_tpu.utils.bits import reverse_bits_len
from plonky25_torch.convert import from_jax
from plonky25_torch.fields import gl, gl2
from plonky25_torch.ops import ntt as tntt

P = 0xFFFFFFFF00000001


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes, and PyTorch's default
    of one thread per core in each of them oversubscribes it (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cols(log_n, seed, width=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(width, 1 << log_n), dtype=np.uint64)


def _ints(x):
    """A port GL or a JAX GL -> nested lists of Python ints."""
    if isinstance(x, gl.GL):
        return gl.to_u64(x).tolist()
    return np.asarray(jgl.to_u64_np(x), dtype=object).tolist()


FUNCS = {
    "ntt": (jntt.ntt, tntt.ntt),
    "intt": (jntt.intt, tntt.intt),
    "ntt_flat_dif": (jntt._ntt_flat_dif, tntt._ntt_flat_dif),
    "ntt_flat_dif_inverse": (lambda x: jntt._ntt_flat_dif(x, True),
                             lambda x: tntt._ntt_flat_dif(x, True)),
    "ntt_flat_bitrev_in": (lambda x: jntt._ntt_flat(x, in_bitrev=True),
                           lambda x: tntt._ntt_flat(x, in_bitrev=True)),
    "coset_ntt": (lambda x: jntt.coset_ntt(x, 7),
                  lambda x: tntt.coset_ntt(x, 7)),
    "coset_intt": (lambda x: jntt.coset_intt(x, 7),
                   lambda x: tntt.coset_intt(x, 7)),
    "coset_lde_pair_b1": (lambda x: jntt.coset_lde_pair(x, 1, 1),
                          lambda x: tntt.coset_lde_pair(x, 1, 1)),
    "coset_lde_pair_b2": (lambda x: jntt.coset_lde_pair(x, 7, 2, 3),
                          lambda x: tntt.coset_lde_pair(x, 7, 2, 3)),
    "coset_lde_to_rev_b1": (lambda x: jntt.coset_lde_to_rev(x, 1, 1),
                            lambda x: tntt.coset_lde_to_rev(x, 1, 1)),
    "coset_lde_to_rev_b2": (lambda x: jntt.coset_lde_to_rev(x, 7, 2),
                            lambda x: tntt.coset_lde_to_rev(x, 7, 2)),
}


@pytest.mark.parametrize("log_n", [3, 4, 5, 6])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_transform_matches_jax(name, log_n):
    a = _cols(log_n, 10 * log_n + len(name))
    jf, tf = FUNCS[name]
    assert _ints(tf(gl.from_u64(a, "cpu"))) == _ints(jf(jgl.from_u64(a)))


@pytest.mark.parametrize("log_n", [3, 4, 5, 6])
@pytest.mark.parametrize("shift", [1, 7])
def test_barycentric_eval_ext_matches_jax(log_n, shift):
    a = _cols(log_n, log_n + shift)
    r = random.Random(log_n * 100 + shift)
    z = JGL2(jgl.from_u64([r.randrange(P)])[0], jgl.from_u64([r.randrange(P)])[0])
    want = jntt.barycentric_eval_ext(jgl.from_u64(a), shift, z)
    got = tntt.barycentric_eval_ext(gl.from_u64(a, "cpu"), shift,
                                    from_jax(z, "cpu"))
    assert (_ints(got.c0), _ints(got.c1)) == (_ints(want.c0), _ints(want.c1))


def test_barycentric_eval_ext_batched_points():
    """One point per leading index: (S, C, N) evaluations at (S,) points
    equal S separate evaluations."""
    a = _cols(4, 3, width=6).reshape(2, 3, 16)
    r = random.Random(5)
    zs = [(r.randrange(P), r.randrange(P)) for _ in range(2)]
    z = gl2.from_u64_pair([c0 for c0, _ in zs], [c1 for _, c1 in zs], "cpu")
    got = tntt.barycentric_eval_ext(gl.from_u64(a, "cpu"), 7, z)
    for s in range(2):
        one = tntt.barycentric_eval_ext(gl.from_u64(a[s], "cpu"), 7, z[s])
        assert _ints(got.c0[s]) == _ints(one.c0)
        assert _ints(got.c1[s]) == _ints(one.c1)


def test_lde_at_2_pow_14_points_matches_oracle():
    """An LDE past the JAX package's six-step threshold (2^14 points): the
    flat transforms give the oracle's values."""
    log_n = 13
    col = [int(v) for v in _cols(log_n, 99, width=1)[0]]
    coeffs = rntt.coset_intt(col, 1) + [0] * (1 << log_n)
    natural = rntt.coset_ntt(coeffs, 7)
    rev = [natural[reverse_bits_len(i, log_n + 1)] for i in range(2 << log_n)]
    t = gl.from_u64([col], "cpu")
    assert _ints(tntt.coset_lde_pair(t, 1, 1))[0] == natural
    assert _ints(tntt.coset_lde_to_rev(t, 1, 1))[0] == rev


# ------------------------------------------------------------ device tables


@pytest.mark.parametrize("log_n", [1, 3, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_root_powers_table_matches_host_list(log_n, inverse):
    got = _ints(tntt._root_powers(log_n, inverse, "cpu"))
    assert got == list(jntt._root_powers_host(log_n, inverse))


@pytest.mark.parametrize("log_n", [0, 1, 5, 10])
def test_bitrev_table_matches_host_list(log_n):
    assert tntt._bitrev(log_n, "cpu").tolist() == list(jntt._bitrev_host(log_n))


@pytest.mark.parametrize("log_n", [2, 5])
def test_lde_scale_tables_match_host_lists(log_n):
    inv_n = Gl.inv(1 << log_n)
    natural = [inv_n * v % P for v in jntt._coset_ratio_host(log_n, 1, 7)]
    assert _ints(tntt._lde_scale(log_n, 1, 7, "cpu", False)) == natural
    assert (_ints(tntt._lde_scale(log_n, 7, 3, "cpu", True))
            == list(jntt._lde_scale_rev_host(log_n, 7, 3)))


@pytest.mark.parametrize("shift, log_n", [(1, 4), (7, 6)])
def test_coset_points_match_host_list(shift, log_n):
    g = Gl.two_adic_generator(log_n)
    assert (_ints(tntt.coset_points(log_n, shift, "cpu"))
            == [shift * pow(g, i, P) % P for i in range(1 << log_n)])


@pytest.mark.parametrize("n", [1, 2, 3, 17])
def test_powers_match_host_list(n):
    assert _ints(tntt.powers(P - 5, n, "cpu")) == [pow(P - 5, i, P)
                                                    for i in range(n)]
