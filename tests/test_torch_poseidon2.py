"""The port's Poseidon2 (plonky25_torch.ops.poseidon2) against the JAX
package's jnp permutation and the int oracle, bit for bit.

The JAX jnp path is the one the Pallas kernel is held bit-equal to (the
Pallas kernel's own interpret-mode run is skipped on the CPU,
tests/test_pallas.py).  The CUDA kernel cannot run on the CPU: its case is
marked `cuda` and skips without a GPU.  The JAX package is imported by a
fixture, so that on a GPU machine without JAX the `cuda` case still runs:
    python -m pytest --noconftest -m cuda tests/test_torch_poseidon2.py"""

import types

import numpy as np
import pytest
import torch

from plonky25_torch.constants import GOLDILOCKS_P as P
from plonky25_torch.fields import gl as tgl
from plonky25_torch.ops import poseidon2 as tp2

EDGE = [0, 1, P - 1, 1 << 32, 0xFFFFFFFF, (0xFFFFFFFF << 32) % P]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's permutation and the int oracle."""
    from plonky25_tpu.fields import gl
    from plonky25_tpu.ops.poseidon2 import poseidon2_permute
    from plonky25_tpu.refimpl.poseidon2 import poseidon2

    return types.SimpleNamespace(gl=gl, permute=poseidon2_permute,
                                 oracle=poseidon2)


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(n, 12), dtype=np.uint64)


def _edge_states():
    """Every edge value in every lane, and states made only of edges."""
    out = [[e] * 12 for e in EDGE]
    out += [[EDGE[(i + j) % len(EDGE)] for i in range(12)]
            for j in range(len(EDGE))]
    return np.asarray(out, dtype=np.uint64)


def _rows(x):
    return [[int(v) for v in row] for row in
            np.asarray(x, dtype=object).reshape(-1, 12)]


@pytest.mark.parametrize("n", [1, 5, 257])
def test_plain_matches_jax_and_oracle(ref, n):
    s = _states(n, n)
    got = _rows(tgl.to_u64(tp2.poseidon2_permute_plain(tgl.from_u64(s, "cpu"))))
    want = _rows(ref.gl.to_u64(ref.permute(ref.gl.from_u64(s))))
    assert got == want
    assert got[:5] == [ref.oracle([int(v) for v in row]) for row in s[:5]]


def test_plain_on_edge_states_matches_oracle(ref):
    s = _edge_states()
    got = _rows(tgl.to_u64(tp2.poseidon2_permute_plain(tgl.from_u64(s, "cpu"))))
    assert got == [ref.oracle([int(v) for v in row]) for row in s]


def test_plain_keeps_leading_batch_axes():
    s = _states(2 * 3 * 4, 9).reshape(2, 3, 4, 12)
    out = tp2.poseidon2_permute_plain(tgl.from_u64(s, "cpu"))
    assert out.shape == (2, 3, 4, 12)
    flat = tp2.poseidon2_permute_plain(tgl.from_u64(s.reshape(-1, 12), "cpu"))
    assert _rows(tgl.to_u64(out)) == _rows(tgl.to_u64(flat))


def test_wrapper_runs_plain_on_cpu_tensors_without_counting():
    s = tgl.from_u64(_states(3, 3), "cpu")
    before = tp2.poseidon2_permute.launches
    out = tp2.poseidon2_permute(s)
    assert tp2.poseidon2_permute.launches == before
    assert _rows(tgl.to_u64(out)) == \
        _rows(tgl.to_u64(tp2.poseidon2_permute_plain(s)))


@pytest.mark.parametrize("bad, exc", [
    ("int32", TypeError), ("width", ValueError), ("strided", ValueError),
    ("shapes", ValueError), ("cpu", ValueError)])
def test_kernel_input_check_rejects(bad, exc):
    lo = torch.zeros(4, 12, dtype=torch.int64)
    state = {
        "int32": tgl.GL(lo.int(), lo.int()),
        "width": tgl.GL(lo[:, :8], lo[:, :8].clone()),
        "strided": tgl.GL(torch.zeros(12, 4, dtype=torch.int64).T, lo),
        "shapes": tgl.GL(lo, lo[:2]),
        "cpu": tgl.GL(lo, lo),
    }[bad]
    with pytest.raises(exc):
        tp2.check_kernel_input(state)


def test_kernel_constants_are_the_reduced_tables():
    from plonky25_torch.constants import MAT_DIAG_M_1, RC, RC_MID

    words = list(tp2._kernel_constants())
    want = [v % P for row in RC for v in row] + [v % P for v in RC_MID]
    want += [(d - 1) % P for d in MAT_DIAG_M_1]
    assert words == want and len(words) == 8 * 12 + 22 + 12


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for n in (1, 255, 257, 100_003):
        s = tgl.from_u64(_states(n, n), "cuda")
        before = tp2.poseidon2_permute.launches
        out = tp2.poseidon2_permute(s)
        want = tp2.poseidon2_permute_plain(s)
        torch.cuda.synchronize()
        assert tp2.poseidon2_permute.launches == before + 1
        assert torch.equal(out.lo, want.lo) and torch.equal(out.hi, want.hi)
