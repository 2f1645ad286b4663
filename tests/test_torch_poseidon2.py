"""The port's Poseidon2 (plonky25_torch.ops.poseidon2), state-major and
lane-major, against the JAX package's jnp permutation, its lane-major
helpers and the int oracle, bit for bit.

The JAX jnp path is the one the Pallas kernel is held bit-equal to (the
Pallas kernel's own interpret-mode run is skipped on the CPU,
tests/test_pallas.py).  The CUDA kernel cannot run on the CPU: its case is
marked `cuda` and skips without a GPU.  The JAX package is imported by a
fixture, so that on a GPU machine without JAX the `cuda` case still runs:
    python -m pytest --noconftest -m cuda tests/test_torch_poseidon2.py"""

import ctypes
import types

import numpy as np
import pytest
import torch

from plonky25_torch.constants import GOLDILOCKS_P as P
from plonky25_torch.fields import gl as tgl
from plonky25_torch.ops import poseidon2 as tp2
from plonky25_torch.utils import profiling

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
    """The plain version counts its states and no launch."""
    s = tgl.from_u64(_states(3, 3), "cpu")
    with profiling.recording():
        out = tp2.poseidon2_permute(s)
        got = profiling.launch_counts()
    assert (got[profiling.AOS], got[profiling.AOS + ".states"]) == (0, 3)
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


def _csrc(name):
    import os

    path = os.path.join(os.path.dirname(tp2.__file__), os.pardir, "csrc", name)
    with open(path) as f:
        return f.read()


def test_kernel_constants_are_the_reduced_tables():
    """Both kernels run the rounds of poseidon2_common.cuh, whose constants
    come from poseidon2_constants.cuh (held to constants.py below): no
    kernel source carries a constant table or parameter of its own."""
    import re

    assert '#include "poseidon2_constants.cuh"' in _csrc("poseidon2_common.cuh")
    for name in ("poseidon2.cu", "poseidon2_soa.cu"):
        src = _csrc(name)
        assert '#include "poseidon2_common.cuh"' in src, name
        assert "p25::permute(s);" in src, name
        assert "p25::permute_split(x, g);" in src, name
        assert not re.search(r"0x[0-9A-Fa-f]{9,}", src), name


def _gpu_sizes(split_max):
    """Small, ragged and large sizes, and both sides of the crossover."""
    return (1, 255, 257, split_max, split_max + 1, 100_003)


def _ran_split(built, entry, s):
    """The variant the C launcher `entry` of `built` reports it ran on the
    CUDA states `s` (True: three threads per state)."""
    out_lo, out_hi = torch.empty_like(s.lo), torch.empty_like(s.hi)
    ran = ctypes.c_int(-1)
    err = getattr(built.lib, entry)(
        s.lo.data_ptr(), s.hi.data_ptr(), out_lo.data_ptr(),
        out_hi.data_ptr(), s.lo.numel() // 12,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(ran))
    assert err == 0
    return bool(ran.value)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """Both variants (one thread and three threads per state) and the
    launcher's choice, bit-equal to the plain version; the launcher runs
    split up to its crossover; the launch counted with the states it
    permuted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    split_max = tp2.kernel_library().split_max
    w = tp2.poseidon2_permute
    aos = profiling.AOS
    for n in _gpu_sizes(split_max):
        s = tgl.from_u64(_states(n, n), "cuda")
        with profiling.recording():
            out = w(s)
            got = profiling.launch_counts()
        want = tp2.poseidon2_permute_plain(s)
        torch.cuda.synchronize()
        assert (got[aos], got[aos + ".states"]) == (1, n)
        assert _ran_split(tp2.kernel_library(), "p25_poseidon2_permute_w12",
                          s) == (n <= split_max)
        for got in (out, tp2._poseidon2_permute_variant(s, False),
                    tp2._poseidon2_permute_variant(s, True)):
            assert torch.equal(got.lo, want.lo) and torch.equal(got.hi, want.hi)
    e = tgl.from_u64(_edge_states(), "cuda")
    want = tp2.poseidon2_permute_plain(e)
    for split in (False, True):
        got = tp2._poseidon2_permute_variant(e, split)
        assert torch.equal(got.lo, want.lo) and torch.equal(got.hi, want.hi)


# ------------------------------------------------------------ lane-major form


@pytest.fixture(scope="module")
def soa_ref():
    """The JAX package's lane-major helpers (the Pallas `_soa_kernel`'s
    building blocks), called directly."""
    from plonky25_tpu.fields import gl
    from plonky25_tpu.ops.pallas import poseidon2_pallas as pp

    return types.SimpleNamespace(gl=gl, sbox=pp._soa_sbox, m4=pp._soa_m4,
                                 matmul_external=pp._soa_matmul_external)


def _lanes(n, seed, k):
    """k lane arrays of n seeded values, as numpy (k, n)."""
    return np.random.default_rng(seed).integers(0, P, size=(k, n),
                                                dtype=np.uint64)


@pytest.mark.parametrize("n", [1, 5, 257])
def test_soa_plain_matches_jax(ref, n):
    """`poseidon2_permute_pallas_soa` is bit-identical to the JAX
    `poseidon2_permute` (its interpret-mode run is too slow on the CPU,
    tests/test_pallas.py), so the lane-major plain version is held to it."""
    s = _states(n, 100 + n)
    out = tp2.poseidon2_permute_soa_plain(tgl.from_u64(s.T.copy(), "cpu"))
    want = _rows(ref.gl.to_u64(ref.permute(ref.gl.from_u64(s))))
    assert _rows(tgl.to_u64(out).T) == want


def test_soa_plain_on_edge_states_matches_oracle(ref):
    s = _edge_states()
    out = tp2.poseidon2_permute_soa_plain(tgl.from_u64(s.T.copy(), "cpu"))
    assert _rows(tgl.to_u64(out).T) == [ref.oracle([int(v) for v in row])
                                         for row in s]


def test_soa_plain_keeps_trailing_axes():
    s = _states(2 * 3, 4).T.copy().reshape(12, 2, 3)
    out = tp2.poseidon2_permute_soa_plain(tgl.from_u64(s, "cpu"))
    flat = tp2.poseidon2_permute_soa_plain(tgl.from_u64(s.reshape(12, 6), "cpu"))
    assert out.shape == (12, 2, 3)
    assert tgl.to_u64(out).reshape(12, 6).tolist() == tgl.to_u64(flat).tolist()


@pytest.mark.parametrize("helper", ["sbox", "m4", "matmul_external"])
def test_soa_helpers_match_jax_twins(soa_ref, helper):
    k = {"sbox": 1, "m4": 4, "matmul_external": 12}[helper]
    a = _lanes(33, 7 + k, k)
    ours = [tgl.from_u64(a[i], "cpu") for i in range(k)]
    theirs = [soa_ref.gl.from_u64(a[i]) for i in range(k)]
    if helper == "sbox":
        got, want = [tp2._soa_sbox(ours[0])], [soa_ref.sbox(theirs[0])]
    else:
        got = getattr(tp2, f"_soa_{helper}")(ours)
        want = getattr(soa_ref, helper)(theirs)
    assert [tgl.to_u64(x).tolist() for x in got] == [
        np.asarray(soa_ref.gl.to_u64(x), dtype=object).tolist() for x in want]


def test_soa_wrapper_runs_plain_on_cpu_tensors_without_counting():
    """The plain version counts its states and no launch."""
    s = tgl.from_u64(_states(3, 8).T.copy(), "cpu")
    with profiling.recording():
        out = tp2.poseidon2_permute_soa(s)
        got = profiling.launch_counts()
    assert (got[profiling.SOA], got[profiling.SOA + ".states"]) == (0, 3)
    assert tgl.to_u64(out).tolist() == \
        tgl.to_u64(tp2.poseidon2_permute_soa_plain(s)).tolist()


@pytest.mark.parametrize("bad, exc", [
    ("int32", TypeError), ("width", ValueError), ("strided", ValueError),
    ("shapes", ValueError), ("cpu", ValueError)])
def test_soa_kernel_input_check_rejects(bad, exc):
    lo = torch.zeros(12, 4, dtype=torch.int64)
    planes = {
        "int32": tgl.GL(lo.int(), lo.int()),
        "width": tgl.GL(lo[:8], lo[:8].clone()),
        "strided": tgl.GL(torch.zeros(4, 12, dtype=torch.int64).T, lo),
        "shapes": tgl.GL(lo, lo[:, :2]),
        "cpu": tgl.GL(lo, lo),
    }[bad]
    with pytest.raises(exc):
        tp2.check_kernel_input(planes, lane_axis=0)


def test_constants_header_matches_constants():
    """csrc/poseidon2_constants.cuh holds constants.py's tables, reduced."""
    import re

    from plonky25_torch.constants import MAT_DIAG_M_1, RC, RC_MID

    src = _csrc("poseidon2_constants.cuh")

    def table(name):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9A-F]{16})ull", body)]

    assert table("kRC") == [v % P for row in RC for v in row]
    assert table("kRCMid") == [v % P for v in RC_MID]
    assert table("kDiag") == [(d - 1) % P for d in MAT_DIAG_M_1]


@pytest.mark.cuda
def test_soa_kernel_matches_plain_and_state_major_kernel_on_gpu():
    """Both lane-major variants and the launcher's choice, bit-equal to the
    plain version and to the state-major kernel, transposed; the launcher
    runs split up to its crossover."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    split_max = tp2.soa_kernel_library().split_max
    w = tp2.poseidon2_permute_soa
    soa = profiling.SOA
    for rows in [_states(n, n) for n in _gpu_sizes(split_max)] + [
            _edge_states()]:
        n = len(rows)
        s = tgl.from_u64(rows.T.copy(), "cuda")
        with profiling.recording():
            out = w(s)
            got = profiling.launch_counts()
        want = tp2.poseidon2_permute_soa_plain(s)
        aos = tp2.poseidon2_permute(tgl.GL(s.lo.T.contiguous(),
                                           s.hi.T.contiguous()))
        torch.cuda.synchronize()
        assert (got[soa], got[soa + ".states"]) == (1, n)
        assert _ran_split(tp2.soa_kernel_library(),
                          "p25_poseidon2_permute_soa", s) == (n <= split_max)
        for got in (out, tp2._poseidon2_permute_soa_variant(s, False),
                    tp2._poseidon2_permute_soa_variant(s, True)):
            assert torch.equal(got.lo, want.lo) and torch.equal(got.hi, want.hi)
            assert torch.equal(got.lo, aos.lo.T) and torch.equal(got.hi, aos.hi.T)
