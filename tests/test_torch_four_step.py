"""The port's four-step NTT (plonky25_torch.ops.ntt: ntt_four_step,
four_step_output, coset_ntt_four_step with and without a mesh) and the
module's coset_lde and barycentric_eval, against the JAX package's values
(tests/test_ntt.py's inputs; scripts/make_torch_fixtures.py, group
`parallel`, in tests/fixtures/torch_tests_jax_values.json).  The meshed
transform runs on gloo groups of 2 and 4 ranks
(tests/torch_dist_worker.py); every rank must return the whole result."""

import json
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from plonky25_torch.fields import gl
from plonky25_torch.ops import ntt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "fixtures",
                       "torch_tests_jax_values.json")) as _f:
    JAX = json.load(_f)["parallel"]["four_step"]
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = W.spawn("four_step", world,
                                   tmp_path_factory.mktemp(f"world{world}"))
        return _RUNS[world]
    return get


def _ints(x):
    return W.ints(x)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ntt_four_step_matches_jax(direction):
    x = gl.from_u64(JAX["8x16_input"], "cpu").reshape(8, 16)
    m = ntt.ntt_four_step(x, inverse=direction == "inverse")
    want = JAX[f"8x16_{direction}"]
    assert _ints(m) == want["matrix"]
    assert _ints(ntt.four_step_output(m)) == want["output"]
    assert want["output"] == _ints(ntt.ntt(
        gl.from_u64(JAX["8x16_input"], "cpu"),
        inverse=direction == "inverse"))


def test_coset_ntt_four_step_matches_jax():
    _, c = W.four_step_inputs()
    coeffs = gl.from_u64(c, "cpu")
    assert _ints(ntt.coset_ntt_four_step(coeffs, 7, log_rows=3)) == \
        JAX["coset_256"]
    assert JAX["coset_256"] == _ints(ntt.coset_ntt(coeffs, 7))
    for log_rows in (0, 1, 5, 8):
        assert _ints(ntt.coset_ntt_four_step(coeffs, 7, log_rows)) == \
            JAX["coset_256"]


def test_batched_four_step_equals_coset_ntt():
    rng = np.random.default_rng(3)
    x = gl.from_u64(rng.integers(0, W.P, size=(2, 3, 64), dtype=np.uint64),
                    "cpu")
    assert _ints(ntt.coset_ntt_four_step(x, 7, log_rows=2)) == \
        _ints(ntt.coset_ntt(x, 7))


@pytest.mark.parametrize("world", [2, 4])
def test_meshed_four_step_matches_jax(ranks, world):
    for r in ranks(world):
        assert r["coset_256_r3"] == JAX["coset_256"]
        assert r["coset_256_r2"] == JAX["coset_256"]
        # the JAX ntt_four_step over make_mesh(8), (8, 64) seed 12
        assert r["coset_512"] == JAX["8x64_sharded"]
        assert r["batched_equal"]


@pytest.mark.parametrize("world", [2, 4])
def test_meshed_view_must_split_over_the_ranks(ranks, world):
    for r in ranks(world):
        assert r["too_small"] == (f"a (1, 4) four-step view does not split "
                                  f"over {world} ranks")


def test_barycentric_eval_matches_jax():
    b = JAX["barycentric"]
    got = ntt.barycentric_eval(gl.from_u64(b["evals"], "cpu"), b["shift"],
                               gl.from_u64(b["z"], "cpu"))
    assert _ints(got) == b["output"]


@pytest.mark.parametrize("case", range(3))
def test_coset_lde_matches_jax(case):
    c = JAX["coset_lde"]["cases"][case]
    got = ntt.coset_lde(gl.from_u64(JAX["coset_lde"]["evals"], "cpu"),
                        c["log_blowup"], c["shift"])
    assert _ints(got) == c["output"]
