"""The gamma sponge's chunk programs (plonky25_torch/attest_program.py's
`_chain_chunk_fn` and `_chain_states_fn`, utils/graphs.py StaticPrograms of
GAMMA_CHUNK sponge steps) against the JAX package's
derive_gammas_from_pairs and the eager `_chain` loop, bit for bit
(tolerance 0: every value is an integer).

On the CPU a program runs `_chain` on its static buffers, so these tests
hold the chunk loop, the loads from the stream on the device, the padding
and the program cache.  The JAX gammas of the seeded streams (1, 2 and 3
GAMMA_CHUNKs per lane) are committed under `gamma_programs` in
tests/fixtures/torch_tests_jax_values.json (`python
scripts/make_torch_fixtures.py gamma_programs`, ~30 s), so this file
imports no JAX.  Each plain permutation of 5 states takes ~60 ms here,
so the file runs ~3,000 of them (~3 min).  The case marked `cuda` replays
the graphs on a GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_gamma_programs.py
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import plonky25_torch.attest_program as ap
from plonky25_torch.fields import gl
from plonky25_torch.fields.goldilocks import GL
from plonky25_torch.ops import poseidon2
from plonky25_torch.utils import profiling

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_verifier.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _want():
    with open(os.path.join(FIXTURES, "torch_tests_jax_values.json")) as f:
        return json.load(f)["gamma_programs"]


def _pairs(chunks):
    """scripts/make_torch_fixtures.py's gamma_pairs: (n_rows, uint64 (n, 2)
    pairs) of `chunks` GAMMA_CHUNKs per lane, 37 pairs short."""
    n = 5 * 256 * chunks - 37
    rng = np.random.default_rng(1000 + chunks)
    return n // 3, rng.integers(0, P, size=(n, 2), dtype=np.uint64)


def _as_list(pairs):
    return [(int(a), int(b)) for a, b in pairs]


def _zero_start(device):
    """The sub-chains' start: the permutation of the zero state."""
    return poseidon2.poseidon2_permute(gl.zeros((ap.GAMMA_LANES, 12), device))


@pytest.fixture(scope="module")
def eager2():
    """The 2-chunk stream and its eager `_chain(record=True)` from the
    zero start: (stream, final state, ins, outs) as uint64 arrays."""
    stream = ap._gamma_stream(_as_list(_pairs(2)[1]), "cpu")
    state, ins, outs = ap._chain(_zero_start("cpu"), stream, record=True)
    return stream, gl.to_u64_np(state), gl.to_u64_np(ins), gl.to_u64_np(outs)


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_derive_gammas_through_the_programs_match_jax(chunks):
    want = _want()[str(chunks)]
    n_rows, pairs = _pairs(chunks)
    assert hashlib.sha256(pairs.tobytes()).hexdigest() == want["sha256"]
    assert (n_rows, len(pairs)) == (want["n_rows"], want["n_pairs"])
    assert ap.padded_pair_count(len(pairs)) == 5 * 256 * chunks
    got = ap.derive_gammas_from_pairs(n_rows, _as_list(pairs), "cpu")
    assert list(got) == want["gammas"]


def test_chunk_program_equals_the_eager_chain(eager2):
    """Two replays of the chunk program from the zero start give the
    eager loop's final states over the same stream."""
    stream, final, _, _ = eager2
    assert stream.shape == (512, ap.GAMMA_LANES, 2)
    assert (ap._chain_digests(stream) == final).all()


def test_states_program_equals_the_recorded_chain(eager2):
    """`_chain_states_fn`'s ins and outs are `_chain(record=True)`'s, step
    for step, across the chunk boundary; the final state is carried into
    the second chunk."""
    stream, final, ins, outs = eager2
    prog = ap._chain_states_fn(ap.GAMMA_LANES, "cpu")
    state = _zero_start("cpu")
    got_ins, got_outs = [], []
    for off in (0, ap.GAMMA_CHUNK):
        state, i, o = prog(state, stream[off:off + ap.GAMMA_CHUNK])
        got_ins.append(gl.to_u64_np(i))
        got_outs.append(gl.to_u64_np(o))
        assert (gl.to_u64_np(state) == got_outs[-1][-1]).all()
    assert (np.concatenate(got_ins) == ins).all()
    assert (np.concatenate(got_outs) == outs).all()
    assert (gl.to_u64_np(state) == final).all()


def test_one_program_per_kind_n_and_device():
    chunk = ap._chain_chunk_fn(ap.GAMMA_LANES, "cpu")
    assert ap._chain_chunk_fn(ap.GAMMA_LANES, torch.device("cpu")) is chunk
    assert ap._chain_chunk_fn(3, "cpu") is not chunk
    states = ap._chain_states_fn(ap.GAMMA_LANES, "cpu")
    assert states is not chunk
    assert ap._chain_states_fn(ap.GAMMA_LANES, "cpu") is states
    for key in (("chunk", ap.GAMMA_LANES, "cpu"), ("chunk", 3, "cpu"),
                ("states", ap.GAMMA_LANES, "cpu")):
        assert key in ap._chain_fn_cache
    state, pairs = chunk.inputs
    assert state.shape == (ap.GAMMA_LANES, 12)
    assert pairs.shape == (ap.GAMMA_CHUNK, ap.GAMMA_LANES, 2)
    with pytest.raises(ValueError):      # a chunk of another length
        chunk(state, gl.zeros((ap.GAMMA_CHUNK - 1, ap.GAMMA_LANES, 2),
                              "cpu"))


def test_the_chunk_body_leaves_its_input_as_loaded():
    """The chunk program's body permutes a copy of the loaded state (on
    the card its warm-up and its capture run on the same buffers); the
    states body copies at every step."""
    start = gl.from_u64(np.arange(24, dtype=np.uint64).reshape(2, 12), "cpu")
    pairs = gl.from_u64(np.full((1, 2, 2), 7, np.uint64), "cpu")
    kept = gl.to_u64_np(start)
    out = ap._chunk(start, pairs)
    assert (gl.to_u64_np(start) == kept).all()
    state, ins, outs = ap._chunk_states(start, pairs)
    assert (gl.to_u64_np(start) == kept).all()
    assert (gl.to_u64_np(state) == gl.to_u64_np(out)).all()
    assert (gl.to_u64_np(ins)[0, :, 2:] == kept[:, 2:]).all()
    assert (gl.to_u64_np(ins)[0, :, :2] == 7).all()
    assert (gl.to_u64_np(outs)[0] == gl.to_u64_np(out)).all()


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_chunk_programs_replay_on_the_card():
    """The chunk program's graph equals the eager chain over two chunks on
    the card; each replay counts GAMMA_CHUNK state-major launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph of the kernels)")
    stream = ap._gamma_stream(_as_list(_pairs(2)[1]), "cuda")
    start = _zero_start("cuda")
    eager = ap._chain(GL(start.lo.clone(), start.hi.clone()), stream,
                      record=True)
    assert (ap._chain_digests(stream) == gl.to_u64_np(eager[0])).all()
    _, got = profiling.counted(lambda: ap._chain_digests(stream))
    launches = 1 + 2 * ap.GAMMA_CHUNK
    assert (got[profiling.AOS], got[profiling.AOS + ".states"]) == (
        launches, launches * ap.GAMMA_LANES)
    prog = ap._chain_states_fn(ap.GAMMA_LANES, "cuda")
    state = start
    for off in (0, ap.GAMMA_CHUNK):
        state, ins, outs = prog(state, stream[off:off + ap.GAMMA_CHUNK])
        assert torch.equal(ins.lo, eager[1].lo[off:off + ap.GAMMA_CHUNK])
        assert torch.equal(outs.hi, eager[2].hi[off:off + ap.GAMMA_CHUNK])
    assert prog.stats["capture_ms"] > 0
