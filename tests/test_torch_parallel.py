"""The port's multi-device paths (plonky25_torch.parallel and the meshed
provers) against the JAX package's, on the CPU: gloo process groups of 2,
3 and 4 ranks (tests/torch_dist_worker.py, one spawn per world size).

The JAX results were computed on 8 virtual CPU devices by
scripts/make_torch_fixtures.py (group `parallel`, in
tests/fixtures/torch_tests_jax_values.json): ShardedVerifier over
make_mesh(8) (Q_pad 104), MultiHostBatchVerifier at (b=2, q=4), the
lde_mesh and meshed BatchProver proofs.  Padding repeats query 0, so a
world of w ranks gives Q_pad = ceil(100 / w) * w padded indices: the
first 100 are the proof's, the rest repeat the first."""

import json
import os

import pytest
import torch

import torch_dist_worker as W
from plonky25_torch.parallel import (
    init_distributed,
    make_batch_mesh,
    make_host_mesh,
    make_mesh,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "fixtures",
                       "torch_tests_jax_values.json")) as _f:
    _VALUES = json.load(_f)
JAX = _VALUES["parallel"]
JAX_UNSHARDED = _VALUES["verifier"]["fixture"]["fields"]
SCENARIOS = {2: "sharded_provers", 3: "sharded", 4: "multihost"}
_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(w): every rank's result of SCENARIOS[w], spawned once."""
    def get(world):
        if world not in _RUNS:
            _RUNS[world] = W.spawn(SCENARIOS[world], world,
                                   tmp_path_factory.mktemp(f"world{world}"))
        return _RUNS[world]
    return get


def _padded(indices, q_pad):
    return indices + [indices[0]] * (q_pad - len(indices))


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_pads_and_splits_the_queries(ranks, world):
    q_pad = -(-100 // world) * world
    runs = ranks(world)
    assert [r["Q_pad"] for r in runs] == [q_pad] * world
    assert [r["n_dev"] for r in runs] == [world] * world
    step = q_pad // world
    assert [r["plan"] for r in runs] == [[i * step, (i + 1) * step]
                                         for i in range(world)]
    assert JAX["sharded"]["Q_pad"] == 104


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_accepts_with_the_jax_transcript(ranks, world):
    want = JAX["sharded"]["fields"]
    for r in ranks(world):
        got = r["accept"]
        for k in ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok",
                  "alpha", "zeta"):
            assert got[k] == want[k], k
        assert got["shape_ok"]
        # JAX pads to 104 on 8 devices; both repeat query 0
        assert want["query_indices"] == _padded(want["query_indices"][:100],
                                                104)
        assert got["query_indices"] == _padded(want["query_indices"][:100],
                                               r["Q_pad"])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_rejects_the_tamper_on_every_rank(ranks, world):
    """Query 99 lies on the last rank only; the MIN all-reduce carries its
    Merkle failure to every rank."""
    want = JAX["sharded"]["tamper"]
    for r in ranks(world):
        got = r["tamper"]
        assert {k: got[k] for k in want} == want
        assert not got["ok"] and not got["merkle_ok"]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_matches_unsharded(ranks, world):
    for r in ranks(world):
        got = r["accept"]
        assert got["alpha"] == JAX_UNSHARDED["alpha"]
        assert got["zeta"] == JAX_UNSHARDED["zeta"]
        assert got["query_indices"][:100] == JAX_UNSHARDED["query_indices"]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_fails_closed_on_a_bad_shape(ranks, world):
    for r in ranks(world):
        assert r["short"] == {"ok": False, "pow_ok": False,
                              "merkle_ok": False, "fold_ok": False,
                              "quotient_ok": False, "shape_ok": False}


def test_verify_proof_sharded_on_the_default_mesh(ranks):
    for r in ranks(2):
        assert r["one_call"] == r["accept"]


def test_lde_mesh_prover_is_byte_equal(ranks):
    want = JAX["provers"]
    assert want["lde_mesh"] == want["unmeshed"]
    assert [r["lde_mesh"] for r in ranks(2)] == [want["lde_mesh"]] * 2


def test_meshed_batch_prover_is_byte_equal_in_order(ranks):
    """Rank r proves lanes [2r, 2r + 2); every rank returns all four, each
    the JAX package's proof of its trace (lanes 1 and 3 changed traces)."""
    want = JAX["provers"]
    assert want["batch_mesh"] == want["single"]
    assert len(set(want["single"])) == 3
    assert want["single"][0] == want["unmeshed"]
    for r in ranks(2):
        assert r["batch_mesh"] == want["single"]


def test_multihost_accepts_and_rejects(ranks):
    want = JAX["multihost"]
    assert (want["n_batch"], want["n_query"], want["Q_pad"]) == (2, 4, 100)
    runs = ranks(4)
    assert sorted(tuple(r["coords"]) for r in runs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in runs:
        assert r["shape"] == [2, 2, 100]
        assert r["ok"] == want["ok"] == [True, False, True, True]
        assert r["all_ok"] is want["all_ok"] is False
        # make_host_mesh(n_query=2) and verify_proof_batch_multihost
        assert r["host_mesh"] == [[True, False], False]


def test_multihost_matches_batch_verifier(ranks):
    runs = ranks(4)
    assert runs[1]["batch_verifier"] == runs[1]["ok"]
    assert JAX["multihost"]["batch_verifier"] == JAX["multihost"]["ok"]


def test_host_mesh_errors_and_default(ranks):
    for r in ranks(4):
        e = r["errors"]
        for n in ("0", "5"):
            assert e[n] == (f"n_query={n} must be in [1, 4] (total devices "
                            f"available)")
        assert e["3"] == "n_query=3 must divide the device count 4 evenly"
        assert "multiple of the 'b' mesh extent 2" in e["batch_3"]
        assert r["default_host_mesh"] == [1, 4]


def test_no_group_without_an_address_or_a_launcher():
    """Single-process mode, as the JAX package without a coordinator: no
    group is made, and the meshes say why they cannot be built."""
    assert init_distributed() is False
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    for call in (lambda: make_mesh(device="cpu"),
                 lambda: make_batch_mesh(1, 1, device="cpu"),
                 lambda: make_host_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="no torch.distributed process"):
            call()
    with pytest.raises(ValueError, match="num_processes and process_id"):
        init_distributed("127.0.0.1:1", device="cpu")
