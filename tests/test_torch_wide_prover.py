"""The prover's wide-AIR memory strategies in the port, on the CPU: each
gives the proof bytes of the one-shot stages (tolerance 0: the arithmetic
is exact, and every strategy only splits per-column work), as
tests/test_tpu_prover.py:46-192 requires of the JAX TpuProver:

  * a W=5 / W=6 AIR (the counterpart of that file's _Wide5Air) with the
    strided quotient segmentation at S=2 and S=4, quotient column groups
    (G=2: the narrower last group at W=5, the exact divisor at W=6), LDE
    column chunks, and both column slabs forced to 2 columns, each alone
    and all at once;
  * fib(64) at S=2, byte-equal to tests/fixtures/proof_fibonacci_refimpl.json
    (the proof whose transcript proof_fibonacci_expected.json holds);
  * RlcAir at 16 rows and S=4, whose stage-2 columns are segmented too;
  * get_prover's cache keyed on the knobs, and BatchProver at S=2.

The unchunked port proof is held to JAX and the int oracle elsewhere
(test_torch_prover.py, test_torch_multistage.py), so these tests hold
the port against itself.
"""

import importlib
import json
import os
import random

import numpy as np
import pytest
import torch

from plonky25_torch.models import FibonacciAir, RlcAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.proof import FriConfig, proof_to_json
from plonky25_torch.prover import BatchProver, TorchProver
from plonky25_torch.prover.prove import get_prover

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FC = FriConfig(log_blowup=1, num_queries=2, proof_of_work_bits=1)
# the module (the package exports its `prove` function under that name)
prove_mod = importlib.import_module("plonky25_torch.prover.prove")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the test run shares the CPU between worker
    processes (see tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Wide5Air:
    """tests/test_tpu_prover.py's _Wide5Air: the first column of each row
    sums the row before, the first row starts at 1.  Width 5 is odd, so
    G=2 leaves a narrower last group (3 + 2 columns); width 6 takes the
    exact divisor (3 + 3)."""

    def __init__(self, w: int = 5):
        self._w = w

    def name(self):
        return f"Wide{self._w}"

    def width(self):
        return self._w

    def stage2_width(self):
        return 0

    def num_challenges(self):
        return 0

    def public_values(self):
        return {}

    def quotient_degree(self):
        return 2

    def eval(self, folder):
        ops = folder.ops
        loc = folder.main.trace_local[:self._w]
        nxt = folder.main.trace_next[:self._w]
        tot = loc[0]
        for v in loc[1:]:
            tot = ops.add(tot, v)
        folder.when_transition().assert_eq(nxt[0], tot)
        folder.when_first_row().assert_eq(loc[0], ops.one())


def wide_trace(h, w=5, seed=11):
    rng = random.Random(seed)
    rows = [[1] + [rng.randrange(P) for _ in range(w - 1)]]
    for _ in range(h - 1):
        rows.append([sum(rows[-1]) % P]
                    + [rng.randrange(P) for _ in range(w - 1)])
    return rows


def _text(proof):
    return json.dumps(proof_to_json(proof), separators=(",", ":"))


def _prove(air, trace, fc=FC, s=1, g=None, chunks=None, slab=None):
    p = TorchProver(air, len(trace).bit_length() - 1, fc, "cpu",
                    quotient_eval_chunks=s, quotient_col_groups=g)
    p.commit_col_chunks = chunks
    if slab:
        p._ro_col_slab = p._bary_col_slab = slab
    return p.prove(trace)


@pytest.fixture(scope="module")
def wide_base():
    """The one-shot W=5 and W=6 proofs of 32 rows: the budgets are far
    above these shapes, so no strategy engages."""
    out = {}
    for w in (5, 6):
        tr = wide_trace(32, w)
        out[w] = (tr, _text(_prove(Wide5Air(w), tr)))
    return out


@pytest.mark.parametrize("w, knobs", [
    (5, dict(s=2)),
    (5, dict(s=4)),
    (5, dict(s=2, g=2)),                  # groups of 3 and 2 columns
    (5, dict(s=4, g=2)),
    (6, dict(s=2, g=2)),                  # the exact divisor: 3 and 3
    (5, dict(chunks=2)),                  # LDE commit in 3 + 2 columns
    (5, dict(slab=2)),                    # slabs of 2, 2, 1 columns
    (5, dict(s=4, g=2, chunks=2, slab=2)),
    (6, dict(s=2, g=2, chunks=3, slab=2)),
])
def test_strategy_is_byte_equal_to_the_one_shot_proof(wide_base, w, knobs):
    tr, want = wide_base[w]
    assert _text(_prove(Wide5Air(w), tr, **knobs)) == want


def test_the_strategies_engage(monkeypatch):
    """The forced knobs reach the split code: column chunks and groups
    split the columns, the slabs split the sums, the segments evaluate
    the AIR S times at q / S points each."""
    calls = {"lde": [], "bary": [], "eval": []}
    p = TorchProver(Wide5Air(), 5, FC, "cpu", quotient_eval_chunks=4,
                    quotient_col_groups=2)
    p.commit_col_chunks = 2
    p._ro_col_slab = p._bary_col_slab = 2
    real_lde, real_fold = p._commit_trace_fn, p._fold
    monkeypatch.setattr(p, "_commit_trace_fn", lambda c: (
        calls["lde"].append(c.shape[1]), real_lde(c))[1])
    monkeypatch.setattr(p, "_fold", lambda main, shape, *a: (
        calls["eval"].append(shape), real_fold(main, shape, *a))[1])
    real_bary = prove_mod.barycentric_eval_ext
    monkeypatch.setattr(prove_mod, "barycentric_eval_ext", lambda *a, **k: (
        calls["bary"].append(k.get("col_slab")), real_bary(*a, **k))[1])
    real_sum = prove_mod.gl2.sum_dim
    monkeypatch.setattr(prove_mod.gl2, "sum_dim", lambda x, dim: (
        dim == -2 and calls.setdefault("ro", []).append(x.shape[-2]),
        real_sum(x, dim))[1])
    p.prove(wide_trace(32))
    assert calls["lde"] == [3, 2]
    assert calls["eval"] == [(1, 16)] * 4          # q = 64 points, S = 4
    # the trace at zeta and zeta * g in slabs, the quotient chunks whole
    assert calls["bary"] == [2, 2, None, None]
    assert calls["ro"] == [2, 2, 1, 2, 2, 1, 4]
    assert p._col_groups(1, 5) == 3 and TorchProver(
        Wide5Air(6), 5, FC, "cpu", quotient_col_groups=2)._col_groups(1, 6) == 3


def test_fibonacci_segmented_is_the_fixture():
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        fc = FriConfig(**json.load(f)["fri_config"])
    with open(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")) as f:
        want = f.read()
    assert _text(_prove(FibonacciAir(), fibonacci_trace(64), fc, s=2)) == want


def test_rlc_stage2_segmented_is_byte_equal():
    """tests/test_tpu_prover.py:186-192: RlcAir at 16 rows, S=4 (M = 8
    points per segment, below the 16-row height: the fold sums K = 2
    coefficient blocks), its stage-2 column segmented with the trace."""
    fc = FriConfig(log_blowup=1, num_queries=8, proof_of_work_bits=4)
    rng = random.Random(5)
    trace = [[rng.randrange(1 << 63), rng.randrange(1 << 63)]
             for _ in range(16)]
    base = _prove(RlcAir(), trace, fc)
    assert _text(_prove(RlcAir(), trace, fc, s=4)) == _text(base)
    assert base.commitments.stage2 is not None


@pytest.mark.parametrize("log_n, want", [(14, 1), (16, 1), (19, 8)])
def test_prove_on_device_segments_verifier_air_by_the_budget(
        log_n, want, monkeypatch):
    """prove_on_device's S for the 620-column VerifierAir: the least power
    of two with W * 2^(log_n + 1) * 32 / S within QUOTIENT_EVAL_BYTES (the
    JAX rule; 3 GiB, measured on the H100: PERF.md) — the golden
    attestation (2^14) and attest_many's B=4 (2^16) unsegmented, the
    composed attestation's 2^19 outer STARK in 8 segments."""
    from plonky25_torch.models.verifier_air import VerifierAir

    air = VerifierAir()
    s = prove_mod.quotient_eval_chunks_for(air, log_n)
    ws = air.width() * (2 << log_n) * 32
    assert s == want
    assert ws // s <= prove_mod.QUOTIENT_EVAL_BYTES
    assert s == 1 or ws // (s // 2) > prove_mod.QUOTIENT_EVAL_BYTES
    monkeypatch.setattr(prove_mod, "QUOTIENT_EVAL_BYTES", ws // 16)
    assert prove_mod.quotient_eval_chunks_for(air, log_n) == 16


def test_prove_on_device_segments_and_keeps_the_bytes(monkeypatch):
    """With the budget a quarter of fib(64)'s working set (2 columns x 128
    quotient points x 32 bytes), prove_on_device proves its columns at
    S = 4 and gives the fixture's bytes."""
    monkeypatch.setattr(prove_mod, "QUOTIENT_EVAL_BYTES", 2048)
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        fc = FriConfig(**json.load(f)["fri_config"])
    with open(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")) as f:
        want = f.read()
    used = []
    real = prove_mod.get_prover

    def spy(air, log_n, fri_config, device, s=1):
        used.append(s)
        return real(air, log_n, fri_config, device, s)

    monkeypatch.setattr(prove_mod, "get_prover", spy)
    cols = prove_mod.trace_columns([fibonacci_trace(64)], "cpu")
    got = prove_mod.prove_on_device(FibonacciAir(), type(cols)(
        cols.lo[0], cols.hi[0]), fc, device="cpu")
    assert used == [4] and _text(got) == want


def test_get_prover_keys_on_the_knobs():
    air = Wide5Air()
    a = get_prover(air, 5, FC, "cpu")
    assert get_prover(air, 5, FC, "cpu") is a
    b = get_prover(air, 5, FC, "cpu", quotient_eval_chunks=2)
    c = get_prover(air, 5, FC, "cpu", quotient_eval_chunks=2,
                   quotient_col_groups=2)
    assert len({id(a), id(b), id(c)}) == 3
    assert (a.quotient_eval_chunks, b.quotient_eval_chunks,
            c.quotient_col_groups) == (1, 2, 2)
    assert BatchProver(air, 5, FC, "cpu", quotient_eval_chunks=2).base is b
    with pytest.raises(ValueError):
        TorchProver(air, 5, FC, "cpu", quotient_eval_chunks=3)


def test_batch_prover_segmented_equals_single_proofs(wide_base):
    trs = [wide_trace(32, 5, seed) for seed in (11, 12)]
    got = BatchProver(Wide5Air(), 5, FC, "cpu",
                      quotient_eval_chunks=2).prove(np.asarray(trs, np.uint64))
    assert _text(got[0]) == wide_base[5][1]
    assert _text(got[1]) == _text(_prove(Wide5Air(), trs[1]))
    assert _text(got[0]) != _text(got[1])
