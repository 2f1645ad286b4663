"""The correctness check catches a broken timed path, on the CPU.

Each test drives the rest of a run (set-up, a traced window of two calls,
the reference's judgement) with the harness's look for a card skipped and
the timed path broken underneath, and sees `correct` come out false: once
for each fault a cell can have, and once for each control in the
program's place (p3bench/control.py).  The cells run cut to what a test
run holds: 8 lanes, or Keccak traces of 32 rows at 8 FRI queries; the
sizes the benchmark times run on the card (p3bench/control.py).

    python -m pytest p3bench/tests/test_p3bench_faults.py -q   # ~6 min
"""

import copy

import numpy as np
import pytest
import torch

from p3bench import control
from p3bench.harness.core import Cell, run_cell

SEED = 2**31 + 17


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def verify_cell():
    c = Cell.load("fib-golden.verify-b2048")
    c.traffic = dict(c.traffic, batch=8, tampered_per_batch=5,
                     distinct_batches=2)
    c.cell = dict(c.cell, trace_calls=2)
    return c


def prove_cell():
    c = Cell.load("keccak-2p14.prove")
    c.config = dict(c.config, log_n=5,
                    fri={"log_blowup": 1, "num_queries": 8,
                         "proof_of_work_bits": 10})
    c.traffic = dict(c.traffic, distinct_traces=2, checked_proofs=2)
    c.cell = dict(c.cell, trace_calls=2)
    return c


def run(cell, hook=None):
    return run_cell(cell, SEED, 0, True, "cpu", hook=hook,
                    log=lambda line: None)


# ------------------------------------------------------------ verify faults

def altered_verdict(op):
    verify = op.verify

    def broken(ws, on_stage):
        ok = verify(ws, on_stage).copy()
        ok[3] = ~ok[3]
        return ok
    op.verify = broken


def half_batch(op):
    """The first half of the lanes verified, its verdicts given to all."""
    verify = op.verify

    def broken(ws, on_stage):
        ok = verify(ws, on_stage)
        half = len(ok) // 2
        return np.concatenate([ok[:half], ok[:len(ok) - half]])
    op.verify = broken


def stale_state(op):
    """Each call returns the verdicts of the call before it."""
    verify, last = op.verify, []

    def broken(ws, on_stage):
        ok = verify(ws, on_stage)
        out = last[-1] if last else ok
        last.append(ok)
        return out
    op.verify = broken


PLANTED = []      # the program objects a planted fault patched


def final_accepts_all(op):
    """The program's final stage (the constraint check at zeta) accepts
    every lane; the other four stages run as they are."""
    base = op.bv.base
    final = base._final_fn

    def broken(*args):
        return torch.ones_like(final(*args))
    base._final_fn = broken
    PLANTED.append(base)


@pytest.fixture
def unplant():
    yield
    while PLANTED:
        PLANTED.pop().__dict__.pop("_final_fn", None)


def test_verify_cell_is_correct_unbroken():
    r = run(verify_cell())
    assert r["correct"] and r["attempted"] == 16
    assert r["checks"]["verdicts_differing"]["value"] == 0
    # the broken trace's proof fails the constraint check and no other
    assert r["checks"]["broken_proof_not_isolated"]["value"] == 0


@pytest.mark.parametrize("fault", [altered_verdict, half_batch, stale_state,
                                   final_accepts_all])
def test_verify_cell_catches(fault, unplant):
    r = run(verify_cell(), fault)
    assert not r["correct"]
    assert r["checks"]["verdicts_differing"]["value"] > 0


@pytest.mark.parametrize("ctl", [control.verify_control,
                                 control.constraint_control])
def test_verify_control_is_not_correct(ctl):
    r = run(verify_cell(), ctl)
    assert not r["correct"]
    assert r["checks"]["verdicts_differing"]["value"] > 0


# ------------------------------------------------------------ prove faults

def altered_proof(op):
    prove = op.prove

    def broken(cols, on_stage):
        p = prove(cols, on_stage)
        c0, c1 = p.opened_values.trace_local[7]
        p.opened_values.trace_local[7] = ((c0 + 1) % (2**64 - 2**32 + 1), c1)
        return p
    op.prove = broken


def stale_proof(op):
    """Each call returns the proof of the call before it."""
    prove, last = op.prove, []

    def broken(cols, on_stage):
        p = prove(cols, on_stage)
        out = last[-1] if last else p
        last.append(p)
        return out
    op.prove = broken


@pytest.fixture(scope="module")
def proofs():
    """The program's proofs of the prove cell's traces, from a clean run
    (the proofs are deterministic, so a fault replays them)."""
    out = {}

    def record(op):
        prove = op.prove

        def recording(cols, on_stage):
            k = [id(c) for c in op.cols].index(id(cols))
            out[k] = prove(cols, on_stage)
            return out[k]
        op.prove = recording

    r = run(prove_cell(), record)
    assert r["correct"], r["checks"]
    return out


def replayed(fault):
    """The hook: the recorded proofs in the program's place, then fault."""
    def hook(op, proofs):
        op.prove = lambda cols, on_stage: copy.deepcopy(
            proofs[[id(c) for c in op.cols].index(id(cols))])
        fault(op)
    return hook


def test_prove_cell_is_correct_unbroken(proofs):
    assert sorted(proofs) == [0, 1]
    r = run(prove_cell(), lambda op: replayed(lambda op: None)(op, proofs))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [altered_proof, stale_proof])
def test_prove_cell_catches(fault, proofs):
    r = run(prove_cell(), lambda op: replayed(fault)(op, proofs))
    assert not r["correct"]


def test_prove_control_is_not_correct():
    r = run(prove_cell(), control.prove_control)
    assert not r["correct"]
    assert r["checks"]["proofs_rejected"]["value"] > 0
