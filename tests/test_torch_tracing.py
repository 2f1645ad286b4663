"""The port's tracing switch, spans and counters (utils/profiling.py) on
the CPU: off, nothing is recorded and no annotation entered; on, inside
recording() or while torch.profiler records, each span is a user
annotation of the profiler's trace with the table's name, nesting and
duration, and one call's spans share its call; the Poseidon2 counters
count what the verifier's and the prover's paths permute; the
benchmark's readers of the table (p3bench/metrics).  The last test runs
on the card: the spans leave the device trace's kernels and busy time as
they were.  This file imports no JAX."""

import contextlib
import os
import time

import pytest
import torch

from p3bench.harness.core import Run, load_module
from p3bench.harness.timeline import Timeline
from plonky25_torch.fields import gl
from plonky25_torch.models import FibonacciAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.ops import poseidon2
from plonky25_torch.parallel.batch import BatchVerifier, stack_witnesses
from plonky25_torch.proof import FriConfig, derive_config, load_proof
from plonky25_torch.prover.prove import (TorchProver, grind_window,
                                         trace_columns)
from plonky25_torch.utils import profiling
from plonky25_torch.witness import pack_witness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "proof_fibonacci_refimpl.json")
FC = FriConfig(1, 100, 16)
AOS, SOA = profiling.AOS, profiling.SOA


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(table):
    return [s.name for s in table.spans]


# ------------------------------------------------------------ the switch

def test_off_records_nothing_and_enters_no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.tracing()
    before = profiling.table()
    spans, counts = list(before.spans), dict(before.counts)
    with profiling.span("off"):
        profiling.count("off.count", 5)
        poseidon2.poseidon2_permute(gl.zeros((2, 12), "cpu"))
    with profiling.recording_launches() as rec:
        poseidon2._launched("w12", 7)
    profiling.replay_launches(rec)
    assert profiling.table() is before
    assert list(before.spans) == spans and before.counts == counts


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_spans_nest_and_match_the_profilers_annotations(how):
    """On in both ways: the table's spans are user annotations of the
    profiler's trace under the same names, nested alike, their durations
    within 10% of the trace's."""
    from torch.profiler import ProfilerActivity, profile

    block = (profiling.recording() if how == "recording"
             else contextlib.nullcontext())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with block:
            assert profiling.tracing()
            with profiling.span("outer"):
                time.sleep(0.03)
                with profiling.span("inner"):
                    time.sleep(0.03)
            mine = [s for s in profiling.table().spans
                    if s.name in ("plonky25.outer", "plonky25.inner")][-2:]
    inner, outer = mine
    assert (inner.name, outer.name) == ("plonky25.inner", "plonky25.outer")
    assert inner.parent == outer.id and outer.parent == -1
    assert inner.call == outer.call
    assert outer.start_ns <= inner.start_ns
    assert inner.start_ns + inner.dur_ns <= outer.start_ns + outer.dur_ns
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.SPAN_PREFIX)}
    assert set(events) == {"plonky25.outer", "plonky25.inner"}
    eo, ei = events["plonky25.outer"], events["plonky25.inner"]
    assert eo.is_user_annotation() and ei.is_user_annotation()
    assert eo.start_ns() <= ei.start_ns()
    assert (ei.start_ns() + ei.duration_ns()
            <= eo.start_ns() + eo.duration_ns())
    for rec, ev in ((outer, eo), (inner, ei)):
        assert rec.dur_ns == pytest.approx(ev.duration_ns(), rel=0.1)


def test_a_root_span_starts_a_call_and_recording_adds_up():
    process = profiling.table()
    spans, counts = list(process.spans), dict(process.counts)
    with profiling.recording() as outer:
        profiling.count("x", 2)
        with profiling.recording() as inner:
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
            profiling.count("x", 3)
        assert inner.counts == {"x": 3}
        assert outer.counts == {"x": 5}
        assert _names(outer) == _names(inner) == [
            "plonky25.b", "plonky25.a", "plonky25.c"]
    b, a, c = inner.spans
    assert b.call == a.call != c.call and b.parent == a.id
    assert not profiling.tracing()
    # the process's table holds what the profiler traced, not the blocks'
    assert profiling.table() is process
    assert list(process.spans) == spans and process.counts == counts


# ------------------------------------------------------------ counters

@pytest.fixture(scope="module")
def fib_batch():
    proof = load_proof(FIXTURE)
    cfg = derive_config(proof, FC)
    ws = stack_witnesses([pack_witness(proof, cfg, "cpu")] * 2)
    return BatchVerifier(FibonacciAir(), cfg, "cpu"), ws


def test_staged_batch_counts_the_lock_step_walk(fib_batch):
    """fib(64), B = 2, staged: the state-major states are the program's
    lock-step walk (chip_smoke.py's verify_path_shapes), which is 1 /
    0.742 of what the shapes need (p3bench/harness/shapes.py)."""
    from chip_smoke import verify_path_shapes
    from p3bench.harness import shapes

    bv, ws = fib_batch
    with profiling.recording() as t:
        assert bv.verify_witnesses(ws, fused=False).tolist() == [True] * 2
    walked = sum(n * c for n, c in verify_path_shapes(bv.base, 2).items())
    assert t.counts == {"poseidon2.w12.states": walked}
    need = shapes.total_states(shapes.verify_states(6, 100, 1, 3, 1, 2))
    assert need / walked == pytest.approx(0.742, abs=5e-4)


def test_programs_call_shares_one_call_id(fib_batch):
    """The five stage programs (on the CPU the stage functions): each run
    a replay span inside the call's span, all of one call; the same
    states as staged."""
    bv, ws = fib_batch
    with profiling.recording() as staged:
        bv.verify_witnesses(ws, fused=False)
    counts = [staged.counts]
    for _ in range(2):
        with profiling.recording() as t:
            assert bv.verify_witnesses(ws, fused=True).tolist() == [True] * 2
        counts.append(t.counts)
        (call,) = [s for s in t.spans if s.name == "plonky25.verify.call"]
        replays = [s for s in t.spans
                   if s.name.startswith("plonky25.replay.")]
        assert sorted(s.name for s in replays) == sorted(
            "plonky25.replay." + n for n in ("_t", "_b", "_r", "_f", "_fin"))
        assert {s.call for s in t.spans} == {call.call}
        assert {s.parent for s in replays} == {call.id}
    assert counts[0] == counts[1] == counts[2]


def test_cpu_proof_counts_lane_major_states():
    """fib(16) at FriConfig(1, 8, 2): the lane-major states are
    chip_smoke.py's prove_path_shapes at the witness's windows; the call,
    pull and assembly spans carry one call."""
    from chip_smoke import prove_path_shapes

    fc = FriConfig(1, 8, 2)
    p = TorchProver(FibonacciAir(), 4, fc, device="cpu")
    cols = trace_columns([fibonacci_trace(16)], "cpu")
    with profiling.recording() as t:
        (proof,) = p.prove_columns(cols)
    witness = proof.opening_proof.fri_proof.pow_witness
    windows = witness // grind_window(fc) + 1
    want = prove_path_shapes(4, fc, FibonacciAir(), 1, windows)
    assert t.counts["poseidon2.soa.states"] == sum(
        n * c for n, c in want[SOA].items())
    assert t.counts["poseidon2.w12.states"] == sum(
        n * c for n, c in want[AOS].items())
    assert "poseidon2.soa.launches" not in t.counts      # the plain version
    names = _names(t)
    assert names.count("plonky25.prove.call") == 1
    assert names.count("plonky25.prove.assemble") == 1
    assert "plonky25.prove.pull" in names
    assert len({s.call for s in t.spans}) == 1


def test_replay_counts_each_recorded_call_as_a_launch():
    # _launched is what _launch calls once a launch went through
    with profiling.recording_launches() as rec:
        poseidon2._launched("w12", 7)
        poseidon2._launched("soa", 4)
        poseidon2._launched("w12", 5)
    with profiling.recording():
        profiling.replay_launches(rec)
        got = profiling.launch_counts()
    assert got == {AOS: 2, AOS + ".states": 12, SOA: 1, SOA + ".states": 4}


def test_recording_launches_neither_counts_nor_observes():
    seen = []

    def cb(n):
        seen.append(n)
        return contextlib.nullcontext()

    with profiling.recording() as t, poseidon2.observe_states(cb):
        with profiling.recording_launches() as rec:
            # the plain versions launch nothing, so nothing is recorded
            poseidon2.poseidon2_permute(gl.zeros((3, 12), "cpu"))
            poseidon2.poseidon2_permute_soa(gl.zeros((12, 5), "cpu"))
            poseidon2._launched("w12", 3)
            poseidon2._launched("soa", 5)
        assert t.counts == {} and seen == []
        profiling.replay_launches(rec)
    assert rec.counts == {"poseidon2.w12.launches": 1,
                          "poseidon2.w12.states": 3,
                          "poseidon2.soa.launches": 1,
                          "poseidon2.soa.states": 5}
    assert seen == [3, 5]


# ------------------------------------------------------------ the readers

class _Op:
    outputs = ["a", "b"]

    def poseidon2_states(self, calls):
        return 742 * len(calls)


def _read(metric, run):
    return load_module(f"p3bench/metrics/{metric}.py").read(run)


READERS = ("graph_launch_ms.verify", "graph_launch_ms.prove",
           "host_assembly_ms.prove", "poseidon2_useful_share.verify")


def _span(i, name, call, ms, parent=-1):
    return profiling.SpanRecord(i, profiling.SPAN_PREFIX + name, parent,
                                call, 0, int(ms * 1e6))


@pytest.mark.parametrize("metric", READERS)
def test_readers_read_the_table(metric, monkeypatch):
    untraced = Run(op=_Op(), setup_s=1.0, trace=False, call_s=[1.0] * 2,
                   proofs=[1, 1])
    # the idle gaps by the host event at their middle: 10 ms of them in
    # the replays (the replay spans themselves and the graph launches in
    # them), the rest elsewhere
    gaps = [("Buffer Flush", 0.5), ("plonky25.prove.assemble", 0.2),
            ("plonky25.replay._t", 0.006), ("cudaGraphLaunch", 0.004)]
    traced = Run(op=_Op(), setup_s=1.0, trace=True, call_s=[1.0] * 2,
                 proofs=[1, 1],
                 timeline=Timeline(2.0, 1.0, 10, {}, gaps))
    with profiling.recording() as t:
        assert _read(metric, traced) is None          # an empty table
        entry = "verify.call" if metric.endswith("verify") else "prove.call"
        for call in (1, 2):
            t.spans.append(_span(10 * call, entry, call, 100))
            t.spans.append(_span(10 * call + 1, "replay._t", call, 3,
                                 10 * call))
            t.spans.append(_span(10 * call + 2, "replay.grind", call, 2,
                                 10 * call))
            t.spans.append(_span(10 * call + 3, "prove.assemble", call, 40,
                                 10 * call))
        t.spans.append(_span(99, "replay.other", 9, 1000))   # not a call's
        t.counts["poseidon2.w12.states"] = 2000
        assert _read(metric, untraced) is None
        want = {"graph_launch_ms.verify": 5.0, "graph_launch_ms.prove": 5.0,
                "host_assembly_ms.prove": 40.0,
                "poseidon2_useful_share.verify": 0.742}[metric]
        assert _read(metric, traced) == pytest.approx(want)
        # a program without the table (the one before it had one)
        monkeypatch.delattr(profiling, "table")
        assert _read(metric, traced) is None


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_spans_leave_the_device_trace_as_it_was(monkeypatch):
    """A replayed BatchVerifier call at fib(64), B = 64, under
    torch.profiler: the same kernels and about the same union busy time
    with the program's spans as with tracing forced off, read as the
    benchmark reads them (p3bench/harness/timeline.py), which keeps the
    spans' device-row annotations out of both."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph of the kernels)")
    from p3bench.harness import timeline

    proof = load_proof(FIXTURE)
    cfg = derive_config(proof, FC)
    ws = stack_witnesses([pack_witness(proof, cfg, "cuda")] * 64)
    bv = BatchVerifier(FibonacciAir(), cfg, "cuda")
    bv.verify_witnesses(ws, fused=True)                # capture
    assert bv.plan(ws) == "replay"

    def traced():
        torch.cuda.synchronize()
        with timeline.traced("cuda") as events:
            ok = bv.verify_witnesses(ws).tolist()
            torch.cuda.synchronize()
        assert ok == [True] * 64
        return timeline.read(events, timeline.innermost_host_ops), events

    reads = {}
    for how in ("on", "off", "on", "off"):
        with monkeypatch.context() as m:
            if how == "off":
                m.setattr(profiling, "_profiler_enabled", lambda: False)
            before = len(profiling.table().spans)
            tl, events = traced()
            spans = len(profiling.table().spans) - before
        assert (spans > 0) == (how == "on")
        names = {e.name() for e in events}
        assert any(n.startswith("plonky25.replay.") for n in names) == (
            how == "on")
        assert not any(k.startswith(profiling.SPAN_PREFIX)
                       for k in tl.by_name)
        reads.setdefault(how, []).append(tl)
    kernels = {tl.kernels for tls in reads.values() for tl in tls}
    assert len(kernels) == 1 and kernels.pop() > 0
    on = min(tl.busy_s for tl in reads["on"])
    off = min(tl.busy_s for tl in reads["off"])
    assert on == pytest.approx(off, rel=0.05)
