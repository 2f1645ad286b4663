"""plonky25_torch/utils/profiling.py on the CPU: the JAX package's
StageTimer and measure_throughput test (tests/test_errors_profiling.py)
repeated on the port, `trace` on the CPU and its refusal without a GPU,
`sync` of a nested tree, and the bookkeeping of the CUDA clocks and launch
counters with torch.cuda's calls stubbed (they need the card to measure
anything; chip_smoke.py's [tooling] phase runs them there)."""

import json
import os

import pytest
import torch

import plonky25_torch.utils as port_utils
from plonky25_torch.fields import gl
from plonky25_torch.ops import poseidon2 as p2
from plonky25_torch.utils import StageTimer, measure_throughput, sync, trace
from plonky25_torch.utils import profiling
from plonky25_torch.utils.tree import tree_leaves
import plonky25_tpu.utils as jax_utils


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work: the test run
    shares the CPU between several worker processes (see
    tests/test_torch_multistage.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_timer_and_throughput():
    t = StageTimer()
    x = torch.arange(8)
    with t.stage("double") as h:
        h["result"] = x * 2
    s = t.summary()
    assert s["double"]["n"] == 1 and s["double"]["total_s"] >= 0

    m = measure_throughput(lambda a: a + 1, (x,), n_items=8, iters=3)
    assert m["items_per_sec"] > 0


def test_stage_timer_record_summary_report():
    t = StageTimer()
    t.record("a", 0.002)
    t.record("a", 0.004)
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["n"] == 2 and s["b"]["n"] == 1
    assert s["a"]["mean_ms"] == pytest.approx(3.0)
    assert s["a"]["min_ms"] == pytest.approx(2.0)
    assert s["a"]["total_s"] == pytest.approx(0.006)
    assert json.loads(t.report()) == s


def test_stage_timer_records_a_stage_that_raises():
    t = StageTimer()
    with pytest.raises(ZeroDivisionError):
        with t.stage("bad"):
            1 / 0
    assert t.summary()["bad"]["n"] == 1


def test_measure_throughput_counts_calls_and_items():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(1)

    m = measure_throughput(fn, (), n_items=10, iters=4, warmup=2)
    assert len(calls) == 6
    assert m["items_per_sec"] == pytest.approx(10 / m["sec_per_call"])


def test_trace_writes_a_cpu_trace(tmp_path):
    a = gl.from_u64([1, 2, 3], "cpu")
    with trace(str(tmp_path), device="cpu") as prof:
        gl.add(a, a)
    assert prof is not None
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::add" in names


def test_trace_without_logdir_does_nothing(tmp_path):
    with trace() as prof:
        pass
    assert prof is None


def test_trace_refuses_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path)):
            pass
    assert os.listdir(tmp_path) == []


def test_sync_takes_a_nested_tree(monkeypatch):
    a = gl.from_u64([5, 6], "cpu")
    t1, t2 = torch.ones(2), torch.zeros(1)
    tree = {"a": a, "b": [t1, (t2, None)], "c": 3}
    assert [x.data_ptr() for x in tree_leaves(tree)] == [
        a.lo.data_ptr(), a.hi.data_ptr(), t1.data_ptr(), t2.data_ptr()]
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", waited.append)
    assert sync(tree) is None
    assert sync(None) is None
    assert waited == []          # CPU tensors: nothing to wait for


def test_cuda_clocks_refuse_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.StageClock()


def _stub_cuda(monkeypatch, peaks):
    """torch.cuda's calls that the launch bookkeeping makes, as no-ops; the
    peak memory read pops `peaks`."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a: peaks.pop(0))


def _launch(tag, n):
    """One launch of the kernel `tag` on n states, as the wrappers count
    it."""
    profiling.count(f"poseidon2.{tag}.launches")
    profiling.count(f"poseidon2.{tag}.states", n)


def test_counted_and_step_clock_bookkeeping(monkeypatch):
    _stub_cuda(monkeypatch, [1e9, 3e9])
    aos, soa = profiling.AOS, profiling.SOA

    def run():
        for _ in range(3):
            _launch("w12", 10)
        clock = profiling.StepClock()
        for _ in range(2):
            _launch("soa", 7)
        clock("one")
        _launch("w12", 5)
        # the plain version on the CPU: states, no launch
        p2.poseidon2_permute(gl.zeros((4, 12), "cpu"))
        clock("two")
        return clock

    with profiling.recording():
        _launch("w12", 99)          # before counted: not its count
        clock, got = profiling.counted(run)
    assert got == {aos: 4, aos + ".states": 39, soa: 2, soa + ".states": 14}
    assert clock.steps["one"]["launches"][soa] == 2
    assert clock.steps["one"]["launches"][aos] == 0
    assert clock.steps["two"]["launches"][aos] == 1
    assert clock.steps["two"]["launches"][aos + ".states"] == 9
    assert clock.peak_gb() == pytest.approx(3.0)
    assert "one" in clock.text() and all(
        v["ms"] >= 0 for v in clock.steps.values())


def test_device_summary():
    text, rec = profiling.device_summary(None, 10.0)
    assert "not measured" in text and rec is None
    prof = (6.0, 5, {"void p25::poseidon2_w12_kernel(...)": (2.0, 2),
                     "poseidon2_soa_split_kernel": (1.0, 1),
                     "elementwise": (3.0, 2)})
    text, rec = profiling.device_summary(prof, 12.0)
    assert rec["busy_share"] == pytest.approx(0.5)
    assert rec["poseidon2_ms"] == {profiling.AOS: 2.0, profiling.SOA: 1.0}
    assert rec["top_kernels"][0] == ["elementwise", 3.0, 2]


def test_exports_match_the_jax_package():
    jax_names = {n for n in dir(jax_utils) if not n.startswith("_")}
    port_names = {n for n in dir(port_utils) if not n.startswith("_")}
    assert {"sync", "StageTimer", "trace", "measure_throughput",
            "reverse_bits", "reverse_slice_index_bits"} <= port_names
    # (roofline is a submodule name once something has imported it)
    assert jax_names - {"roofline"} <= port_names
