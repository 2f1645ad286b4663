"""The benchmark's harness on the CPU: BENCHMARK.json and every file it
names, the shape of BENCHMARK.json, the timeline arithmetic, the shape counts
against chip_smoke.py's, a run without a card, the no-JAX check and a new
cell found by name.

    python -m pytest p3bench/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from p3bench.harness import core, shapes, tamper, timeline

ROOT = core.ROOT
BENCH = core.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["p3bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("p3bench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_config_workload_and_metric_loads_by_name():
    for c in BENCH["configs"]:
        cfg = core.load_json(c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        core.load_object(cfg["air"]["reference"])
    for w in BENCH["workloads"]:
        cell = core.Cell.load(w["name"])
        assert os.path.exists(os.path.join(
            ROOT, "p3bench/ops", cell.traffic["op"] + ".py"))
        assert cell.cell["trace_calls"] >= 1
        kinds = {m["kind"] for m in cell.metrics.values()}
        assert kinds == {"end_to_end", "per_layer"}
        assert "setup_s" in cell.metrics
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        mod = core.load_module(f"p3bench/metrics/{m['name']}.py")
        assert callable(mod.read)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in core.Cell.load(cell).metrics, (m, cell)


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A later change adds a cell by adding files and BENCHMARK.json
    entries, and edits no file the harness has."""
    shutil.copytree(os.path.join(ROOT, "p3bench"), tmp_path / "p3bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "fib-golden.verify-b64", "config": "fib-golden",
        "traffic": "verify-b64", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][0]["workloads"].append("fib-golden.verify-b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "p3bench/traffic/verify-b64.json").write_text(json.dumps(
        {"op": "verify_batch", "batch": 64, "tampered_per_batch": 4,
         "distinct_batches": 2}))
    (tmp_path / "p3bench/workloads/fib-golden.verify-b64.json").write_text(
        json.dumps({"config": "fib-golden", "traffic": "verify-b64",
                    "trace_calls": 2}))
    monkeypatch.setattr(core, "ROOT", str(tmp_path))
    cell = core.Cell.load("fib-golden.verify-b64")
    assert cell.traffic["batch"] == 64
    assert "verified_proofs_per_s" in cell.metrics
    assert cell.op(1, "cpu").traffic["batch"] == 64


def test_a_per_layer_metric_must_name_its_cells(monkeypatch):
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(ValueError, match="lists no workloads"):
        core.Cell.load("fib-golden.verify-b2048", bench)


def test_union_idle_share_on_overlapping_intervals():
    iv = [(0, 4), (1, 3), (2, 6), (8, 9), (8.5, 12), (20, 30)]
    assert timeline.union_s(iv, 0, 10) == 6 + 2
    assert timeline.idle_gaps(iv, 0, 10) == [(6, 8)]
    assert timeline.idle_gaps(iv, 0, 25) == [(6, 8), (12, 20)]
    # a sum of the lengths would read 13 over a window of 10
    busy = timeline.union_s(iv, 0, 10)
    assert 0 <= 1 - busy / 10 <= 1
    rng = np.random.default_rng(5)
    starts = rng.uniform(0, 100, 500)
    iv = list(zip(starts, starts + rng.uniform(0, 20, 500)))
    busy = timeline.union_s(iv, 10, 90)
    gaps = sum(e - s for s, e in timeline.idle_gaps(iv, 10, 90))
    assert busy <= 80 and abs(busy + gaps - 80) < 1e-9


def test_timeline_read_from_events():
    import torch

    class Ev:
        def __init__(self, name, dev, s, d):
            self._n, self._dev, self._s, self._d = name, dev, s, d

        def name(self):
            return self._n

        def device_type(self):
            return self._dev

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def is_user_annotation(self):
            return self._n.startswith("p3bench.")

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    evs = [Ev(timeline.WINDOW, cpu, 0, 1000),
           Ev("aten::copy_", cpu, 600, 300),
           Ev("poseidon2_w12_kernel", cuda, 100, 200),
           Ev("fold_kernel", cuda, 200, 300),
           Ev("Memcpy DtoH", cuda, 500, 50),
           Ev("outside", cuda, 2000, 10),
           Ev(timeline.CALL, cuda, 0, 1000)]
    tl = timeline.read(evs, timeline.innermost_host_ops)
    assert tl.window_s == 1e-6 and abs(tl.busy_s - 450e-9) < 1e-15
    assert tl.kernels == 2 and tl.kernel_s("poseidon2")[1] == 1
    assert dict(tl.gaps)["aten::copy_"] == pytest.approx(450e-9)
    assert dict(tl.gaps)["host Python"] == pytest.approx(100e-9)


def test_innermost_host_ops_sweep():
    host = [(0, 100, "call"), (10, 50, "aten::copy_"), (20, 30, "inner"),
            (60, 70, "aten::add"), (200, 300, "other")]
    times = [5, 15, 25, 40, 65, 80, 150, 250]
    assert timeline.innermost_host_ops(host, times) == [
        "call", "aten::copy_", "inner", "aten::copy_", "aten::add", "call",
        "host Python", "other"]


def _verifier(air, log_n, fc):
    from chip_smoke import shape_config
    from plonky25_torch.verifier import get_verifier

    return get_verifier(air, shape_config(air, log_n, fc), "cpu")


def _without_fold(path_shapes, log_n, b, num_queries=100):
    """chip_smoke.py's counts less its lock-step fold walk ({log_n * b *
    Q: 1 + log_n}), which the benchmark counts at each phase's depth."""
    out = dict(path_shapes)
    key = log_n * b * num_queries
    out[key] -= 1 + log_n
    return {k: v for k, v in out.items() if v}


def test_fib_golden_state_count_matches_chip_smoke():
    from chip_smoke import verify_path_shapes
    from plonky25_torch.models.fibonacci import FibonacciAir
    from plonky25_torch.proof import FriConfig

    v = _verifier(FibonacciAir(), 6, FriConfig(1, 100, 16))
    for b in (1, 2048):
        assert shapes.commit_states(6, 100, 1, 3, 1, b) == \
            _without_fold(verify_path_shapes(v, b), 6, b)
    # the fold's walks: phase i's tree has 6 - i levels, so a query needs
    # 7 + 6 + ... + 2 = 27 states (the lock-step walk launches 6 x 7)
    assert shapes.fold_states(6, 100, 1, 1) == {100: 27}
    # 2,048 lanes: 8,841,216 states per call
    n = shapes.total_states(shapes.verify_states(6, 100, 1, 3, 1, 2048))
    assert n == 8_841_216
    assert shapes.poseidon2_bound_ms(n)[0] == pytest.approx(2.570, abs=1e-3)


def test_keccak_state_counts_match_chip_smoke():
    from chip_smoke import prove_path_shapes, verify_path_shapes
    from plonky25_torch.models.keccak_air import KeccakAir
    from plonky25_torch.proof import FriConfig

    fc = FriConfig(1, 100, 16)
    v = _verifier(KeccakAir(), 12, fc)
    assert shapes.commit_states(12, 100, 1, 2633, 2, 256) == \
        _without_fold(verify_path_shapes(v, 256), 12, 256)
    assert shapes.fold_states(12, 100, 1, 256) == {25600: 12 + 78}
    want = prove_path_shapes(12, fc, KeccakAir(), 1, 3)["poseidon2_permute_soa"]
    assert shapes.prove_states(12, 1, 16, 2633, 2, 1, 3) == want


def test_multistage_state_count_matches_chip_smoke():
    """A two-stage AIR's transcript and third Merkle batch, for the
    configurations later changes add."""
    from chip_smoke import verify_path_shapes
    from plonky25_torch.models.rlc_air import RlcAir
    from plonky25_torch.proof import FriConfig

    air = RlcAir()
    v = _verifier(air, 10, FriConfig(1, 100, 16))
    assert shapes.commit_states(
        10, 100, 1, air.width(), 1 << v.config.log_quotient_degree, 64,
        air.stage2_width(), air.num_challenges()) == \
        _without_fold(verify_path_shapes(v, 64), 10, 64)


def test_shape_bound_matches_the_program_roofline():
    from plonky25_torch.utils import roofline

    for n in (1, 2048, 1 << 21):
        assert shapes.poseidon2_bound_ms(n) == roofline.poseidon2_bound_ms(n)


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    r = subprocess.run(
        [sys.executable, "p3bench/run.py", "--workload",
         "fib-golden.verify-b2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "correct" not in r.stdout
    assert "CUDA" in r.stderr


def test_no_jax_check_compares_top_level_names_whole(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib.xla_client", "flax",
                 "plonky25_tpu.verifier"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    for name in ("plonky25_torch", "plonky25_torch.verifier", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name not in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_the_program_nor_jax():
    ref = os.path.join(ROOT, "p3bench", "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                top = mod.split(".")[0]
                assert top not in ("plonky25_torch", "plonky25_tpu", "jax",
                                   "jaxlib", "flax", "torch"), (f, mod)


def test_harness_imports_no_jax():
    for d in ("harness", "ops", "metrics", "reference"):
        base = os.path.join(ROOT, "p3bench", d)
        for f in os.listdir(base):
            if f.endswith(".py"):
                for mod in _imports(os.path.join(base, f)):
                    assert mod.split(".")[0] not in core.FORBIDDEN, (f, mod)


@pytest.mark.parametrize("kind", tamper.KINDS)
def test_tamper_changes_one_value_and_leaves_the_original(kind):
    proof = core.load_json("p3bench/data/proof_fibonacci_refimpl.json")
    before = json.dumps(proof)
    rng = np.random.default_rng(3)
    out = tamper.tamper(proof, kind, rng)
    assert json.dumps(proof) == before

    def leaves(x, path=()):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, path + (k,))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                yield from leaves(v, path + (i,))
        else:
            yield path, x

    diff = [(p, a, b) for (p, a), (_, b) in zip(leaves(proof), leaves(out))
            if a != b]
    assert len(diff) == 1
    assert 0 <= diff[0][2] < tamper.P
