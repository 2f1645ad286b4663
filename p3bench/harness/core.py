"""The benchmark's harness: one cell, one seed, one run.

Everything it runs is found by name from BENCHMARK.json at the root of
the checkout:

  * a cell's file, p3bench/workloads/<cell>.json, names its configuration
    and traffic mix (as BENCHMARK.json does) and how many calls its traced
    window holds;
  * a configuration is the file BENCHMARK.json names for it;
  * a traffic mix is p3bench/traffic/<traffic>.json, a file of
    parameters whose "op" names the module that reads them and drives the
    program's entry point, p3bench/ops/<op>.py;
  * every metric is a reader of its own, p3bench/metrics/<metric>.py,
    whose read(run) returns the metric or None where it finds nothing.

A run makes its inputs from the seed, warms up and captures the cell's own
shapes (set-up), then either measures a closed loop for `seconds` (trace
0: the end-to-end metrics) or profiles the cell's traced window (trace 1:
the per-layer metrics), and then judges what the timed calls returned
against the plain reference in p3bench/reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "flax", "plonky25_tpu")
START: Dict[str, float] = {}     # seconds of main's steps before set-up
# the program's build and kernel caches, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_module(rel: str):
    """The Python file at `rel` (relative to the checkout) as a module."""
    path = os.path.join(ROOT, rel)
    name = "p3bench_" + rel.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_object(ref: str):
    """"package.module:attr" -> the attribute."""
    mod, _, attr = ref.partition(":")
    return getattr(importlib.import_module(mod), attr)


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names."""

    name: str
    entry: Dict
    cell: Dict          # p3bench/workloads/<name>.json
    config: Dict        # the configuration's file
    traffic: Dict       # p3bench/traffic/<traffic>.json
    metrics: Dict[str, Dict] = field(default_factory=dict)  # e2e + layer

    @classmethod
    def load(cls, name: str, bench: Dict = None) -> "Cell":
        bench = bench or load_json("BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
        cell = load_json(f"p3bench/workloads/{name}.json")
        for key in ("config", "traffic"):
            if cell[key] != entry[key]:
                raise ValueError(f"p3bench/workloads/{name}.json names "
                                 f"{key} {cell[key]!r}; BENCHMARK.json "
                                 f"{entry[key]!r}")
        out = cls(name, entry, cell, load_json(cfg["file"]),
                  load_json(f"p3bench/traffic/{entry['traffic']}.json"))
        # an end-to-end metric without "workloads" is every cell's; a
        # per-layer metric names its cells
        for kind in ("end_to_end", "per_layer"):
            for m in bench[kind]:
                if kind == "per_layer" and "workloads" not in m:
                    raise ValueError(f"per-layer metric {m['name']!r} "
                                     "lists no workloads")
                if name in m.get("workloads", [name]):
                    out.metrics[m["name"]] = dict(m, kind=kind)
        return out

    def op(self, seed: int, device: str):
        mod = load_module(f"p3bench/ops/{self.traffic['op']}.py")
        return mod.Op(self.config, self.traffic, seed, device)


class StageClock:
    """The program's on_stage hook: a mark at each stage boundary, on the
    card a CUDA event (device time between marks), on the CPU the host
    clock.  `ms()` gives {stage: [ms per call]}."""

    def __init__(self, device: str):
        self.cuda = device == "cuda"
        self.calls: List[List] = []

    def _now(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self):
        self.calls.append([("start", self._now())])

    def __call__(self, name: str):
        self.calls[-1].append((name, self._now()))

    def ms(self) -> Dict[str, List[float]]:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for marks in self.calls:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                out.setdefault(name, []).append(ms)
        return out


@dataclass
class Run:
    """What the metric readers read."""

    op: object
    setup_s: float
    trace: bool
    call_s: List[float] = field(default_factory=list)   # per timed call
    proofs: List[int] = field(default_factory=list)     # per timed call
    window_s: float = 0.0
    peak_reserved_bytes: int = 0
    stage_ms: Dict[str, List[float]] = field(default_factory=dict)
    timeline: object = None                             # traced runs


def nvidia_smi() -> Dict[str, str]:
    """The card's name, power limit and SM clocks; empty without the tool."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if not out:
        return {}
    return dict(zip(fields.split(","), (v.strip() for v in out[0].split(","))))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None,
             hook: Callable = None, log=print) -> Dict:
    """Set up, measure or trace, and judge one run of the cell; the
    result line's fields.  `hook(op)`, if given, runs after set-up (the
    tests break the timed path there)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    op = cell.op(seed, device)
    started = time.perf_counter() - t0      # interpreter, torch, the cell
    op.setup()
    if hook is not None:
        hook(op)
    # what set-up made (the inputs' trees, the reference's copies) stays
    # out of the collector's sweeps in the window
    gc.collect()
    gc.freeze()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    run = Run(op=op, setup_s=time.perf_counter() - t0, trace=trace)
    if trace:
        from . import timeline

        clock = StageClock(device)
        t_start = time.perf_counter()
        with timeline.traced(device) as events:
            for i in range(cell.cell["trace_calls"]):
                clock.start()
                with torch.profiler.record_function(timeline.CALL):
                    t = time.perf_counter()
                    run.proofs.append(op.call(i, clock))
                    run.call_s.append(time.perf_counter() - t)
        run.window_s = time.perf_counter() - t_start
        run.stage_ms = clock.ms()
        if cuda:
            run.timeline = timeline.read(events, timeline.innermost_host_ops)
    else:
        t_start = time.perf_counter()
        i = 0
        while time.perf_counter() - t_start < seconds:
            t = time.perf_counter()
            run.proofs.append(op.call(i))
            run.call_s.append(time.perf_counter() - t)
            i += 1
        run.window_s = time.perf_counter() - t_start
    gc.unfreeze()
    if cuda:
        run.peak_reserved_bytes = torch.cuda.max_memory_reserved()
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, m in cell.metrics.items():
        if m["kind"] != kind:
            continue
        value = load_module(f"p3bench/metrics/{name}.py").read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}

    op.release()
    t_ref = time.perf_counter()
    verdict = op.check()
    ref_s = time.perf_counter() - t_ref

    smi = nvidia_smi() if cuda else {}
    bound = {}
    if run.timeline is not None:
        from . import shapes

        n = op.poseidon2_states(op.outputs)
        ms, which = shapes.poseidon2_bound_ms(n)
        bound = {"poseidon2_bound": {"states": n, "ms": ms, "by": which}}
    done = sum(run.proofs)
    rate = done / run.window_s if run.window_s else 0.0
    log(json.dumps({"p3bench": "run", "workload": cell.name, "seed": seed,
                    "trace": int(trace), "calls": len(run.call_s),
                    "proofs": done, "window_s": run.window_s,
                    "setup_s": run.setup_s,
                    "setup_phases_s": {"start": started, **START,
                                       **getattr(op, "phases", {})},
                    "reference_s": ref_s,
                    **op.rates(rate), **bound, "card": smi,
                    "call_ms_quartiles": _quartiles(run.call_s),
                    "stage_ms_mean": {k: statistics.fmean(v) for k, v
                                      in run.stage_ms.items()},
                    "programs": op.program_stats()}))
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": (torch.cuda.get_device_name(0) if cuda
                                  else device),
                         "count": cell.entry["chips"],
                         "memory_peak_bytes": run.peak_reserved_bytes}}
    if run.timeline is not None:
        result["device"]["busy_s"] = run.timeline.busy_s
        result["device"]["window_s"] = run.timeline.window_s
        result["breakdown"] = run.timeline.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in verdict["checks"].items()}
    return result


def _quartiles(call_s: List[float]) -> List[float]:
    """min, quartiles and max of the calls' ms (for PERF.md)."""
    ms = sorted(s * 1e3 for s in call_s)
    if len(ms) < 4:
        return ms
    return [ms[0], *statistics.quantiles(ms, n=4), ms[-1]]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (plonky25_torch begins with the
    JAX package's letters and is not among them)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(
        prog="p3bench/run.py",
        description="Run one benchmark cell once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0: float = None) -> int:
    args = parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = os.path.join(ROOT, rel)
    cell = Cell.load(args.workload)
    t = time.perf_counter()
    import torch

    START["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    START["count_devices"] = time.perf_counter() - t
    if have < chips:
        print(f"p3bench: {args.workload} needs {chips} CUDA device(s); "
              f"{have} available. Nothing was measured.", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print("p3bench: JAX or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
