"""Timing and tracing of the port: the counterpart of
plonky25_tpu/utils/profiling.py, on CUDA events and torch.profiler.

JAX's names keep their contracts:

  * `sync(x)`: wait until the devices of a tree's tensors are done;
  * `StageTimer`: wall-clock per named stage across repetitions, the
    stage's result synchronised at its end;
  * `trace(logdir)`: a torch.profiler trace of CPU and CUDA activity,
    written under `logdir` (TensorBoard's and Perfetto's format);
  * `measure_throughput`: items per second of a call, synchronised.

The port's own clocks, which what JAX times per stage becomes on the card:

  * `StageClock`: CUDA events recorded at stage boundaries, the hook that
    the verifier's `verify_witnesses` and the provers take as
    `on_stage(name)`; device ms per stage;
  * `StepClock`: the attestation entry points' `on_step(name)` hook: wall
    ms, each kernel's launches and states, and peak device memory per step;
  * `counted(fn)`: fn's result and both kernels' launches and states in it;
  * `cuda_ms`, `once_ms`: device time from CUDA events (a mean over a run,
    or one call);
  * `profile_device_time`, `kernel_device_ms`, `device_summary`: device
    time by kernel from torch.profiler.

A device figure comes from the device: StageClock, StepClock, counted and
the CUDA-event and profiler helpers need a CUDA device and raise without
one.  StageTimer, sync, measure_throughput and trace(device="cpu") also
run on the CPU, where they time the host.

The program's own spans and counters, on the profiler's clock:

  * tracing is on while torch.profiler records (the autograd profiler's
    flag) and inside a `recording()` block, and off at all other times;
    nothing else turns it on.  Off, a span or a count costs one check of
    that flag;
  * `span(name)`: with tracing on, a `record_function("plonky25." + name)`
    (a user annotation in the profiler's trace, beside the device rows)
    and a `SpanRecord` in the table: its name, the span it is nested in,
    its call (a span opened with no other open on its thread starts a new
    call: the entry points' `verify.call` and `prove.call` spans, so every
    span of one call carries that call's number) and its host start and
    duration;
  * `count(name, n)`: with tracing on, adds n to the table's counter
    (`add(counts)`: several at once);
  * `table()`: the table spans and counters go to: `recording()`'s own
    for its block (added to an enclosing block's table when it ends);
    outside every block, the process's, which gathers what the
    profiler's sessions traced and nothing else.  At most MAX_SPANS spans
    are kept, the newest; reading the table leaves it as it is.

The Poseidon2 wrappers count `poseidon2.w12.*` and `poseidon2.soa.*`
(`states`, and `launches` of the CUDA kernel), and the field kernels
(ops/goldilocks.py) `field.<op>.launches` and `field.<op>.elements`
(<op> `gl_add`, ..., `gl2_mul_base`); `launch_counts`, `counted` and
`StepClock` read the Poseidon2 counters, `field_launches` the field
kernels'.  A kernel's launch reports itself through `launched`; inside a
CUDA graph capture that goes to the `recording_launches` record, which
`replay_launches` counts at each replay of the graph.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .tree import tree_leaves

# the port's two kernels, by the names their rows carry (chip_smoke.py's
# kernel line, device_summary), and the tags of their counters
AOS, SOA = "poseidon2_permute_w12", "poseidon2_permute_soa"
KERNEL_TAGS = {AOS: "w12", SOA: "soa"}
SPAN_PREFIX = "plonky25."
MAX_SPANS = 1 << 16


# ------------------------------------------------------------ tracing

_profiler_enabled = torch._C._autograd._profiler_enabled


class SpanRecord(NamedTuple):
    id: int
    name: str           # as the profiler's annotation has it
    parent: int         # the id of the span it is nested in; -1: none
    call: int           # the call it belongs to
    start_ns: int       # time.perf_counter_ns() at its start
    dur_ns: int


@dataclass
class Table:
    """What spans and counters recorded (module docstring)."""

    spans: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=MAX_SPANS))
    counts: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Table") -> None:
        self.spans.extend(other.spans)
        for k, n in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + n


_recording = 0              # open recording() blocks, on any thread
_process_table = Table()
_table = _process_table
_table_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans
_span_ids = itertools.count()
_call_ids = itertools.count(1)
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether spans and counts are recorded: torch.profiler records, or
    a recording() block is open."""
    return _recording > 0 or _profiler_enabled()


def table() -> Table:
    return _table


@contextlib.contextmanager
def recording():
    """Tracing on for the block, into a fresh table (yielded), which is
    added to an enclosing block's when the block ends."""
    global _recording, _table
    with _table_lock:
        outer, _table = _table, Table()
        _recording += 1
    try:
        yield _table
    finally:
        with _table_lock:
            _recording -= 1
            inner, _table = _table, outer
            if outer is not _process_table:
                outer.add(inner)


class _Span:
    __slots__ = ("name", "id", "parent", "call", "start", "annotation")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = -1, next(_call_ids)
        self.id = next(_span_ids)
        stack.append(self)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.start
        self.annotation.__exit__(*exc)
        _local.stack.pop()
        rec = SpanRecord(self.id, self.name, self.parent, self.call,
                         self.start, dur)
        with _table_lock:
            _table.spans.append(rec)
        return False


def span(name: str):
    """A context manager: the span `name` where tracing is on, nothing
    where it is off."""
    return _Span(name) if tracing() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add n to the table's counter `name` where tracing is on."""
    if tracing():
        with _table_lock:
            _table.counts[name] = _table.counts.get(name, 0) + n


def add(counts: Dict[str, int]) -> None:
    """count(name, n) for each item of `counts`, at once."""
    if tracing():
        with _table_lock:
            for name, n in counts.items():
                _table.counts[name] = _table.counts.get(name, 0) + n


# ------------------------------------------------------------ launch records

@dataclass
class LaunchRecord:
    """The launches of a block run by `recording_launches`: the counters
    they add up to, and the replay hook each left, in order."""

    counts: Dict[str, int] = field(default_factory=dict)
    hooks: list = field(default_factory=list)


_launch_record: Optional[LaunchRecord] = None


@contextlib.contextmanager
def recording_launches():
    """Record the block's kernel launches (`launched`) without counting
    them.  For a block that captures a CUDA graph: the Python around a
    launch runs at capture and not at replay, so the graph's owner passes
    the yielded LaunchRecord to `replay_launches` once per replay, which
    counts the launches where they run (utils/graphs.py)."""
    global _launch_record
    saved, _launch_record = _launch_record, LaunchRecord()
    rec = _launch_record
    try:
        yield rec
    finally:
        _launch_record = saved


def launch_record_open() -> bool:
    """Whether a recording_launches block is open."""
    return _launch_record is not None


def launched(counts: Dict[str, int], replay=None) -> None:
    """A hand-written kernel's launch went through (the Poseidon2
    wrappers, the field kernels): `counts` go to the open launch record,
    with `replay` (called by each replay of the record), else to the
    table where tracing is on."""
    rec = _launch_record
    if rec is None:
        add(counts)
        return
    for name, n in counts.items():
        rec.counts[name] = rec.counts.get(name, 0) + n
    if replay is not None:
        rec.hooks.append(replay)


def replay_launches(rec: LaunchRecord) -> None:
    """Count one replay of a graph captured under `recording_launches`
    (its counters at once, where tracing is on) and call the hooks its
    launches left."""
    add(rec.counts)
    for hook in rec.hooks:
        hook()


def sync(x) -> None:
    """Block until every tensor of the tree `x` is computed: each CUDA
    device that holds one is synchronised once; a CPU tensor is ready when
    the op that made it returns."""
    devices = {t.device for t in tree_leaves(x) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage across repetitions.

    with timer.stage("transcript") as h:
        h["result"] = fn(x)
        # h["result"] is synchronised on exit
    """

    times: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if "result" in holder:
                sync(holder["result"])
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.times.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            a = np.asarray(ts)
            out[name] = {
                "n": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "min_ms": float(a.min() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2, sort_keys=True)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device="cuda"):
    """Record a torch.profiler trace of the block and write it under
    `logdir` as <host>_<pid>.<ns>.pt.trace.json (TensorBoard's profiler
    plugin and Perfetto read it); does nothing if `logdir` is None.  On
    "cuda" (the default) it records CPU and CUDA activity and raises
    without a GPU; on "cpu" it records CPU activity alone.  Yields the
    profiler (its `key_averages()`), or None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    d = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if d.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(d)
    with profile(activities=acts, acc_events=True,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure_throughput(fn, args, n_items: int, iters: int = 20,
                       warmup: int = 1) -> Dict[str, float]:
    """items/s of `fn(*args)`: `warmup` synchronised calls, then `iters`
    calls timed on the host clock up to the last result's sync."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    r = None
    for _ in range(iters):
        r = fn(*args)
    sync(r)
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_call": dt, "items_per_sec": n_items / dt}


# ------------------------------------------------------------ CUDA events

def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, from CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """Device time of one call of fn(), no warm-up, from CUDA events (for
    a call too slow to repeat, such as a plain Poseidon2 version at a
    large shape: dispatch-bound, 0.2-0.4 s a call below 10^5 states on the
    H100, PERF.md)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class StageClock:
    """CUDA events recorded at each stage boundary: pass it as a path's
    `on_stage`; `ms()` gives {stage: device ms since the previous
    boundary}, the first measured from the clock's creation."""

    def __init__(self):
        resolve_device("cuda")      # raises without a GPU
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events = [("start", ev)]

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def ms(self):
        torch.cuda.synchronize()
        return {name: self.events[i][1].elapsed_time(ev)
                for i, (name, ev) in enumerate(self.events[1:])}


def launch_counts() -> Dict[str, int]:
    """{kernel: launches, kernel.states: states permuted} as the table
    holds them now."""
    counts = _table.counts
    return {k + suf: counts.get(f"poseidon2.{tag}.{what}", 0)
            for k, tag in KERNEL_TAGS.items()
            for suf, what in (("", "launches"), (".states", "states"))}


def field_launches() -> Dict[str, int]:
    """{field op: launches} as the table holds them now (the ops that
    launched)."""
    pre, suf = "field.", ".launches"
    return {k[len(pre):-len(suf)]: n for k, n in _table.counts.items()
            if k.startswith(pre) and k.endswith(suf)}


def counted(fn):
    """Run fn() inside a recording() block; return (fn's result,
    launch_counts() of the block), the device synchronised on both
    sides."""
    torch.cuda.synchronize()
    with recording():
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()


class StepClock:
    """The attestation entry points' on_step hook: wall ms (the device
    synchronised at each step's end), each kernel's launches and states,
    and peak device memory of each step since the previous one (the peak
    statistics reset at every step)."""

    def __init__(self):
        self.steps = {}
        self.start()

    def start(self):
        """Restart the clock, the counts (call it inside the recording()
        block that counts: inside `counted`) and the peak; returns the
        hook."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t, self.last = time.perf_counter(), launch_counts()
        return self

    def __call__(self, name):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), launch_counts()
        self.steps[name] = {
            "ms": (now - self.t) * 1e3,
            "launches": {k: counts[k] - self.last[k] for k in counts},
            "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.reset_peak_memory_stats()
        self.t, self.last = now, counts

    def peak_gb(self):
        return max(v["peak_allocated_gb"] for v in self.steps.values())

    def text(self):
        return ", ".join(
            f"{k} {v['ms']:.1f} ms ({v['launches'][AOS]}/"
            f"{v['launches'][SOA]}, peak {v['peak_allocated_gb']:.2f} GB)"
            for k, v in self.steps.items())


# ------------------------------------------------------------ torch.profiler

def profile_device_time(fn, cpu=False):
    """(device ms, kernel count, {name: (ms, count)}) of one run of fn,
    from torch.profiler; None where the profiler saw no CUDA kernels.  A
    path's run traces CUDA activity alone: on a run of 323k kernels that
    gave the device time and kernel count of tracing CPU and CUDA activity
    in about half the time (scripts/profiler_cost.py, PERF.md).  `cpu`
    traces both, as kernel_device_ms does (the per-kernel timings keep
    their earlier method).  Either way a profile has missed the kernels of
    five 2^21-state launches; callers then say "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (t / 1e3, ev.count)
    if not kernels:
        return None
    total = sum(t for t, _ in kernels.values())
    count = sum(c for _, c in kernels.values())
    return total, count, kernels


def kernel_device_ms(fn, reps):
    """Mean device time of the Poseidon2 kernel launched by fn(), over
    `reps` calls, from torch.profiler: unlike CUDA events around the
    calls, it leaves out the host time of the wrapper, which bounds the
    event time of a small launch.  None where the profiler saw no kernel."""
    fn()
    prof = profile_device_time(lambda: [fn() for _ in range(reps)], cpu=True)
    mine = [(t, c) for name, (t, c) in (prof[2].items() if prof else ())
            if "poseidon2" in name]
    return sum(t for t, _ in mine) / sum(c for _, c in mine) if mine else None


def device_summary(prof, wall_ms):
    """(a line of text, a record) of profile_device_time's result beside
    the wall time of the same work: device ms, kernels, busy share, each
    Poseidon2 kernel's ms and the top kernels; "not measured" where the
    profiler saw no kernels."""
    if not prof:
        return "device time not measured (profiler saw no kernels)", None
    p2_ms = {k: sum(t for name, (t, _) in prof[2].items() if tag in name)
             for k, tag in ((AOS, "w12"), (SOA, "soa"))}
    text = (f"{prof[0]:.1f} ms device time in {prof[1]} kernels "
            f"(busy {100 * prof[0] / wall_ms:.0f}% of {wall_ms:.1f} ms), "
            f"Poseidon2 state-major {p2_ms[AOS]:.1f} ms, lane-major "
            f"{p2_ms[SOA]:.1f} ms")
    return text, {"device_ms": prof[0], "device_kernels": prof[1],
                  "busy_share": prof[0] / wall_ms, "poseidon2_ms": p2_ms,
                  "top_kernels": sorted(([k, t, c] for k, (t, c)
                                         in prof[2].items()),
                                        key=lambda x: -x[1])[:12]}
