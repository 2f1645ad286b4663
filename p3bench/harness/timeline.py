"""The traced window: torch.profiler over a few calls, read as a timeline.

Device time is the union of the intervals in which an operation (a
kernel, a copy or a fill) ran on the card, not the sum of their lengths:
kernels of one graph may overlap, and a sum then exceeds the wall time.
The window is the benchmark's own annotation around the traced calls, on
the profiler's clock, so that both ends are read from the same trace."""

from __future__ import annotations

import contextlib
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "p3bench.window"
CALL = "p3bench.call"


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernels: int                                  # kernel launches seen
    by_name: Dict[str, Tuple[float, int]]         # kernel: (s, count)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_s(self, tag: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds `tag`."""
        hits = [v for k, v in self.by_name.items() if tag in k]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(((k, s) for k, (s, _) in self.by_name.items()),
                     key=lambda x: -x[1])[:top]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:top]]}


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def _annotation(e) -> bool:
    is_user = getattr(e, "is_user_annotation", None)
    return (is_user is not None and is_user()) or e.name().startswith(
        "p3bench.")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy",
                                "cudaMemset"))


def read(events, host_label) -> Timeline:
    """A Timeline from Kineto events: each has name(), device_type(),
    start_ns() and duration_ns().  `host_label(host events, times)`
    names what the host was doing at each of the ascending times (ns), the
    idle gaps' midpoints."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name() == WINDOW]
    if not window:
        raise RuntimeError("the traced window's annotation is missing")
    lo = window[0].start_ns()
    hi = lo + window[0].duration_ns()
    dev, host, by_name, kernels = [], [], {}, 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            # the benchmark's own annotations also show on the device's
            # row, spanning each call: they are not device work
            if (d <= 0 or s + d <= lo or s >= hi or _annotation(e)):
                continue
            dev.append((s, s + d))
            name = e.name()
            if _is_kernel(name):
                kernels += 1
                t, c = by_name.get(name, (0.0, 0))
                by_name[name] = (t + d / 1e9, c + 1)
        elif e.name() not in (WINDOW, CALL):
            host.append((s, s + d, e.name()))
    gaps: Dict[str, float] = {}
    idle = idle_gaps(dev, lo, hi)
    for (s, e), label in zip(idle, host_label(host, [(s + e) / 2
                                                     for s, e in idle])):
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e9
    return Timeline(
        window_s=(hi - lo) / 1e9, busy_s=union_s(dev, lo, hi) / 1e9,
        kernels=kernels, by_name=by_name,
        gaps=sorted(gaps.items(), key=lambda x: -x[1]))


def innermost_host_ops(host, times) -> List[str]:
    """For each of the ascending `times`, the host-side event (an ATen op
    or an annotation) that started last among those spanning it: the
    innermost, as a thread's events nest; "host Python" where none spans
    it.  One sweep over the events sorted by start."""
    events = sorted(host)
    active: list = []                 # heap of (-start, end, name)
    out, j = [], 0
    for t in times:
        while j < len(events) and events[j][0] <= t:
            s, e, name = events[j]
            heapq.heappush(active, (-s, e, name))
            j += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][2] if active else "host Python")
    return out


@contextlib.contextmanager
def traced(device_type: str):
    """Profile the block's CPU and CUDA activity on the card; yields a
    list that holds the Kineto events once the block has ended.  Off the
    card nothing is profiled (there is no device to read) and the list
    stays empty."""
    out: list = []
    if device_type != "cuda":
        yield out
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    out.extend(prof.profiler.kineto_results.events())
