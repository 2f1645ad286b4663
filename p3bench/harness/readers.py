"""What the metric readers in p3bench/metrics share.  A reader returns
None where its run has nothing to read (a trace-only quantity in an
untraced run, a kernel the trace did not see)."""

from __future__ import annotations

import statistics

from . import shapes


def rate(run):
    """Proofs completed in the window over the window's seconds."""
    if run.trace or not run.window_s:
        return None
    return sum(run.proofs) / run.window_s


def stage_ms(run, name):
    """Mean device ms of one stage per traced call (the program's on_stage
    marks: the time from the previous mark to this stage's)."""
    ms = run.stage_ms.get(name)
    return statistics.fmean(ms) if ms else None


def capture_s(run):
    """Seconds the program's captured programs took to make in set-up:
    eager warm-up, capture and instantiation, summed over the programs."""
    stats = run.op.program_stats()
    if not stats:
        return None
    return sum(s.get("warmup_ms", 0) + s.get("capture_ms", 0)
               + s.get("instantiate_ms", 0) for s in stats.values()) / 1e3


def roofline(run, kernel_tag):
    """The Poseidon2 kernels' share of their least time, in %: the
    card's bound for the states the traced calls needed, counted from the
    shapes, over the device time of the kernels whose name holds
    kernel_tag."""
    tl = run.timeline
    if tl is None:
        return None
    ms = tl.kernel_s(kernel_tag)[0] * 1e3
    if ms <= 0:
        return None
    bound, _ = shapes.poseidon2_bound_ms(
        run.op.poseidon2_states(run.op.outputs))
    return 100.0 * bound / ms


def kernels_per_proof(run):
    tl = run.timeline
    if tl is None or not tl.kernels or not sum(run.proofs):
        return None
    return tl.kernels / sum(run.proofs)


def idle_share(run):
    """1 - the union of the device's busy intervals over the traced
    window."""
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 1.0 - tl.busy_s / tl.window_s
