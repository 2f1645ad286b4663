"""What the program's own spans and counters say: the table of
plonky25_torch/utils/profiling.py, and the traced timeline's idle gaps
that the program's spans name.  The program records into the table only
while tracing is on, and in a benchmark run that is while the profiler
records: the traced window.  An untraced run, or a program without the
table, reads None."""

from __future__ import annotations

PREFIX = "plonky25."                   # the program's span names begin so
W12_STATES = "poseidon2.w12.states"    # state-major states permuted
REPLAY = PREFIX + "replay."            # a captured program's run
LAUNCH = "cudaGraphLaunch"             # the runtime call a replay holds


def table(run):
    """The program's table after a traced run; None where there is none
    or it is empty."""
    if not run.trace:
        return None
    from plonky25_torch.utils import profiling

    get = getattr(profiling, "table", None)
    t = get() if get is not None else None
    if t is None or not (t.spans or t.counts):
        return None
    return t


def span_ms(run, entry: str, prefix: str, per: int):
    """Host ms inside the spans whose names begin with `prefix`, of the
    calls of the entry point's span `entry`, over `per`."""
    t = table(run)
    if t is None or not per:
        return None
    calls = {s.call for s in t.spans if s.name == PREFIX + entry}
    if not calls:
        return None
    ns = sum(s.dur_ns for s in t.spans
             if s.call in calls and s.name.startswith(PREFIX + prefix))
    return ns / 1e6 / per


def replay_idle_ms(run, per: int):
    """Device ms idle while the host replayed the program's captured
    graphs, over `per`: the timeline's idle gaps whose label (the
    innermost host event at a gap's middle) is a replay.* span or the
    cudaGraphLaunch inside one.  The launches' cost as the card sees it;
    the host's own time in the spans is no measure of it, because a large
    graph's launch blocks until the card has room in its queue."""
    t, tl = table(run), run.timeline
    if t is None or tl is None or not per:
        return None
    if not any(s.name.startswith(REPLAY) for s in t.spans):
        return None
    idle = sum(sec for label, sec in tl.gaps
               if label == LAUNCH or label.startswith(REPLAY))
    return idle * 1e3 / per


def useful_share(run):
    """The state-major states the traced calls needed (the shapes' count,
    which poseidon2_roofline.verify's bound is of) over those the program
    permuted in them."""
    t = table(run)
    done = t.counts.get(W12_STATES, 0) if t is not None else 0
    if not done:
        return None
    return run.op.poseidon2_states(run.op.outputs) / done
