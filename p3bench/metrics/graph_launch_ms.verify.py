"""Device ms a traced call spends idle while the host replays the
verifier's captured programs: the timeline's idle gaps inside the program's
replay.* spans."""

from p3bench.harness.spans import replay_idle_ms


def read(run):
    return replay_idle_ms(run, len(run.call_s))
