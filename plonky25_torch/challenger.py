"""Duplex challenger: a static schedule, then the transcript as a loop of
permutations over all proofs at once.

The reference challenger (src/p3/challenger.rs) is sequential: every
observation mutates a sponge and every challenge pops sponge output.  As in
plonky25_tpu/challenger.py, `SymbolicChallenger` replays the verifier's
observe/sample sequence with tokens, recording which observations overwrite
which state lanes at each duplex step and which (step, lane) each sample
reads.  The schedule depends only on the proof's shape.  `run_transcript`
then runs the duplex steps, each one permutation (one kernel launch on the
card) over the whole batch of proofs, and gathers the samples.

Bit-exactness quirks kept (challenger.rs:88-116): the input buffer fills to
WIDTH before duplexing, `sample` pops from the BACK of the output buffer,
and `observe` clears pending outputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .constants import WIDTH
from .fields import gl
from .fields.goldilocks import GL
from .ops.poseidon2 import poseidon2_permute


@dataclass
class SymbolicChallenger:
    """Replay of challenger.rs that records a static schedule (a copy of
    plonky25_tpu.challenger.SymbolicChallenger)."""

    n_obs: int = 0
    n_samples: int = 0
    # per duplex step: list of observation indices writing lanes 0..k-1
    steps: List[List[int]] = field(default_factory=list)
    # per sample: (duplex_step, lane) it reads
    sample_srcs: List[Tuple[int, int]] = field(default_factory=list)

    _input_buffer: List[int] = field(default_factory=list)
    _output_tokens: List[Tuple[int, int]] = field(default_factory=list)

    def _duplex(self):
        assert len(self._input_buffer) <= WIDTH
        self.steps.append(list(self._input_buffer))
        self._input_buffer.clear()
        step = len(self.steps) - 1
        self._output_tokens = [(step, lane) for lane in range(WIDTH)]

    def observe(self, n: int = 1) -> List[int]:
        """Observe n values; returns their observation indices."""
        ids = []
        for _ in range(n):
            self._output_tokens.clear()
            idx = self.n_obs
            self.n_obs += 1
            ids.append(idx)
            self._input_buffer.append(idx)
            if len(self._input_buffer) == WIDTH:
                self._duplex()
        return ids

    def sample(self) -> int:
        """Sample one challenge; returns its index in sample order."""
        if self._input_buffer or not self._output_tokens:
            self._duplex()
        self.sample_srcs.append(self._output_tokens.pop())
        s = self.n_samples
        self.n_samples += 1
        return s

    def sample_ext(self) -> Tuple[int, int]:
        return self.sample(), self.sample()

    def schedule(self):
        """(write_idx (n_steps, 12) int, -1 where a lane keeps its value;
        sample steps (n_samples,); sample lanes (n_samples,))."""
        write_idx = np.full((len(self.steps), WIDTH), -1, np.int64)
        for s, obs_ids in enumerate(self.steps):
            write_idx[s, :len(obs_ids)] = obs_ids
        steps_arr = np.asarray([s for s, _ in self.sample_srcs], np.int64)
        lanes_arr = np.asarray([l for _, l in self.sample_srcs], np.int64)
        return write_idx, steps_arr, lanes_arr


def run_transcript(schedule, observations: GL) -> GL:
    """Run the transcript.

    schedule: SymbolicChallenger.schedule() as tensors on the observations'
    device.  observations: GL (..., n_obs) in observation order, with any
    leading batch axes.  Returns the samples, GL (..., n_samples), in
    sample order."""
    write_idx, steps_arr, lanes_arr = schedule
    write = write_idx >= 0
    gathered = observations[..., write_idx.clamp(min=0)]  # (..., n_steps, 12)
    state = gl.zeros((*observations.shape[:-1], WIDTH), observations.device)
    outs = []
    for s in range(write_idx.shape[0]):
        state = poseidon2_permute(gl.select(write[s], gathered[..., s, :], state))
        outs.append(state)
    outs = gl.stack(outs, dim=-2)                          # (..., n_steps, 12)
    return outs[..., steps_arr, lanes_arr]
