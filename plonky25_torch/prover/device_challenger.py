"""Duplex challenger whose values stay on the device, for the prover's
Fiat-Shamir transcript; the counterpart of
plonky25_tpu/prover/device_challenger.py.

Same duplex semantics as the int oracle (src/p3/challenger.rs, with its two
bit-exactness quirks: the input buffer fills to WIDTH=12 before
duplexing, and `sample` pops from the BACK of the output buffer).  Every
value is a tensor of the batch shape and every duplex is one
`poseidon2_permute` call (one kernel launch on the card) over all the
transcripts of the batch, so tree roots feed observations and sampled
challenges feed the next stage with no device-to-host copy.

The buffer bookkeeping (fill count, how many outputs remain) is host-side
Python: it depends only on the call schedule, never on field values.
"""

from __future__ import annotations

from typing import List

import torch

from ..constants import WIDTH
from ..fields import gl
from ..fields.extension import GL2
from ..fields.goldilocks import GL
from ..ops.poseidon2 import poseidon2_permute


class DeviceChallenger:
    """Duplex challenger over device values of shape `batch` (() for one
    transcript, (B,) for B transcripts advancing in lockstep)."""

    def __init__(self, batch=(), device="cuda"):
        self.batch = tuple(batch)
        self.state: GL = gl.zeros((*self.batch, WIDTH), device)
        self.input_buffer: List[GL] = []   # GL (*batch,) values
        self._out_avail: int = 0           # entries of `state` still poppable

    def _duplex(self):
        if len(self.input_buffer) > WIDTH:
            raise AssertionError("input buffer overflow")
        if self.input_buffer:
            k = len(self.input_buffer)
            head = gl.stack(self.input_buffer, dim=-1)        # (*batch, k)
            self.input_buffer = []
            self.state = gl.concatenate([head, self.state[..., k:]], dim=-1)
        self.state = poseidon2_permute(self.state)
        self._out_avail = WIDTH

    def observe(self, value: GL):
        """value: GL (*batch,)."""
        self._out_avail = 0
        self.input_buffer.append(value)
        if len(self.input_buffer) == WIDTH:
            self._duplex()

    def observe_many(self, values: GL):
        """values: GL (*batch, k), observed in order along the last axis."""
        for i in range(values.shape[-1]):
            self.observe(values[..., i])

    def sample(self) -> GL:
        if self.input_buffer or not self._out_avail:
            self._duplex()
        self._out_avail -= 1
        return self.state[..., self._out_avail]

    def sample_ext(self) -> GL2:
        return GL2(self.sample(), self.sample())

    def sample_bits(self, bits: int) -> torch.Tensor:
        """The next sample's low `bits` bits (bits <= 32), int64 (*batch,)."""
        if bits > 32:
            raise ValueError("at most 32 bits")
        return self.sample().lo & ((1 << bits) - 1)

    def sample_many_bits(self, n: int, bits: int) -> torch.Tensor:
        """n samples masked to `bits` bits, int64 (*batch, n), on a static
        schedule: drain the remaining outputs, then duplex as needed."""
        if bits > 32 or self.input_buffer:
            raise ValueError("at most 32 bits, and no pending observations")
        outs = [self.state[..., i] for i in range(self._out_avail - 1, -1, -1)]
        while len(outs) < n:
            self.state = poseidon2_permute(self.state)
            outs += [self.state[..., i] for i in range(WIDTH - 1, -1, -1)]
        self._out_avail = len(outs) - n
        return gl.stack(outs[:n], dim=-1).lo & ((1 << bits) - 1)
