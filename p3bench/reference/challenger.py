"""Duplex challenger (Fiat-Shamir transcript) on plain Python ints (a copy
of plonky25_torch/refimpl/challenger.py).

Mirrors src/p3/challenger.rs exactly, including its two nonstandard quirks
that bit-exactness depends on (SURVEY.md step 3):

  * the input buffer fills to WIDTH=12 (not the sponge rate) before a
    duplexing is forced (challenger.rs:91-93), and
  * `sample` pops from the BACK of the output buffer (Vec::pop,
    challenger.rs:114-116), so the first sample after a duplex is state[11].

`observe` clears the output buffer (challenger.rs:88) so samples always
reflect all observations.
"""

from .constants import WIDTH
from .poseidon2 import poseidon2


class DuplexChallenger:
    def __init__(self):
        self.state = [0] * WIDTH
        self.input_buffer = []
        self.output_buffer = []

    def _duplex(self):
        assert len(self.input_buffer) <= WIDTH
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = poseidon2(self.state)
        self.output_buffer = list(self.state)

    def observe(self, value: int):
        self.output_buffer.clear()
        self.input_buffer.append(value)
        if len(self.input_buffer) == WIDTH:
            self._duplex()

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self, d: int = 2):
        """One extension sample = d base samples, low coefficient first
        (challenger.rs:150-157 for d=2; the d=3 family generalizes the
        same convention)."""
        return tuple(self.sample() for _ in range(d))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, bits: int, witness: int) -> bool:
        """PoW check (challenger.rs:159-169): observe witness, sample `bits`
        bits, require zero."""
        self.observe(witness)
        return self.sample_bits(bits) == 0
