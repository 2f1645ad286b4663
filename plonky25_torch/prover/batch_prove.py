"""Batch prover: B same-shape traces proved in lockstep; the counterpart of
plonky25_tpu/prover/batch_prove.py.

Every stage of TorchProver already takes a leading proof axis, so the batch
runs the single prover's code on (B, W, H) columns: B transcripts advance
together in one DeviceChallenger (values never cross proofs), a
multi-stage AIR's stage-2 builder scans each proof's rows along the last
axis with the proof's own challenges, each tree level of all B trees is
one lane-major Poseidon2 launch, and the PoW grind
searches all B witnesses in shared windows with each proof's first hit
kept (the witness order of the sequential grind).  A batch therefore
launches each kernel as often as one proof does, apart from grind windows:
the batch grinds until its last proof has found a witness.
"""

from __future__ import annotations

from typing import List

from ..air import Air
from ..proof import FriConfig, Proof
from ..utils.bits import log2_strict
from .prove import get_prover, trace_columns


class BatchProver:
    """Prove batches of traces of one shape."""

    def __init__(self, air: Air, log_n: int, fri_config: FriConfig,
                 device="cuda", quotient_eval_chunks: int = 1):
        self.base = get_prover(air, log_n, fri_config, device,
                               quotient_eval_chunks)

    def prove(self, traces, on_stage=None) -> List[Proof]:
        """traces: B row-major traces of identical shape -> B proofs, each
        identical to what TorchProver.prove gives for that trace."""
        return self.base.prove_columns(
            trace_columns(traces, self.base.device), on_stage)


def prove_batch_on_device(air: Air, traces, fri_config: FriConfig,
                          device="cuda",
                          quotient_eval_chunks: int = 1) -> List[Proof]:
    """Prove B same-shape row-major traces on `device`."""
    return BatchProver(air, log2_strict(len(traces[0])), fri_config,
                       device, quotient_eval_chunks).prove(traces)
