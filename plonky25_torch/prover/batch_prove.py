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
the batch grinds until its last proof has found a witness.  With a mesh
(`prove(..., mesh=)`) each rank proves its share of the batch this way.

The stages run as the base prover's stage programs or staged, as its
`plan` says for the batch's signature (prove.py's module docstring): on
the card a batch size's first batch is staged, its second captures the
programs, later ones replay them.  `warmup(n_proofs)` captures them on
the card for a batch of n_proofs, as JAX compiled its vmapped modules for
one, so the first batch of that size replays.  A meshed batch runs
staged; `warmup` is for unmeshed batches.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch.distributed as dist

from ..air import Air
from ..parallel.mesh import axis_group
from ..proof import FriConfig, Proof
from ..utils.bits import log2_strict
from ..utils.graphs import StaticProgram
from .prove import get_prover, trace_columns


class BatchProver:
    """Prove batches of traces of one shape."""

    def __init__(self, air: Air, log_n: int, fri_config: FriConfig,
                 device="cuda", quotient_eval_chunks: int = 1):
        self.base = get_prover(air, log_n, fri_config, device,
                               quotient_eval_chunks)

    def warmup(self, n_proofs: int, max_workers: int = 8) -> None:
        """TorchProver.warmup at an unmeshed batch of n_proofs (the JAX
        BatchProver.warmup, plonky25_tpu/prover/batch_prove.py:95): a
        batch of zero-filled (n_proofs, W, H) columns proved and
        discarded, the stage programs captured on the card.  A meshed
        batch (`prove(..., mesh=)`) runs staged and never replays them:
        warming it up here would capture a set that its first batch drops
        unused, so a meshed caller warms up by proving its first batch.
        `max_workers` is kept for JAX's signature and unused."""
        self.base._warmup(n_proofs)

    def programs(self) -> Dict[str, StaticProgram]:
        """The base prover's stage programs, by name (TorchProver.programs)."""
        return self.base.programs()

    def release_programs(self) -> None:
        """Drop the base prover's stage programs."""
        self.base.release_programs()

    def prove(self, traces, on_stage=None, mesh=None,
              fused: bool = None) -> List[Proof]:
        """traces: B row-major traces of identical shape -> B proofs, each
        identical to what TorchProver.prove gives for that trace.

        With `mesh` (a 1-D torch.distributed DeviceMesh whose ranks all call
        with the same traces), data-parallel proving: B must be a multiple
        of the mesh's size, rank r proves traces [r B/n, (r + 1) B/n), and
        the host arrays of the proofs are all-gathered in rank order before
        assembly, so every rank returns all B.  Proofs are independent:
        nothing else crosses ranks.

        Without a mesh the stages run as `self.base.plan(columns, fused)`
        says (the stage programs or staged; the same bytes); a meshed
        batch runs staged, and fused=True with a mesh raises."""
        if mesh is None:
            return self.base.prove_columns(
                trace_columns(traces, self.base.device), on_stage,
                fused=fused)
        if fused:
            raise ValueError("BatchProver.prove(mesh=) runs staged")
        if mesh.device_type != self.base.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a "
                             f"{self.base.device.type} prover")
        group, rank, ranks = axis_group(mesh)
        if len(traces) % ranks:
            raise ValueError(f"batch {len(traces)} must be a multiple of "
                             f"the mesh size {ranks}")
        per = len(traces) // ranks

        def gather(host):
            parts = [None] * ranks
            dist.all_gather_object(parts, host, group=group)
            return _concat(parts)

        return self.base.prove_columns(trace_columns(
            traces[rank * per:(rank + 1) * per], self.base.device), on_stage,
            gather, fused=False)


def _concat(parts):
    """The pulled host arrays of each rank's proofs (prove._pull's dicts,
    lists and (c0, c1) pairs of arrays with a leading proof axis) joined
    along that axis; the self-check flags AND-ed."""
    first = parts[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat(list(xs)) for xs in zip(*parts))
    return all(parts)


def prove_batch_on_device(air: Air, traces, fri_config: FriConfig,
                          device="cuda",
                          quotient_eval_chunks: int = 1) -> List[Proof]:
    """Prove B same-shape row-major traces on `device`."""
    return BatchProver(air, log2_strict(len(traces[0])), fri_config,
                       device, quotient_eval_chunks).prove(traces)
