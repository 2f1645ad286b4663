"""Batched verification of same-shape proofs (the counterpart of
plonky25_tpu/parallel/batch.py).

B proofs are packed, stacked on a leading proof axis and verified by the
verifier's stages in one pass: the hash stages flatten (B, Q) into one lane
axis, so each sponge chunk and each path level is one Poseidon2 kernel
launch for the whole batch.  A multi-stage AIR's witnesses carry
`stage2_local`/`stage2_next` and a third batch opening per query, which
stack like the other fields.

As the JAX BatchVerifier runs five jitted programs (`_t`, `_b`, `_r`, `_f`,
`_fin`), the port runs the five stages each as a utils/graphs.py
StaticProgram of one utils/graphs.py ProgramSet: on the card a CUDA
graph, on the CPU the stage function itself.  The programs share one
memory pool and always replay in capture order, one program's outputs
taken as the next one's input buffers without a copy.

A capture costs an eager warm-up of every stage besides the capture and
instantiation, so it pays only for a batch shape that comes again.  A
BatchVerifier therefore decides from the signatures it sees (B and the
shapes; JAX compiles per shape too): where `fused_default(device)` holds,
the first batch of a signature takes the staged path (the base verifier's
verify_witnesses), the second captures that signature's programs, and
later ones replay them.  It holds the programs of one signature: a capture
for another signature drops them, pool and buffers with them, and so does
dropping the BatchVerifier.  `fused=True` or False chooses the programs
or the staged path outright, as in TorchVerifier.verify.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import torch

from ..air import Air
from ..proof import FriConfig, P3Config, Proof, derive_config
from ..utils import profiling
from ..utils.graphs import ProgramSet, StaticProgram
from ..utils.tree import tree_map, tree_signature
from ..verifier import fused_default, get_verifier
from ..witness import pack_witness


def stack_witnesses(ws: List[Dict]) -> Dict:
    """Stack per-proof witnesses along a new leading proof axis."""
    return tree_map(lambda *xs: torch.stack(xs), ws[0], *ws[1:])


def tile_witness(w: Dict, b: int) -> Dict:
    """One witness repeated B times along a new leading proof axis."""
    return tree_map(lambda x: x[None].expand(b, *x.shape), w)


class BatchVerifier:
    """Verify batches of proofs that share one shape config."""

    def __init__(self, air: Air, config: P3Config, device="cuda"):
        self.base = get_verifier(air, config, device)
        self._held = None        # the ProgramSet of one signature
        self._seen = None        # the signature of the last staged batch
        self._lock = threading.Lock()

    def programs(self) -> Dict[str, StaticProgram]:
        """The stage programs held (of the last signature captured), by
        name; empty before the first capture."""
        held = self._held
        return dict(held.programs) if held is not None else {}

    def plan(self, ws: Dict, fused: bool = None) -> str:
        """What verify_witnesses(ws, fused=fused) will do: "staged",
        "capture" (make the programs of ws's signature and run them) or
        "replay" (module docstring)."""
        sig = tree_signature(ws)
        held = self._held is not None and self._held.signature == sig
        if fused is None:
            fused = fused_default(self.base.device) and (
                held or sig == self._seen)
        if not fused:
            return "staged"
        return "replay" if held else "capture"

    def _verify(self, ws: Dict, on_stage=None, fused: bool = None) -> Dict:
        """The dict of the base verifier's verify_witnesses, through the
        stage programs or staged as `plan` says; every tensor the
        caller's own."""
        with self._lock:
            how = self.plan(ws, fused)
            if how == "staged":
                self._seen = tree_signature(ws)
            elif how == "capture":
                self._held = None       # the old programs' pool goes first
                self._held = ProgramSet(tree_signature(ws),
                                        self.base.device)
            progs = self._held
        if how == "staged":
            return self.base.verify_witnesses(ws, on_stage)
        with progs.lock:
            return tree_map(torch.clone, self.base.verify_witnesses(
                ws, on_stage, run=progs))

    def verify_witnesses(self, ws: Dict, on_stage=None,
                         with_samples: bool = False, fused: bool = None):
        """ws: stacked witness (leading proof axis B) -> ok (B,) bool; with
        `with_samples`, (ok, samples), samples the GL (B, n) of every
        Fiat-Shamir sample in order (plonky25_tpu.parallel.batch's
        BatchVerifier.verify_witnesses).  The staged path or the five
        stage programs, as `plan(ws, fused)` says; the same values either
        way.  `on_stage(name)` is called after each stage is enqueued, as
        in TorchVerifier.verify_witnesses.  The call is the span
        `verify.call` (utils/profiling.py)."""
        with profiling.span("verify.call"):
            r = self._verify(ws, on_stage, fused)
        return (r["ok"], r["samples"]) if with_samples else r["ok"]

    def verify(self, proofs: List[Proof]) -> torch.Tensor:
        """Verdicts (B,) of proofs that all pass the shape check for this
        verifier's config (see verifier.verify_proof for the single-proof
        API that checks shape first)."""
        cfg, dev = self.base.config, self.base.device
        return self.verify_witnesses(
            stack_witnesses([pack_witness(p, cfg, dev) for p in proofs]))


def verify_proof_batch(proofs: List[Proof], air: Air, fri_config: FriConfig,
                       device="cuda") -> torch.Tensor:
    """Verdicts (B,) of same-shape proofs, the config derived from the
    first (plonky25_tpu.parallel.batch.verify_proof_batch)."""
    config = derive_config(proofs[0], fri_config)
    return BatchVerifier(air, config, device).verify(proofs)
