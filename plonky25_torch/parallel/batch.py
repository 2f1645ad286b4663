"""Batched verification of same-shape proofs (the counterpart of
plonky25_tpu/parallel/batch.py).

B proofs are packed, stacked on a leading proof axis and verified by the
verifier's stages in one pass: the hash stages flatten (B, Q) into one lane
axis, so each sponge chunk and each path level is one Poseidon2 kernel
launch for the whole batch.  A multi-stage AIR's witnesses carry
`stage2_local`/`stage2_next` and a third batch opening per query, which
stack like the other fields.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..air import Air
from ..proof import FriConfig, P3Config, Proof, derive_config
from ..utils.tree import tree_map
from ..verifier import get_verifier
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

    def verify_witnesses(self, ws: Dict, on_stage=None,
                         with_samples: bool = False):
        """ws: stacked witness (leading proof axis B) -> ok (B,) bool; with
        `with_samples`, (ok, samples), samples the GL (B, n) of every
        Fiat-Shamir sample in order (plonky25_tpu.parallel.batch's
        BatchVerifier.verify_witnesses).  `on_stage` as in
        TorchVerifier.verify_witnesses."""
        r = self.base.verify_witnesses(ws, on_stage)
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
