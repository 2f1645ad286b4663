"""Query-sharded verification of one proof; the counterpart of
plonky25_tpu/parallel/sharded.py.

The transcript is sequential but small (about 20 duplexes), so every rank
replays it; the per-query work (Merkle batch openings, reduced openings,
the FRI fold: verifier.rs:266-344, 419-519) is split over the ranks of a
1-D "q" mesh, the query axis padded to a multiple of the rank count by
repeating query 0 (a valid opening, so a padded lane cannot change the
verdict).  The final stage runs on every rank, and the verdict flags are
MIN-all-reduced over "q": the all-reduce XLA inserts in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..air import Air
from ..device import resolve_device
from ..proof import FriConfig, P3Config, Proof, derive_config
from ..utils.tree import tree_map
from ..verifier import VerifyResult, _publics, _shape_fail, get_verifier
from ..witness import pack_witness
from .mesh import make_mesh, query_shardings


def _pad_axis(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Pad `axis` to length `target` by repeating its first slice."""
    n = x.shape[axis]
    if n == target:
        return x
    reps = [1] * x.dim()
    reps[axis] = target - n
    return torch.cat([x, x.narrow(axis, 0, 1).repeat(*reps)], dim=axis)


def _pad_tree(t, axis: int, target: int):
    return tree_map(lambda a: _pad_axis(a, axis, target), t)


def _shard(t, axis: int, plan):
    """The rank's slice [plan.start, plan.stop) of `axis`, padded to
    plan.q_pad first."""
    return tree_map(lambda a: a.narrow(axis, plan.start,
                                       plan.stop - plan.start),
                    _pad_tree(t, axis, plan.q_pad))


def _lead(x):
    """A proof's witness field as a batch of one."""
    return tree_map(lambda a: a[None], x)


def min_flags(flags, group) -> torch.Tensor:
    """The verdict flags (bool tensors of one shape) AND-ed over `group`:
    one MIN all-reduce of their stack.  Returns bool (n_flags, ...)."""
    t = torch.stack(list(flags)).to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.bool()


def sharded_flags(v, plan, ws: Dict, group):
    """The verifier v's stages on a stacked witness ws (leading proof
    axis B): the transcript and the final stage on every rank, the Merkle,
    reduced-opening and fold stages on this rank's query slice of `plan`,
    the flags (pow, merkle, fold, quotient) MIN-all-reduced over `group`.
    Returns (transcript, padded index (B, Q_pad), flags bool (4, B))."""
    ax = plan.axes
    t = v._transcript_fn(ws["obs"])
    index = _pad_axis(t["index"], 1 + ax["index"], plan.q_pad)
    idx = index[:, plan.start:plan.stop]                     # (B, Q/n)
    vals = [_shard(x, 1 + ax["batch_values"], plan)
            for x in ws["batch_values"]]
    sibs = [_shard(x, 1 + ax["batch_sibs"], plan)
            for x in ws["batch_sibs"]]
    commits = [t["trace_commit"]]
    if v.s2w:
        commits.append(t["stage2_commit"])
    commits.append(t["quotient_commit"])
    merkle_ok = v._batched_batch_all_fn(idx, vals, sibs, commits).all(-1)
    opened = [ws.get(k) for k in ("trace_local", "trace_next",
                                  "quotient_chunks", "stage2_local",
                                  "stage2_next")]
    ro_stack = v._ro_fn(idx, t["zeta"], t["zeta_next"], t["alpha_fri"],
                        vals, *opened)
    fold_ok = v._batched_fold_fn(
        idx, t["phase_commits"], t["betas_stack"],
        _shard(ws["fold_sibling_values"], 1 + ax["fold_sibling_values"],
               plan),
        ro_stack, _shard(ws["fold_sibs"], 1 + ax["fold_sibs"], plan),
        ws["final_poly"])
    quotient_ok = v._final_fn(
        t["alpha"], t["zeta"], opened[0], opened[1], opened[2],
        _publics(v.air, v.device), opened[3], opened[4],
        t.get("challenges"))
    return t, index, min_flags((t["pow_ok"], merkle_ok, fold_ok,
                                quotient_ok), group)


class ShardedVerifier:
    """The shape-specialized TorchVerifier with a query-sharded plan over
    a 1-D mesh (make_mesh's by default).  Every rank of the mesh calls
    `verify` with the same proof and returns the same result."""

    def __init__(self, air: Air, config: P3Config, mesh=None, device="cuda"):
        self.device = resolve_device(device)
        self.base = get_verifier(air, config, self.device)
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh for a "
                             f"{self.device.type} verifier")
        axis = self.mesh.mesh_dim_names[0]
        self.group = self.mesh.get_group(axis)
        self.plan = query_shardings(self.mesh, config.fri_config.num_queries,
                                    axis)
        self.n_dev = self.plan.ranks
        self.Q_pad = self.plan.q_pad

    def verify_witness(self, w: Dict) -> VerifyResult:
        """Verify one packed witness (`sharded_flags` on a batch of one).
        query_indices holds all Q_pad padded indices."""
        t, index, flags = sharded_flags(self.base, self.plan, _lead(w),
                                        self.group)
        pow_ok, merkle_ok, fold_ok, quotient_ok = flags[:, 0]
        return VerifyResult(
            ok=pow_ok & merkle_ok & fold_ok & quotient_ok, pow_ok=pow_ok,
            merkle_ok=merkle_ok, fold_ok=fold_ok, quotient_ok=quotient_ok,
            shape_ok=True, alpha=t["alpha"][0], zeta=t["zeta"][0],
            query_indices=index[0])

    def verify(self, proof: Proof) -> VerifyResult:
        """Shape first (fail-closed, shape_ok=False), then the witness."""
        if not self.base.check_shape(proof):
            return _shape_fail(self.device)
        return self.verify_witness(
            pack_witness(proof, self.base.config, self.device))


def verify_proof_sharded(proof: Proof, air: Air, fri_config: FriConfig,
                         mesh=None, device="cuda") -> VerifyResult:
    """verify_proof with the queries split over `mesh`'s ranks."""
    device = resolve_device(device)
    config = derive_config(proof, fri_config)
    return ShardedVerifier(air, config, mesh, device).verify(proof)
