"""Multi-host proof-batch aggregation; the counterpart of
plonky25_tpu/parallel/multihost.py.

A batch of same-shape proofs is verified over a 2-D (b, q) mesh: the
proofs are split over "b" (across hosts) and each proof's queries over "q"
(the devices of a host), as in ShardedVerifier.  Each rank runs
BatchVerifier's batched stages on its proofs' query slices; the per-proof
flags are MIN-all-reduced over "q" and the verdicts all-gathered over
"b", so every rank returns the whole batch's.  The only traffic is those
two small collectives.

One process drives one device.  `init_distributed` brings up the process
group: from an explicit address, or from torchrun's launch (torch reads
its variables itself: the port reads no environment).  Without either the
program runs in one process, as the JAX package does without a
coordinator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..air import Air
from ..device import resolve_device
from ..proof import FriConfig, P3Config, Proof, derive_config
from ..utils.tree import tree_map
from ..witness import pack_witness
from .batch import BatchVerifier, stack_witnesses
from .mesh import _init_mesh, _world, axis_group, query_shardings
from .sharded import sharded_flags


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> bool:
    """Bring up the torch.distributed process group: NCCL for "cuda" (the
    process then drives device rank % the host's device count), gloo for
    "cpu".

    coordinator_address is "host:port" (or an init URL, "tcp://..." or
    "file://..."), given with num_processes and process_id.  Without an
    address the group comes from torchrun's launch when there is one.
    Returns True if a process group exists afterwards (one already made
    counts), False for single-process mode.  A failure to initialise
    raises: there is no fallback to another backend or to the CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    launched = dist.is_available() and dist.is_torchelastic_launched()
    if coordinator_address is None and not launched:
        return False
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an address needs num_processes and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    if device.type == "cuda":       # before the group's first collective
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return True


def make_host_mesh(n_query: Optional[int] = None, device="cuda"):
    """(b, q) mesh: "q" the devices of a host, "b" the rest (the hosts).

    n_query defaults to the devices of this host (for "cuda": its device
    count, at most the group's size; for "cpu": the whole group), so that
    "b" follows host boundaries when each host runs one process per
    device, as torchrun places them."""
    device = resolve_device(device)
    world = _world()
    if n_query is None:
        n_query = (min(torch.cuda.device_count(), world)
                   if device.type == "cuda" else world)
    if not 0 < n_query <= world:
        raise ValueError(f"n_query={n_query} must be in [1, {world}] "
                         f"(total devices available)")
    if world % n_query:
        raise ValueError(f"n_query={n_query} must divide the device count "
                         f"{world} evenly")
    return _init_mesh(device, (world // n_query, n_query), ("b", "q"))


class MultiHostBatchVerifier:
    """Verify batches of same-shape proofs over a (b, q) mesh
    (make_host_mesh's by default).  Every rank calls with the whole batch
    and returns the whole batch's verdicts."""

    def __init__(self, air: Air, config: P3Config, mesh=None, device="cuda"):
        self.device = resolve_device(device)
        self.mesh = (mesh if mesh is not None
                     else make_host_mesh(device=self.device))
        if set(self.mesh.mesh_dim_names or ()) != {"b", "q"}:
            raise ValueError(f"want a ('b', 'q') mesh, got axes "
                             f"{self.mesh.mesh_dim_names}")
        if self.mesh.device_type != self.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh for a "
                             f"{self.device.type} verifier")
        self.bv = BatchVerifier(air, config, self.device)
        self.base = self.bv.base
        self.b_group, self.b_rank, self.n_batch = axis_group(self.mesh, "b")
        self.q_group, self.q_rank, self.n_query = axis_group(self.mesh, "q")
        self.plan = query_shardings(self.mesh, config.fri_config.num_queries,
                                    "q")
        self.Q_pad = self.plan.q_pad

    def verify_witnesses(self, ws: Dict) -> torch.Tensor:
        """ws: stacked witness (leading proof axis B, a multiple of the "b"
        extent) -> ok (B,) bool, the same on every rank."""
        B = ws["obs"].shape[0]
        if B % self.n_batch:            # the JAX package's assertion
            raise AssertionError(
                f"batch {B} must be a multiple of the 'b' mesh extent "
                f"{self.n_batch} (pad with duplicate proofs)")
        per = B // self.n_batch
        mine = tree_map(lambda a: a[self.b_rank * per:(self.b_rank + 1) * per],
                        ws)
        _, _, flags = sharded_flags(self.base, self.plan, mine, self.q_group)
        ok = flags.all(dim=0).to(torch.int32)
        parts = [torch.empty_like(ok) for _ in range(self.n_batch)]
        dist.all_gather(parts, ok, group=self.b_group)
        return torch.cat(parts).bool()

    def verify(self, proofs: List[Proof]):
        """(ok (B,), all_ok): every proof's verdict and their AND."""
        cfg = self.base.config
        ok = self.verify_witnesses(stack_witnesses(
            [pack_witness(p, cfg, self.device) for p in proofs]))
        return ok, ok.all()


def verify_proof_batch_multihost(proofs: List[Proof], air: Air,
                                 fri_config: FriConfig, mesh=None,
                                 device="cuda"):
    """(ok (B,), all_ok) of same-shape proofs over `mesh`, the config
    derived from the first."""
    device = resolve_device(device)
    config = derive_config(proofs[0], fri_config)
    return MultiHostBatchVerifier(air, config, mesh, device).verify(proofs)
