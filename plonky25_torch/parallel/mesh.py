"""Device meshes over a torch.distributed process group; the counterpart of
plonky25_tpu/parallel/mesh.py.

The JAX package runs one process over every device and lets XLA insert the
collectives that its sharding annotations imply.  The port runs one process
per device (torchrun, or `multihost.init_distributed`), so a mesh here is a
`torch.distributed.device_mesh.DeviceMesh` with the JAX axis names — "q"
for the queries of one proof, ("b", "q") for a batch of proofs — and each
stage calls its collectives itself, where XLA put them.  `query_shardings`
becomes each rank's plan: which axis of each witness field carries the
queries, and which slice of the padded query axis is this rank's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist

from ..device import resolve_device


def _world() -> int:
    """The default group's size, or a clear error without one."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call parallel."
            "init_distributed(...) or start the program under torchrun")
    return dist.get_world_size()


def _init_mesh(device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis_name: str = "q"):
    """1-D mesh named `axis_name` over the process group's ranks, one
    device each.  n_devices, if given, must be the group's size: every
    rank of the group takes part."""
    device = resolve_device(device)
    world = _world()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a process group of "
                         f"{world}: start {n} processes")
    return _init_mesh(device, (n,), (axis_name,))


def make_batch_mesh(n_batch: int, n_query: int, device="cuda"):
    """2-D (proof-batch "b" x query "q") mesh over n_batch * n_query ranks,
    the process group's size."""
    device = resolve_device(device)
    world = _world()
    if n_batch < 1 or n_query < 1 or n_batch * n_query != world:
        raise ValueError(f"a ({n_batch}, {n_query}) mesh in a process group "
                         f"of {world}")
    return _init_mesh(device, (n_batch, n_query), ("b", "q"))


def axis_group(mesh, axis: Optional[str] = None):
    """(process group, this rank's index, size) of the mesh dimension
    `axis` (the first when None)."""
    names = mesh.mesh_dim_names
    axis = names[0] if axis is None else axis
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(names.index(axis)))


@dataclass(frozen=True)
class QueryPlan:
    """One rank's share of the query-parallel verifier stages.

    `axes[field]` is the axis of a proof's witness field that carries the
    queries (one more with a leading proof axis); the query axis is padded
    to `q_pad`, a multiple of the rank count, and this rank takes
    [start, stop)."""

    axes: Dict[str, int]
    q_pad: int
    ranks: int
    rank: int

    @property
    def start(self) -> int:
        return self.rank * (self.q_pad // self.ranks)

    @property
    def stop(self) -> int:
        return self.start + self.q_pad // self.ranks


# the JAX package's shardings (plonky25_tpu/parallel/mesh.py:40-55): the
# query axis leads the index and the batch openings; the fold arrays and
# the reduced-opening stack have a level axis first
QUERY_AXES = {"index": 0, "batch_values": 0, "batch_sibs": 0,
              "fold_sibling_values": 1, "fold_sibs": 1, "ro": 1}


def query_shardings(mesh, num_queries: int, axis_name: str = "q") -> QueryPlan:
    """This rank's QueryPlan for `num_queries` queries over the mesh
    dimension `axis_name`."""
    _, rank, ranks = axis_group(mesh, axis_name)
    return QueryPlan(axes=dict(QUERY_AXES),
                     q_pad=-(-num_queries // ranks) * ranks,
                     ranks=ranks, rank=rank)
