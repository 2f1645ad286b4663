"""MMCS Merkle trees on the device (prover side); the counterpart of
plonky25_tpu/ops/mmcs.py.

A tree is built over the rows of a column-major matrix (..., W, N), the
layout the LDE produces: leaf digests by `hash_rows_planes`, then one
`compress_planes` per level over the even and odd nodes of the level
below.  Levels are digest planes (..., 4, n).  Leading axes (the batch
prover's proof axis) fold into the Poseidon2 kernel's N, so a batch of
trees launches the kernel as often as one tree does.
"""

from __future__ import annotations

from typing import List

import torch

from ..fields import gl
from ..fields.goldilocks import GL
from .sponge import compress_planes, hash_rows_planes


def _build_tree(cols: GL) -> List[GL]:
    """Leaf digests and every compression level of the trees over the rows
    of cols (..., W, N), N a power of two: levels[t] is (..., 4, N >> t).
    With a leading proof axis this is also the counterpart of the JAX
    package's _build_tree_batched."""
    n = cols.shape[-1]
    if n & (n - 1):
        raise ValueError(f"tree height {n} is not a power of two")
    levels = [hash_rows_planes(cols)]
    while levels[-1].shape[-1] > 1:
        prev = levels[-1]
        levels.append(compress_planes(prev[..., 0::2], prev[..., 1::2]))
    return levels


def _open_paths(levels: List[GL], idx: torch.Tensor) -> GL:
    """Sibling digests of leaves idx (..., Q): GL (..., Q, depth, 4), where
    level t's sibling is levels[t][..., (idx >> t) ^ 1]."""
    sibs = []
    for t, lv in enumerate(levels[:-1]):
        ix = ((idx >> t) ^ 1).unsqueeze(-2).expand(
            *lv.shape[:-1], idx.shape[-1])
        sibs.append(GL(torch.gather(lv.lo, -1, ix),
                       torch.gather(lv.hi, -1, ix)))          # (..., 4, Q)
    st = gl.stack(sibs, dim=-1)                                # (..., 4, Q, D)
    return GL(st.lo.movedim(-3, -1), st.hi.movedim(-3, -1))


class DeviceMerkleTree:
    """Poseidon2 MMCS tree over the rows of cols (..., W, N)."""

    def __init__(self, cols: GL):
        self.levels: List[GL] = _build_tree(cols)

    @property
    def root(self) -> GL:
        """(..., 4)."""
        return self.levels[-1][..., 0]

    def root_host(self) -> list:
        """The root as four Python ints (one tree: no leading axes)."""
        return [int(v) for v in gl.to_u64_np(self.root)]

    def open_paths(self, idx: torch.Tensor) -> GL:
        """idx (..., Q) int64 -> sibling digests (..., Q, depth, 4)."""
        return _open_paths(self.levels, idx)
