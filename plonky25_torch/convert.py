"""Carry values and witnesses across from the JAX package.

`from_jax` takes a JAX `GL` or `GL2`, or a dict or list of them, after the
caller has turned every leaf into a numpy array (for example
`jax.tree.map(np.asarray, x)`): GL leaves hold uint32 `lo`/`hi` arrays and
GL2 leaves `c0`/`c1` pairs of them.  It returns the same structure of the
port's GL / GL2 tensors.  Given the dict that plonky25_tpu.witness.pack_witness
returns, that is the port's witness, equal to the port's own `pack_witness`
of the same proof; the stage tests feed both packages the same trace
columns and challenges through it.  The structures are read by their field
names, so nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .fields.extension import GL2
from .fields.goldilocks import GL


def from_jax(x, device="cuda"):
    """A JAX GL / GL2 value, or a dict or list of them, with numpy uint32
    limbs, as the port's GL / GL2 tensors on `device`."""
    device = resolve_device(device)

    def limb(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype != np.uint32:
            raise TypeError(f"expected uint32 limbs, got {a.dtype}")
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "c0") and hasattr(x, "c1"):
            return GL2(conv(x.c0), conv(x.c1))
        if hasattr(x, "lo") and hasattr(x, "hi"):
            return GL(limb(x.lo), limb(x.hi))
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        raise TypeError(f"unexpected leaf {type(x).__name__}")

    return conv(x)
