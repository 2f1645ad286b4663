"""Carry a witness across from the JAX package.

`from_jax_witness` takes the dict that plonky25_tpu.witness.pack_witness
returns, after the caller has turned every leaf into a numpy array (for
example `jax.tree.map(np.asarray, w)`): its GL leaves hold uint32 `lo`/`hi`
arrays and its GL2 leaves `c0`/`c1` pairs of them.  It returns the port's
witness, equal to the port's own `pack_witness` of the same proof.  The
structures are read by their field names, so nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .fields.extension import GL2
from .fields.goldilocks import GL


def from_jax_witness(w, device="cuda"):
    """The JAX witness `w` (numpy leaves) as the port's witness on `device`."""
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
        raise TypeError(f"unexpected witness leaf {type(x).__name__}")

    return conv(w)
