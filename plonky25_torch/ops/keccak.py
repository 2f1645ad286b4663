"""keccak-f[1600], batched over leading axes: the counterpart of
plonky25_tpu/ops/keccak.py (jnp under lax.scan there, PyTorch ops here).

A lane is a u64 value held as a (lo, hi) pair of 32-bit limbs in int64
tensors, the limb discipline of the Goldilocks field; the state is two
tensors of shape (..., 25), lane i = x + 5*y.  A round works on all 25
lanes at once: theta as xors of the five rows, rho as one rotation by a
per-lane amount, pi as one gather, chi as xors of the state rolled along
x, iota on lane 0.  The 24 rounds run as a Python loop.  No kernel is
written for this: the JAX package has none either, and neither the prover
nor the verifier calls it (the Keccak AIR's trace is made on the host).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..refimpl.keccak import NUM_ROUNDS, RC, R

M32 = 0xFFFFFFFF


class U64Lanes(NamedTuple):
    lo: torch.Tensor  # int64 (..., 25), values in [0, 2^32)
    hi: torch.Tensor


def _tables_host():
    """(rotation per lane, lane each pi output takes) for lane i = x + 5y."""
    rot = np.zeros(25, np.int64)
    src = np.zeros(25, np.int64)
    for x in range(5):
        for y in range(5):
            rot[x + 5 * y] = R[x][y]
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return rot, src


_ROT, _PI_SRC = _tables_host()
_TABLES: Dict[str, tuple] = {}


def _tables(device):
    """The per-lane tables on `device`, built once per device: whether the
    rotation swaps the limbs (amount >= 32), the amount mod 32, the pi
    gather, and the round constants' limbs."""
    key = str(device)
    if key not in _TABLES:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)
        _TABLES[key] = (t(_ROT >= 32).bool(), t(_ROT % 32), t(_PI_SRC),
                        t([c & M32 for c in RC]), t([c >> 32 for c in RC]))
    return _TABLES[key]


def _rows(v: torch.Tensor) -> torch.Tensor:
    """(..., 25) -> (..., 5, 5) indexed [y, x]."""
    return v.reshape(*v.shape[:-1], 5, 5)


def keccak_round(state: U64Lanes, rc_lo, rc_hi) -> U64Lanes:
    """One round on (..., 25) lanes; rc_lo/rc_hi: the round constant's
    limbs (ints or 0-d tensors)."""
    swap, amount, pi_src = _tables(state.lo.device)[:3]
    lo, hi = _rows(state.lo), _rows(state.hi)
    # theta: C[x] = xor over y; D[x] = C[x - 1] ^ rol(C[x + 1], 1)
    c_lo, c_hi = lo[..., 0, :], hi[..., 0, :]
    for y in range(1, 5):
        c_lo, c_hi = c_lo ^ lo[..., y, :], c_hi ^ hi[..., y, :]
    r_lo, r_hi = torch.roll(c_lo, -1, -1), torch.roll(c_hi, -1, -1)
    d_lo = torch.roll(c_lo, 1, -1) ^ (((r_lo << 1) | (r_hi >> 31)) & M32)
    d_hi = torch.roll(c_hi, 1, -1) ^ (((r_hi << 1) | (r_lo >> 31)) & M32)
    lo = (lo ^ d_lo[..., None, :]).flatten(-2)
    hi = (hi ^ d_hi[..., None, :]).flatten(-2)
    # rho: rotate lane i left by R[x][y] (limbs swapped for 32 and more;
    # for amount 0 the shifted-in part `>> 32` of a u32 value is 0)
    lo, hi = torch.where(swap, hi, lo), torch.where(swap, lo, hi)
    lo, hi = (((lo << amount) | (hi >> (32 - amount))) & M32,
              ((hi << amount) | (lo >> (32 - amount))) & M32)
    # pi: B[y][(2x + 3y) % 5] = rho(A)[x][y]
    lo, hi = _rows(lo[..., pi_src]), _rows(hi[..., pi_src])
    # chi: B[x] ^ (~B[x + 1] & B[x + 2]) along x
    lo = lo ^ ((torch.roll(lo, -1, -1) ^ M32) & torch.roll(lo, -2, -1))
    hi = hi ^ ((torch.roll(hi, -1, -1) ^ M32) & torch.roll(hi, -2, -1))
    lo, hi = lo.flatten(-2), hi.flatten(-2)
    # iota
    lo = torch.cat([lo[..., :1] ^ rc_lo, lo[..., 1:]], dim=-1)
    hi = torch.cat([hi[..., :1] ^ rc_hi, hi[..., 1:]], dim=-1)
    return U64Lanes(lo, hi)


def keccak_f(state: U64Lanes) -> U64Lanes:
    """24-round keccak-f[1600], batched over the leading axes of (..., 25)."""
    rc_lo, rc_hi = _tables(state.lo.device)[3:]
    for r in range(NUM_ROUNDS):
        state = keccak_round(state, rc_lo[r], rc_hi[r])
    return state


# the JAX package's jitted name: eager PyTorch compiles nothing, so it is
# the same function
keccak_f_jit = keccak_f


def from_u64(flat, device) -> U64Lanes:
    """Host: (..., 25) array-like of u64 ints -> U64Lanes on `device`."""
    a = np.asarray(flat, dtype=np.uint64)
    return U64Lanes(
        torch.from_numpy((a & np.uint64(M32)).astype(np.int64)).to(device),
        torch.from_numpy((a >> np.uint64(32)).astype(np.int64)).to(device))


def to_u64(state: U64Lanes) -> np.ndarray:
    """U64Lanes -> numpy uint64 (..., 25) on the host."""
    lo = state.lo.cpu().numpy().astype(np.uint64)
    hi = state.hi.cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo
