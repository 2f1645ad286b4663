"""Roofline accounting for the port on an NVIDIA H100: the counterpart of
plonky25_tpu/utils/roofline.py, with its ceilings derived again for this
card.

The work is integer arithmetic on 32-bit words (Goldilocks elements as two
u32 limbs; no tensor-core work), so the compute ceiling is the rate at
which an SM dispatches 32-bit integer instructions.  The H100's figures (the
H100 data sheet, SXM part; the CUDA C Programming Guide's arithmetic
throughput table for compute capability 9.0):

  * HBM: 3.35e12 bytes/s (`HBM_BYTES_PER_S`);
  * per SM per clock: 64 results of 32-bit integer compare, logic, shift,
    select or three-input add (the ALU pipe, `ALU_PER_CLK`), 64 of 32-bit
    integer multiply-add (the FMA pipe, `FMA_PER_CLK`), and 4 x 32
    instructions dispatched (`DISPATCH_PER_CLK`).  An add, with or without
    carry, runs on either pipe (IADD3 on the ALU pipe, IMAD.IADD and
    IMAD.X on the FMA pipe), so no 32-bit integer instruction mix runs
    faster than 128 per SM per clock;
  * `int_peak(sms, sm_clock_hz)` = 128 x sms x clock u32 ops/s.  Its
    defaults, 132 SMs at 1,980 MHz, are the H100 SXM's data-sheet figures
    (`INT_PEAK_H100` = 3.35e13 ops/s, in the place of JAX's TPU figure
    `VPU_PEAK_V5E`); a caller that has the card reads its SM count
    (`torch.cuda.get_device_properties(0).multi_processor_count`) and its
    maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`) instead.

JAX's module also carried a measured integer ceiling of its TPU
(`U32_CEILING_V5E`).  No such ceiling has been measured on the H100, so it
has no counterpart here and `mfu_report` has no key for it: every share
below is against the dispatch rate above.

The accounting is a lower bound on time, so no share can exceed 1.0:

  * `count_int_ops(fn, *args)` counts the integer elementwise ATen ops
    that fn dispatches, one op per output element.  The port keeps field
    elements as u32 limbs in int64 tensors, so one ATen op on a limb
    tensor is one u32 op in JAX's sense, and no instruction mix does it in
    fewer than one 32-bit instruction per element;
  * a field kernel's launch inside fn (ops/goldilocks.py: add, sub and
    mul of GL and GF(p^2) on the card) is charged the ATen ops its limb
    chain dispatches on the CPU (gl.add_limbs, ...), counted on meta
    tensors of the operands' shapes and strides;
  * a call of `poseidon2_permute` or `poseidon2_permute_soa` inside fn is
    charged by the permutation's work model (`P2_OPS["total"]` per state),
    whatever runs it: the limb ops of the plain version on the CPU are not
    counted, and the kernel's launch on the card is not an ATen op.  So a
    function's count is the same on the CPU and on the card, and a faster
    kernel cannot move it;
  * the work model counts the fewest 32-bit instructions the permutation's
    arithmetic needs (below), and `poseidon2_bound_ms` gives the least
    time N states can take: the larger of that work at the dispatch rates and
    the bytes at the HBM rate (each state read once and written once: 12
    lanes x 2 int64 limbs x 8 B, twice: 384 B).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .tree import tree_leaves

HBM_BYTES_PER_S = 3.35e12
ALU_PER_CLK, FMA_PER_CLK, DISPATCH_PER_CLK = 64, 64, 128
H100_SMS = 132                  # H100 SXM data sheet
H100_SM_CLOCK_HZ = 1.98e9       # its maximum (boost) SM clock


def int_peak(sms: int = H100_SMS,
             sm_clock_hz: float = H100_SM_CLOCK_HZ) -> float:
    """32-bit integer instructions per second the card can dispatch."""
    return DISPATCH_PER_CLK * sms * sm_clock_hz


INT_PEAK_H100 = int_peak()      # u32 ops/s, see the module docstring

# What one permutation must compute (csrc/poseidon2_common.cuh): 736
# Goldilocks products (x^7 is 4, in 8 x 12 full-round and 22 partial-round
# S-boxes; 22 x 12 internal-diagonal products) and 1,182 modular adds (118
# round constants; 9 M_E, each 3 M4 of 14 adds and 4 block sums of 5; 22
# internal layers of 11 + 12).
P2_PRODUCTS = 4 * (8 * 12 + 22) + 22 * 12
P2_ADDS = (8 * 12 + 22) + 9 * (3 * 14 + 4 * 5) + 22 * (11 + 12)
# The fewest 32-bit instructions each needs, 64-bit values held as two
# 32-bit words and reduction left lazy.  A product: the four 32x32->64
# partial products of the 128-bit product (IMAD.WIDE.U32, FMA pipe, the
# cross-term sums folded into their addends), two adds to carry the cross
# terms into the top words, four to reduce 128 bits to 64 with
# 2^64 = 2^32 - 1 and 2^96 = -1 (a three-input add per word, two to fold
# the last carry): 6 adds.  An add: one two-word add, 2 adds.  Only the
# partial products are bound to one pipe (FMA); every add may run on
# either, and none of the work needs the ALU pipe alone.
PRODUCT_FMA, PRODUCT_ADDS, ADD_ADDS = 4, 6, 2
P2_OPS = {"fma_pipe": P2_PRODUCTS * PRODUCT_FMA, "alu_pipe": 0,
          "either_pipe": P2_PRODUCTS * PRODUCT_ADDS + P2_ADDS * ADD_ADDS}
P2_OPS["total"] = P2_OPS["fma_pipe"] + P2_OPS["either_pipe"]
# bytes one state moves: 12 lanes x 2 int64 limbs x 8 B, read and written
P2_BYTES_PER_STATE = 12 * 2 * 8 * 2


def clocks_per_state(mix) -> float:
    """SM clocks one state costs at the dispatch rates above, for a mix of
    instructions per state: "alu_pipe" and "fma_pipe" count those bound to
    one pipe, "total" all of them (with those that may run on either)."""
    return max(mix["alu_pipe"] / ALU_PER_CLK, mix["fma_pipe"] / FMA_PER_CLK,
               mix["total"] / DISPATCH_PER_CLK)


def bound_ms(n_items: int, clocks_per_item: float, bytes_per_item: float,
             sms: int = H100_SMS, sm_clock_hz: float = H100_SM_CLOCK_HZ):
    """(least ms, "operations" or "bytes") for n items, each costing
    `clocks_per_item` SM clocks of dispatch and moving `bytes_per_item` bytes
    of HBM: the larger of the two times, and which one it is."""
    ops_ms = n_items * clocks_per_item / (sms * sm_clock_hz) * 1e3
    bytes_ms = n_items * bytes_per_item / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def poseidon2_bound_ms(n_states: int, sms: int = H100_SMS,
                       sm_clock_hz: float = H100_SM_CLOCK_HZ, mix=None):
    """(least ms, "operations" or "bytes") of permuting n states: the
    permutation's work model (or another instruction `mix` per state, such
    as a kernel's own SASS counts) at the dispatch rates, against its 384 B
    per state at the HBM rate.  The bound of both hand-written kernels
    (csrc/poseidon2.cu and csrc/poseidon2_soa.cu): 0.610 ms at 2^21
    states on 132 SMs at 1,980 MHz, bound by operations (76.0 clocks per
    state)."""
    return bound_ms(n_states, clocks_per_state(mix or P2_OPS),
                    P2_BYTES_PER_STATE, sms, sm_clock_hz)


# ------------------------------------------------------------ op counting

@dataclass
class OpCount:
    int_ops: float
    exact: bool  # False if an op outside both sets below was charged


def _packets(*names):
    """The ATen overload packets of `names` that this PyTorch has."""
    return {getattr(torch.ops.aten, n) for n in names
            if hasattr(torch.ops.aten, n)}


# Elementwise integer ops, one u32 op per output element (JAX's
# _INT_PRIMS: add, sub, mul, and/or/xor/not, shifts, comparisons, min/max,
# select_n, rem, neg), with their in-place forms.
_INT_OPS = _packets(
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_",
    "bitwise_and", "bitwise_and_", "bitwise_or", "bitwise_or_",
    "bitwise_xor", "bitwise_xor_", "bitwise_not", "bitwise_not_",
    "__and__", "__iand__", "__or__", "__ior__", "__xor__", "__ixor__",
    "bitwise_left_shift", "bitwise_left_shift_", "bitwise_right_shift",
    "bitwise_right_shift_", "__lshift__", "__ilshift__", "__rshift__",
    "__irshift__",
    "eq", "eq_", "ne", "ne_", "lt", "lt_", "le", "le_", "gt", "gt_", "ge",
    "ge_", "minimum", "maximum", "where", "remainder", "remainder_",
    "fmod", "fmod_", "neg", "neg_")
# Views, reshapes, copies, joins, index/gather/scatter and factories: data
# movement, free in this model (JAX's _FREE_PRIMS).
_FREE_OPS = _packets(
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "squeeze",
    "unsqueeze", "permute", "transpose", "t", "slice", "select", "narrow",
    "as_strided", "alias", "detach", "unbind", "split", "split_with_sizes",
    "chunk", "movedim", "view_as", "flip", "roll", "repeat", "unfold",
    "constant_pad_nd", "clone", "copy", "copy_", "_to_copy", "to",
    "contiguous", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "cat", "stack", "index", "index_select", "index_put", "index_put_",
    "_index_put_impl_", "gather", "scatter", "scatter_", "take",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "fill", "fill_", "zero_", "arange",
    "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full",
    "scalar_tensor", "resize_", "set_")


class _Counter(TorchDispatchMode):
    """Counts the ATen ops dispatched under it; inside `permutation(n)`
    the ops are not counted and the permutation's model is charged; at a
    field kernel's launch (`field_launch`) its limb chain is counted on
    meta tensors."""

    def __init__(self):
        super().__init__()
        self.ops, self.exact, self.opaque = 0.0, True, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if self.opaque or packet in _FREE_OPS:
            return out
        self.ops += sum(t.numel() for t in tree_leaves(out))
        if packet not in _INT_OPS:
            self.exact = False
        return out

    def field_launch(self, op: str, tensors) -> None:
        from ..ops import goldilocks as field_kernels

        if self.opaque:
            return
        field_kernels.limb_chain(op)(*(torch.empty_strided(
            t.shape, t.stride(), dtype=t.dtype, device="meta")
            for t in tensors))

    @contextlib.contextmanager
    def permutation(self, n_states: int):
        self.ops += n_states * P2_OPS["total"]
        self.opaque += 1
        try:
            yield
        finally:
            self.opaque -= 1


def count_int_ops(fn, *args) -> OpCount:
    """Total u32 ops of one call `fn(*args)`: each integer elementwise ATen
    op at one op per output element, each field kernel's launch at its
    limb chain's, each Poseidon2 permutation at the
    model's `P2_OPS["total"]` per state (see the module docstring); an op
    in neither the counted nor the free set is charged one op per output
    element and makes the count inexact, as in JAX.  A table that an
    earlier call built and cached (the NTT's twiddles) is not rebuilt, so
    warm fn up to count a steady call."""
    from ..ops import goldilocks as field_kernels
    from ..ops import poseidon2 as p2

    counter = _Counter()
    with p2.observe_states(counter.permutation), \
            field_kernels.observe_launches(counter.field_launch), counter:
        fn(*args)
    return OpCount(counter.ops, counter.exact)


# ------------------------------------------------------------ reports

def mfu_report(name: str, ops_per_item: OpCount, items_per_sec: float,
               peak: float = INT_PEAK_H100,
               bytes_per_item: float = 0.0) -> dict:
    """MFU-style record: achieved u32 ops/s against the card's integer
    peak (`mfu`), and the items/s against the roofline, the larger of the
    operations and the bytes bound per item (`roofline_share`).  Neither
    exceeds 1.0 while the count is a lower bound (module docstring)."""
    achieved = ops_per_item.int_ops * items_per_sec
    ops_s = ops_per_item.int_ops / peak
    bytes_s = bytes_per_item / HBM_BYTES_PER_S
    return {
        "kernel": name,
        "u32_ops_per_item": ops_per_item.int_ops,
        "bytes_per_item": bytes_per_item,
        "items_per_sec": items_per_sec,
        "achieved_u32_ops_per_sec": achieved,
        "int_peak_u32_ops_per_sec": peak,
        "mfu": achieved / peak,
        "achieved_bytes_per_sec": bytes_per_item * items_per_sec,
        "hbm_bytes_per_sec": HBM_BYTES_PER_S,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "roofline_share": items_per_sec * max(ops_s, bytes_s),
        "count_exact": ops_per_item.exact,
    }


def speed_of_light_items_per_sec(ops_per_item: OpCount,
                                 peak: float = INT_PEAK_H100) -> float:
    return peak / ops_per_item.int_ops if ops_per_item.int_ops else math.inf
