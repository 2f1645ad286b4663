"""Goldilocks and GF(p^2) add, sub and mul on CUDA tensors: one launch of
csrc/goldilocks.cu per field op.

fields/goldilocks.py (`gl.add`, `gl.sub`, `gl.mul`) and fields/extension.py
(`gl2.add`, `gl2.sub`, `gl2.mul`, `gl2.mul_base`) call `launch` for every
operand on a CUDA device; on the CPU they run their limb chains, which the
kernels are held bit-equal to.  There is no size threshold and no switch.

An op's operands are its limb tensors in order (lo, hi of each GL; c0.lo,
c0.hi, c1.lo, c1.hi of each GL2), in any shapes that broadcast together
and with any strides: `plan` computes the broadcast shape, drops its
length-1 axes, merges adjacent axes that every operand spans densely
(stride 0 on a broadcast axis), and hands the kernel each operand's
element strides over what is left, so an expanded zero, a `movedim`
view, a (k, 1, 1) constant or a 0-d scalar is read where it lies, with no
copy.  A plan of more than MAX_RANK axes raises.  The outputs are fresh
contiguous tensors of the broadcast shape, written on the current stream
(a capturing stream inside a CUDA graph capture, as Poseidon2's launches).

Where tracing is on (utils/profiling.py), every launch that went through
counts in `field.<op>.launches` and its elements in `field.<op>.elements`
(profiling.launched: inside a CUDA graph capture, into the launch record
that each replay of the graph counts).  `limb_chain` gives each op's
plain version, the limb chain the CPU runs.  `load_kernel` builds the
library; ops/poseidon2.py's `load_kernels` builds it with the Poseidon2
libraries before any capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..utils import profiling
from . import build

KERNEL_SOURCE = "plonky25_torch/csrc/goldilocks.cu"
MAX_RANK = 6
# op -> (input limb tensors, output limb tensors)
OPS = {"gl_add": (4, 2), "gl_sub": (4, 2), "gl_mul": (4, 2),
       "gl2_add": (8, 4), "gl2_sub": (8, 4), "gl2_mul": (8, 4),
       "gl2_mul_base": (6, 4)}
COUNTERS = {op: (f"field.{op}.launches", f"field.{op}.elements")
            for op in OPS}

_observers = []     # callbacks of the open observe_launches blocks


def plan(tensors):
    """(shape, dims, strides) of one launch over `tensors`: their
    broadcast shape, its axes with the length-1 ones dropped and dense
    neighbours merged (outermost first; [1] for a single element), and
    each tensor's element strides over those axes (0 where it is
    broadcast).  Raises ValueError if the shapes do not broadcast or more
    than MAX_RANK axes are left."""
    first = tensors[0].shape
    if all(t.shape == first and t.is_contiguous() for t in tensors):
        n = tensors[0].numel()
        return tuple(first), [n], [[1 if n != 1 else 0] for _ in tensors]
    nd = max(t.dim() for t in tensors)
    shape = [1] * nd
    aligned = {}
    for t in tensors:
        if id(t) in aligned:
            continue
        lead = nd - t.dim()
        a = [0] * nd
        for i, (n, st) in enumerate(zip(t.shape, t.stride())):
            if n != 1:
                d = lead + i
                if shape[d] == 1:
                    shape[d] = n
                elif shape[d] != n:
                    raise ValueError(
                        f"operand shapes {[tuple(u.shape) for u in tensors]}"
                        " do not broadcast together")
                a[d] = st
        aligned[id(t)] = a
    aligned = [aligned[id(t)] for t in tensors]
    dims, strides = [], [[] for _ in tensors]
    for d in range(nd):
        if shape[d] == 1:
            continue
        if dims and all(st[-1] == a[d] * shape[d]
                        for st, a in zip(strides, aligned)):
            # axis d (inner) continues the last axis kept (outer): merge
            dims[-1] *= shape[d]
            for st, a in zip(strides, aligned):
                st[-1] = a[d]
            continue
        dims.append(shape[d])
        for st, a in zip(strides, aligned):
            st.append(a[d])
    if not dims:
        dims, strides = [1], [[0] for _ in tensors]
    if len(dims) > MAX_RANK:
        raise ValueError(f"operands of shapes "
                         f"{[tuple(t.shape) for t in tensors]} leave "
                         f"{len(dims)} axes after merging; the field "
                         f"kernels take at most {MAX_RANK}")
    return tuple(shape), dims, strides


def limb_chain(op: str):
    """Field op `op`'s plain version, the chain of limb ops the CPU runs
    (gl.add_limbs, ..., gl2.mul_base_limbs), as a function of the op's
    input limb tensors that returns its output limb tensors, as `launch`
    does."""
    from ..fields import gl, gl2
    from ..fields.extension import GL2
    from ..fields.goldilocks import GL

    if op.startswith("gl2_"):
        fn = getattr(gl2, op[len("gl2_"):] + "_limbs")
        base = op == "gl2_mul_base"

        def chain(*t):
            y = GL(*t[4:6]) if base else GL2(GL(*t[4:6]), GL(*t[6:8]))
            out = fn(GL2(GL(*t[0:2]), GL(*t[2:4])), y)
            return [*out.c0, *out.c1]
    else:
        fn = getattr(gl, op[len("gl_"):] + "_limbs")

        def chain(a_lo, a_hi, b_lo, b_hi):
            return list(fn(GL(a_lo, a_hi), GL(b_lo, b_hi)))
    return chain


@functools.lru_cache(maxsize=None)
def load_kernel() -> build.Built:
    """Build (at first use) and load csrc/goldilocks.cu, its entry points
    bound."""
    built = build.build("goldilocks")
    for op in OPS:
        fn = getattr(built.lib, op)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rank = built.lib.gl_max_rank
    rank.argtypes, rank.restype = [], ctypes.c_int64
    if rank() != MAX_RANK:
        raise RuntimeError(f"csrc/goldilocks.cu takes rank {rank()}, the "
                           f"launcher plans for {MAX_RANK}")
    return built


def launch(op: str, tensors):
    """Run field op `op` (a key of OPS) on its input limb tensors, int64 on
    one CUDA device; returns its output limb tensors, new and contiguous
    in the operands' broadcast shape."""
    n_in, n_out = OPS[op]
    if len(tensors) != n_in:
        raise ValueError(f"{op} takes {n_in} limb tensors, got "
                         f"{len(tensors)}")
    if any(t.dtype != torch.int64 for t in tensors):
        raise TypeError(f"{op}: limbs must be int64, got "
                        f"{[t.dtype for t in tensors]}")
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(f"{op}: the kernel takes tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    shape, dims, strides = plan(tensors)
    outs = [torch.empty(shape, dtype=torch.int64, device=device)
            for _ in range(n_out)]
    n = outs[0].numel()
    if n == 0:
        return outs
    args = [len(dims), n, device.index or 0, *dims,
            *(t.data_ptr() for t in tensors),
            *(s for st in strides for s in st),
            *(o.data_ptr() for o in outs)]
    for cb in _observers:
        cb(op, tensors)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(load_kernel().lib, op)(
        (ctypes.c_int64 * len(args))(*args), stream)
    if err != 0:
        raise RuntimeError(f"{op} launch failed: cudaError {err}")
    profiling.launched(counts_of(op, n))
    return outs


def counts_of(op: str, n: int) -> dict:
    """The counters one launch of `op` on n elements adds."""
    launches, elements = COUNTERS[op]
    return {launches: 1, elements: n}


@contextlib.contextmanager
def observe_launches(cb):
    """Within the block, call `cb(op, tensors)` (the op and its input limb
    tensors) at every launch, before the kernel runs
    (utils/roofline.py's count_int_ops charges the op's limb chain
    there)."""
    _observers.append(cb)
    try:
        yield
    finally:
        _observers.remove(cb)
