"""Poseidon2 width-12 permutation over Goldilocks.

`poseidon2_permute(state)` is what every caller uses.  It picks by the
tensor's device alone:

  * a CPU tensor runs `poseidon2_permute_plain`, the PyTorch version below
    (the CPU tests' path);
  * a CUDA tensor launches the hand-written kernel csrc/poseidon2.cu, at
    every batch size, or raises.  There is no size threshold, no fallback
    and no switch around it.

Each kernel has two hand-written variants, one thread per state and three
threads per state; its C launcher picks one by the number of states alone
(the crossover is a constant of the .cu file).
`_poseidon2_permute_variant` is a measurement hook, not part of this
contract: it runs the variant it is told to at any size, so that each can
be held to the plain version and timed on both sides of the crossover.

The plain version mirrors plonky25_tpu/ops/poseidon2.py (rounds in array
form over a (..., 12) state; the constants of poseidon2_goldilocks.rs:11-164);
the kernel replaces the Pallas kernel of
plonky25_tpu/ops/pallas/poseidon2_pallas.py:103.

`poseidon2_permute_soa(planes)` is the same permutation on lane-major
states, planes (12, ...): lane k of every state in planes[k].  It picks by
device in the same way, between `poseidon2_permute_soa_plain` (a mirror of
the Pallas `_soa_*` helpers on a list of 12 lane arrays) and the kernel
csrc/poseidon2_soa.cu, which replaces the Pallas kernel of
poseidon2_pallas.py:219.

`observe_states(cb)` lets a caller see the work of both wrappers whatever
runs it: inside its block every call of either is entered as
`with cb(n_states):`, around the plain version or the launch
(utils/roofline.py's count_int_ops charges the permutation's work model
there).  Where tracing is on (utils/profiling.py), every call counts its
states in `poseidon2.<kernel>.states`, and every launch of a kernel that
went through counts in `poseidon2.<kernel>.launches`, <kernel> `w12`
(state-major) or `soa` (lane-major): a call of the plain version permutes
states and launches nothing.  Counts and observers run in Python, which a
CUDA graph does not replay: a graph's owner captures under
utils/profiling.py's `recording_launches`, in which each launch records
its counts and its observers' replay, and calls `replay_launches` at each
replay (utils/graphs.py), so a launch is counted where the kernel runs.
`load_kernels` builds both libraries, and the field kernels'
(ops/goldilocks.py), before a capture, during which ops/build.py refuses
to build.
`poseidon2_permute_auto` is the JAX package's name for the same
dispatch as `poseidon2_permute`.  JAX's `poseidon2_permute_jit` (a jitted
alias) and `PALLAS_DISABLED` (the P25_DISABLE_PALLAS environment switch,
read at import, that sends the TPU to the plain path) have no counterpart:
PyTorch runs eagerly, so there is nothing to compile, and the port reads no
environment and has no switch around its kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..constants import (
    GOLDILOCKS_P as P,
    MAT_DIAG_M_1,
    RC,
    RC_MID,
    ROUND_F_BEGIN,
    ROUND_F_END,
    WIDTH,
)
from ..fields import gl
from ..fields.goldilocks import GL
from ..utils import profiling
from . import build
from . import goldilocks as field_kernels

KERNEL_SOURCE = "plonky25_torch/csrc/poseidon2.cu"
REPLACES = "plonky25_tpu/ops/pallas/poseidon2_pallas.py:103"
SOA_KERNEL_SOURCE = "plonky25_torch/csrc/poseidon2_soa.cu"
SOA_REPLACES = "plonky25_tpu/ops/pallas/poseidon2_pallas.py:219"

# ------------------------------------------------------------ plain version


@functools.lru_cache(maxsize=None)
def _plain_constants(device: torch.device):
    """(rc_ext (8, 12), rc_mid (22,), diag (12,)) as GL on `device`."""
    return (gl.from_u64(RC, device), gl.from_u64(RC_MID, device),
            gl.from_u64([(d - 1) % P for d in MAT_DIAG_M_1], device))


def _sbox(x: GL) -> GL:
    """x^7 elementwise (poseidon2.rs:114-121)."""
    x2 = gl.square(x)
    x4 = gl.square(x2)
    return gl.mul(gl.mul(x, x2), x4)


def _matmul_external(state: GL) -> GL:
    """M_E on (..., 12): M4 per 4-lane block, then the block sums
    (poseidon2.rs:127-147)."""
    batch = state.shape[:-1]
    b = state.reshape(*batch, 3, 4)
    x0, x1, x2, x3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(t1, gl.double(x1))
    t3 = gl.add(t0, gl.double(x3))
    t4 = gl.add(t3, gl.scale_small(t1, 4))
    t5 = gl.add(t2, gl.scale_small(t0, 4))
    m4 = gl.stack([gl.add(t3, t5), t5, gl.add(t2, t4), t4], dim=-1)  # (...,3,4)
    stored = gl.add(gl.add(m4[..., 0, :], m4[..., 1, :]), m4[..., 2, :])
    return gl.add(m4, stored[..., None, :]).reshape(*batch, WIDTH)


def _sum_lanes(state: GL) -> GL:
    """Sum of the 12 lanes, (..., 12) -> (...,)."""
    batch = state.shape[:-1]
    b = state.reshape(*batch, 3, 4)
    t = gl.add(gl.add(b[..., 0, :], b[..., 1, :]), b[..., 2, :])  # (..., 4)
    return gl.add(gl.add(t[..., 0], t[..., 1]), gl.add(t[..., 2], t[..., 3]))


def poseidon2_permute_plain(state: GL) -> GL:
    """The permutation in PyTorch ops, on a GL of shape (..., 12)."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"state shape {state.shape}: last axis must be {WIDTH}")
    rc_ext, rc_mid, diag = _plain_constants(state.device)
    state = _matmul_external(state)
    for r in range(ROUND_F_BEGIN):
        state = _matmul_external(_sbox(gl.add(state, rc_ext[r])))
    for r in range(len(RC_MID)):
        lane0 = _sbox(gl.add(state[..., 0], rc_mid[r]))
        state = gl.concatenate([lane0[..., None], state[..., 1:]], dim=-1)
        state = gl.add(gl.mul(diag, state), _sum_lanes(state)[..., None])
    for r in range(ROUND_F_BEGIN, ROUND_F_END):
        state = _matmul_external(_sbox(gl.add(state, rc_ext[r])))
    return state


# ------------------------------------------------------------ observers

_observers = []     # callbacks of the open observe_states blocks
_OFF = contextlib.nullcontext()
_COUNTERS = {k: (f"poseidon2.{k}.states", f"poseidon2.{k}.launches")
             for k in ("w12", "soa")}


@contextlib.contextmanager
def observe_states(cb):
    """Within the block, enter `cb(n)` (a context manager) around the work
    of every call of poseidon2_permute and poseidon2_permute_soa on n
    states, on either device."""
    _observers.append(cb)
    try:
        yield
    finally:
        _observers.remove(cb)


def _entered(n: int):
    """The observers' contexts for one call on n states."""
    if not _observers:
        return _OFF
    stack = contextlib.ExitStack()
    for cb in list(_observers):
        stack.enter_context(cb(n))
    return stack


def _observed(state: GL, kernel: str):
    """What one call of `kernel` on `state` (12 lanes a state, on either
    axis) runs inside: its states counted where tracing is on, and the
    observers' contexts; nothing inside profiling.recording_launches,
    where _launched records the launch."""
    if profiling.launch_record_open() or (not _observers
                                        and not profiling.tracing()):
        return _OFF
    n = state.lo.numel() // WIDTH
    profiling.count(_COUNTERS[kernel][0], n)
    return _entered(n)


def _launched(kernel: str, n: int) -> None:
    """One launch of `kernel` on n states went through: its launch
    counted where tracing is on (its states were, in _observed), or
    inside profiling.recording_launches both recorded, the observers'
    contexts entered at each replay."""
    states, launches = _COUNTERS[kernel]
    if not profiling.launch_record_open():
        profiling.count(launches)
        return
    profiling.launched({states: n, launches: 1},
                       functools.partial(_replayed, n))


def _replayed(n: int) -> None:
    """A replay of a recorded launch on n states: the open observers'
    contexts, entered and left."""
    if _observers:
        with _entered(n):
            pass


# ------------------------------------------------------------ the kernel


def _load(name: str, entry: str, split_max: str) -> build.Built:
    """Build (at first use) and load csrc/<name>.cu; bind its launcher
    `entry`, the measurement hook `entry`_variant, and the crossover
    getter `split_max` (the launcher runs n <= split_max states split)."""
    built = build.build(name)
    limbs = [ctypes.c_void_p] * 4 + [ctypes.c_int64]
    launcher = getattr(built.lib, entry)
    hook = getattr(built.lib, entry + "_variant")
    launcher.argtypes = limbs + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    hook.argtypes = limbs + [ctypes.c_int, ctypes.c_void_p]
    launcher.restype = hook.restype = ctypes.c_int
    getter = getattr(built.lib, split_max)
    getter.argtypes, getter.restype = [], ctypes.c_int64
    built.split_max = int(getter())
    return built


@functools.lru_cache(maxsize=None)
def kernel_library() -> build.Built:
    """Build (at first use) and load csrc/poseidon2.cu."""
    return _load("poseidon2", "p25_poseidon2_permute_w12",
                 "p25_poseidon2_w12_split_max_states")


def check_kernel_input(state: GL, lane_axis: int = -1) -> None:
    """Raise unless `state` is what a kernel takes: two contiguous int64
    limb tensors of one shape with 12 lanes on `lane_axis` ((..., 12) for
    the state-major kernel, (12, ...) for the lane-major one), on one CUDA
    device."""
    lo, hi = state
    if lo.dtype != torch.int64 or hi.dtype != torch.int64:
        raise TypeError(f"limbs must be int64, got {lo.dtype} and {hi.dtype}")
    if lo.shape != hi.shape or lo.dim() == 0 or lo.shape[lane_axis] != WIDTH:
        want = f"(..., {WIDTH})" if lane_axis == -1 else f"({WIDTH}, ...)"
        raise ValueError(f"limb shapes {tuple(lo.shape)} and {tuple(hi.shape)}"
                         f": want two equal shapes {want}")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("limb tensors must be contiguous")
    if lo.device.type != "cuda" or hi.device != lo.device:
        raise ValueError(f"the kernel takes CUDA tensors on one device, got "
                         f"{lo.device} and {hi.device}")


def _launch(kernel: str, built: build.Built, entry: str, state: GL,
            split=None) -> GL:
    """Launch `entry` of `built` on `state` (checked by the caller) into
    new tensors: the variant n selects, or through the hook `entry`_variant
    the one `split` names.  Counts the launch as one of `kernel`'s once it
    went through (_launched)."""
    lo, hi = state
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    n = lo.numel() // WIDTH
    if n == 0:
        return GL(out_lo, out_hi)
    with torch.cuda.device(lo.device):
        stream = torch.cuda.current_stream(lo.device).cuda_stream
        ptrs = (lo.data_ptr(), hi.data_ptr(), out_lo.data_ptr(),
                out_hi.data_ptr(), n)
        if split is None:
            # the launcher reports the variant it ran (the kernel tests
            # hold it to the crossover; the device trace names it)
            ran_split = ctypes.c_int(0)
            err = getattr(built.lib, entry)(*ptrs, stream,
                                            ctypes.byref(ran_split))
        else:
            entry += "_variant"
            err = getattr(built.lib, entry)(*ptrs, int(split), stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    _launched(kernel, n)
    return GL(out_lo, out_hi)


def poseidon2_permute(state: GL) -> GL:
    """Permute a GL of shape (..., 12): the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (see the module docstring)."""
    with _observed(state, "w12"):
        if state.lo.device.type == "cpu" and state.hi.device.type == "cpu":
            return poseidon2_permute_plain(state)
        check_kernel_input(state)
        return _launch("w12", kernel_library(),
                       "p25_poseidon2_permute_w12", state)


def poseidon2_permute_auto(state: GL) -> GL:
    """The JAX package's backend-aware entry: here the same dispatch as
    poseidon2_permute, by device alone (no size threshold, no switch)."""
    return poseidon2_permute(state)


def _poseidon2_permute_variant(state: GL, split: bool) -> GL:
    """Measurement hook, not part of the wrapper's contract: the kernel's
    variant `split` (three threads per state) or not (one) on CUDA
    state-major states, at any size, for holding each variant to the plain
    version and timing it on both sides of the crossover.  Counted as
    poseidon2_permute's calls are."""
    check_kernel_input(state)
    with _observed(state, "w12"):
        return _launch("w12", kernel_library(), "p25_poseidon2_permute_w12",
                       state, split)


# ------------------------------------------------------------ lane-major form


def _soa_sbox(x: GL) -> GL:
    """x^7 elementwise (poseidon2_pallas.py:193-196)."""
    return _sbox(x)


def _soa_m4(b):
    """M4 on a list of four lane arrays (poseidon2_pallas.py:199-208)."""
    x0, x1, x2, x3 = b
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(t1, gl.double(x1))
    t3 = gl.add(t0, gl.double(x3))
    t4 = gl.add(t3, gl.scale_small(t1, 4))
    t5 = gl.add(t2, gl.scale_small(t0, 4))
    return [gl.add(t3, t5), t5, gl.add(t2, t4), t4]


def _soa_matmul_external(s):
    """M_E on a list of 12 lane arrays (poseidon2_pallas.py:211-216)."""
    blocks = [_soa_m4(s[4 * k:4 * k + 4]) for k in range(3)]
    stored = [gl.add(gl.add(blocks[0][i], blocks[1][i]), blocks[2][i])
              for i in range(4)]
    return [gl.add(blocks[k][i], stored[i])
            for k in range(3) for i in range(4)]


def poseidon2_permute_soa_plain(planes: GL) -> GL:
    """The permutation on lane-major planes (12, ...), in PyTorch ops: the
    rounds of the Pallas `_soa_kernel` (poseidon2_pallas.py:219-252).  The
    lane-wise steps (round constants, S-boxes, the internal diagonal) run
    on the stacked lanes, one op for all 12; M_E runs on the lane list."""
    if planes.shape[0] != WIDTH:
        raise ValueError(f"planes shape {planes.shape}: first axis must be "
                         f"{WIDTH}")
    rc_ext, rc_mid, diag = _plain_constants(planes.device)
    col = (WIDTH,) + (1,) * (len(planes.shape) - 1)   # broadcast over lanes

    def lanes(x: GL):
        return [x[i] for i in range(WIDTH)]

    def ext_round(s, r: int):
        x = _soa_sbox(gl.add(gl.stack(s), rc_ext[r].reshape(*col)))
        return _soa_matmul_external(lanes(x))

    s = _soa_matmul_external(lanes(planes))
    for r in range(ROUND_F_BEGIN):
        s = ext_round(s, r)
    for r in range(len(RC_MID)):
        s = [_soa_sbox(gl.add(s[0], rc_mid[r]))] + s[1:]
        t = gl.add(gl.add(gl.add(s[0], s[1]), gl.add(s[2], s[3])),
                   gl.add(gl.add(s[4], s[5]), gl.add(s[6], s[7])))
        total = gl.add(t, gl.add(gl.add(s[8], s[9]), gl.add(s[10], s[11])))
        s = lanes(gl.add(gl.mul(gl.stack(s), diag.reshape(*col)), total))
    for r in range(ROUND_F_BEGIN, ROUND_F_END):
        s = ext_round(s, r)
    return gl.stack(s, dim=0)


@functools.lru_cache(maxsize=None)
def soa_kernel_library() -> build.Built:
    """Build (at first use) and load csrc/poseidon2_soa.cu."""
    return _load("poseidon2_soa", "p25_poseidon2_permute_soa",
                 "p25_poseidon2_soa_split_max_states")


def poseidon2_permute_soa(planes: GL) -> GL:
    """Permute lane-major planes (12, ...): the plain version for CPU
    tensors, the CUDA kernel csrc/poseidon2_soa.cu for CUDA tensors."""
    with _observed(planes, "soa"):
        if planes.lo.device.type == "cpu" and planes.hi.device.type == "cpu":
            return poseidon2_permute_soa_plain(planes)
        check_kernel_input(planes, lane_axis=0)
        return _launch("soa", soa_kernel_library(),
                       "p25_poseidon2_permute_soa", planes)


def _poseidon2_permute_soa_variant(planes: GL, split: bool) -> GL:
    """The measurement hook _poseidon2_permute_variant for lane-major
    planes (12, ...).  Counted as poseidon2_permute_soa's calls are."""
    check_kernel_input(planes, lane_axis=0)
    with _observed(planes, "soa"):
        return _launch("soa", soa_kernel_library(),
                       "p25_poseidon2_permute_soa", planes, split)


def load_kernels() -> None:
    """Build (one nvcc for each source, started together) and load both
    kernel libraries and the field kernels' (ops/goldilocks.py), so that
    no later call builds one: a captured CUDA graph must not (ops/build.py
    refuses to build during a capture)."""
    build.build_many(["poseidon2", "poseidon2_soa", "goldilocks"])
    kernel_library()
    soa_kernel_library()
    field_kernels.load_kernel()
