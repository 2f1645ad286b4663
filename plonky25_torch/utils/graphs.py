"""Static-buffer programs: a function run on input buffers of its own,
captured once as a CUDA graph on the card.

The port's counterpart of `jax.jit` over a chain of stages (the JAX
verifier's `_s_all = jax.jit(self._verify_all_fn)`).  PyTorch dispatches
every op from the host; a CUDA graph replays the kernels a function
enqueued with one launch, every argument and address fixed at capture.
So a `StaticProgram` owns its inputs:

  * it allocates one tensor per input leaf when it is made, shaped like
    the template it is made from;
  * `load(*args)` copies the caller's tensors into them (`copy_`);
  * `run()`, on the card, replays the graph.  The graph is captured at the
    first run, after one eager run of the function on a side stream
    (PyTorch's documented warm-up): that run builds the kernel libraries,
    fills the module caches and loads every kernel module, none of which
    a capture may do.  On the CPU `run()` calls the function on the same
    buffers: the caller chose that device, and the CPU tests go through
    the same load, run and clone;
  * calling the program is load + run under its lock and returns clones of
    the outputs, which the next replay leaves alone.  A caller that chains
    runs (the gamma sponge's chunks, BatchVerifier's five stages) holds
    `lock` across them and loads one run's outputs into the next program
    itself: `load` copies them on the device before the replay that would
    overwrite them, so no clone is needed.  A caller whose programs pass
    large tensors on (the provers' LDEs and trees) gives the next program
    those tensors as `shared`: a template leaf that is one of them becomes
    the program's input buffer itself, and `load` skips it when it is
    given that very tensor, so nothing is copied.

Programs that always run one after the other, in the order they were
captured, may share one memory pool (`pool`, from
torch.cuda.graph_pool_handle()): a later capture reuses the blocks that an
earlier one freed, never those of its outputs, which the program holds.

A failed capture or replay raises; nothing runs the function eagerly in
its place.  The Poseidon2 wrappers and the field kernels' launcher count
launches in Python, which runs at capture and not at replay: the program
records what they counted at capture (utils/profiling.py's
recording_launches) and counts it again at every replay where tracing is
on.  Each run is the span `replay.<name>` (utils/profiling.py): the
graph's replay and its count on the card, the function's call on the CPU;
a capture is not in it.  A tensor that a module cache first makes during
the capture would live in the graph's memory pool, which replays
overwrite; the program checks that the caches did not grow during the
capture: the module caches, and the tables of the program's owner
(`tables`, the prover's per-instance tables).
`stats` holds the warm-up, capture, instantiation and first-replay times
and the bytes by which the capture grew the graph's memory pool.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict

import torch

from ..fields import extension
from ..ops import ntt, poseidon2
from . import profiling
from .tree import tree_leaves, tree_map, tree_signature


def _cache_sizes(tables: Callable = None) -> Dict[str, int]:
    """The entries of every module cache that holds device tensors, and
    those of `tables()` ({name: entries}, an owner's own caches)."""
    sizes = {"extension._CONSTS": len(extension._CONSTS),
             "extension._INDEX": len(extension._INDEX)}
    for mod in (ntt, poseidon2):
        for name, f in vars(mod).items():
            if hasattr(f, "cache_info"):
                sizes[f"{mod.__name__}.{name}"] = f.cache_info().currsize
    if tables is not None:
        sizes.update({f"tables.{k}": int(n) for k, n in tables().items()})
    return sizes


class StaticProgram:
    """`fn(*args)` on buffers of its own: a CUDA graph on the card, the
    function itself on the CPU (module docstring)."""

    def __init__(self, fn: Callable, template: tuple, device, pool=None,
                 shared: Dict[int, torch.Tensor] = None,
                 tables: Callable = None, name: str = "program"):
        self.fn = fn
        self.span = "replay." + name
        self.device = torch.device(device)
        self.pool = pool
        self.tables = tables
        self.signature = tree_signature(template)
        shared = shared or {}
        self.inputs = tree_map(
            lambda a: a if shared.get(id(a)) is a else torch.empty(
                a.shape, dtype=a.dtype, device=self.device), template)
        self.stats: Dict[str, float] = {}
        self._graph = None
        self._outputs = None
        self._launches = None
        self.lock = threading.Lock()

    def load(self, *args) -> None:
        """Copy `args` (the template's structure and shapes) into the
        program's input buffers."""
        if tree_signature(args) != self.signature:
            raise ValueError("the inputs do not have the structure and "
                             "shapes of the program's template")
        tree_map(lambda dst, src: dst if dst is src else dst.copy_(src),
                 self.inputs, args)

    def run(self):
        """Run the function on the loaded buffers; returns its outputs,
        which on the card the next run overwrites."""
        if self.device.type != "cuda":
            with profiling.span(self.span):
                return self.fn(*self.inputs)
        if self._graph is None:
            self._capture()
            t0 = time.perf_counter()
            self._replay()
            torch.cuda.synchronize(self.device)
            self.stats["first_replay_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            self._replay()
        return self._outputs

    def _replay(self) -> None:
        with profiling.span(self.span):
            self._graph.replay()
            profiling.replay_launches(self._launches)

    def __call__(self, *args):
        """Load `args`, run, and return clones of the outputs."""
        with self.lock:
            self.load(*args)
            return tree_map(torch.clone, self.run())

    def _capture(self) -> None:
        dev = self.device
        poseidon2.load_kernels()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.stats["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        sizes = _cache_sizes(self.tables)
        # torch.cuda.graph empties the allocator's cache before it
        # captures; emptying it here first makes the rise of the reserved
        # bytes the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # kept after the capture, so that its instantiation is timed apart
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with profiling.recording_launches() as launches:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*self.inputs)
        self.stats["capture_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.stats["instantiate_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["pool_bytes"] = torch.cuda.memory_reserved(dev) - reserved
        grown = {k: (n, sizes.get(k)) for k, n in
                 _cache_sizes(self.tables).items() if n != sizes.get(k)}
        if grown:
            raise RuntimeError(f"module caches grew during the capture "
                               f"(now, before): {grown}")
        self._graph, self._outputs, self._launches = graph, outputs, launches


class ProgramSet:
    """The stage programs of one signature (parallel/batch.py's
    BatchVerifier: `_t`, `_b`, `_r`, `_f`, `_fin`; prover/prove.py's
    provers: one per JAX prover jit), each made from its first call's
    arguments.  They run one after the other under `lock`, in the order
    they were captured, so they share one memory pool.  A program takes
    the tensors that earlier programs made, and the buffers `input`
    fills, as its own input buffers (StaticProgram's `shared`): they pass
    on without a copy.  The programs hold no strong reference to the
    object whose methods they run; `tables` is that object's table
    census (StaticProgram)."""

    def __init__(self, signature, device: torch.device,
                 tables: Callable = None):
        self.signature = signature
        self.device = device
        self.pool = (torch.cuda.graph_pool_handle()
                     if device.type == "cuda" else None)
        self.lock = threading.Lock()
        self.programs: Dict[str, StaticProgram] = {}
        self._tables = tables and _weak(tables)
        self._inputs: Dict = {}
        self._shared: Dict[int, torch.Tensor] = {}

    def _share(self, tree) -> None:
        for t in tree_leaves(tree):
            self._shared[id(t)] = t

    def __call__(self, name: str, fn: Callable, *args):
        """Program `name` on `args`: its outputs, which its next run
        overwrites."""
        prog = self.programs.get(name)
        made = prog is None
        if made:
            prog = StaticProgram(_weak(fn), args, self.device, self.pool,
                                 self._shared, self._tables, name)
            self.programs[name] = prog
            self._share(prog.inputs)
        prog.load(*args)
        out = prog.run()
        if made:
            self._share(out)
        return out

    def input(self, name: str, x):
        """x copied into this set's buffer `name`, which its programs
        share."""
        buf = self._inputs.get(name)
        if buf is None:
            buf = self._inputs[name] = tree_map(
                lambda a: torch.empty(a.shape, dtype=a.dtype,
                                      device=self.device), x)
            self._share(buf)
        tree_map(lambda d, v: d.copy_(v), buf, x)
        return buf


def _weak(fn: Callable) -> Callable:
    """fn, holding only a weak reference to the object a bound method is
    bound to (a program must not keep its owner alive)."""
    if getattr(fn, "__self__", None) is None:
        return fn
    ref = weakref.WeakMethod(fn)
    return lambda *args: ref()(*args)
