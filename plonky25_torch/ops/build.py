"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into
`build/<name>-<hash>.so` at the root of the checkout, with a plain C
interface that ctypes loads; `build_many` runs one nvcc per source, all at
once, and refuses to run during a CUDA graph capture.  The hash covers the
sources and the flags, so an edit rebuilds and an unchanged tree reuses
the library.  The compiler's report (registers, spills) is kept beside
the library as `.log`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: str
    log: str          # nvcc's output (ptxas register/spill report)
    seconds: float    # compile time; 0.0 when an earlier build was reused


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    path = os.path.join(CUDA_HOME, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{path} does not exist")
    return path


def _library_path(name: str) -> str:
    """build/<name>-<hash>.so, the hash over the flags and every source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> Built:
    """Compile csrc/<name>.cu (unless built already) and load it."""
    return build_many([name])[name]


def build_many(names) -> dict:
    """Compile csrc/<name>.cu for every name not built yet, all nvcc
    processes at once, then load each: {name: Built}.  Raises inside a
    CUDA graph capture, which neither a build nor a library load may
    interrupt (ops/poseidon2.py::load_kernels builds both beforehand)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel library cannot be built or loaded "
                           "during a CUDA graph capture; load it first")
    started = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        so = _library_path(name)
        if os.path.exists(so):
            continue
        src = os.path.join(CSRC_DIR, name + ".cu")
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, time.perf_counter(), so, tmp, src)
    seconds = {}
    failed = []
    for name, (proc, t0, so, tmp, src) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
            continue
        with open(so[:-len(".so")] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    built = {}
    for name in names:
        so = _library_path(name)
        log_path = so[:-len(".so")] + ".log"
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        built[name] = Built(ctypes.CDLL(so), so, log, seconds.get(name, 0.0))
    return built
