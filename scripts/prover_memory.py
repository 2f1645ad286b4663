"""Peak device memory of the port's prover on KeccakAir 2^12 x 2,633 against
the batch size and each memory strategy, on one NVIDIA GPU.

    python scripts/prover_memory.py [--out PATH] [--only NAME ...]

Each configuration runs in a child process of its own (a fresh CUDA
context, so one configuration's cached blocks and a failed allocation do
not reach the next): the tests/fixtures/proof_keccak_expected.json trace,
and for B > 1 traces of seeded inputs beside it, proved at
FriConfig(1, 100, 16) twice through TorchProver.prove_columns.  The second
proof is measured: torch.cuda.max_memory_allocated() read and reset at
every stage boundary (the peak of each stage, with what earlier stages
still hold), the whole proof's peak, its wall time, and its kernel count
(torch.profiler).  "off" means every strategy off: S = 1, one LDE chunk,
no slabs.  A configuration that runs out of memory reports the error.
Prints one line per configuration and writes all of them as JSON to PATH
(default build/prover_memory.json).  Needs the repository beside it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOG_N = 12
WIDE = 10 ** 9          # a slab width that leaves every sum one-shot

# name: (B, quotient_eval_chunks, quotient_col_groups, commit_col_chunks,
#        _ro_col_slab, _bary_col_slab); None keeps the prover's default
OFF = dict(s=1, g=None, chunks=1, ro=WIDE, bary=WIDE)
CONFIGS = {
    "B1 off": dict(OFF, b=1),
    "B2 off": dict(OFF, b=2),
    "B4 off": dict(OFF, b=4),
    "B1 S2": dict(OFF, b=1, s=2, g=1),
    "B1 S4": dict(OFF, b=1, s=4, g=1),
    "B1 S8": dict(OFF, b=1, s=8, g=1),
    "B1 S4 G4": dict(OFF, b=1, s=4, g=4),
    "B1 LDE chunks 4": dict(OFF, b=1, chunks=4),
    "B1 ro slab 256": dict(OFF, b=1, ro=256),
    "B1 bary slab 256": dict(OFF, b=1, bary=256),
    "B8 S4 defaults": dict(b=8, s=4, g=None, chunks=None, ro=None, bary=None),
    "B8 S4 all": dict(b=8, s=4, g=4, chunks=4, ro=256, bary=256),
    "B8 off": dict(OFF, b=8),
}


def traces(b):
    """The fixture's trace and b - 1 traces of seeded inputs (the
    chip_smoke.py batch), as one (b, H, W) array."""
    import numpy as np

    from plonky25_torch.models import keccak_trace_np

    with open(os.path.join(ROOT, "tests", "fixtures",
                           "proof_keccak_expected.json")) as f:
        inputs = json.load(f)["inputs"]
    out = [keccak_trace_np(inputs, 1 << LOG_N)]
    for i in range(1, b):
        rng = np.random.default_rng(0xCECC + i)
        seeded = rng.integers(0, 1 << 64, size=(len(inputs), 25),
                              dtype=np.uint64).tolist()
        out.append(keccak_trace_np(seeded, 1 << LOG_N))
    return np.stack(out)


def run_config(cfg, device="cuda"):
    """Prove B traces twice with the configuration's knobs; measure the
    second proof (module docstring)."""
    import torch

    from plonky25_torch.models import KeccakAir
    from plonky25_torch.proof import FriConfig
    from plonky25_torch.prover import TorchProver
    from plonky25_torch.prover.prove import trace_columns

    p = TorchProver(KeccakAir(), LOG_N, FriConfig(1, 100, 16), device,
                    quotient_eval_chunks=cfg["s"],
                    quotient_col_groups=cfg["g"])
    p.commit_col_chunks = cfg["chunks"]
    if cfg["ro"] == WIDE:       # and no budget to halve it
        importlib.import_module("plonky25_torch.prover.prove").SLAB_BYTES = \
            float("inf")
    if cfg["ro"] is not None:
        p._ro_col_slab = cfg["ro"]
    if cfg["bary"] is not None:
        p._bary_col_slab = cfg["bary"]
    tr = traces(cfg["b"])
    p.prove_columns(trace_columns(tr, device))
    torch.cuda.synchronize()
    cols = trace_columns(tr, device)
    stages = {}

    def mark(name):
        torch.cuda.synchronize()
        stages[name] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    p.prove_columns(cols, on_stage=mark)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        p.prove_columns(cols)
        torch.cuda.synchronize()
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return {"peak_gb": max(stages.values()), "stage_peak_gb": stages,
            "held_before_gb": held, "wall_ms": wall, "kernels": kernels}


def child(name):
    import torch

    try:
        out = run_config(CONFIGS[name])
    except torch.cuda.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).splitlines()[0]}
    print(json.dumps(dict(out, name=name, config=CONFIGS[name])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "prover_memory.json"))
    ap.add_argument("--only", nargs="*", help="configuration names")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("prover_memory: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        child(args.child)
        return 0
    from plonky25_torch.ops import build

    build.build_many(["poseidon2", "poseidon2_soa"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    rows = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in args.only or CONFIGS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", name], capture_output=True, text=True,
                           timeout=900)
        last = r.stdout.strip().splitlines()[-1:] or [""]
        try:
            row = json.loads(last[0])
        except json.JSONDecodeError:
            row = {"name": name, "error": r.stderr.strip()[-2000:]}
        rows.append(row)
        if "peak_gb" in row:
            print(f"{name}: peak {row['peak_gb']:.2f} GB, "
                  f"{row['wall_ms']:.0f} ms, {row['kernels']} kernels; by "
                  "stage " + ", ".join(f"{k} {v:.2f}" for k, v
                                       in row["stage_peak_gb"].items()),
                  flush=True)
        else:
            print(f"{name}: {row.get('out_of_memory') or row.get('error')}",
                  flush=True)
        with open(args.out, "w") as f:       # after every configuration
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
