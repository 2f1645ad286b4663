"""Peak device memory of the port's prover on KeccakAir 2^12 x 2,633 against
the batch size and each memory strategy, or on the 620-column VerifierAir
against its height and the quotient segments, on one NVIDIA GPU.

    python scripts/prover_memory.py [--air keccak|verifier] [--out PATH]
                                    [--only NAME ...]

Each configuration runs in a child process of its own (a fresh CUDA
context, so one configuration's cached blocks and a failed allocation do
not reach the next): the tests/fixtures/proof_keccak_expected.json trace,
and for B > 1 traces of seeded inputs beside it, proved at
FriConfig(1, 100, 16) twice through TorchProver.prove_columns, staged
(fused=False: no stage program is captured).  The second proof is
measured: torch.cuda.max_memory_allocated() read and reset at
every stage boundary (the peak of each stage, with what earlier stages
still hold), the whole proof's peak, its wall time, and its kernel count
(torch.profiler).  "off" means every strategy off: S = 1, one LDE chunk,
no slabs.  A configuration that runs out of memory reports the error.
Prints one line per configuration and writes all of them as JSON to PATH
(default build/prover_memory.json).  Needs the repository beside it.

With --air verifier (VERIFIER_CONFIGS) the trace is an attestation's: the
schedule of `copies` copies of the golden fib(64) proof's verification
(artifacts/attestation_fibonacci.json's samples; 13,477 rows each), at
the golden bundle's gamma and the accumulator it folds to (any gamma gives
a trace that satisfies VerifierAir), 2^14 rows for 1 copy, 2^16 for 4 and
2^19 for 31.  The parent builds each height's trace once on the card and
hands it to the children as a .npy file under build/.  The children prove
it at FriConfig(1, 100, 16) with S quotient segments and every other
strategy at its default, twice below 2^19 (the second measured) and once
at 2^19 (that first proof measured); no kernel count (the profiler would
take minutes per proof of half a million kernels).
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
# name: (copies of the golden schedule, quotient_eval_chunks)
VERIFIER_CONFIGS = {
    "V14 S1": dict(copies=1, s=1),
    "V14 S2": dict(copies=1, s=2),
    "V14 S4": dict(copies=1, s=4),
    "V16 S1": dict(copies=4, s=1),
    "V16 S2": dict(copies=4, s=2),
    "V16 S4": dict(copies=4, s=4),
    "V19 S8": dict(copies=31, s=8),
    "V19 S16": dict(copies=31, s=16),
}


def verifier_trace_path(copies):
    return os.path.join(ROOT, "build", f"verifier_trace_x{copies}.npz")


def write_verifier_trace(copies, device="cuda"):
    """The VerifierAir trace of `copies` golden schedules (module
    docstring), as columns (W, H) uint64 with its gamma and acc."""
    import numpy as np

    from plonky25_torch import attest_program as attp
    from plonky25_torch.attest import load_bundle
    from plonky25_torch.fields import gl
    from plonky25_torch.models import FibonacciAir
    from plonky25_torch.proof import FriConfig, derive_config, load_proof

    proof = load_proof(os.path.join(ROOT, "tests", "fixtures",
                                    "proof_fibonacci_refimpl.json"))
    golden = load_bundle(os.path.join(ROOT, "artifacts",
                                      "attestation_fibonacci.json"))
    rows = attp.build_verification_schedule(
        proof, derive_config(proof, FriConfig(1, 100, 16)), FibonacciAir(),
        golden.samples) * copies
    gamma = tuple(golden.gamma)
    acc = attp.fold_accumulator(rows, gamma)
    cols = gl.to_u64_np(attp.build_trace_cols(rows, gamma, device=device))
    np.savez(verifier_trace_path(copies), cols=cols, gamma=np.asarray(
        gamma, np.uint64), acc=np.asarray(acc, np.uint64))
    return len(rows), cols.shape


def run_verifier_config(cfg, device="cuda"):
    """Prove the VerifierAir trace with S = cfg["s"] (module docstring)."""
    import numpy as np
    import torch

    from plonky25_torch.fields import gl
    from plonky25_torch.fields.goldilocks import GL
    from plonky25_torch.models.verifier_air import VerifierAir
    from plonky25_torch.proof import FriConfig
    from plonky25_torch.prover import TorchProver

    data = np.load(verifier_trace_path(cfg["copies"]))
    air = VerifierAir({"gamma": tuple(int(x) for x in data["gamma"]),
                       "acc": tuple(int(x) for x in data["acc"])})
    log_n = data["cols"].shape[1].bit_length() - 1
    p = TorchProver(air, log_n, FriConfig(1, 100, 16), device,
                    quotient_eval_chunks=cfg["s"])
    one = gl.from_u64(data["cols"], device)
    cols = GL(one.lo[None], one.hi[None])
    del one, data
    if log_n < 19:
        p.prove_columns(cols, fused=False)
    torch.cuda.synchronize()
    stages = {}

    def mark(name):
        torch.cuda.synchronize()
        stages[name] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    p.prove_columns(cols, on_stage=mark, fused=False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return {"peak_gb": max(stages.values()), "stage_peak_gb": stages,
            "held_before_gb": held, "wall_ms": wall, "log_n": log_n,
            "first_proof": log_n >= 19}


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
    p.prove_columns(trace_columns(tr, device), fused=False)
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
    p.prove_columns(cols, on_stage=mark, fused=False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        p.prove_columns(cols, fused=False)
        torch.cuda.synchronize()
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return {"peak_gb": max(stages.values()), "stage_peak_gb": stages,
            "held_before_gb": held, "wall_ms": wall, "kernels": kernels}


def child(name, air):
    import torch

    configs = VERIFIER_CONFIGS if air == "verifier" else CONFIGS
    run = run_verifier_config if air == "verifier" else run_config
    try:
        out = run(configs[name])
    except torch.cuda.OutOfMemoryError as e:
        out = {"out_of_memory": str(e).splitlines()[0]}
    print(json.dumps(dict(out, name=name, config=configs[name])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "prover_memory.json"))
    ap.add_argument("--air", choices=("keccak", "verifier"), default="keccak",
                    help="KeccakAir (CONFIGS) or VerifierAir "
                         "(VERIFIER_CONFIGS)")
    ap.add_argument("--only", nargs="*", help="configuration names")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("prover_memory: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        child(args.child, args.air)
        return 0
    from plonky25_torch.ops import build

    build.build_many(["poseidon2", "poseidon2_soa"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    configs = VERIFIER_CONFIGS if args.air == "verifier" else CONFIGS
    names = args.only or list(configs)
    rows = []
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.air == "verifier":
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        for copies in sorted({configs[n]["copies"] for n in names}):
            t0 = time.perf_counter()
            n_rows, shape = write_verifier_trace(copies)
            print(f"VerifierAir trace of {copies} golden schedules: {n_rows} "
                  f"rows, columns {shape}, built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    for name in names:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--air", args.air, "--child", name],
                           capture_output=True, text=True, timeout=900)
        last = r.stdout.strip().splitlines()[-1:] or [""]
        try:
            row = json.loads(last[0])
        except json.JSONDecodeError:
            row = {"name": name, "error": r.stderr.strip()[-2000:]}
        rows.append(row)
        if "peak_gb" in row:
            print(f"{name}: peak {row['peak_gb']:.2f} GB, "
                  f"{row['wall_ms']:.0f} ms, {row.get('kernels')} kernels; by "
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
