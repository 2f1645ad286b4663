"""Run the PyTorch port (plonky25_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--report PATH]

Phases, one line each; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/poseidon2.cu for sm_90a from this checkout's sources;
  3. the Poseidon2 kernel against its plain PyTorch version, bit for bit:
     N = 1, 255, 257 and 1,048,579 random states, edge-value states, the
     fixture's known answers, and every state count the main path launches;
  4. `verify_proof` of the fixture proof (tests/fixtures/) on the card: the
     transcript values of tests/fixtures/proof_fibonacci_expected.json, the
     tamper battery, the kernel's launch count, the latency;
  5. `BatchVerifier` at B=2048 proofs x Q=100 queries (the fixture tiled,
     4 lanes tampered): exact verdicts, ms per batch, queries/s, peak
     memory, ms per stage (CUDA events), device time (torch.profiler);
  6. the kernel table line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.

With --report, the full measurements also go to PATH as JSON.  The script
imports nothing of JAX or plonky25_tpu; it needs the repository beside it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from plonky25_torch.fields import gl  # noqa: E402
from plonky25_torch.models import FibonacciAir  # noqa: E402
from plonky25_torch.ops import build  # noqa: E402
from plonky25_torch.ops import poseidon2 as p2  # noqa: E402
from plonky25_torch.parallel.batch import (  # noqa: E402
    BatchVerifier,
    stack_witnesses,
)
from plonky25_torch.proof import FriConfig, derive_config, load_proof  # noqa: E402
from plonky25_torch.verifier import get_verifier, verify_proof  # noqa: E402
from plonky25_torch.witness import pack_witness  # noqa: E402

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
DEVICE = "cuda"
B = 2048
TAMPERED = ("pow", "merkle_sibling", "fold_sibling", "final_poly")
# H100 SXM rates (NVIDIA data sheet; CUDA C Programming Guide throughput
# table for compute capability 9.0): HBM bytes/s, and per SM per clock
# 64 results of 32-bit integer add/compare/logic/shift/select (ALU pipe),
# 64 of 32-bit integer multiply-add (FMA pipe), 4 x 32 instructions dispatched.
HBM_BYTES_PER_S = 3.35e12
ALU_PER_CLK, FMA_PER_CLK, DISPATCH_PER_CLK = 64, 64, 128


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
         "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout
    return out.strip()


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ phase 2

def sass_mix(path):
    """Per-thread instruction counts of the kernel, by pipe, from its SASS.

    The kernel is straight-line code (every round unrolled), so the static
    count is what one thread executes."""
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    ops = Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)", sass))
    ops.pop("NOP", None)
    fma = sum(v for k, v in ops.items()
              if k.startswith(("IMAD", "IMUL", "VIADD")))
    uniform = sum(v for k, v in ops.items() if k.startswith("U"))
    other = sum(v for k, v in ops.items() if k.startswith(
        ("LD", "ST", "S2R", "S2UR", "EXIT", "BRA", "CS2R")))
    total = sum(ops.values())
    return {"total": total, "fma_pipe": fma, "uniform": uniform,
            "memory_control": other,
            "alu_pipe": total - fma - uniform - other,
            "by_opcode": dict(ops.most_common())}


# ------------------------------------------------------------ phase 3

def random_states(n, seed):
    rng = np.random.default_rng(seed)
    return gl.from_u64(rng.integers(0, P, size=(n, 12), dtype=np.uint64),
                       DEVICE)


def edge_states():
    edge = [0, 1, P - 1, 1 << 32, 0xFFFFFFFF, (0xFFFFFFFF << 32) % P,
            P - (1 << 32)]
    rows = [[edge[(i * k + j) % len(edge)] for i in range(12)]
            for k in range(1, 8) for j in range(len(edge))]
    rows += [[e] * 12 for e in edge]
    return gl.from_u64(np.asarray(rows, dtype=np.uint64), DEVICE)


def kernel_vs_plain(state):
    """Max |kernel - plain| over both limbs (0 when bit-equal)."""
    out = p2.poseidon2_permute(state)
    ref = p2.poseidon2_permute_plain(state)
    torch.cuda.synchronize()
    return max(int((out.lo - ref.lo).abs().max()),
               int((out.hi - ref.hi).abs().max()))


def main_path_shapes(v, b):
    """{states per launch: launches} of one verification of b proofs: the
    transcript's duplex steps, the fused Merkle walk (leaf hash + one
    compression per level), the fold's leaf hash and its walk."""
    nb = 2                                   # trace and quotient batches
    shapes = Counter()
    shapes[b] += v.n_steps
    shapes[nb * b * v.Q] += 1 + v.log_max_height
    shapes[v.n_phases * b * v.Q] += 1 + v.n_phases
    return dict(shapes)


# ------------------------------------------------------------ phases 4, 5

def tamper(proof, kind):
    p = copy.deepcopy(proof)
    fp = p.opening_proof.fri_proof
    if kind == "pow":
        fp.pow_witness += 1
    elif kind == "merkle_sibling":
        p.opening_proof.query_openings[17][0].opening_proof[3][2] ^= 1
    elif kind == "fold_sibling":
        s = fp.query_proofs[5].commit_phase_openings[1]
        s.sibling_value = (s.sibling_value[0] ^ 1, s.sibling_value[1])
    elif kind == "final_poly":
        fp.final_poly = (fp.final_poly[0] + 1, fp.final_poly[1])
    return p


def ext_int(x):
    return [int(gl.to_u64(x.c0)), int(gl.to_u64(x.c1))]


def profile_device_time(fn):
    """(device ms, kernel count, {name: (ms, count)}) of one run of fn,
    from torch.profiler; None where the profiler saw no CUDA kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0) or 0
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (t / 1e3, ev.count)
    if not kernels:
        return None
    total = sum(t for t, _ in kernels.values())
    count = sum(c for _, c in kernels.values())
    return total, count, kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the measurements here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    report = {}

    # 1. the card
    card = nvidia_smi("name,power.limit")
    print(card)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report["card"] = {"nvidia_smi": card, "max_sm_clock_mhz": max_sm_mhz,
                      "sm_count": sms}

    # 2. build
    t0 = time.perf_counter()
    built = p2.kernel_library()
    build_s = time.perf_counter() - t0
    regs = re.search(r"Used (\d+) registers", built.log)
    spills = re.search(r"(\d+) bytes spill stores", built.log)
    mix = sass_mix(built.path)
    print(f"[build] {os.path.relpath(built.path, ROOT)} for sm_90a in "
          f"{build_s:.1f} s (nvcc {built.seconds:.1f} s); "
          f"{regs.group(1) if regs else '?'} registers, "
          f"{spills.group(1) if spills else '?'} bytes spilled; "
          f"{mix['total']} SASS instructions per permutation "
          f"(ALU pipe {mix['alu_pipe']}, FMA pipe {mix['fma_pipe']})")
    report["build"] = {"seconds": build_s, "nvcc_seconds": built.seconds,
                       "ptxas": built.log, "sass": mix}

    # 3. kernel against the plain version
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        expected = json.load(f)
    proof = load_proof(os.path.join(FIXTURES, "proof_fibonacci_refimpl.json"))
    fc = FriConfig(**expected["fri_config"])
    cfg = derive_config(proof, fc)
    v = get_verifier(FibonacciAir(), cfg, DEVICE)
    single_shapes = main_path_shapes(v, 1)
    batch_shapes = main_path_shapes(v, B)
    err = 0
    sizes = [1, 255, 257, 1_048_579]
    for n in sizes:
        err = max(err, kernel_vs_plain(random_states(n, n)))
    err = max(err, kernel_vs_plain(edge_states()))
    kat = expected["poseidon2_known_answers"]
    kat_in = gl.from_u64(np.asarray([k["input"] for k in kat], np.uint64), DEVICE)
    kat_out = p2.poseidon2_permute(kat_in)
    check(gl.to_u64(kat_out).tolist() == [k["output"] for k in kat],
          "kernel disagrees with the fixture's Poseidon2 known answers")
    err = max(err, kernel_vs_plain(kat_in))
    path_sizes = sorted(set(single_shapes) | set(batch_shapes))
    for n in path_sizes:
        err = max(err, kernel_vs_plain(random_states(n, 7 * n + 1)))
    check(err == 0, f"kernel differs from the plain version by {err}")
    print(f"[kernel] poseidon2_permute_w12 bit-equal to the plain version at "
          f"N={','.join(map(str, sizes))}, on {edge_states().shape[0]} "
          f"edge-value states, on {len(kat)} known answers and at the main "
          f"path's N={','.join(map(str, path_sizes))}")

    # 4. one proof through verify_proof
    r = verify_proof(proof, FibonacciAir(), fc, device=DEVICE)
    for k, want in expected["verdict"].items():
        check(bool(getattr(r, k)) == want, f"fixture verdict {k}={want} not met")
    check(ext_int(r.alpha) == expected["alpha"], "alpha differs")
    check(ext_int(r.zeta) == expected["zeta"], "zeta differs")
    check(r.query_indices.tolist() == expected["query_indices"],
          "query indices differ")
    chal = v.fri_challenges(proof)
    check([list(b) for b in chal.betas] == expected["betas"], "betas differ")
    flags = {"pow": "pow_ok", "merkle_sibling": "merkle_ok",
             "fold_sibling": "fold_ok", "final_poly": "fold_ok"}
    for kind, flag in flags.items():
        t = verify_proof(tamper(proof, kind), FibonacciAir(), fc, device=DEVICE)
        check(not bool(t.ok) and not bool(getattr(t, flag)),
              f"tampered {kind} was not rejected")
    bad_q = verify_proof(proof, FibonacciAir(), FriConfig(
        fc.log_blowup, fc.num_queries - 1, fc.proof_of_work_bits), device=DEVICE)
    check(not bad_q.shape_ok and not bool(bad_q.ok),
          "wrong query count was not rejected")

    def verify_one():
        return bool(verify_proof(proof, FibonacciAir(), fc, device=DEVICE).ok)

    torch.cuda.synchronize()
    p2.poseidon2_permute.launches = 0
    check(verify_one(), "fixture rejected")
    launches_single = p2.poseidon2_permute.launches
    check(launches_single == sum(single_shapes.values()) and launches_single > 0,
          f"single proof launched the kernel {launches_single} times, "
          f"expected {sum(single_shapes.values())}")
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        check(verify_one(), "fixture rejected")
        lat.append((time.perf_counter() - t0) * 1e3)
    prof1 = profile_device_time(verify_one)
    dev1 = (f"{prof1[0]:.1f} ms device time in {prof1[1]} kernels"
            if prof1 else "device time not measured (profiler saw no kernels)")
    print(f"[single] fixture accepted on cuda with the expected alpha, zeta, "
          f"betas and {len(expected['query_indices'])} query indices; "
          f"{len(flags)} tampers and a wrong query count rejected; "
          f"{launches_single} kernel launches; latency median "
          f"{statistics.median(lat):.1f} ms, best {min(lat):.1f} ms; {dev1}")
    report["single"] = {"latency_ms": lat, "launches": launches_single,
                        "shapes": single_shapes,
                        "device_ms": prof1[0] if prof1 else None,
                        "device_kernels": prof1[1] if prof1 else None}

    # 5. a batch of B proofs
    bv = BatchVerifier(FibonacciAir(), cfg, device=DEVICE)
    w = pack_witness(proof, cfg, DEVICE)
    lanes = [3, B // 3, 2 * B // 3, B - 1]    # one lane per tamper kind
    bad = {lane: pack_witness(tamper(proof, kind), cfg, DEVICE)
           for lane, kind in zip(lanes, TAMPERED)}
    ws = stack_witnesses([bad.get(b, w) for b in range(B)])
    want = torch.ones(B, dtype=torch.bool, device=DEVICE)
    want[lanes] = False

    def verify_batch(on_stage=None):
        return bv.verify_witnesses(ws, on_stage)

    check(torch.equal(verify_batch(), want), "batch verdicts differ")
    torch.cuda.synchronize()
    p2.poseidon2_permute.launches = 0
    ok = verify_batch()
    torch.cuda.synchronize()
    launches_batch = p2.poseidon2_permute.launches
    check(torch.equal(ok, want), "batch verdicts differ")
    check(launches_batch == sum(batch_shapes.values()),
          f"batch launched the kernel {launches_batch} times, expected "
          f"{sum(batch_shapes.values())}")
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        ok = verify_batch()
        check(torch.equal(ok, want), "batch verdicts differ")
        runs.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    verify_batch(mark)
    torch.cuda.synchronize()
    stage_ms = {name: events[i][1].elapsed_time(ev)
                for i, (name, ev) in enumerate(events[1:])}
    prof = profile_device_time(verify_batch)
    ms_batch = statistics.median(runs)
    qps = B * v.Q / (ms_batch / 1e3)
    stages = ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items())
    if prof:
        p2_ms, p2_n = next(((t, c) for k, (t, c) in prof[2].items()
                            if "poseidon2" in k), (0.0, 0))
        devb = (f"{prof[0]:.1f} ms device time in {prof[1]} kernels, "
                f"Poseidon2 {p2_ms:.1f} ms in {p2_n}")
    else:
        devb = "device time not measured (profiler saw no kernels)"
    print(f"[batch] B={B} x Q={v.Q}: verdicts exact ({len(lanes)} "
          f"tampered lanes rejected); {launches_batch} kernel launches; "
          f"{ms_batch:.1f} ms per batch (median of {len(runs)}), "
          f"{qps:.0f} queries/s; peak {peak_gb:.2f} GB; stage ms: {stages}; "
          f"{devb}")
    report["batch"] = {
        "B": B, "Q": v.Q, "ms_runs": runs, "ms": ms_batch,
        "queries_per_s": qps, "peak_allocated_gb": peak_gb,
        "stage_ms": stage_ms, "launches": launches_batch,
        "shapes": batch_shapes,
        "device_ms": prof[0] if prof else None,
        "device_kernels": prof[1] if prof else None,
        "top_kernels": sorted(([k, t, c] for k, (t, c) in prof[2].items()),
                              key=lambda x: -x[1])[:12] if prof else None}

    # 6. the kernel at the main path's shapes
    clk_hz = max_sm_mhz * 1e6
    per_state_clk = max(mix["alu_pipe"] / ALU_PER_CLK,
                        mix["fma_pipe"] / FMA_PER_CLK,
                        mix["total"] / DISPATCH_PER_CLK)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    ops_ms_total = bytes_ms_total = 0.0
    for n, count in sorted(batch_shapes.items()):
        s = random_states(n, n)
        ms = cuda_ms(lambda: p2.poseidon2_permute(s), 20 if n < 10**5 else 5)
        plain = cuda_ms(lambda: p2.poseidon2_permute_plain(s),
                        3 if n < 10**5 else 1)
        ops_ms = n * per_state_clk / (sms * clk_hz) * 1e3
        bytes_ms = n * 12 * 2 * 8 * 2 / HBM_BYTES_PER_S * 1e3
        row = {"states": n, "launches": count, "ms": ms, "plain_ms": plain,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        rows.append(row)
        for k in tot:
            tot[k] += count * row[k]
        ops_ms_total += count * ops_ms
        bytes_ms_total += count * bytes_ms
    kernel_row = {
        "name": "poseidon2_permute_w12", "route": "cuda",
        "source": p2.KERNEL_SOURCE, "replaces": p2.REPLACES,
        "launches": launches_batch, "launches_single_proof": launches_single,
        "bit_equal": err == 0, "max_abs_err": float(err), "tolerance": 0,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "operations" if ops_ms_total >= bytes_ms_total else "bytes",
        "library_ms": None,
        "per_launch": rows,
    }
    report["kernels"] = [kernel_row]
    report["seconds"] = time.perf_counter() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": [kernel_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
