"""Run the port's multi-device paths on W devices of one host, one process
per device, and hold each to the single-device path it replaces.

    python3 scripts/multi_device_chip.py [--world W] [--device cuda|cpu]
                                         [--log-n N] [--batch B]
                                         [--report PATH]

W defaults to the host's CUDA device count.  The processes make an NCCL
group (gloo with --device cpu) at tcp://127.0.0.1:<free port> through
`parallel.init_distributed`, then, at FriConfig(1, 100, 16):

  sharded    ShardedVerifier of tests/fixtures/proof_fibonacci_refimpl.json
             over make_mesh(): verify_proof's verdict, alpha, zeta and
             query indices on every rank; query 99's quotient sibling ^4
             refused; latency beside verify_proof's;
  multihost  MultiHostBatchVerifier over make_batch_mesh(W / 2, 2) (1 x 1
             at W = 1) of B copies of the fixture proof, four lanes
             tampered: the verdicts of BatchVerifier on one device,
             queries/s of both;
  four-step  coset_ntt_four_step at 2^(N+1) (log_rows 3) over the mesh,
             equal to coset_ntt; ms of both;
  lde-mesh   TorchProver(lde_mesh=make_mesh()) of fib(2^N): the unmeshed
             proof's bytes; steady ms of both;
  batch-mesh BatchProver.prove(256 x fib(64), mesh=make_mesh()): every
             proof the fixture's bytes; ms beside the unmeshed batch.

Wall times are taken between barriers (the slowest rank's).  Rank 0
prints one line per phase and the card's name and power limit, and writes
the report (--report) as JSON.  Exits non-zero if any check fails.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chip_smoke import (  # noqa: E402
    TAMPERED,
    compact,
    ext_int,
    free_port,
    gl_equal,
    tamper,
    verdict,
)
from plonky25_torch.fields import gl  # noqa: E402
from plonky25_torch.models import FibonacciAir  # noqa: E402
from plonky25_torch.models.fibonacci import fibonacci_trace  # noqa: E402
from plonky25_torch.ops import ntt  # noqa: E402
from plonky25_torch.parallel import (  # noqa: E402
    BatchVerifier,
    MultiHostBatchVerifier,
    ShardedVerifier,
    init_distributed,
    make_batch_mesh,
    make_mesh,
    stack_witnesses,
)
from plonky25_torch.proof import (  # noqa: E402
    FriConfig,
    derive_config,
    load_proof,
)
from plonky25_torch.prover import BatchProver, TorchProver  # noqa: E402
from plonky25_torch.prover.prove import trace_columns  # noqa: E402
from plonky25_torch.verifier import verify_proof  # noqa: E402
from plonky25_torch.witness import pack_witness  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "proof_fibonacci_refimpl.json")
FC = FriConfig(log_blowup=1, num_queries=100, proof_of_work_bits=16)
P = 0xFFFFFFFF00000001


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def wall_ms(fn, device, runs=1):
    """(result of the last run, [ms of each run]), each run between
    barriers, so the slowest rank's time."""
    times, out = [], None
    for _ in range(runs):
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def rank_main(rank, world, address, device, log_n, batch, out_path):
    if device == "cpu":
        torch.set_num_threads(1)
    check(init_distributed(address, world, rank, device=device),
          "no process group")
    rep, lines = {"world": world, "device": device}, []

    def say(text):
        lines.append(text)

    try:
        fib = FibonacciAir()
        with open(FIXTURE) as f:
            fixture = f.read()
        proof = load_proof(FIXTURE)
        cfg = derive_config(proof, FC)
        mesh = make_mesh(device=device)

        # ---- sharded
        sv = ShardedVerifier(fib, cfg, mesh, device=device)
        plain = verify_proof(proof, fib, FC, device=device)
        r = sv.verify(proof)
        check(verdict(r) == verdict(plain) and verdict(r)["ok"]
              and ext_int(r.alpha) == ext_int(plain.alpha)
              and ext_int(r.zeta) == ext_int(plain.zeta)
              and r.query_indices.tolist()[:FC.num_queries]
              == plain.query_indices.tolist(),
              "sharded: differs from verify_proof")
        bad = copy.deepcopy(proof)
        bad.opening_proof.query_openings[99][1].opening_proof[0][0] ^= 4
        rt = verdict(sv.verify(bad))
        check(not rt["ok"] and not rt["merkle_ok"], f"sharded tamper: {rt}")
        _, t_sh = wall_ms(lambda: sv.verify(proof).ok.item(), device, 5)
        _, t_pl = wall_ms(
            lambda: verify_proof(proof, fib, FC, device=device).ok.item(),
            device, 5)
        rep["sharded"] = {"Q_pad": sv.Q_pad, "ms": t_sh,
                          "verify_proof_ms": t_pl}
        say(f"[sharded] world {world}, Q_pad {sv.Q_pad}: verify_proof's "
            f"verdict, alpha, zeta, indices; tamper refused; median "
            f"{statistics.median(t_sh):.1f} ms (verify_proof "
            f"{statistics.median(t_pl):.1f} ms)")

        # ---- multihost
        nq = 2 if world % 2 == 0 else 1
        hmesh = make_batch_mesh(world // nq, nq, device=device)
        w = pack_witness(proof, cfg, device)
        lanes = [3, batch // 3, 2 * batch // 3, batch - 1]
        tw = {lane: pack_witness(tamper(proof, kind), cfg, device)
              for lane, kind in zip(lanes, TAMPERED)}
        ws = stack_witnesses([tw.get(b, w) for b in range(batch)])
        want = torch.ones(batch, dtype=torch.bool, device=device)
        want[lanes] = False
        mv = MultiHostBatchVerifier(fib, cfg, hmesh, device=device)
        bv = BatchVerifier(fib, cfg, device=device)
        ok, t_mh = wall_ms(lambda: mv.verify_witnesses(ws), device, 3)
        check(torch.equal(ok, want), "multihost: verdicts differ")
        ok1, t_bv = wall_ms(lambda: bv.verify_witnesses(ws), device, 3)
        check(torch.equal(ok1, want), "BatchVerifier: verdicts differ")
        qps = [batch * FC.num_queries / (statistics.median(t) / 1e3)
               for t in (t_mh, t_bv)]
        rep["multihost"] = {"mesh": [mv.n_batch, mv.n_query], "B": batch,
                            "ms": t_mh, "batch_verifier_ms": t_bv,
                            "queries_per_s": qps[0],
                            "batch_verifier_queries_per_s": qps[1]}
        say(f"[multihost] ({mv.n_batch}, {mv.n_query}) mesh, B={batch} x "
            f"Q={FC.num_queries}: BatchVerifier's verdicts; {qps[0]:.0f} "
            f"queries/s (BatchVerifier on one device {qps[1]:.0f})")
        del ws, ok, ok1

        # ---- four-step
        rng = np.random.default_rng(0x4F5)
        n = 1 << (log_n + 1)
        coeffs = gl.from_u64(rng.integers(0, P, size=n, dtype=np.uint64),
                             device)
        ref, t_ref = wall_ms(lambda: ntt.coset_ntt(coeffs, 7), device, 5)
        got, t_fs = wall_ms(lambda: ntt.coset_ntt_four_step(
            coeffs, 7, log_rows=3, mesh=mesh), device, 5)
        check(gl_equal(got, ref), "four-step: differs from coset_ntt")
        rep["four_step"] = {"n": n, "ms": t_fs, "coset_ntt_ms": t_ref}
        say(f"[four-step] 2^{log_n + 1} over {world} ranks equal to "
            f"coset_ntt; median {statistics.median(t_fs):.2f} ms (coset_ntt "
            f"{statistics.median(t_ref):.2f} ms)")
        del coeffs, ref, got

        # ---- lde-mesh prover
        trace = np.asarray(fibonacci_trace(1 << log_n), dtype=np.uint64)
        single = TorchProver(fib, log_n, FC, device)
        meshed = TorchProver(fib, log_n, FC, device, lde_mesh=mesh)
        want_text = compact(single.prove(trace))
        got_text = compact(meshed.prove(trace))
        check(got_text == want_text, "lde-mesh: proof differs")
        _, t_m = wall_ms(lambda: meshed.prove(trace), device, 2)
        # staged, as the meshed prover runs (the unmeshed prover would
        # capture its stage programs at its second proof in a row)
        _, t_s = wall_ms(lambda: single.prove_columns(
            trace_columns([trace], device), fused=False), device, 2)
        rep["lde_mesh"] = {
            "log_n": log_n, "ms": t_m, "unmeshed_ms": t_s,
            "sha256": hashlib.sha256(got_text.encode()).hexdigest()}
        say(f"[lde-mesh] fib(2^{log_n}) meshed over {world} ranks: the "
            f"unmeshed proof's bytes; median {statistics.median(t_m):.1f} ms"
            f" (unmeshed {statistics.median(t_s):.1f} ms)")
        del trace

        # ---- meshed batch prover
        b_prove = 256 if device == "cuda" else 2 * world
        traces = np.asarray([fibonacci_trace(64)] * b_prove, dtype=np.uint64)
        bp = BatchProver(fib, 6, FC, device=device)
        proofs, t_bm = wall_ms(lambda: bp.prove(traces, mesh=mesh), device, 2)
        check(len(proofs) == b_prove
              and all(compact(p) == fixture for p in proofs),
              "batch-mesh: a proof differs from the fixture")
        _, t_b1 = wall_ms(lambda: bp.prove(traces, fused=False), device, 2)
        rep["batch_mesh"] = {"B": b_prove, "ms": t_bm, "unmeshed_ms": t_b1}
        say(f"[batch-mesh] {b_prove} x fib(64) over {world} ranks: every "
            f"proof the fixture's; median {statistics.median(t_bm):.1f} ms "
            f"(one device {statistics.median(t_b1):.1f} ms)")
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for line in lines:
            print(line, flush=True)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(rep, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("multi_device_chip: no CUDA device", file=sys.stderr)
            return 2
        from plonky25_torch.ops import build

        build.build_many(["poseidon2", "poseidon2_soa"])   # once, not per rank
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    world = args.world or (torch.cuda.device_count() if args.device == "cuda"
                           else 2)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
    torch.multiprocessing.spawn(
        rank_main, args=(world, f"127.0.0.1:{free_port()}", args.device,
                         args.log_n, args.batch, args.report),
        nprocs=world, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
