"""Rank functions of the port's multi-process tests on the CPU.

tests/test_torch_parallel.py and tests/test_torch_four_step.py start W
processes with torch.multiprocessing (gloo, one PyTorch thread each), and
every child imports this module to find its rank function.  It imports
the port only: a child that imported the test module would import
plonky25_tpu, and with it JAX.  pytest does not collect it (no test_
prefix).

`spawn(scenario, world, tmp)` runs SCENARIOS[scenario](rank, world) on
every rank, after `parallel.init_distributed` has made a gloo group from a
file store under tmp, and returns each rank's JSON-able result in rank
order.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import random

import numpy as np
import torch
import torch.distributed as dist

from plonky25_torch.fields import gl
from plonky25_torch.models import FibonacciAir
from plonky25_torch.models.fibonacci import fibonacci_trace
from plonky25_torch.ops import ntt
from plonky25_torch.parallel import (
    BatchVerifier,
    MultiHostBatchVerifier,
    ShardedVerifier,
    init_distributed,
    make_batch_mesh,
    make_host_mesh,
    make_mesh,
    verify_proof_batch_multihost,
    verify_proof_sharded,
)
from plonky25_torch.proof import (
    FriConfig,
    derive_config,
    load_proof,
    proof_to_json,
)
from plonky25_torch.prover import BatchProver, TorchProver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "proof_fibonacci_refimpl.json")
FC = FriConfig(log_blowup=1, num_queries=100, proof_of_work_bits=16)
# the meshed provers' config: a 256-witness grind window keeps a CPU proof
# to a few seconds (a fib(64) proof at FC grinds two windows of 2^16)
FC_PROVE = FriConfig(log_blowup=1, num_queries=20, proof_of_work_bits=4)
P = 0xFFFFFFFF00000001
DEV = "cpu"


def compact(proof) -> str:
    return json.dumps(proof_to_json(proof), separators=(",", ":"))


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def ints(x) -> list:
    return [int(v) for v in np.asarray(gl.to_u64(x), dtype=object).reshape(-1)]


def sharded_tamper(proof):
    """tests/test_sharded.py's tamper: query 99's quotient-batch sibling."""
    p = copy.deepcopy(proof)
    p.opening_proof.query_openings[99][1].opening_proof[0][0] ^= 4
    return p


def multihost_tamper(proof):
    """tests/test_multihost.py's tamper: query 7's trace-batch sibling."""
    p = copy.deepcopy(proof)
    p.opening_proof.query_openings[7][0].opening_proof[2][1] ^= 1
    return p


def batch_traces():
    """The B=4 fib(64) traces of the meshed BatchProver case: lanes 0 and 2
    the fixture's trace, lanes 1 and 3 with one value changed each
    (scripts/make_torch_fixtures.py's `parallel` group proves the same)."""
    t = np.asarray([fibonacci_trace(64)] * 4, dtype=np.uint64)
    t[1, 10, 1] = (int(t[1, 10, 1]) + 1) % P
    t[3, 41, 0] = (int(t[3, 41, 0]) + 5) % P
    return t


def four_step_inputs():
    """tests/test_ntt.py's four-step inputs: (8, 64) seed 12, and 256
    coefficients seed 99."""
    rng = random.Random(12)
    x = [rng.randrange(P) for _ in range(8 * 64)]
    rng = random.Random(99)
    c = [rng.randrange(P) for _ in range(256)]
    return x, c


def _verdict(r) -> dict:
    out = {k: bool(getattr(r, k)) for k in
           ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok")}
    out["shape_ok"] = bool(r.shape_ok)
    if r.shape_ok:
        out["alpha"] = [ints(r.alpha.c0)[0], ints(r.alpha.c1)[0]]
        out["zeta"] = [ints(r.zeta.c0)[0], ints(r.zeta.c1)[0]]
        out["query_indices"] = r.query_indices.tolist()
    return out


def sharded(rank, world):
    """ShardedVerifier over make_mesh(): Q_pad and this rank's slice, the
    fixture accepted, the tamper and a proof short of a query refused."""
    proof = load_proof(FIXTURE)
    cfg = derive_config(proof, FC)
    sv = ShardedVerifier(FibonacciAir(), cfg, make_mesh(device=DEV),
                         device=DEV)
    short = copy.deepcopy(proof)
    short.opening_proof.query_openings.pop()
    return {
        "Q_pad": sv.Q_pad, "n_dev": sv.n_dev,
        "plan": [sv.plan.start, sv.plan.stop],
        "accept": _verdict(sv.verify(proof)),
        "tamper": _verdict(sv.verify(sharded_tamper(proof))),
        "short": _verdict(sv.verify(short)),
    }


def provers(rank, world):
    """TorchProver(lde_mesh=) of fib(64) and BatchProver.prove(mesh=) of
    batch_traces() at FC_PROVE: the proofs' sha256."""
    mesh = make_mesh(device=DEV)
    p = TorchProver(FibonacciAir(), 6, FC_PROVE, device=DEV,
                    lde_mesh=mesh).prove(fibonacci_trace(64))
    batch = BatchProver(FibonacciAir(), 6, FC_PROVE, device=DEV).prove(
        batch_traces(), mesh=mesh)
    return {"lde_mesh": sha(compact(p)),
            "batch_mesh": [sha(compact(q)) for q in batch]}


def sharded_provers(rank, world):
    """`sharded`, verify_proof_sharded on the default mesh, and
    `provers`."""
    out = sharded(rank, world)
    out["one_call"] = _verdict(verify_proof_sharded(
        load_proof(FIXTURE), FibonacciAir(), FC, device=DEV))
    out.update(provers(rank, world))
    return out


def multihost(rank, world):
    """MultiHostBatchVerifier at (b=2, q=2) on [fixture, tamper, fixture,
    fixture]; BatchVerifier on the same lanes (rank 1); make_host_mesh's
    errors and default shape; the batch-size assertion."""
    proof = load_proof(FIXTURE)
    cfg = derive_config(proof, FC)
    proofs = [proof, multihost_tamper(proof), proof, proof]
    mesh = make_batch_mesh(2, 2, device=DEV)
    mv = MultiHostBatchVerifier(FibonacciAir(), cfg, mesh, device=DEV)
    ok, all_ok = mv.verify(proofs)
    host = make_host_mesh(n_query=2, device=DEV)
    ok2, all2 = verify_proof_batch_multihost(proofs[:2], FibonacciAir(), FC,
                                             host, device=DEV)
    errors = {}
    for n_query in (0, 3, 5):
        try:
            make_host_mesh(n_query=n_query, device=DEV)
        except ValueError as e:
            errors[str(n_query)] = str(e)
    try:
        mv.verify(proofs[:3])
    except AssertionError as e:
        errors["batch_3"] = str(e)
    out = {
        "shape": [mv.n_batch, mv.n_query, mv.Q_pad],
        "coords": [mv.b_rank, mv.q_rank],
        "ok": ok.tolist(), "all_ok": bool(all_ok),
        "host_mesh": [ok2.tolist(), bool(all2)],
        "default_host_mesh": list(make_host_mesh(device=DEV).mesh.shape),
        "errors": errors,
    }
    if rank == 1:
        out["batch_verifier"] = BatchVerifier(
            FibonacciAir(), cfg, device=DEV).verify(proofs).tolist()
    return out


def four_step(rank, world):
    """coset_ntt_four_step with its rows over make_mesh() at 256 (seed 99)
    and at the (8, 64) vector of seed 12, the batched (3, 2, 256) case,
    and the local result beside each; log_rows 3 and 2."""
    mesh = make_mesh(device=DEV)
    x, c = four_step_inputs()
    coeffs = gl.from_u64(c, DEV)
    vec = gl.from_u64(x, DEV)
    rng = np.random.default_rng(5)
    batch = gl.from_u64(rng.integers(0, P, size=(3, 2, 256), dtype=np.uint64),
                        DEV)
    out = {}
    for log_rows in (2, 3):
        out[f"coset_256_r{log_rows}"] = ints(ntt.coset_ntt_four_step(
            coeffs, 7, log_rows=log_rows, mesh=mesh, axis="q"))
    out["coset_512"] = ints(ntt.coset_ntt_four_step(vec, 1, mesh=mesh))
    out["batched_equal"] = ints(ntt.coset_ntt_four_step(
        batch, 7, mesh=mesh)) == ints(ntt.coset_ntt(batch, 7))
    try:
        ntt.coset_ntt_four_step(gl.from_u64(c[:4], DEV), 7, log_rows=0,
                                mesh=mesh)
        out["too_small"] = None
    except ValueError as e:
        out["too_small"] = str(e)
    return out


SCENARIOS = {"sharded": sharded, "sharded_provers": sharded_provers,
             "multihost": multihost, "four_step": four_step}


def _run(rank, world, tmp, scenario):
    torch.set_num_threads(1)
    assert init_distributed(f"file://{tmp}/store_{scenario}", world, rank,
                            device="cpu")
    try:
        out = SCENARIOS[scenario](rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{scenario}.{rank}.json"), "w") as f:
        json.dump(out, f)


def spawn(scenario: str, world: int, tmp) -> list:
    """Run `scenario` on `world` gloo ranks; their results in rank order."""
    tmp = str(tmp)
    torch.multiprocessing.spawn(_run, args=(world, tmp, scenario),
                                nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{scenario}.{r}.json")) as f:
            out.append(json.load(f))
    return out
