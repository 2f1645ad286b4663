"""Run the PyTorch port (plonky25_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--report PATH]

Phases, one line each; any failure exits non-zero:
  [card]        the card's name and power limit (nvidia-smi);
  [build]       both kernels, csrc/poseidon2.cu (state-major) and
                csrc/poseidon2_soa.cu (lane-major), and the field kernels'
                csrc/goldilocks.cu, built for sm_90a from this checkout's
                sources, one nvcc each, started together;
                registers, spills and SASS instruction mix of each
                __global__ (one thread per state, and split: three);
  [field]       the field kernels, csrc/goldilocks.cu (Goldilocks and
                GF(p^2) add, sub, mul, and GF(p^2) times GF(p)), each
                alone at FIELD_N elements: bit-equal to its plain version
                (the limb chain, gl.*_limbs / gl2.*_limbs) on the card, ms
                per launch (CUDA events) against that chain's ms and the
                bytes bound (limbs read and written once, at 3.35 TB/s),
                and ms per launch of one element; then the main paths at
                the benchmark's shapes (a Keccak 2^14 proof, its quotient
                and fold; BatchVerifier on 256 of its proofs and on 2,048
                fib fixture proofs), each staged, captured and replayed
                under observe_launches: every distinct layout (op, operand
                shapes and strides) bit-equal to its limb chain on the same
                card tensors, field.*.launches and .elements counted equal
                to the launches observed in the staged runs, a replay's
                launches the warm staged run's (the first call also builds
                the cached tables) (`--phases field` runs [card], [build]
                and this phase alone);
  [kernel]      the state-major kernel against its plain PyTorch version,
                bit for bit, each variant and the launcher's choice: N = 1,
                255, 257, 1,048,579 and both sides of the crossover,
                edge-value states, the fixture's known answers, every state
                count it launches;
  [single]      `verify_proof` of the fixture proof: the transcript values
                of tests/fixtures/proof_fibonacci_expected.json, the tamper
                battery, the launch count, the latency (verify_proof takes
                the fused program on the card: its first call captures the
                graph);
  [fused]       the fused verification (`verify(fused=True)`, one CUDA
                graph) against the staged one (`fused=False`) on the
                fixture proof: flags, alpha, zeta, query indices and
                `_verify_all_fn`'s samples equal, and equal to the fixture;
                golden, the tamper battery, golden through one program (the
                staged verdicts, a held result unchanged); two instances of
                a FibonacciAir with a public first-row value through one
                cached verifier; launches per replay held to the shape;
                capture, instantiation and first-replay ms, the pool's
                bytes, wall ms fused and staged in turns (median of 5),
                one replay's device time;
  [batch]       `BatchVerifier` at B=2048 proofs x Q=100 queries: exact
                verdicts; its first three batches as a caller makes them
                (the first staged, the second capturing the five stage
                programs as CUDA graphs, the third replaying them), each
                one's wall ms, verdicts and samples equal; then programs
                and staged path in turns, ms per batch of each, queries/s,
                the phase's peak memory, ms per stage (CUDA events), device
                time of each (torch.profiler), each program's capture ms
                and pool;
  [kernel-soa]  the lane-major kernel, each variant, against its plain
                version and the state-major kernel, at the same sizes, both
                sides of its crossover and every state count the prover
                paths launch;
  [prove-64]    `prove` of fib(64) at FriConfig(1, 100, 16): byte-equal to
                tests/fixtures/proof_fibonacci_refimpl.json, launch counts;
  [prove-8192]  fib(2^13), whose LDE crosses the JAX package's six-step
                threshold: digest and transcript values equal to
                tests/fixtures/proof_fibonacci8192_expected.json;
  [prove]       fib(2^20) at FriConfig(1, 100, 16): accepted by the port's
                `verify_proof`, a flipped Merkle sibling rejected; the
                signature's first three proofs (staged, capturing the
                prover's stage programs, replaying them: `TorchProver.plan`)
                byte-equal, launches of each held to the path's shape, each
                program's warm-up, capture, instantiation and first-replay
                ms and pool; replays against staged proofs in turns (ms,
                stage ms, peak allocated and reserved memory, device time
                and busy share of each); then a fresh prover of that shape:
                `warmup()` (its capture) and its first proof, a replay,
                byte-equal; the card's reserved memory back within 0.5 GiB
                once that prover is dropped;
  [batch-prove] `BatchProver` on B=256 copies of fib(64), one lane's trace
                tampered: valid lanes byte-equal to the fixture, the tampered
                lane rejected by its quotient check; the first three
                batches and the turns as in [prove]; `warmup(256)` (its
                capture) and the first batch after it, a replay;
  [mmcs-multi]  the multi-height MMCS `verify_batch` on
                tests/fixtures/mmcs_multi_height.json (heights 2^12, 2^12,
                2^6, 2^3, 1; 100 openings): all accepted, a flipped sibling
                below each fold-in and a changed row of each short group
                rejected, verdicts equal to the plain path on the CPU;
  [prove-rlc-64], [prove-multiset-64]  the multi-stage AIRs on the seeded
                64-row traces of tests/fixtures/proof_{rlc,multiset}64_
                expected.json: digest, commitments, challenges, alpha,
                zeta, PoW witness and query indices equal to the JAX
                package's; accepted by `verify_proof`, fused and staged
                alike (the fused program's capture ms and pool bytes);
  [batch-rlc]   `BatchVerifier` at B=2048 x Q=100 on copies of the RLC
                proof (three Merkle batches per query), five lanes tampered
                (pow, Merkle sibling, fold sibling, final poly, stage-2
                leaf): exact verdicts, the stage programs against the
                staged path as in [batch]; queries/s, stage ms, peak
                memory, device time;
  [prove-rlc]   RlcAir at 2^20 rows: accepted; a flipped stage-2 sibling, a
                changed stage2_local value and a changed stage-2 commitment
                rejected; the first three proofs and the turns as in [prove]
                (stage2 its own stage; no device time);
  [prove-multiset]  MultisetAir at 2^20 pairs (two quotient chunks):
                accepted; side B with one value changed proves (through the
                held programs) and is rejected by its quotient check alone;
                the same measurements;
  [batch-prove-rlc]  `BatchProver` on 256 distinct 64-row RLC traces, lane
                0 the fixture's (its digest), one lane's stage-2 column
                changed at a row by a prover faulty on that lane: all 256
                through one `BatchVerifier` call, the faulty lane rejected
                by its quotient check alone; proofs/s staged, peak memory;
  [keccak-f]    ops/keccak.py's keccak-f[1600] (PyTorch ops) at 2^16 states
                against refimpl.keccak_f_flat on a sample and the zero-state
                known answer; ms per call;
  [prove-keccak-32]  KeccakAir's one-keccak-f trace (32 rows x 2,633
                columns, FriConfig(1, 20, 8)): byte-equal to
                tests/fixtures/proof_keccak32_refimpl.json, accepted by
                `verify_proof` with the fixture's transcript, the a_prime-bit
                tamper rejected with the JAX verifier's flags, a changed
                trace-leaf value rejected by the Merkle check; fused and
                staged verification alike (capture ms, pool bytes); launch
                counts;
  [prove-keccak]  KeccakAir at 2^12 rows x 2,633 columns (the fixture's 170
                seeded permutations), FriConfig(1, 100, 16): digest, commitments,
                alpha, zeta, PoW witness and query indices equal to
                tests/fixtures/proof_keccak_expected.json (the JAX device
                prover's); the first three proofs and the turns as in
                [prove], keccak-f/s;
  [verify-keccak]  `verify_proof` of that proof: fused and staged alike
                (capture ms, pool bytes), launches (659 sponge chunks per
                trace leaf), latency median of 5;
  [batch-keccak]  `BatchVerifier` at B=256 copies of that proof x Q=100,
                four lanes tampered: exact verdicts, the first three
                batches and the stage programs against the staged path as
                in [batch]; the card's reserved memory back to its level
                before the phase once its BatchVerifier is dropped;
                queries/s, stage ms, peak memory;
  [prove-keccak-chunked]  that 2^12 x 2,633 trace proved with every memory
                strategy of the prover at once (S=4 quotient segments, 4
                column groups, 4 LDE column chunks, both column slabs at
                256 of the 2,633 columns): equal to the JAX digest; peak
                memory beside the unchunked one, and the unchunked peak at
                B=2;
  [batch-prove-keccak]  `BatchProver` at B=8 x 2^12 x 2,633 (BASELINE.md
                config 4) at S=4 with the default groups and slabs: the
                fixture's trace and 7 of seeded inputs; the fixture lane
                equal to the JAX digest, another byte-equal to the port's
                single proof of its trace, all 8 accepted by one
                `BatchVerifier` call beside a tampered copy, which is
                rejected; the first three batches and one turn each as in
                [prove] (the staged turn with the programs dropped),
                keccak-f/s, launches and states; the card's
                reserved memory back within 0.5 GiB of its level before
                the phase once the programs are dropped (these three Keccak
                phases, [prove-keccak], [prove-rlc] and [prove-multiset]
                are not profiled: UNPROFILED);
  [gl3]         GF(p^3) mul, inv and div (fields/extension3.py) on the card
                against the int Gl3 on a seeded sample;
  [gamma-programs]  the gamma sponge's chunk programs (GAMMA_CHUNK steps
                of the 5 chains as one CUDA graph; `_chain_chunk_fn`,
                `_chain_states_fn`) against the eager chain on
                compose-small's pair stream (45,568 steps): digests, and
                the states program's ins and outs over two chunks, equal;
                launches per derivation; wall ms of each in turns, device
                time of 8 chunks each way, capture ms and pools; it
                captures both programs, so the later phases replay them;
  [attest-golden]  `attest` of the fib(64) fixture proof at FriConfig(1,
                100, 16): the sample-recording verification, the 13,477-row
                schedule, the gammas (5 sponge chains of 15,104 steps), the
                trace and the 2^14 x 620 VerifierAir STARK; the bundle
                byte-equal to artifacts/attestation_fibonacci.json (made by
                the JAX package); ms, launches and states per step, each
                held to its shape; peak memory;
  [check-golden]  `check_attestation` of that committed bundle with the
                port's verifier: accepted; a flipped sample, the statement
                stripped, gamma + 1, a changed opening of the STARK and
                num_queries = 0 refused;
  [attest-small]  `attest` and `attest_many` of
                artifacts/attestation_small.json's proofs: byte-equal to
                its `bundle` and `multi`, both accepted;
  [attest-many]  `attest_many` of 4 copies of the golden proof (batched
                sample recording, 53,908 rows, a 2^16 x 620 STARK): every
                proof's samples the golden bundle's, `check_attestations`
                accepts, one proof's flipped sample refused; the same
                measurements (these three phases are not profiled:
                UNPROFILED);
  [compose-small]  `attest_composed` of artifacts/attestation_small.json's
                fib(8) proof with its `bundle` as the inner attestation,
                FriConfig(1, 2, 1) both: 39,463 rows, a 2^16 x 620 outer
                STARK whose recorded samples, gammas, accumulator and
                statement equal the JAX package's
                (tests/fixtures/composed_expected.json); accepted by the int
                oracle and by `check_composed` with and without the target
                proof; refused: tests/test_composed.py's seven tampers (its
                inner sample 2 only with the target: without it that value
                is unbound, in the JAX package too, and accepted; a changed
                query-index sample refused), a changed opening of the outer
                STARK, the fib(16) proof as the target;
  [attest-attestation]  `attest_attestation` of that bundle: 38,171 rows,
                2^16, equal to the JAX values (its STARK repeats
                compose-small's signature and proves staged, as every
                attestation's STARK does); `check_attested_attestation`
                accepts it and refuses an inner acc + 1 and the fib(16)
                proof as the target;
  [compose-golden]  `attest_composed` of the fib(64) fixture proof with
                artifacts/attestation_fibonacci.json as the inner
                attestation: 403,335 rows, a 2^19 x 620 outer STARK (the
                quotient in prove_on_device's segments), equal to the JAX
                values (its gammas through the chunk programs); ms,
                launches, states and peak memory per step;
  [check-composed-golden]  `check_composed` of it without the target's
                bytes: accepted; the statement stripped and a trace width
                of 99 refused with no launch; ms, launches and peak per
                step;
  [nccl]        `parallel.init_distributed` at tcp://127.0.0.1:<free port>
                makes a world-size-1 NCCL process group; make_mesh ("q")
                and make_host_mesh (("b", "q") = (1, 1)) over it; the
                group is destroyed after the next five phases;
  [sharded]     `ShardedVerifier` of the fixture proof (Q_pad 100): its
                verdict, alpha, zeta and 100 query indices equal
                verify_proof's in the same run, one all_reduce of the
                flags, launches as verify_proof's; the JAX tamper (query
                99's quotient sibling ^4) refused; latency beside
                verify_proof's;
  [multihost]   `MultiHostBatchVerifier` at (b=1, q=1) on [batch]'s
                stacked witness (B=2048 x Q=100): [batch]'s verdicts, one
                all_reduce and one all_gather, queries/s in turns with
                `BatchVerifier` on the same witness, peak memory; the
                JAX 4-proof list (query 7's trace sibling ^1 on proof 1):
                [True, False, True, True], all_ok False;
  [four-step]   `coset_ntt_four_step` at 2^21 (log_rows 3) over the mesh
                (two all_to_all_single and one all_gather) and without it
                equal to `coset_ntt`; `ntt_four_step` at (8, 2^18) equal to
                `ntt`, forward and inverse; ms per call of each;
  [prove-lde-mesh]  `TorchProver(lde_mesh=make_mesh())`: fib(64)
                byte-equal to the fixture; fib(2^20) equal to [prove]'s
                unmeshed proof (its sha256); first and steady latency (in
                turns with the unmeshed prover), stage ms, launches, peak
                memory;
  [batch-prove-mesh]  `BatchProver.prove(256 x fib(64), mesh=)`: every
                proof byte-equal to the fixture, one all_gather_object
                (its host ms); proofs/s beside an unmeshed batch in turns,
                launches, peak memory;
  [graphs]      every program the run captured that the module caches
                hold (the fused verification per verifier shape, the chunk
                programs; a BatchVerifier's stage programs are in its
                phase's line): warm-up, capture and instantiation ms, pool
                bytes;
  [timing]      each kernel at each path's state counts against its bound
                and its plain version (the plain version timed once per
                state count); both kernels, each variant, at
                N = 1, 2,048, 32,768 and 2^21 and across the crossover
                (CUDA events, and the kernel's device time alone);
  [tooling]     plonky25_torch/utils/profiling.py and utils/roofline.py:
                StageTimer and StageClock around one verification of the
                fixture (its stages through `on_stage`); measure_throughput
                of [batch]'s B=2048 x Q=100 BatchVerifier beside [batch]'s
                queries/s; `trace` of one batch (the file written, the
                state-major kernel found in it by name, or "not measured"
                where the profiler saw no kernels); `count_int_ops` of
                `poseidon2_permute` at 2^10 states and of `coset_ntt` at
                2^12 x 4 columns, equal on the CPU and the card;
                `mfu_report` of both kernels at 2^21 states (each share at
                most 1.0, the roofline share equal to bound_ms / ms);
then the kernel table line {"kernels": [...]} (launches and times of
MAIN_PATH, compose_golden, with every path's beside them) and the last
line {"ok": true, "device": {...}}.  Every path is driven inside
`counted` (a fresh table of launch and state counts, the field kernels'
launches beside them) and the Poseidon2 counts are held to the numbers the
path's shape gives, states too: a single
verification's first call through a verifier launches its kernels twice
(the eager warm-up before the graph's capture, then the replay;
verify_runs), later calls once per replay; so does a chunk program's first
chunk, and a BatchVerifier's second batch of a signature, which captures
its programs (its first batch is staged: one run).  The multi-device
phases run at world size 1 on the one card the script uses: their
collectives, padding and per-rank slicing all run, but nothing is divided
(the CPU tests divide over 2-4 gloo ranks).

With --report, the full measurements also go to PATH as JSON.  The script
imports nothing of JAX or plonky25_tpu; it needs the repository beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import plonky25_torch.attest as attest_mod  # noqa: E402
import plonky25_torch.attest_program as attp  # noqa: E402
import plonky25_torch.verifier as verifier_mod  # noqa: E402
from plonky25_torch.challenger import SymbolicChallenger  # noqa: E402
from plonky25_torch.constants import EXT_DEGREE, RATE  # noqa: E402
from plonky25_torch.fields import gl, gl2  # noqa: E402
from plonky25_torch.models import (  # noqa: E402
    FibonacciAir,
    KeccakAir,
    MultisetAir,
    RlcAir,
    keccak_trace_np,
)
from plonky25_torch.models.fibonacci import fibonacci_trace  # noqa: E402
from plonky25_torch.models.verifier_air import VerifierAir  # noqa: E402
from plonky25_torch.ops import keccak as keccak_ops  # noqa: E402
from plonky25_torch.ops import ntt as ntt_ops  # noqa: E402
from plonky25_torch.ops import build  # noqa: E402
from plonky25_torch.ops import goldilocks as field_kernels  # noqa: E402
from plonky25_torch.ops import poseidon2 as p2  # noqa: E402
from plonky25_torch.parallel import (  # noqa: E402
    MultiHostBatchVerifier,
    ShardedVerifier,
    init_distributed,
    make_host_mesh,
    make_mesh,
)
from plonky25_torch.parallel.batch import (  # noqa: E402
    BatchVerifier,
    stack_witnesses,
)
from plonky25_torch.ops.sponge import verify_batch as mmcs_verify_batch  # noqa: E402
from plonky25_torch.proof import (  # noqa: E402
    FriConfig,
    P3Config,
    derive_config,
    load_proof,
    proof_from_json,
    proof_to_json,
)
from plonky25_torch.fields import gl3  # noqa: E402
from plonky25_torch.fields.goldilocks import GL  # noqa: E402
from plonky25_torch.prover import BatchProver, TorchProver, prove  # noqa: E402
from plonky25_torch.prover.prove import (  # noqa: E402
    get_prover,
    grind_window,
    quotient_eval_chunks_for,
    trace_columns,
)
from plonky25_torch.refimpl.field import Gl3  # noqa: E402
from plonky25_torch.refimpl.keccak import keccak_f_flat  # noqa: E402
from plonky25_torch.refimpl.verifier import verify as refimpl_verify  # noqa: E402
from plonky25_torch.utils.bits import log2_ceil  # noqa: E402
from plonky25_torch.utils.profiling import (  # noqa: E402
    AOS,
    SOA,
    StageClock,
    StageTimer,
    StepClock,
    cuda_ms,
    device_summary,
    field_launches,
    kernel_device_ms,
    launch_counts,
    measure_throughput,
    once_ms,
    profile_device_time,
    recording,
    trace,
)
from plonky25_torch.utils.roofline import (  # noqa: E402
    HBM_BYTES_PER_S,
    P2_BYTES_PER_STATE,
    P2_OPS,
    OpCount,
    clocks_per_state,
    count_int_ops,
    int_peak,
    mfu_report,
    poseidon2_bound_ms,
)
from plonky25_torch.utils.tree import tree_map  # noqa: E402
from plonky25_torch.verifier import (  # noqa: E402
    _publics,
    get_verifier,
    verify_proof,
)
from plonky25_torch.witness import pack_witness  # noqa: E402

# the module (the package exports its `prove` function under that name)
prove_mod = importlib.import_module("plonky25_torch.prover.prove")
P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
DEVICE = "cuda"
B = 2048
B_PROVE = 256
LOG_N = 20
KECCAK_LOG_N = 12       # BASELINE.md config 4: 2^12 x 2,633 traces
B_KECCAK = 256
B_KECCAK_PROVE = 8      # BASELINE.md config 4's batch (bench.py:146-154)
S_KECCAK = 4            # its quotient_eval_chunks
TAMPERED = ("pow", "merkle_sibling", "fold_sibling", "final_poly")
B_ATTEST = 4            # attest_many of the golden proof: 53,908 rows, 2^16
MAIN_PATH = "compose_golden"  # the kernel line's launches and times
# [prove-rlc], [prove-multiset], [prove-keccak], [verify-keccak],
# [batch-keccak] and [batch-prove-keccak] run without their profiled run
# (profiling costs about 0.23 ms per kernel, scripts/profiler_cost.py; the
# three provers launch 115k-133k kernels each), which keeps the script well
# inside its time limit beside the attestation and multi-device phases;
# PERF.md keeps their earlier device times
UNPROFILED = "device time not profiled in this phase (PERF.md)"
ARTIFACTS = os.path.join(ROOT, "artifacts")
# ALU-pipe SASS instructions per state of the first kernels, one thread
# per state, every operation corrected to its canonical value (PERF.md,
# the first kernels' build on the card): printed beside this build's counts.
FIRST_SASS_ALU = {AOS: 26_934, SOA: 27_171}
SMALL_N = (1, 2048, 32768)            # latency-bound launches
FIELD_N = 1 << 24                     # [field]: elements a launch
# [field]: op -> (the dispatching function, its plain version, operand kinds)
FIELD_OPS = {
    "gl_add": (gl.add, gl.add_limbs, "gl", "gl"),
    "gl_sub": (gl.sub, gl.sub_limbs, "gl", "gl"),
    "gl_mul": (gl.mul, gl.mul_limbs, "gl", "gl"),
    "gl2_add": (gl2.add, gl2.add_limbs, "gl2", "gl2"),
    "gl2_sub": (gl2.sub, gl2.sub_limbs, "gl2", "gl2"),
    "gl2_mul": (gl2.mul, gl2.mul_limbs, "gl2", "gl2"),
    "gl2_mul_base": (gl2.mul_base, gl2.mul_base_limbs, "gl2", "gl"),
}
CROSSOVER_N = (8192, 16384, 24576, 32768, 40960, 49152, 65536)
# [field] main paths: the Keccak proof's height and the batches, as the
# benchmark's cells have them (p3bench/configs, p3bench/traffic)
FIELD_LOG_N = 14
FIELD_B = {"keccak": 256, "fib": 2048}
FIELD = "field"         # the field kernels' launches in counted()'s dict


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


# ------------------------------------------------------------ build

def variant_of(function):
    """"split" or "whole" for a kernel's mangled __global__ name."""
    return "split" if "split_kernel" in function else "whole"


def sass_mixes(path):
    """{variant: per-thread instruction counts by pipe} of each __global__
    of the library, from its SASS.  Every kernel is straight-line code
    (every round unrolled), so the static count is what one thread
    executes; a split thread runs a third of a state."""
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    mixes = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)",
            chunk))
        ops.pop("NOP", None)
        fma = sum(v for k, v in ops.items()
                  if k.startswith(("IMAD", "IMUL", "VIADD")))
        uniform = sum(v for k, v in ops.items() if k.startswith("U"))
        other = sum(v for k, v in ops.items() if k.startswith(
            ("LD", "ST", "S2R", "S2UR", "EXIT", "BRA", "CS2R")))
        total = sum(ops.values())
        mixes[variant_of(chunk.split("\n", 1)[0])] = {
            "total": total, "fma_pipe": fma, "uniform": uniform,
            "memory_control": other,
            "alu_pipe": total - fma - uniform - other,
            "by_opcode": dict(ops.most_common())}
    return mixes


def ptxas_functions(log):
    """{__global__ (its mangled name): (registers, bytes spilled)} from
    nvcc's -Xptxas -v log."""
    out = {}
    for part in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores", part)
        line = part.split("\n", 1)[0]
        out[line.split("'")[1] if "'" in line else line.strip()] = (
            int(regs.group(1)) if regs else None,
            int(spills.group(1)) if spills else None)
    return out


def ptxas_report(log):
    """{variant: (registers, bytes spilled)} from nvcc's -Xptxas -v log."""
    return {variant_of(name): v for name, v in ptxas_functions(log).items()}


# ------------------------------------------------------------ kernels

def random_states(n, seed, lane_major=False):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, P, size=(n, 12), dtype=np.uint64)
    return gl.from_u64(s.T.copy() if lane_major else s, DEVICE)


def edge_states():
    edge = [0, 1, P - 1, 1 << 32, 0xFFFFFFFF, (0xFFFFFFFF << 32) % P,
            P - (1 << 32)]
    rows = [[edge[(i * k + j) % len(edge)] for i in range(12)]
            for k in range(1, 8) for j in range(len(edge))]
    rows += [[e] * 12 for e in edge]
    return gl.from_u64(np.asarray(rows, dtype=np.uint64), DEVICE)


def max_err(a, b):
    """Max |a - b| over both limbs (0 when bit-equal)."""
    torch.cuda.synchronize()
    return max(int((a.lo - b.lo).abs().max()), int((a.hi - b.hi).abs().max()))


def transposed(x):
    return gl.GL(x.lo.T.contiguous(), x.hi.T.contiguous())


VARIANTS = (None, False, True)   # the launcher's choice, whole, split


def aos_vs_plain(states):
    """Max error of the state-major kernel, each variant and the
    launcher's choice, against its plain version."""
    want = p2.poseidon2_permute_plain(states)
    return max(max_err(p2.poseidon2_permute(states) if v is None else
                       p2._poseidon2_permute_variant(states, v), want)
               for v in VARIANTS)


def soa_vs_plain_and_aos(planes):
    """Max error of the lane-major kernel, each variant and the launcher's
    choice, against its plain version and against the state-major kernel
    on the same states."""
    want = p2.poseidon2_permute_soa_plain(planes)
    aos = transposed(p2.poseidon2_permute(transposed(planes)))
    err = 0
    for v in VARIANTS:
        out = (p2.poseidon2_permute_soa(planes) if v is None else
               p2._poseidon2_permute_soa_variant(planes, v))
        err = max(err, max_err(out, want), max_err(out, aos))
    return err


def verify_path_shapes(v, b):
    """{states per launch: launches} of the state-major kernel in one
    verification of b proofs: the transcript's duplex steps, the Merkle
    walks over the trace, [stage-2] and quotient batches (fused, a leaf
    hash and one compression per level, when every batch's row fits one
    sponge chunk; otherwise each batch alone, a launch per sponge chunk of
    its row and one per level: 659 chunks for a KeccakAir row), the fold's
    leaf hash and its walk."""
    widths = [v.config.trace_width] + ([v.s2w] if v.s2w else []) + [
        v.quotient_degree * EXT_DEGREE]
    shapes = Counter()
    shapes[b] += v.n_steps
    if max(widths) <= RATE:
        shapes[len(widths) * b * v.Q] += 1 + v.log_max_height
    else:
        for w in widths:
            shapes[b * v.Q] += -(-w // RATE) + v.log_max_height
    shapes[v.n_phases * b * v.Q] += 1 + v.n_phases
    return dict(shapes)


def transcript_steps(log_n, fc, n_challenges=0, s2w=0):
    """Duplex steps of the prover's transcript (the verifier's schedule)."""
    sym = SymbolicChallenger()
    sym.observe(4)                       # trace commitment
    for _ in range(n_challenges):        # stage-2 challenges
        sym.sample_ext()
    if s2w:
        sym.observe(4)                   # stage-2 commitment
    sym.sample_ext()                     # alpha
    sym.observe(4)                       # quotient commitment
    sym.sample_ext()                     # zeta
    sym.sample_ext()                     # alpha_fri
    for _ in range(log_n):               # FRI commit phases
        sym.observe(4)
        sym.sample_ext()
    sym.observe(1)                       # PoW witness
    sym.sample()
    for _ in range(fc.num_queries):
        sym.sample()
    return len(sym.steps)


def prove_path_shapes(log_n, fc, air, b, windows):
    """{kernel: {states per launch: launches}} of proving b traces of
    2^log_n rows of `air`: the state-major kernel's transcript duplexes
    over the b transcripts; the lane-major kernel's trace tree (sponge
    chunks, then one compression per level), [stage-2 tree (s2w
    columns),] quotient tree (n_chunks * 2 columns), FRI commit trees (4
    columns, one per phase) and `windows` grind windows."""
    log_max = log_n + fc.log_blowup
    s2w, n_ch = air.stage2_width(), air.num_challenges()
    n_chunks = 1 << log2_ceil(getattr(air, "quotient_degree", lambda: 1)())
    soa = Counter()

    def tree(log_h, w):
        soa[b << log_h] += -(-w // RATE)
        for t in range(log_h):
            soa[b << t] += 1

    tree(log_max, air.width())
    if s2w:
        tree(log_max, s2w)
    tree(log_max, n_chunks * EXT_DEGREE)
    for log_folded in range(log_max - 1, fc.log_blowup - 1, -1):
        tree(log_folded, 4)
    soa[b * grind_window(fc)] += windows
    return {AOS: {b: transcript_steps(log_n, fc, n_ch, s2w)}, SOA: dict(soa)}


def capture_shapes(log_n, fc, air, b, windows):
    """prove_path_shapes of a proof that captures the prover's stage
    programs: each program's lane-major launches twice (its eager warm-up,
    then its first replay), the grind program's first window once more
    (its warm-up; later windows replay it), the transcript's state-major
    duplexes (eager, between the programs) once."""
    shapes = prove_path_shapes(log_n, fc, air, b, windows + 1)
    for n, c in prove_path_shapes(log_n, fc, air, b, 0)[SOA].items():
        shapes[SOA][n] += c
    return shapes


def shape_config(air, log_n, fc):
    """The P3Config that derive_config gives a proof of 2^log_n rows of
    `air`: the verifier's shape, known before the proof exists."""
    lqd = log2_ceil(getattr(air, "quotient_degree", lambda: 1)())
    return P3Config(fri_config=fc, log_quotient_degree=lqd,
                    log_trace_height=log_n, trace_width=air.width(),
                    opening_matrix_log_max_height=log_n + fc.log_blowup,
                    quotient_opened_values_len=EXT_DEGREE, degree_bits=log_n,
                    stage2_width=air.stage2_width())


def mmcs_groups(mm, device):
    """The mixed-height fixture as verify_batch's inputs: the matrices'
    opened rows merged by height, tallest first, in batch order (GL (Q,
    L_g) each), their log-heights, the siblings GL (Q, D, 4), the indices
    and the root."""
    heights = mm["heights"]
    order = sorted(range(len(heights)), key=lambda i: -heights[i])
    by_h = {}
    for i in order:
        by_h.setdefault(heights[i], []).append(i)
    rows = [gl.from_u64(np.asarray(
        [[v for i in by_h[h] for v in opened[i]] for opened in mm["opened"]],
        dtype=np.uint64), device) for h in sorted(by_h, reverse=True)]
    logs = [h.bit_length() - 1 for h in sorted(by_h, reverse=True)]
    sibs = gl.from_u64(np.asarray(mm["paths"], dtype=np.uint64), device)
    index = torch.tensor(mm["indices"], dtype=torch.int64, device=device)
    root = gl.from_u64(np.asarray(mm["root"], dtype=np.uint64), device)
    return rows, logs, sibs, index, root


def mmcs_path_shapes(rows, logs, q):
    """{kernel: {states: launches}} of verify_batch on q lanes: each
    group's sponge chunks, one compression per path level and one per
    fold-in."""
    chunks = sum(-(-r.shape[-1] // RATE) for r in rows)
    return {AOS: {q: chunks + logs[0] + len(logs) - 1}, SOA: {}}


def counted(fn):
    """Run fn() inside a recording() block; return (fn's result, the
    block's launch_counts(), with the field kernels' launches beside them
    under FIELD: {op: launches}), the device synchronised on both
    sides."""
    torch.cuda.synchronize()
    with recording():
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        got[FIELD] = field_launches()
    return out, got


def check_launches(path, got, shapes):
    """The path's counts equal its shape's, its launches and the states
    they permuted, and each of its kernels ran.  (Which variant a launch
    ran is the device trace's to name.)"""
    for k in (AOS, SOA):
        want = sum(shapes[k].values())
        states = sum(n * c for n, c in shapes[k].items())
        check(got[k] == want, f"{path}: {k} launched {got[k]} times, the "
              f"shape gives {want}")
        check(got[k + ".states"] == states,
              f"{path}: {k} permuted {got[k + '.states']} states, the shape "
              f"gives {states}")
        check(got[k] > 0 or not shapes[k], f"{path}: {k} was not launched")


# ------------------------------------------------------------ verifier paths

def tamper(proof, kind):
    p = copy.deepcopy(proof)
    fp = p.opening_proof.fri_proof
    if kind == "pow":
        fp.pow_witness += 1
    elif kind == "merkle_sibling":
        p.opening_proof.query_openings[17][0].opening_proof[3][2] ^= 1
    elif kind == "stage2_sibling":
        p.opening_proof.query_openings[17][1].opening_proof[3][2] ^= 1
    elif kind == "stage2_leaf":
        row = p.opening_proof.query_openings[23][1].opened_values[0]
        row[0] = (row[0] + 1) % P
    elif kind == "stage2_local":
        c0, c1 = p.opened_values.stage2_local[0]
        p.opened_values.stage2_local[0] = ((c0 + 1) % P, c1)
    elif kind == "stage2_commit":
        p.commitments.stage2.value[0] ^= 1
    elif kind == "a_prime_bit":
        # tests/test_keccak.py:91-99: a KeccakAir a_prime bit at zeta
        c0, c1 = p.opened_values.trace_local[865 + 77]
        p.opened_values.trace_local[865 + 77] = ((c0 + 1) % P, c1)
    elif kind == "trace_leaf":
        row = p.opening_proof.query_openings[3][0].opened_values[0]
        row[1234 % len(row)] = (row[1234 % len(row)] + 1) % P
    elif kind == "fold_sibling":
        s = fp.query_proofs[5].commit_phase_openings[1]
        s.sibling_value = (s.sibling_value[0] ^ 1, s.sibling_value[1])
    elif kind == "final_poly":
        fp.final_poly = (fp.final_poly[0] + 1, fp.final_poly[1])
    return p


def ext_int(x):
    return [int(gl.to_u64(x.c0)), int(gl.to_u64(x.c1))]


def compact(proof):
    return json.dumps(proof_to_json(proof), separators=(",", ":"))


def verdict(r):
    """The five verdict flags of a VerifyResult, as bools."""
    return {k: bool(getattr(r, k)) for k in
            ("ok", "pow_ok", "merkle_ok", "fold_ok", "quotient_ok")}


def transcript(r):
    """A VerifyResult's flags, alpha, zeta and query indices, as plain
    values."""
    return dict(verdict(r), alpha=ext_int(r.alpha), zeta=ext_int(r.zeta),
                query_indices=r.query_indices.tolist())


class PublicFibonacciAir(FibonacciAir):
    """FibonacciAir with its first-row value a public value (the port's
    FibonacciAir has none): the same constraints, and so the fixture
    proof's quotient, when the public is 1.  [fused] sends two instances
    with different values through one cached verifier."""

    def __init__(self, first):
        self.first = first

    def public_values(self):
        return {"first": self.first}

    def eval(self, folder):
        ops = folder.ops
        a, b, c = folder.main.trace_local[:3]
        na, nb, _ = folder.main.trace_next[:3]
        folder.assert_eq(ops.add(a, b), c)
        folder.when_first_row().assert_eq(folder.publics["first"], a)
        folder.when_first_row().assert_eq(ops.one(), b)
        folder.when_transition().assert_eq(na, b)
        folder.when_transition().assert_eq(nb, c)


def program_of(v):
    """The verifier's fused program (utils/graphs.py's StaticProgram)."""
    check(v._program is not None, "the verifier made no fused program")
    return v._program


def verify_runs(v):
    """How many times a single verification through `v`, which takes the
    fused program on the card, launches its kernels: twice at the first
    call (the eager warm-up before the capture, then the replay), once
    later.  Read before the call."""
    return 2 if v._program is None else 1


def programs_text(stats):
    """Capture figures of a set of stage programs, {name: stats}, as
    text: each program's capture ms and pool, and their sums."""
    tot = {k: sum(st[k] for st in stats.values())
           for k in ("warmup_ms", "capture_ms", "instantiate_ms",
                     "pool_bytes")}
    return (f"{len(stats)} programs: warm-up {tot['warmup_ms']:.0f} ms, "
            f"capture {tot['capture_ms']:.0f} ms, instantiation "
            f"{tot['instantiate_ms']:.0f} ms in all; capture ms / pool MiB "
            + ", ".join(f"{n} {st['capture_ms']:.0f} / "
                        f"{st['pool_bytes'] / 2**20:.1f}"
                        for n, st in stats.items()))


def batch_first_calls(path, bv, ws, want):
    """`ws` through a fresh BatchVerifier `bv` three times, as a caller
    makes them: staged, then capturing the stage programs, then replaying
    them (BatchVerifier.plan); each gives the verdicts `want` and the first
    call's samples.  Returns each call's wall ms by plan and the programs'
    capture figures by name."""
    ms, first = {}, None
    for how in ("staged", "capture", "replay"):
        check(bv.plan(ws) == how, f"{path}: the batch's plan was "
              f"{bv.plan(ws)}, not {how}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok, smp = bv.verify_witnesses(ws, with_samples=True)
        torch.cuda.synchronize()
        ms[how] = (time.perf_counter() - t0) * 1e3
        check(torch.equal(ok, want), f"{path}: the {how} batch's verdicts "
              f"differ")
        if first is None:
            first = smp
        check(torch.equal(smp.lo, first.lo) and torch.equal(smp.hi, first.hi),
              f"{path}: the {how} batch's samples differ from the staged "
              f"path's")
    return ms, {name: dict(prog.stats)
                for name, prog in bv.programs().items()}


def first_calls_text(ms):
    """A batch's first three calls (batch_first_calls) as text."""
    return ("first batches: " + ", ".join(f"{how} {t:.1f} ms"
                                          for how, t in ms.items()))


def in_turns(run, rounds):
    """Wall ms of run(fused) for fused True (the stage programs) and False
    (staged), in turns P S S P ...: {True: [...], False: [...]}."""
    wall = {True: [], False: []}
    for r in range(rounds):
        for fused in ((True, False) if r % 2 == 0 else (False, True)):
            t0 = time.perf_counter()
            run(fused)
            wall[fused].append((time.perf_counter() - t0) * 1e3)
    return wall


def scaled(shapes, k):
    """{states: launches} times k."""
    return {n: c * k for n, c in shapes.items()}


def program_text(stats):
    """Capture figures of a fused program, as text."""
    return (f"warm-up {stats['warmup_ms']:.1f} ms, capture "
            f"{stats['capture_ms']:.1f} ms, instantiate "
            f"{stats['instantiate_ms']:.1f} ms, first replay "
            f"{stats['first_replay_ms']:.1f} ms, pool "
            f"{stats['pool_bytes'] / 2**20:.1f} MiB")


def fused_vs_staged(path, proof, air, fc):
    """`proof` through its cached verifier fused and staged: the flags,
    alpha, zeta and query indices equal.  Returns the program's capture
    figures."""
    v = get_verifier(air, derive_config(proof, fc), DEVICE)
    check(transcript(v.verify(proof, fused=True))
          == transcript(v.verify(proof, fused=False)),
          f"{path}: the fused and the staged verification differ")
    return dict(program_of(v).stats)


def proof_digest(proof, v, cfg):
    """The values a digest fixture holds a proof to, computed on the card:
    the sha256 of its compact JSON, its commitments, and the verifier's
    transcript (alpha, zeta, query indices, and a multi-stage AIR's
    challenges)."""
    text = compact(proof)
    w = tree_map(lambda a: a[None], pack_witness(proof, cfg, DEVICE))
    r = v.verify_witnesses(w)
    smp = gl.to_u64(r["samples"][0]).tolist()
    fp = proof.opening_proof.fri_proof
    got = {
        "sha256": hashlib.sha256(text.encode()).hexdigest(),
        "bytes": len(text),
        "trace_commit": proof.commitments.trace.value,
        "quotient_commit": proof.commitments.quotient_chunks.value,
        "phase_commits": [c.value for c in fp.commit_phase_commits],
        "alpha": [smp[i] for i in v.alpha_idx],
        "zeta": [smp[i] for i in v.zeta_idx],
        "pow_witness": fp.pow_witness,
        "query_indices": r["index"][0].tolist(),
    }
    if v.s2w:
        got["stage2_commit"] = proof.commitments.stage2.value
        got["challenges"] = [[smp[i0], smp[i1]] for i0, i1 in v.challenge_idx]
    return got


def fused_phase(proof, fc, cfg, expected, path_launches,
                path_shapes):
    """[fused]: the fixture proof through the cached verifier's fused
    program (a CUDA graph captured at [single]'s first verify_proof) and
    its staged path.  Returns (a line of text, the report)."""
    fib = FibonacciAir()
    v = get_verifier(fib, cfg, DEVICE)
    prog = program_of(v)
    # equality with the staged path, the fixture's values and samples
    held = v.verify(proof, fused=True)
    first = transcript(held)
    check(first == transcript(v.verify(proof, fused=False)),
          "fused: the fused and the staged verification differ")
    check(first["ok"] and all(first[k] == expected[k] for k in
                              ("alpha", "zeta", "query_indices")),
          "fused: alpha, zeta or the query indices differ from the fixture")
    w = pack_witness(proof, cfg, DEVICE)
    fused_samples = gl.to_u64(v._s_all(w, _publics(fib, DEVICE))["samples"])
    staged = v.verify_witnesses(tree_map(lambda a: a[None], w))
    check(fused_samples.tolist() == gl.to_u64(staged["samples"][0]).tolist(),
          "fused: _verify_all_fn's samples differ from the staged transcript")
    # no stale inputs: golden, [single]'s tamper battery, golden again
    battery = ["golden"] + list(TAMPERED) + ["golden"]
    for kind in battery:
        p = proof if kind == "golden" else tamper(proof, kind)
        got = transcript(v.verify(p, fused=True))
        check(got == transcript(v.verify(p, fused=False)),
              f"fused: {kind}: the fused verdict differs from the staged one")
        check(got["ok"] == (kind == "golden"), f"fused: {kind}: ok "
              f"{got['ok']}")
    check(transcript(held) == first, "fused: a held result changed")
    # publics: two instances of one AIR class through one verifier
    verdicts = []
    for value in (1, 2, 1):
        vp = get_verifier(PublicFibonacciAir(value), cfg, DEVICE)
        got = verdict(vp.verify(proof, fused=True))
        check(got == verdict(vp.verify(proof, fused=False)),
              f"fused: public {value}: fused and staged verdicts differ")
        verdicts.append(got["ok"])
    check(verdicts == [True, False, True] and vp._program is not None,
          f"fused: public values gave {verdicts}")
    # launches per replay, and of the staged path
    for path, fused in (("verify_fused", True), ("verify_staged", False)):
        path_shapes[path] = path_shapes["verify_single"]
        ok, path_launches[path] = counted(
            lambda: bool(v.verify(proof, fused=fused).ok))
        check(ok, f"{path}: the fixture was rejected")
        check_launches(path, path_launches[path], path_shapes[path])
    # wall ms, in turns
    wall = {True: [], False: []}
    for _ in range(5):
        for fused in (True, False):
            t0 = time.perf_counter()
            check(bool(v.verify(proof, fused=fused).ok), "fixture rejected")
            wall[fused].append((time.perf_counter() - t0) * 1e3)
    # one replay's device time, the inputs loaded
    prog.load(w, _publics(fib, DEVICE))
    prof = profile_device_time(prog.run)
    replay = ("not measured (the profiler saw no kernels)" if prof is None
              else f"{prof[0]:.1f} ms device time in {prof[1]} kernels")
    med = {k: statistics.median(t) for k, t in wall.items()}
    line = (f"[fused] fixture proof: verify(fused=True) equal to "
            f"fused=False and to the fixture (flags, alpha, zeta, "
            f"{len(first['query_indices'])} query indices), the program's "
            f"{len(fused_samples)} samples the staged transcript's; golden, "
            f"{len(TAMPERED)} tampers, golden through one program: the "
            f"staged verdicts, a held result unchanged; public values 1, 2, "
            f"1 through one cached verifier: {verdicts}; "
            f"{path_launches['verify_fused'][AOS]} {AOS} launches per replay "
            f"({path_launches['verify_fused'][AOS + '.states']} states), as "
            f"staged; wall median of 5 in turns: fused {med[True]:.1f} ms, "
            f"staged {med[False]:.1f} ms; one replay: {replay}; "
            + program_text(prog.stats))
    return line, {"stats": dict(prog.stats), "fused_ms": wall[True],
                  "staged_ms": wall[False],
                  "launches": path_launches["verify_fused"],
                  "staged_launches": path_launches["verify_staged"],
                  "replay_device_ms": prof and prof[0],
                  "replay_kernels": prof and prof[1],
                  "publics_verdicts": verdicts}


def graphs_summary():
    """[graphs]: every program this run captured and the module caches
    still hold: the fused verification of each verifier shape and the
    gamma sponge's chunk programs (a BatchVerifier's stage programs are
    its own, in its phase's line): (a line of text,
    {program: capture figures})."""
    out = {}
    for v in verifier_mod._verifier_cache.values():
        fc = v.config.fri_config
        shape = (f"{type(v.air).__name__} 2^{v.n_phases} x "
                 f"{v.config.trace_width}, FriConfig({fc.log_blowup}, "
                 f"{fc.num_queries}, {fc.proof_of_work_bits})")
        if v._program is not None:
            out[shape] = dict(v._program.stats)
    for (kind, n, _), prog in attp._chain_fn_cache.items():
        out[f"gamma {kind} n={n}"] = dict(prog.stats)
    out = {k: st for k, st in out.items() if "capture_ms" in st}
    total = {k: sum(st[k] for st in out.values())
             for k in ("warmup_ms", "capture_ms", "instantiate_ms",
                       "pool_bytes")}
    return (f"[graphs] {len(out)} programs captured in this run and held "
            f"(warm-up {total['warmup_ms'] / 1e3:.1f} s, capture "
            f"{total['capture_ms'] / 1e3:.1f} s, instantiation "
            f"{total['instantiate_ms'] / 1e3:.1f} s, pools "
            f"{total['pool_bytes'] / 2**20:.1f} MiB in all): "
            + "; ".join(f"{k}: {st['capture_ms']:.0f}/"
                        f"{st['instantiate_ms']:.0f} ms, "
                        f"{st['pool_bytes'] / 2**20:.0f} MiB"
                        for k, st in out.items())), out


def timed_runs(prove_batch, traces, fused=None):
    """Three timed batch proofs, the last with stage events: (wall ms of
    each, peak GB, stage ms)."""
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        clock = StageClock() if i == 2 else None
        t0 = time.perf_counter()
        prove_batch(traces, on_stage=clock, fused=fused)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs, torch.cuda.max_memory_allocated() / 1e9, clock.ms()


def prover_plan(prover, b):
    """prover.plan for a batch of b traces of its shape (it reads only the
    shapes: meta tensors stand for the columns)."""
    z = torch.empty((b, prover.width, 1 << prover.log_n), dtype=torch.int64,
                    device="meta")
    return prover.plan(GL(z, z))


def drop_programs(air, log_n, fc):
    """Drop the stage programs of get_prover(air, log_n, fc)'s prover at
    the end of its phase, so that their pool is not held through the
    next phases (a later proof of another signature would drop them)."""
    get_prover(air, log_n, fc, DEVICE,
               quotient_eval_chunks_for(air, log_n)).release_programs()
    torch.cuda.empty_cache()


def first_proofs(path, prover, b, prove_once):
    """A signature's first three proofs as a caller makes them
    (prove_once() -> proofs of b traces): staged, capturing the prover's
    stage programs, replaying them (TorchProver.plan).  The captured and
    the replayed proofs equal the staged proofs in every value (Proof
    equality: a JSON digest of 256 proofs costs seconds of host time);
    the staged and the
    replayed launches are the path's shape (prove_path_shapes), the
    capture's capture_shapes.  Returns (the staged proofs, the shape,
    {plan: wall ms}, {plan: launches}, {program: capture figures})."""
    ms, counts, first, shapes = {}, {}, None, None
    for how in ("staged", "capture", "replay"):
        got = prover_plan(prover, b)
        check(got == how, f"{path}: the proof's plan was {got}, not {how}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs, counts[how] = counted(prove_once)
        ms[how] = (time.perf_counter() - t0) * 1e3
        if first is None:
            first = proofs
            windows = max(pr.opening_proof.fri_proof.pow_witness
                          for pr in proofs) // grind_window(prover.fc) + 1
            args = (prover.log_n, prover.fc, prover.air, b, windows)
            shapes = prove_path_shapes(*args)
        check(proofs == first, f"{path}: the {how} proofs differ from the "
              f"staged proofs")
        want = capture_shapes(*args) if how == "capture" else shapes
        check_launches(f"{path} ({how})", counts[how], want)
    return first, shapes, ms, counts, {
        n: dict(prog.stats) for n, prog in prover.programs().items()}


def prover_programs_text(stats):
    """A prover's stage programs (first_proofs) as text: how many, their
    warm-up, capture, instantiation and first-replay ms and pools in all,
    the largest pools."""
    tot = {k: sum(st[k] for st in stats.values())
           for k in ("warmup_ms", "capture_ms", "instantiate_ms",
                     "first_replay_ms", "pool_bytes")}
    big = sorted(stats.items(), key=lambda kv: -kv[1]["pool_bytes"])[:3]
    return (f"{len(stats)} stage programs: warm-up {tot['warmup_ms']:.0f} "
            f"ms, capture {tot['capture_ms']:.0f} ms, instantiation "
            f"{tot['instantiate_ms']:.0f} ms, first replays "
            f"{tot['first_replay_ms']:.0f} ms, pools "
            f"{tot['pool_bytes'] / 2**20:.0f} MiB in all (largest: "
            + ", ".join(f"{n} {st['pool_bytes'] / 2**20:.0f}"
                        for n, st in big) + ")")


def prove_turns(path, run, rounds, want, profiled, release=None):
    """run(fused, on_stage) -> proofs, replaying the stage programs
    (fused=True) and staged (False) in turns, P S S P ...: the proofs
    equal `want`.  Per mode: wall ms of each run, the stage ms and peak
    allocated and reserved GB of its last run (the allocator's cache
    emptied before each run: the reserved peak is the held programs'
    pools and the run's own), and, if `profiled`, one more run under the
    profiler (device_summary).  With `release` (it drops the programs), a
    staged run never shares the card with their pools: the programs are
    dropped before it, and captured again, untimed, before the next
    replay."""
    out = {m: {"ms": []} for m in ("replay", "staged")}
    held = [True]

    def ready(fused):
        if release is None or fused == held[0]:
            return
        if fused:
            check(run(True, None) == want, f"{path}: a re-captured proof "
                  f"differs")
        else:
            release()
        held[0] = fused

    for r in range(rounds):
        for fused in ((True, False) if r % 2 == 0 else (False, True)):
            rec = out["replay" if fused else "staged"]
            ready(fused)
            clock = StageClock()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            proofs = run(fused, clock)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["stage_ms"] = clock.ms()
            rec["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
            check(proofs == want, f"{path}: a "
                  f"{'replayed' if fused else 'staged'} proof in turns "
                  f"differs")
    for mode, rec in out.items():
        rec["median_ms"] = statistics.median(rec["ms"])
        rec["device"], rec["profile"] = UNPROFILED, None
        if profiled:
            ready(mode == "replay")
            rec["device"], rec["profile"] = device_summary(
                profile_device_time(lambda: run(mode == "replay", None)),
                rec["median_ms"])
    return out


def turns_text(turns):
    """prove_turns' figures as text."""
    return "; ".join(
        f"{mode} {rec['median_ms']:.1f} ms (median of {len(rec['ms'])} in "
        f"turns), peak {rec['peak_allocated_gb']:.2f} GB allocated, "
        f"{rec['peak_reserved_gb']:.2f} GB reserved, stage ms "
        + ", ".join(f"{k} {t:.1f}" for k, t in rec["stage_ms"].items())
        + f", {rec['device']}" for mode, rec in turns.items())


def measure_prove(air, trace, fc, path, path_launches, path_shapes,
                  profiled=True, rounds=2):
    """Prove `trace` through `prove` three times as a caller does: staged,
    capturing the prover's stage programs, replaying them (first_proofs;
    the launches held to the path's shape), then replayed and staged in
    turns through the prover's prove_columns(fused=) (prove_turns).
    Returns (proof, text, report)."""
    log_n = log2_ceil(len(trace))
    p = get_prover(air, log_n, fc, DEVICE, quotient_eval_chunks_for(air, log_n))
    torch.cuda.reset_peak_memory_stats()
    proofs, path_shapes[path], first_ms, counts, progs = first_proofs(
        path, p, 1, lambda: [prove(air, trace, fc, device=DEVICE)])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    proof = proofs[0]
    path_launches[path] = counts["replay"]
    windows = proof.opening_proof.fri_proof.pow_witness // grind_window(fc) + 1
    turns = prove_turns(path, lambda fused, clock: p.prove_columns(
        trace_columns([trace], DEVICE), clock, fused=fused), rounds,
        proofs, profiled)
    text_line = (
        f"first proofs: " + ", ".join(f"{how} {t:.1f} ms"
                                      for how, t in first_ms.items())
        + f" (peak {peak_gb:.2f} GB), each byte-equal; launches per proof "
        f"{AOS} {counts['replay'][AOS]}, {SOA} {counts['replay'][SOA]} "
        f"({windows} grind windows) staged and replayed, at the capture "
        f"{AOS} {counts['capture'][AOS]}, {SOA} {counts['capture'][SOA]} "
        f"(each program's warm-up beside its first replay); "
        + prover_programs_text(progs) + "; " + turns_text(turns))
    return proof, text_line, {
        "log_n": log_n, "bytes": len(compact(proof)),
        "first_ms": first_ms["staged"], "first_calls_ms": first_ms,
        "steady_ms": turns["replay"]["ms"],
        "staged_ms": turns["staged"]["ms"], "turns": turns,
        "stage_ms": turns["replay"]["stage_ms"], "launches": counts["replay"],
        "launches_by_plan": counts, "programs": progs, "windows": windows,
        "peak_allocated_gb": peak_gb,
        "profile": turns["replay"]["profile"]}


def unchunked_prover(air, log_n, fc):
    """A prover with every memory strategy off: S=1, one LDE chunk, slabs
    as wide as the trace (with no_slab_budget, which keeps the reduced
    openings' slab from being halved)."""
    p = TorchProver(air, log_n, fc, DEVICE)
    p.commit_col_chunks = 1
    p._ro_col_slab = p._bary_col_slab = air.width()
    return p


@contextlib.contextmanager
def no_slab_budget():
    mod = importlib.import_module("plonky25_torch.prover.prove")
    saved, mod.SLAB_BYTES = mod.SLAB_BYTES, float("inf")
    try:
        yield
    finally:
        mod.SLAB_BYTES = saved


def keccak_traces(inputs, b):
    """The digest fixture's 2^KECCAK_LOG_N-row trace and b - 1 traces of
    seeded inputs (as many permutations), (b, H, 2,633) uint64."""
    out = [keccak_trace_np(inputs, 1 << KECCAK_LOG_N)]
    for i in range(1, b):
        rng = np.random.default_rng(0xCECC + i)
        seeded = rng.integers(0, 1 << 64, size=(len(inputs), 25),
                              dtype=np.uint64).tolist()
        out.append(keccak_trace_np(seeded, 1 << KECCAK_LOG_N))
    return np.stack(out)



# ------------------------------------------------------------ attestation

def chain_groups(rows):
    """attest_program.build_trace_cols's chains: rows grouped from each
    chain start ('l', 'f', 'g'), as its 'w' runs (an empty 'l' start and
    more than 64 'w' rows: the compression sub-chains), its round A (the
    other 'l' starts) and its round B ('f' and 'g' starts)."""
    chains = []
    for i, r in enumerate(rows):
        if r.sel in ("l", "f", "g"):
            chains.append([i])
        elif r.sel in ("t", "c", "w"):
            chains[-1].append(i)

    def w_run(c):
        return (len(c) > 64 and rows[c[0]].sel == "l"
                and not rows[c[0]].absorbed
                and all(rows[j].sel == "w" for j in c[1:]))

    return ([c for c in chains if w_run(c)],
            [c for c in chains if rows[c[0]].sel == "l" and not w_run(c)],
            [c for c in chains if rows[c[0]].sel in ("f", "g")])


def trace_shapes(rows):
    """{states: launches} of the state-major kernel in build_trace_cols:
    the 'w' runs stepped together (the zero state, then one launch per
    step), then one launch per chain level of each round, over the chains
    longer than the level."""
    w_runs, *groups = chain_groups(rows)
    shapes = Counter()
    if w_runs:
        shapes[len(w_runs)] += len(w_runs[0])
    for group in groups:
        for k in range(max((len(c) for c in group), default=0)):
            shapes[sum(1 for c in group if len(c) > k)] += 1
    return shapes


def gamma_shapes(rows):
    """{states: launches} of derive_gammas: the zero state of the
    GAMMA_LANES chains, one launch per step of the padded lanes, and the
    one-state combine."""
    n_pairs = len(attp.sequence_pairs(rows))
    steps = attp.padded_pair_count(n_pairs) // attp.GAMMA_LANES
    return Counter({attp.GAMMA_LANES: steps + 1, 1: 1})


def add_shapes(*parts):
    """Sum of {kernel: {states: launches}} shapes."""
    out = {AOS: Counter(), SOA: Counter()}
    for part in parts:
        for k in (AOS, SOA):
            out[k].update(part.get(k, {}))
    return {k: dict(v) for k, v in out.items()}


def att_verifier(log_n, att_fc):
    """The cached verifier of VerifierAir STARKs of 2^log_n rows."""
    return get_verifier(VerifierAir(),
                        shape_config(VerifierAir(), log_n, att_fc), DEVICE)


def att_verifier_shapes(log_n, att_fc, b=1, runs=1):
    """The state-major shapes of verifying b VerifierAir STARKs of 2^log_n
    rows (one launch per sponge chunk of the 620-column leaf), `runs`
    times over (verify_runs)."""
    return scaled(verify_path_shapes(att_verifier(log_n, att_fc), b), runs)


def attest_step_shapes(targets, rows, att_fc, windows, b_record,
                       record_runs=1):
    """{step: {kernel: {states: launches}}} of attest / attest_many:
    record (the port's verifier over each same-shape group of the target
    proofs, `targets` as (P3Config, count) pairs; b_record proofs per
    BatchVerifier pass, `record_runs` times over: verify_runs for a group
    of one, which takes the fused program; one run for a batch, which the
    record's own BatchVerifier verifies staged), gammas,
    trace and prove (the attestation STARK's transcript and trees at its
    height, `windows` grind windows: staged)."""
    rec = []
    for cfg, n in targets:
        v = get_verifier(FibonacciAir(), cfg, DEVICE)
        rec.append({AOS: scaled(verify_path_shapes(v, n), record_runs)})
    log_n = max(len(rows) - 1, 3).bit_length()
    return {"record": add_shapes(*rec),
            "gammas": {AOS: dict(gamma_shapes(rows)), SOA: {}},
            "trace": {AOS: dict(trace_shapes(rows)), SOA: {}},
            "prove": prove_path_shapes(log_n, att_fc, VerifierAir(), 1,
                                       windows)}


def check_steps(path, clock, step_shapes):
    """Each step's launches and states equal its shape's."""
    for step, shapes in step_shapes.items():
        check_launches(f"{path} {step}", clock.steps[step]["launches"],
                       shapes)


def check_shapes(rows, log_n, att_fc, runs=1):
    """State-major shapes of check_attestation(s) past its structural
    gate: the gammas, then the STARK's verification (`runs` times,
    verify_runs)."""
    return add_shapes({AOS: gamma_shapes(rows)},
                      {AOS: att_verifier_shapes(log_n, att_fc, runs=runs)})


def outer_step_shapes(inner, rows, att_fc, windows, composed=True,
                      record_runs=1):
    """{step: {kernel: {states: launches}}} of attest_composed
    (composed) or attest_attestation: record (the port's verifier of the
    inner VerifierAir STARK, `record_runs` times, verify_runs), the host
    steps (schedule, outer-schedule: no launch), gammas, trace and prove
    (the outer STARK at its height, staged)."""
    log_n = max(len(rows) - 1, 3).bit_length()
    host = ("schedule", "outer-schedule") if composed else ("schedule",)
    out = {"record": {AOS: att_verifier_shapes(inner.stark.degree_bits,
                                               inner.att_fri_config,
                                               runs=record_runs),
                      SOA: {}}}
    out.update({step: {AOS: {}, SOA: {}} for step in host})
    out.update({"gammas": {AOS: dict(gamma_shapes(rows)), SOA: {}},
                "trace": {AOS: dict(trace_shapes(rows)), SOA: {}},
                "prove": prove_path_shapes(log_n, att_fc, VerifierAir(), 1,
                                           windows)})
    return out


def check_outer_steps(path, clock, step_shapes):
    """The entry point marked exactly the steps of its shapes, and each
    step's launches equal its shape's."""
    check(list(clock.steps) == list(step_shapes),
          f"{path}: steps {list(clock.steps)}, want {list(step_shapes)}")
    check_steps(path, clock, step_shapes)


def golden_rows(proof, fc, samples, copies=1):
    """The golden proof's schedule from its bundle's samples, `copies`
    times over (attest_many of as many copies)."""
    cfg = derive_config(proof, fc)
    return [r for _ in range(copies) for r in
            attp.build_verification_schedule(proof, cfg, FibonacciAir(),
                                             samples)]


def bundle_text(bundle):
    return json.dumps(attest_mod.bundle_to_json(bundle))


def attestation_inputs(proof, fc, golden_file="attestation_fibonacci.json",
                       copies=B_ATTEST):
    """What the attestation phases take: the golden bundle (its text and
    object), its schedule (from its samples) and `copies` copies of it,
    the small artifact, the STARK heights, and every state count the
    phases launch (prove_shapes per STARK, aos_sizes)."""
    with open(os.path.join(ARTIFACTS, golden_file)) as f:
        golden_text = f.read()
    golden = attest_mod.bundle_from_json(json.loads(golden_text))
    att_fc = golden.att_fri_config
    rows_g = golden_rows(proof, fc, golden.samples)
    rows_m = golden_rows(proof, fc, golden.samples, copies)
    with open(os.path.join(ARTIFACTS, "attestation_small.json")) as f:
        small = json.load(f)
    small_fc, small_att = (FriConfig(**small[k]) for k in ("fc", "att_fc"))
    logs = {"golden": max(len(rows_g) - 1, 3).bit_length(),
            "many": max(len(rows_m) - 1, 3).bit_length()}
    prove_shapes = ([prove_path_shapes(n, att_fc, VerifierAir(), 1, 1)
                     for n in logs.values()]
                    + [prove_path_shapes(n, small_att, VerifierAir(), 1, 1)
                       for n in (8, 9)])
    aos_sizes = set().union(*(
        set(gamma_shapes(r)) | set(trace_shapes(r)) for r in (rows_g, rows_m)),
        *(att_verifier_shapes(n, att_fc) for n in logs.values()))
    out = {"golden_text": golden_text, "golden": golden, "att_fc": att_fc,
           "rows_g": rows_g, "rows_m": rows_m, "copies": copies,
           "small": small, "small_fc": small_fc, "small_att": small_att,
           "logs": logs, "prove_shapes": prove_shapes,
           "aos_sizes": aos_sizes}
    out["composed"] = composed_inputs(proof, fc, out)
    out["prove_shapes"] += out["composed"]["prove_shapes"]
    out["aos_sizes"] |= out["composed"]["aos_sizes"]
    return out


def outer_rows(target, fc, inner, samples, compose=True):
    """The outer schedule of a composition: the inner STARK's verification
    at the recorded `samples`, and (compose) the compression rows over the
    target proof's schedule (attest_composed's schedule and
    outer-schedule steps)."""
    rows = attp.build_verification_schedule(
        inner.stark, derive_config(inner.stark, inner.att_fri_config),
        attest_mod._verifier_air_of(inner), samples)
    if not compose:
        return rows
    target_rows = attp.build_verification_schedule(
        target, derive_config(target, fc), FibonacciAir(), inner.samples)
    return rows + attp.build_compression_rows(
        len(target_rows), attp.sequence_pairs(target_rows),
        attp.pair_exponents(target_rows), inner.gamma, inner.acc)


def composed_inputs(proof, fc, att):
    """What the composed phases take: the JAX values
    (tests/fixtures/composed_expected.json), the small artifact's proofs
    and bundle, each phase's outer schedule (from the fixture's outer
    samples) and height, the step shapes' inputs and every state count
    the phases launch."""
    with open(os.path.join(FIXTURES, "composed_expected.json")) as f:
        want = json.load(f)
    small, small_fc = att["small"], att["small_fc"]
    sp = [proof_from_json(x) for x in small["proofs"]]
    inner_s = attest_mod.bundle_from_json(small["bundle"])
    rows = {
        "compose_small": outer_rows(sp[0], small_fc, inner_s,
                                    want["small"]["outer_samples"]),
        "attest_attestation": outer_rows(
            sp[0], small_fc, inner_s,
            want["attest_attestation"]["outer_samples"], compose=False),
        "compose_golden": outer_rows(proof, fc, att["golden"],
                                     want["golden"]["outer_samples"])}
    for path, key in (("compose_small", "small"),
                      ("attest_attestation", "attest_attestation"),
                      ("compose_golden", "golden")):
        check(len(rows[path]) == want[key]["n_rows"],
              f"{path}: the outer schedule has {len(rows[path])} rows, the "
              f"JAX fixture {want[key]['n_rows']}")
    logs = {k: max(len(r) - 1, 3).bit_length() for k, r in rows.items()}
    fcs = {"compose_small": att["small_att"],
           "attest_attestation": att["small_att"],
           "compose_golden": att["att_fc"]}
    target_s = attp.build_verification_schedule(
        sp[0], derive_config(sp[0], small_fc), FibonacciAir(),
        inner_s.samples)
    prove_shapes = [prove_path_shapes(logs[k], fcs[k], VerifierAir(), 1, 1)
                    for k in rows]
    aos_sizes = set().union(
        *(set(gamma_shapes(r)) | set(trace_shapes(r)) for r in rows.values()),
        *(att_verifier_shapes(logs[k], fcs[k]) for k in rows),
        att_verifier_shapes(inner_s.stark.degree_bits, att["small_att"]),
        gamma_shapes(target_s))
    return {"expected": want, "small_proofs": sp, "small_inner": inner_s,
            "rows": rows, "logs": logs, "fcs": fcs, "target_small": target_s,
            "prove_shapes": prove_shapes, "aos_sizes": aos_sizes}


def gamma_programs_phase(att, report, lap):
    """[gamma-programs], once per run (the attestation and the composed
    phases each start with it): the gamma sponge's chunk programs against
    the eager `_chain` on compose-small's pair stream, which runs eagerly
    in seconds (the golden stream takes 30-45 s).  Captures both programs
    of the GAMMA_LANES chains, so that every later gamma derivation and
    'w' run replays them alone and launches what gamma_shapes and
    trace_shapes give."""
    if "gamma_programs" in report:
        return
    n, chunk = attp.GAMMA_LANES, attp.GAMMA_CHUNK
    stream = attp._gamma_stream(
        attp.sequence_pairs(att["composed"]["rows"]["compose_small"]), DEVICE)
    steps = stream.shape[0]
    progs = {"chunk": attp._chain_chunk_fn(n, DEVICE),
             "states": attp._chain_states_fn(n, DEVICE)}
    warm = {k: chunk if p._graph is None else 0 for k, p in progs.items()}

    def eager(s=stream):
        """The derivation's chains before the programs: one launch per
        step from the host."""
        state = p2.poseidon2_permute(gl.zeros((n, 12), DEVICE))
        return gl.to_u64_np(attp._chain(state, s))

    def programs(s=stream):
        return attp._chain_digests(s)

    wall = {"eager": [], "programs": []}
    launches = {}
    for i, (name, fn) in enumerate((("programs", programs), ("eager", eager),
                                    ("programs", programs),
                                    ("programs", programs), ("eager", eager))):
        t0 = time.perf_counter()
        digests, launches[name, i] = counted(fn)
        if i:       # the first call captures the chunk program
            wall[name].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = digests
        check((digests == first).all(), f"gamma-programs: {name} gave other "
              f"digests than the chunk program")
        per_call = {AOS: {n: steps + 1 + (warm["chunk"] if i == 0 else 0)},
                    SOA: {}}
        check_launches(f"gamma-programs {name}", launches[name, i], per_call)
    # the states program against the recorded chain, over two chunks
    start = p2.poseidon2_permute(gl.zeros((n, 12), DEVICE))
    _, ins, outs = attp._chain(GL(start.lo.clone(), start.hi.clone()),
                               stream[:2 * chunk], record=True)
    state = start
    for off in (0, chunk):
        state, i_c, o_c = progs["states"](state, stream[off:off + chunk])
        check(all(torch.equal(a, b) for a, b in zip(
            (i_c.lo, i_c.hi, o_c.lo, o_c.hi),
            (ins.lo[off:off + chunk], ins.hi[off:off + chunk],
             outs.lo[off:off + chunk], outs.hi[off:off + chunk]))),
              f"gamma-programs: the states program differs from the "
              f"recorded chain at steps {off}..{off + chunk - 1}")
    check(all(p._graph is not None for p in progs.values()),
          "gamma-programs: a chain program was not captured")
    # device time of eight chunks each way (the profiler costs ~0.2 ms a
    # kernel: the whole stream is 137k kernels)
    prefix = stream[:8 * chunk]
    dev = {name: profile_device_time(lambda f=fn: f(prefix))
           for name, fn in (("eager", eager), ("programs", programs))}
    med = {k: statistics.median(t) for k, t in wall.items()}
    per_step = {k: (dev[k][0] * 1e3 / (8 * chunk + 1) if dev[k] else None)
                for k in dev}
    dev_text = ", ".join(
        f"{k} {dev[k][0]:.1f} ms in {dev[k][1]} kernels "
        f"({per_step[k]:.1f} us per step; wall {1e3 * med[k] / steps:.1f})"
        if dev[k] else f"{k} not measured (the profiler saw no kernels)"
        for k in dev)
    print(f"[gamma-programs] compose-small's pair stream ({steps} steps of "
          f"{n} chains, {steps // chunk} chunks): the chunk program's "
          f"digests equal the eager chain's; the states program's ins and "
          f"outs the recorded chain's over two chunks; launches "
          f"{steps + 1} per derivation either way (+{warm['chunk']} of the "
          f"first call's warm-up); wall median of 2 in turns: eager "
          f"{med['eager']:.1f} ms, programs {med['programs']:.1f} ms; device"
          f" time of 8 chunks: {dev_text}; chunk "
          + program_text(progs["chunk"].stats) + "; states "
          + program_text(progs["states"].stats))
    report["gamma_programs"] = {
        "steps": steps, "wall_ms": wall,
        "device_8_chunks": {k: d and d[:2] for k, d in dev.items()},
        "device_us_per_step": per_step,
        "stats": {k: dict(p.stats) for k, p in progs.items()}}
    lap("gamma-programs")


def attestation_phases(att, proof, fc, cfg, path_launches,
                       path_shapes, report, lap):
    """[gamma-programs] (once per run), [attest-golden], [check-golden],
    [attest-small], [attest-many]."""
    golden_text, golden, att_fc = (att[k] for k in
                                   ("golden_text", "golden", "att_fc"))
    rows_g, rows_m, att_logs = att["rows_g"], att["rows_m"], att["logs"]
    small, small_fc, small_att = (att[k] for k in
                                  ("small", "small_fc", "small_att"))
    copies = att["copies"]
    gamma_programs_phase(att, report, lap)
    # ---- attest the golden fib(64) proof: the committed bundle, byte for
    # byte (made by the JAX package's device prover)
    fib = FibonacciAir()
    clock = StepClock()
    runs = verify_runs(get_verifier(fib, cfg, DEVICE))
    t0 = time.perf_counter()
    bundle_g, path_launches["attest_golden"] = counted(
        lambda: attest_mod.attest(proof, fib, fc, att_fri_config=att_fc,
                                  device=DEVICE, on_step=clock.start()))
    ag_ms = (time.perf_counter() - t0) * 1e3
    ag_peak = clock.peak_gb()
    check(bundle_text(bundle_g) == golden_text, "attest-golden: the bundle "
          "differs from artifacts/attestation_fibonacci.json")
    ag_windows = (bundle_g.stark.opening_proof.fri_proof.pow_witness
                  // grind_window(att_fc) + 1)
    ag_steps = attest_step_shapes([(cfg, 1)], rows_g, att_fc, ag_windows, 1,
                                  runs)
    check_steps("attest_golden", clock, ag_steps)
    path_shapes["attest_golden"] = add_shapes(*ag_steps.values())
    check_launches("attest_golden", path_launches["attest_golden"],
                   path_shapes["attest_golden"])
    dev_ag, prof_ag = UNPROFILED, None
    la = path_launches["attest_golden"]
    print(f"[attest-golden] attest(fib(64) fixture proof, FibonacciAir(), "
          f"FriConfig(1, 100, 16)): {bundle_g.n_rows} rows, a 2^"
          f"{bundle_g.stark.degree_bits} x {VerifierAir().width()} VerifierAir "
          f"STARK; bundle byte-equal to artifacts/attestation_fibonacci.json "
          f"({len(golden_text)} bytes); {ag_ms:.1f} ms, steps (ms, launches "
          f"{AOS}/{SOA}): {clock.text()}; launches {AOS} {la[AOS]} "
          f"({la[AOS + '.states']} states), {SOA} {la[SOA]} "
          f"({la[SOA + '.states']} states; {ag_windows} grind windows), as "
          f"each step's shape gives; "
          f"peak {ag_peak:.2f} GB; {dev_ag}")
    report["attest_golden"] = {
        "n_rows": bundle_g.n_rows, "ms": ag_ms, "steps": clock.steps,
        "launches": la, "peak_allocated_gb": ag_peak, "windows": ag_windows,
        "profile": prof_ag}

    lap("attest-golden")
    # ---- check the committed golden bundle, and five tampers of it
    runs = verify_runs(att_verifier(att_logs["golden"], att_fc))
    t0 = time.perf_counter()
    ok, path_launches["check_golden"] = counted(
        lambda: attest_mod.check_attestation(golden, proof, fib, fc,
                                             att_fri_config=att_fc,
                                             device=DEVICE))
    cg_ms = (time.perf_counter() - t0) * 1e3
    check(ok, "check-golden: the committed bundle was refused")
    path_shapes["check_golden"] = check_shapes(rows_g, att_logs["golden"],
                                               att_fc, runs)
    check_launches("check_golden", path_launches["check_golden"],
                   path_shapes["check_golden"])
    dev_cg, prof_cg = UNPROFILED, None

    def golden_tamper(kind):
        b = copy.deepcopy(golden)
        if kind == "sample":
            b.samples[7] = (b.samples[7] + 1) % P
        elif kind == "statement":
            b.statement = None
        elif kind == "gamma":
            b.gamma = ((b.gamma[0] + 1) % P, b.gamma[1])
        elif kind == "stark_opening":
            tl = b.stark.opened_values.trace_local
            tl[100] = ((tl[100][0] + 1) % P, tl[100][1])
        elif kind == "num_queries":
            b.att_fri_config = FriConfig(att_fc.log_blowup, 0,
                                         att_fc.proof_of_work_bits)
        return b

    tamper_ms = {}
    for kind in ("sample", "statement", "gamma", "stark_opening",
                 "num_queries"):
        b = golden_tamper(kind)
        t0 = time.perf_counter()
        check(not attest_mod.check_attestation(b, proof, fib, fc,
                                               att_fri_config=att_fc,
                                               device=DEVICE),
              f"check-golden: the {kind} tamper was accepted")
        tamper_ms[kind] = (time.perf_counter() - t0) * 1e3
    lc = path_launches["check_golden"]
    print(f"[check-golden] check_attestation of the committed bundle with the "
          f"port's verifier on the card: accepted in {cg_ms:.1f} ms, launches "
          f"{AOS} {lc[AOS]} ({lc[AOS + '.states']} states) as the shape "
          f"gives, "
          f"{SOA} {lc[SOA]}; {dev_cg}; refused: "
          + ", ".join(f"{k} ({t:.1f} ms)" for k, t in tamper_ms.items()))
    report["check_golden"] = {"ms": cg_ms, "launches": lc,
                              "tamper_ms": tamper_ms, "profile": prof_cg}

    lap("check-golden")
    # ---- the small artifact: attest and attest_many, byte for byte
    sp = [proof_from_json(x) for x in small["proofs"]]
    clock = StepClock()
    runs = verify_runs(get_verifier(fib, derive_config(sp[0], small_fc),
                                    DEVICE))
    sb, path_launches["attest_small"] = counted(lambda: attest_mod.attest(
        sp[0], fib, small_fc, att_fri_config=small_att, device=DEVICE,
        on_step=clock.start()))
    check(bundle_text(sb) == json.dumps(small["bundle"]),
          "attest-small: the bundle differs from the artifact's")
    sms_steps = attest_step_shapes(
        [(derive_config(sp[0], small_fc), 1)],
        attp.build_verification_schedule(
            sp[0], derive_config(sp[0], small_fc), fib, sb.samples),
        small_att, sb.stark.opening_proof.fri_proof.pow_witness
        // grind_window(small_att) + 1, 1, runs)
    check_steps("attest_small", clock, sms_steps)
    path_shapes["attest_small"] = add_shapes(*sms_steps.values())
    check_launches("attest_small", path_launches["attest_small"],
                   path_shapes["attest_small"])
    small_steps = clock.text()
    t0 = time.perf_counter()
    sm = attest_mod.attest_many(sp, fib, small_fc, att_fri_config=small_att,
                                device=DEVICE)
    sm_ms = (time.perf_counter() - t0) * 1e3
    check(bundle_text(sm) == json.dumps(small["multi"]),
          "attest-small: the attest_many bundle differs from the artifact's")
    check(attest_mod.check_attestation(sb, sp[0], fib, small_fc,
                                       att_fri_config=small_att,
                                       device=DEVICE)
          and attest_mod.check_attestations(sm, sp, fib, small_fc,
                                            att_fri_config=small_att,
                                            device=DEVICE),
          "attest-small: a small bundle was refused")
    print(f"[attest-small] artifacts/attestation_small.json: attest of fib(8) "
          f"({sb.n_rows} rows, 2^{sb.stark.degree_bits}) and attest_many of "
          f"fib(8) + fib(16) ({sm.n_rows} rows, 2^{sm.stark.degree_bits}) "
          f"byte-equal to its bundle and multi, both accepted; attest steps: "
          f"{small_steps}; attest_many {sm_ms:.1f} ms")
    report["attest_small"] = {"launches": path_launches["attest_small"],
                              "steps": clock.steps, "many_ms": sm_ms}

    lap("attest-small")
    # ---- attest_many of `copies` copies of the golden proof
    clock = StepClock()
    runs = 1    # attest_many's BatchVerifier is its own: its one batch is staged
    t0 = time.perf_counter()
    mb, path_launches["attest_many"] = counted(
        lambda: attest_mod.attest_many([proof] * copies, fib, fc,
                                       att_fri_config=att_fc, device=DEVICE,
                                       on_step=clock.start()))
    am_ms = (time.perf_counter() - t0) * 1e3
    am_peak = clock.peak_gb()
    check(all(smp == golden.samples for smp in mb.samples)
          and len(mb.samples) == copies,
          "attest-many: recorded samples differ from the golden bundle's")
    check(mb.n_rows == len(rows_m) and mb.stark.degree_bits == att_logs["many"],
          f"attest-many: {mb.n_rows} rows, 2^{mb.stark.degree_bits}")
    am_windows = (mb.stark.opening_proof.fri_proof.pow_witness
                  // grind_window(att_fc) + 1)
    am_steps = attest_step_shapes([(cfg, copies)], rows_m, att_fc,
                                  am_windows, copies, runs)
    check_steps("attest_many", clock, am_steps)
    path_shapes["attest_many"] = add_shapes(*am_steps.values())
    check_launches("attest_many", path_launches["attest_many"],
                   path_shapes["attest_many"])
    am_step_text = clock.text()
    runs = verify_runs(att_verifier(att_logs["many"], att_fc))
    t0 = time.perf_counter()
    ok, path_launches["check_many"] = counted(
        lambda: attest_mod.check_attestations(mb, [proof] * copies, fib, fc,
                                              att_fri_config=att_fc,
                                              device=DEVICE))
    cm_ms = (time.perf_counter() - t0) * 1e3
    check(ok, "attest-many: check_attestations refused the bundle")
    path_shapes["check_many"] = check_shapes(rows_m, att_logs["many"], att_fc,
                                             runs)
    check_launches("check_many", path_launches["check_many"],
                   path_shapes["check_many"])
    flipped = copy.deepcopy(mb)
    flipped.samples[copies // 2][11] = (flipped.samples[copies // 2][11]
                                        + 1) % P
    check(not attest_mod.check_attestations(flipped, [proof] * copies, fib,
                                            fc, att_fri_config=att_fc,
                                            device=DEVICE),
          f"attest-many: a flipped sample of proof {copies // 2} was "
          f"accepted")
    dev_am, prof_am = UNPROFILED, None
    lm = path_launches["attest_many"]
    print(f"[attest-many] attest_many of {copies} copies of the golden proof: "
          f"the batched recording gave each the golden bundle's "
          f"{len(golden.samples)} samples; {mb.n_rows} rows, a 2^"
          f"{mb.stark.degree_bits} x {VerifierAir().width()} STARK; "
          f"{am_ms:.1f} ms, steps (ms, launches {AOS}/{SOA}): {am_step_text}; "
          f"launches {AOS} {lm[AOS]}, {SOA} {lm[SOA]} ({lm[SOA + '.states']} "
          f"states), as each step's shape gives; peak {am_peak:.2f} GB; "
          f"{dev_am}; check_attestations accepted in {cm_ms:.1f} ms "
          f"({path_launches['check_many'][AOS]} launches), one proof's "
          f"flipped sample refused")
    report["attest_many"] = {
        "B": copies, "n_rows": mb.n_rows, "ms": am_ms, "steps": clock.steps,
        "launches": lm, "peak_allocated_gb": am_peak, "check_ms": cm_ms,
        "check_launches": path_launches["check_many"], "profile": prof_am}
    del mb, flipped
    torch.cuda.empty_cache()

    lap("attest-many")


def restated(c, **fields):
    """A shallow copy of a composed attestation with `fields` changed and
    its statement recomputed (a tamper that only the deeper checks see)."""
    out = dataclasses.replace(c, **fields)
    out.statement = attest_mod.composed_statement_digest(out)
    return out


def hold_to_jax(path, got, want, log_n):
    """The outer bundle's row count, height, recorded samples, gammas,
    accumulator and statement equal the JAX package's (the fixture)."""
    outer = getattr(got, "outer", got)
    check(outer.n_rows == want["n_rows"] and outer.stark.degree_bits == log_n,
          f"{path}: {outer.n_rows} rows, 2^{outer.stark.degree_bits}; the "
          f"JAX fixture {want['n_rows']} rows, 2^{log_n}")
    check(outer.samples == want["outer_samples"],
          f"{path}: the recorded outer samples differ from JAX's")
    check(list(outer.gamma) == want["gamma"] and list(outer.acc) == want["acc"],
          f"{path}: outer gammas {outer.gamma} and accumulator {outer.acc}, "
          f"JAX's {want['gamma']} and {want['acc']}")
    check(got.statement == want["statement"],
          f"{path}: the statement differs from JAX's")


def composed_phases(att, proof, fc, path_launches, path_shapes,
                    report, lap):
    """[gamma-programs] (once per run), [compose-small],
    [attest-attestation], [compose-golden], [check-composed-golden]."""
    cin = att["composed"]
    want, rows, logs = cin["expected"], cin["rows"], cin["logs"]
    sp, inner_s = cin["small_proofs"], cin["small_inner"]
    small_fc, small_att, att_fc = att["small_fc"], att["small_att"], att["att_fc"]
    fib = FibonacciAir()
    gamma_programs_phase(att, report, lap)
    torch.cuda.empty_cache()

    # ---- the small composition: the JAX values, the int oracle, the
    # checker's verdicts and its tamper battery
    clock = StepClock()
    runs = verify_runs(att_verifier(inner_s.stark.degree_bits,
                                    inner_s.att_fri_config))
    t0 = time.perf_counter()
    cs_, path_launches["compose_small"] = counted(
        lambda: attest_mod.attest_composed(
            sp[0], fib, small_fc, att_fri_config=small_att, inner=inner_s,
            device=DEVICE, on_step=clock.start()))
    cs_ms = (time.perf_counter() - t0) * 1e3
    hold_to_jax("compose-small", cs_, want["small"], logs["compose_small"])
    check(cs_.outer.n_rows == 39_463 and logs["compose_small"] == 16,
          "compose-small: not 39,463 rows at 2^16")
    windows = (cs_.outer.stark.opening_proof.fri_proof.pow_witness
               // grind_window(small_att) + 1)
    steps = outer_step_shapes(inner_s, rows["compose_small"], small_att,
                              windows, record_runs=runs)
    check_outer_steps("compose_small", clock, steps)
    path_shapes["compose_small"] = add_shapes(*steps.values())
    check_launches("compose_small", path_launches["compose_small"],
                   path_shapes["compose_small"])
    t0 = time.perf_counter()
    check(refimpl_verify(cs_.outer.stark, attest_mod._verifier_air_of(
        cs_.outer), small_att).ok,
        "compose-small: the int oracle refused the outer STARK")
    oracle_ms = (time.perf_counter() - t0) * 1e3

    def check_small(c, **kw):
        t0 = time.perf_counter()
        ok = attest_mod.check_composed(c, fib, small_fc,
                                       att_fri_config=small_att,
                                       device=DEVICE, **kw)
        return ok, (time.perf_counter() - t0) * 1e3

    check_ms = {}
    for name, kw in (("accepted", {}), ("accepted_with_target",
                                        {"target_proof": sp[0]})):
        ok, check_ms[name] = check_small(cs_, **kw)
        check(ok, f"compose-small: check_composed refused ({name})")
    # tests/test_composed.py:180-250's battery, a changed opening of the
    # outer STARK and the artifact's fib(16) proof as the target.  Its
    # inner-sample tamper (index 2) does not steer the schedule: without
    # the target's bytes nothing binds that value, in the JAX package as
    # here (ROADMAP.md Queue C), so it is held here with the target and
    # its verdict without the target is reported, not required; a changed
    # query-index sample (the last) is refused at the gammas
    pow_i = attp.n_presamples(derive_config(sp[0], small_fc), 0) - 1
    bumped = list(cs_.inner_samples)
    bumped[2] = (bumped[2] + 1) % P
    bumped_query = list(cs_.inner_samples)
    bumped_query[-1] = (bumped_query[-1] + 1) % P
    no_pow = list(cs_.inner_samples)
    no_pow[pow_i] |= 1
    opening = copy.deepcopy(cs_.outer)
    tl = opening.stark.opened_values.trace_local
    tl[100] = ((tl[100][0] + 1) % P, tl[100][1])
    stale = dataclasses.replace(cs_, inner_gamma=(
        (cs_.inner_gamma[0] + 1) % P, cs_.inner_gamma[1]))
    tampers = {
        "inner_gamma": (restated(cs_, inner_gamma=stale.inner_gamma), {}),
        "inner_acc": (restated(cs_, inner_acc=(
            (cs_.inner_acc[0] + 1) % P, cs_.inner_acc[1])), {}),
        "inner_sample_with_target": (restated(cs_, inner_samples=bumped),
                                     {"target_proof": sp[0]}),
        "inner_query_sample": (restated(cs_, inner_samples=bumped_query),
                               {}),
        "inner_n_rows": (restated(cs_, inner_n_rows=cs_.inner_n_rows + 1),
                         {}),
        "target_shape": (restated(cs_, target_shape=dict(
            cs_.target_shape, trace_width=99)), {}),
        "stale_statement": (stale, {}),
        "pow_gate": (restated(cs_, inner_samples=no_pow), {}),
        "outer_opening": (dataclasses.replace(cs_, outer=opening), {}),
        "target_fib16": (cs_, {"target_proof": sp[1]}),
    }
    for kind, (c, kw) in tampers.items():
        ok, check_ms[kind] = check_small(c, **kw)
        check(not ok, f"compose-small: the {kind} tamper was accepted")
    unbound_ok, unbound_ms = check_small(
        restated(cs_, inner_samples=bumped))
    print(f"[compose-small] attest_composed(fib(8) proof of "
          f"artifacts/attestation_small.json, inner=its bundle, "
          f"FriConfig(1, 2, 1) both): {cs_.outer.n_rows} rows, a 2^"
          f"{cs_.outer.stark.degree_bits} x {VerifierAir().width()} outer "
          f"STARK; outer samples, gammas, accumulator and statement equal "
          f"to the JAX package's; {cs_ms:.1f} ms, steps (ms, launches "
          f"{AOS}/{SOA}, peak): {clock.text()}; launches as each step's "
          f"shape gives; the int oracle accepted the outer STARK "
          f"({oracle_ms:.1f} ms); check_composed accepted without and with "
          f"the target proof ("
          + ", ".join(f"{check_ms[k]:.1f}" for k in
                      ("accepted", "accepted_with_target"))
          + " ms), refused: "
          + ", ".join(f"{k} ({t:.1f} ms)" for k, t in check_ms.items()
                      if not k.startswith("accepted"))
          + f"; the inner sample 2 changed without the target: "
          f"{'accepted' if unbound_ok else 'refused'} ({unbound_ms:.1f} ms; "
          f"ROADMAP.md Queue C)")
    report["compose_small"] = {
        "n_rows": cs_.outer.n_rows, "ms": cs_ms, "steps": clock.steps,
        "launches": path_launches["compose_small"],
        "oracle_ms": oracle_ms, "check_ms": check_ms,
        "inner_sample_without_target": {"accepted": unbound_ok,
                                        "ms": unbound_ms}}
    del cs_, tampers, opening, stale

    lap("compose-small")
    # ---- attest_attestation of the small bundle
    clock = StepClock()
    runs = verify_runs(att_verifier(inner_s.stark.degree_bits,
                                    inner_s.att_fri_config))
    t0 = time.perf_counter()
    ob, path_launches["attest_attestation"] = counted(
        lambda: attest_mod.attest_attestation(
            inner_s, att_fri_config=small_att, device=DEVICE,
            on_step=clock.start()))
    aa_ms = (time.perf_counter() - t0) * 1e3
    hold_to_jax("attest-attestation", ob, want["attest_attestation"],
                logs["attest_attestation"])
    check(ob.n_rows == 38_171, "attest-attestation: not 38,171 rows")
    windows = (ob.stark.opening_proof.fri_proof.pow_witness
               // grind_window(small_att) + 1)
    steps = outer_step_shapes(inner_s, rows["attest_attestation"], small_att,
                              windows, composed=False, record_runs=runs)
    check_outer_steps("attest_attestation", clock, steps)
    path_shapes["attest_attestation"] = add_shapes(*steps.values())
    check_launches("attest_attestation", path_launches["attest_attestation"],
                   path_shapes["attest_attestation"])

    def check_attested(inner, target):
        t0 = time.perf_counter()
        ok = attest_mod.check_attested_attestation(
            ob, inner, target, fib, small_fc, att_fri_config=small_att,
            device=DEVICE, inner_att_fri_config=small_att)
        return ok, (time.perf_counter() - t0) * 1e3

    bad_inner = dataclasses.replace(inner_s, acc=(
        (inner_s.acc[0] + 1) % P, inner_s.acc[1]))
    aa_check = {}
    ok, aa_check["accepted"] = check_attested(inner_s, sp[0])
    check(ok, "attest-attestation: check_attested_attestation refused")
    for kind, inner, target in (("inner_acc", bad_inner, sp[0]),
                                ("target_fib16", inner_s, sp[1])):
        ok, aa_check[kind] = check_attested(inner, target)
        check(not ok, f"attest-attestation: the {kind} tamper was accepted")
    print(f"[attest-attestation] attest_attestation of the small bundle "
          f"(FriConfig(1, 2, 1)): {ob.n_rows} rows, a 2^"
          f"{ob.stark.degree_bits} STARK; samples, gammas, accumulator and "
          f"statement equal to the JAX package's; {aa_ms:.1f} ms (the prove"
          f" step staged), steps: "
          f"{clock.text()}; check_attested_attestation accepted in "
          f"{aa_check['accepted']:.1f} ms, refused the inner acc + 1 "
          f"({aa_check['inner_acc']:.1f} ms) and the fib(16) proof as the "
          f"target ({aa_check['target_fib16']:.1f} ms)")
    report["attest_attestation"] = {
        "n_rows": ob.n_rows, "ms": aa_ms, "steps": clock.steps,
        "launches": path_launches["attest_attestation"],
        "check_ms": aa_check}
    del ob

    lap("attest-attestation")
    # ---- the golden composition at full width: 2^19 x 620
    golden = att["golden"]
    torch.cuda.empty_cache()
    clock = StepClock()
    runs = verify_runs(att_verifier(golden.stark.degree_bits,
                                    golden.att_fri_config))
    t0 = time.perf_counter()
    cg, path_launches["compose_golden"] = counted(
        lambda: attest_mod.attest_composed(
            proof, fib, fc, att_fri_config=att_fc, inner=golden,
            device=DEVICE, on_step=clock.start()))
    cg_ms = (time.perf_counter() - t0) * 1e3
    hold_to_jax("compose-golden", cg, want["golden"], logs["compose_golden"])
    check(cg.outer.n_rows == 403_335 and logs["compose_golden"] == 19,
          "compose-golden: not 403,335 rows at 2^19")
    s_rule = quotient_eval_chunks_for(VerifierAir(), 19)
    s_used = sorted({pr.quotient_eval_chunks for pr in
                     prove_mod._prover_cache.values()
                     if isinstance(pr.air, VerifierAir) and pr.log_n == 19})
    check(s_used == [s_rule], f"compose-golden: proved at S={s_used}, the "
          f"rule gives {s_rule}")
    windows = (cg.outer.stark.opening_proof.fri_proof.pow_witness
               // grind_window(att_fc) + 1)
    steps = outer_step_shapes(golden, rows["compose_golden"], att_fc, windows,
                              record_runs=runs)
    check_outer_steps("compose_golden", clock, steps)
    path_shapes["compose_golden"] = add_shapes(*steps.values())
    check_launches("compose_golden", path_launches["compose_golden"],
                   path_shapes["compose_golden"])
    lg = path_launches["compose_golden"]
    print(f"[compose-golden] attest_composed(fib(64) fixture proof, "
          f"FibonacciAir(), FriConfig(1, 100, 16), inner=artifacts/"
          f"attestation_fibonacci.json): {cg.outer.n_rows} rows, a 2^"
          f"{cg.outer.stark.degree_bits} x {VerifierAir().width()} outer "
          f"STARK proved at S={s_rule} quotient segments; outer samples, "
          f"gammas, accumulator and statement equal to the JAX package's; "
          f"{cg_ms:.1f} ms, steps (ms, launches {AOS}/{SOA}, peak): "
          f"{clock.text()}; launches {AOS} {lg[AOS]} ({lg[AOS + '.states']} "
          f"states), {SOA} {lg[SOA]} ({lg[SOA + '.states']} states; {windows} "
          f"grind windows), as each step's shape gives; peak "
          f"{clock.peak_gb():.2f} GB; {UNPROFILED}")
    report["compose_golden"] = {
        "n_rows": cg.outer.n_rows, "ms": cg_ms, "steps": clock.steps,
        "launches": lg, "peak_allocated_gb": clock.peak_gb(), "S": s_rule,
        "windows": windows}
    torch.cuda.empty_cache()

    lap("compose-golden")
    # ---- check the golden composition, and two tampers refused before
    # the gammas (no launch)
    clock = StepClock()
    runs = verify_runs(att_verifier(19, att_fc))
    t0 = time.perf_counter()
    ok, path_launches["check_composed_golden"] = counted(
        lambda: attest_mod.check_composed(
            cg, fib, fc, att_fri_config=att_fc, device=DEVICE,
            on_step=clock.start()))
    ccg_ms = (time.perf_counter() - t0) * 1e3
    check(ok, "check-composed-golden: the composition was refused")
    steps = {"schedule": {AOS: {}, SOA: {}},
             "gammas": {AOS: dict(gamma_shapes(rows["compose_golden"])),
                        SOA: {}},
             "verify": {AOS: att_verifier_shapes(19, att_fc, runs=runs),
                        SOA: {}}}
    check_outer_steps("check_composed_golden", clock, steps)
    path_shapes["check_composed_golden"] = add_shapes(*steps.values())
    check_launches("check_composed_golden",
                   path_launches["check_composed_golden"],
                   path_shapes["check_composed_golden"])
    golden_tampers = {
        "statement_stripped": dataclasses.replace(cg, statement=None),
        "trace_width_99": restated(cg, target_shape=dict(
            cg.target_shape, trace_width=99))}
    tamper_ms = {}
    for kind, c in golden_tampers.items():
        t0 = time.perf_counter()
        ok, launched = counted(lambda: attest_mod.check_composed(
            c, fib, fc, att_fri_config=att_fc, device=DEVICE))
        tamper_ms[kind] = (time.perf_counter() - t0) * 1e3
        check(not ok and launched[AOS] == launched[SOA] == 0,
              f"check-composed-golden: the {kind} tamper was accepted or "
              f"launched a kernel")
    lc = path_launches["check_composed_golden"]
    print(f"[check-composed-golden] check_composed of that composition "
          f"(no target bytes): accepted in {ccg_ms:.1f} ms, steps (ms, "
          f"launches {AOS}/{SOA}, peak): {clock.text()}; launches {AOS} "
          f"{lc[AOS]} as the shape gives, {SOA} {lc[SOA]}; refused before "
          f"the gammas, with no launch: "
          + ", ".join(f"{k} ({t:.1f} ms)" for k, t in tamper_ms.items()))
    report["check_composed_golden"] = {
        "ms": ccg_ms, "steps": clock.steps, "launches": lc,
        "peak_allocated_gb": clock.peak_gb(), "tamper_ms": tamper_ms}
    del cg, golden_tampers
    torch.cuda.empty_cache()

    lap("check-composed-golden")


def free_port():
    """A free TCP port on this host's loopback address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Collectives:
    """Count the torch.distributed collectives called inside a `with`:
    `.calls` {name: calls}; `.ms` {name: host milliseconds in its calls}
    (an NCCL collective returns once enqueued; all_gather_object returns
    with the objects).  The port's modules call them through the
    torch.distributed module, so wrapping its attributes sees every one."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single",
             "all_gather_object")

    def __enter__(self):
        self.calls, self.ms = Counter(), Counter()
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(dist, n, self._counting(n, fn))
        return self

    def _counting(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def gl_equal(a, b):
    return torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi)


def multi_device_phases(proof, fc, cfg, fixture_text, expected, ws_batch,
                        want_batch, bv_batch, prove_sha,
                        path_launches, path_shapes, report, lap):
    """[nccl], [sharded], [multihost], [four-step], [prove-lde-mesh],
    [batch-prove-mesh] through one world-size-1 NCCL process group, which
    they destroy at the end.  prove_sha is the sha256 of the unmeshed
    fib(2^LOG_N) proof's compact JSON; ws_batch, want_batch and bv_batch
    are [batch]'s stacked witness, verdicts and BatchVerifier."""
    fib = FibonacciAir()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    address = f"127.0.0.1:{free_port()}"
    check(init_distributed(address, 1, 0, device=DEVICE),
          "init_distributed made no process group")
    try:
        want = "nccl" if DEVICE == "cuda" else "gloo"
        check(dist.get_backend() == want and dist.get_world_size() == 1,
              f"process group {dist.get_backend()} of "
              f"{dist.get_world_size()}: want {want} at world size 1")
        mesh = make_mesh(device=DEVICE)
        host_mesh = make_host_mesh(device=DEVICE)
        check(list(host_mesh.mesh.shape) == [1, 1],
              f"make_host_mesh gave {list(host_mesh.mesh.shape)}")
        nccl_ms = (time.perf_counter() - t0) * 1e3
        print(f"[nccl] init_distributed(tcp://{address}, world size 1) made "
              f"a {dist.get_backend()} group on "
              f"{torch.cuda.get_device_name(0)}; "
              f"make_mesh ('q',) and make_host_mesh ('b', 'q') = (1, 1) in "
              f"{nccl_ms:.1f} ms")
        report["nccl"] = {"ms": nccl_ms, "address": f"tcp://{address}"}
        lap("nccl")
        _sharded_phase(proof, fc, cfg, expected, mesh, fib,
                       path_launches, path_shapes, report)
        lap("sharded")
        _multihost_phase(proof, cfg, ws_batch, want_batch, bv_batch,
                         host_mesh, fib, path_launches,
                         path_shapes, report)
        lap("multihost")
        _four_step_phase(mesh, report)
        lap("four-step")
        _prove_lde_mesh_phase(fc, fixture_text, prove_sha, mesh, fib,
                              path_launches, path_shapes, report)
        lap("prove-lde-mesh")
        _batch_prove_mesh_phase(fc, fixture_text, mesh, fib,
                                path_launches, path_shapes, report)
        lap("batch-prove-mesh")
    finally:
        dist.destroy_process_group()


def _sharded_phase(proof, fc, cfg, expected, mesh, fib,
                   path_launches, path_shapes, report):
    sv = ShardedVerifier(fib, cfg, mesh, device=DEVICE)
    check((sv.Q_pad, sv.n_dev) == (fc.num_queries, 1),
          f"sharded: Q_pad {sv.Q_pad} over {sv.n_dev} ranks")
    plain = verify_proof(proof, fib, fc, device=DEVICE)
    with Collectives() as coll:
        r, path_launches["verify_sharded"] = counted(lambda: sv.verify(proof))
    check(verdict(r) == verdict(plain) and verdict(r)["ok"] and r.shape_ok,
          f"sharded: verdict {verdict(r)}, verify_proof's {verdict(plain)}")
    check(ext_int(r.alpha) == ext_int(plain.alpha) == expected["alpha"]
          and ext_int(r.zeta) == ext_int(plain.zeta) == expected["zeta"],
          "sharded: alpha or zeta differs from verify_proof's")
    check(r.query_indices.tolist() == plain.query_indices.tolist()
          == expected["query_indices"],
          "sharded: the query indices differ from verify_proof's")
    check(dict(coll.calls) == {"all_reduce": 1},
          f"sharded: collectives {dict(coll.calls)}, want one all_reduce")
    path_shapes["verify_sharded"] = {
        AOS: verify_path_shapes(get_verifier(fib, cfg, DEVICE), 1), SOA: {}}
    check_launches("verify_sharded", path_launches["verify_sharded"],
                   path_shapes["verify_sharded"])
    bad = copy.deepcopy(proof)
    bad.opening_proof.query_openings[99][1].opening_proof[0][0] ^= 4
    rt = verdict(sv.verify(bad))
    check(not rt["ok"] and not rt["merkle_ok"] and rt["pow_ok"]
          and rt["fold_ok"] and rt["quotient_ok"],
          f"sharded: the tamper gave {rt}")
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        check(bool(sv.verify(proof).ok), "sharded: fixture rejected")
        lat.append((time.perf_counter() - t0) * 1e3)
    plain_lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        check(bool(verify_proof(proof, fib, fc, device=DEVICE).ok),
              "fixture rejected")
        plain_lat.append((time.perf_counter() - t0) * 1e3)
    print(f"[sharded] ShardedVerifier over make_mesh() ({dist.get_backend()}"
          f", world size 1, Q_pad {sv.Q_pad}): the fixture accepted with "
          f"verify_proof's "
          f"verdict, alpha, zeta and {len(expected['query_indices'])} query "
          f"indices; one all_reduce of the flags; query 99's quotient "
          f"sibling ^4 refused by the Merkle check; "
          f"{path_launches['verify_sharded'][AOS]} launches (verify_proof's "
          f"shape); latency median {statistics.median(lat):.1f} ms, best "
          f"{min(lat):.1f} ms (verify_proof in the same run: median "
          f"{statistics.median(plain_lat):.1f} ms)")
    report["sharded"] = {"Q_pad": sv.Q_pad, "latency_ms": lat,
                         "verify_proof_latency_ms": plain_lat,
                         "collectives": dict(coll.calls),
                         "collective_ms": dict(coll.ms), "tamper": rt,
                         "launches": path_launches["verify_sharded"]}


def _multihost_phase(proof, cfg, ws_batch, want_batch, bv, host_mesh, fib,
                     path_launches, path_shapes, report):
    mv = MultiHostBatchVerifier(fib, cfg, host_mesh, device=DEVICE)
    b, q = ws_batch["obs"].shape[0], cfg.fri_config.num_queries
    check((mv.n_batch, mv.n_query, mv.Q_pad) == (1, 1, q),
          f"multihost: mesh ({mv.n_batch}, {mv.n_query}), Q_pad {mv.Q_pad}")
    with Collectives() as coll:
        ok, path_launches["verify_multihost"] = counted(
            lambda: mv.verify_witnesses(ws_batch))
    check(torch.equal(ok, want_batch), "multihost: verdicts differ from "
          "[batch]'s")
    check(dict(coll.calls) == {"all_reduce": 1, "all_gather": 1},
          f"multihost: collectives {dict(coll.calls)}")
    path_shapes["verify_multihost"] = {
        AOS: verify_path_shapes(get_verifier(fib, cfg, DEVICE), b), SOA: {}}
    check_launches("verify_multihost", path_launches["verify_multihost"],
                   path_shapes["verify_multihost"])
    # in turns with [batch]'s BatchVerifier (its programs of this
    # signature, replayed) on the same witness: its time in this phase,
    # not [batch]'s, minutes earlier
    check(bv.plan(ws_batch) == "replay", "multihost: [batch]'s "
          "BatchVerifier holds no programs of its batch")
    runs, bv_runs = [], []
    torch.cuda.reset_peak_memory_stats()
    for verify, times in ((mv, runs), (bv, bv_runs), (bv, bv_runs),
                          (mv, runs), (mv, runs), (bv, bv_runs)):
        t0 = time.perf_counter()
        check(torch.equal(verify.verify_witnesses(ws_batch), want_batch),
              "multihost: verdicts differ")
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms, bv_ms = statistics.median(runs), statistics.median(bv_runs)
    bad = copy.deepcopy(proof)
    bad.opening_proof.query_openings[7][0].opening_proof[2][1] ^= 1
    ok4, all4 = mv.verify([proof, bad, proof, proof])
    check(ok4.tolist() == [True, False, True, True] and not bool(all4),
          f"multihost: the 4-proof list gave {ok4.tolist()}, {bool(all4)}")
    qps = b * q / (ms / 1e3)
    print(f"[multihost] MultiHostBatchVerifier over make_host_mesh() (b=1, "
          f"q=1) on [batch]'s stacked witness, B={b} x Q={q}: verdicts equal"
          f" to [batch]'s; one all_reduce (flags over 'q') and one "
          f"all_gather (verdicts over 'b'); "
          f"{path_launches['verify_multihost'][AOS]} launches ([batch]'s "
          f"shape); {ms:.1f} ms per batch (median of 3), {qps:.0f} "
          f"queries/s (BatchVerifier in turns with it: {bv_ms:.1f} ms, "
          f"{b * q / (bv_ms / 1e3):.0f}); peak {peak:.2f} GB; [fixture, "
          f"query 7's"
          f" trace sibling ^1, fixture, fixture] gave {ok4.tolist()}, "
          f"all_ok {bool(all4)}")
    report["multihost"] = {"B": b, "Q": q, "ms_runs": runs, "ms": ms,
                           "queries_per_s": qps, "peak_allocated_gb": peak,
                           "batch_verifier_ms_runs": bv_runs,
                           "batch_verifier_queries_per_s":
                               b * q / (bv_ms / 1e3),
                           "collectives": dict(coll.calls),
                           "collective_ms": dict(coll.ms),
                           "four_proofs": ok4.tolist(),
                           "launches": path_launches["verify_multihost"]}


def _four_step_phase(mesh, report):
    rng = np.random.default_rng(0x4F5)
    n = 1 << (LOG_N + 1)
    coeffs = gl.from_u64(rng.integers(0, P, size=n, dtype=np.uint64), DEVICE)
    want = ntt_ops.coset_ntt(coeffs, 7)
    with Collectives() as coll:
        got = ntt_ops.coset_ntt_four_step(coeffs, 7, log_rows=3, mesh=mesh)
    check(gl_equal(got, want), "four-step: coset_ntt_four_step over the mesh "
          "differs from coset_ntt")
    check(dict(coll.calls) == {"all_to_all_single": 2, "all_gather": 1},
          f"four-step: collectives {dict(coll.calls)}")
    check(gl_equal(ntt_ops.coset_ntt_four_step(coeffs, 7, log_rows=3), want),
          "four-step: coset_ntt_four_step without a mesh differs")
    x = gl.from_u64(rng.integers(0, P, size=(8, n // 8), dtype=np.uint64),
                    DEVICE)
    flat = x.reshape(n)
    for inverse in (False, True):
        check(gl_equal(ntt_ops.four_step_output(
            ntt_ops.ntt_four_step(x, inverse)), ntt_ops.ntt(flat, inverse)),
            f"four-step: ntt_four_step (inverse={inverse}) differs from ntt")
    ms = {
        "coset_ntt": cuda_ms(lambda: ntt_ops.coset_ntt(coeffs, 7), 5),
        "coset_ntt_four_step_mesh": cuda_ms(
            lambda: ntt_ops.coset_ntt_four_step(coeffs, 7, 3, mesh=mesh), 5),
        "coset_ntt_four_step": cuda_ms(
            lambda: ntt_ops.coset_ntt_four_step(coeffs, 7, 3), 5),
        "ntt": cuda_ms(lambda: ntt_ops.ntt(flat), 5),
        "ntt_four_step": cuda_ms(lambda: ntt_ops.ntt_four_step(x), 5)}
    print(f"[four-step] n=2^{LOG_N + 1}: coset_ntt_four_step (log_rows 3) "
          f"over make_mesh() (two all_to_all_single, one all_gather) and "
          f"without a mesh equal coset_ntt; ntt_four_step at (8, 2^"
          f"{LOG_N - 2}) equals ntt forward and inverse; ms per call "
          + ", ".join(f"{k} {t:.2f}" for k, t in ms.items()))
    report["four_step"] = {"n": n, "ms": ms, "collectives": dict(coll.calls),
                           "collective_ms": dict(coll.ms)}
    del coeffs, want, got, x, flat
    torch.cuda.empty_cache()


def _prove_lde_mesh_phase(fc, fixture_text, prove_sha, mesh, fib,
                          path_launches, path_shapes, report):
    p64 = TorchProver(fib, 6, fc, DEVICE, lde_mesh=mesh)
    with Collectives() as coll64:
        pr, path_launches["prove_64_lde_mesh"] = counted(
            lambda: p64.prove(fibonacci_trace(64)))
    check(compact(pr) == fixture_text, "prove-lde-mesh: the fib(64) proof "
          "differs from tests/fixtures/proof_fibonacci_refimpl.json")
    path_shapes["prove_64_lde_mesh"] = prove_path_shapes(
        6, fc, fib, 1, pr.opening_proof.fri_proof.pow_witness
        // grind_window(fc) + 1)
    check_launches("prove_64_lde_mesh", path_launches["prove_64_lde_mesh"],
                   path_shapes["prove_64_lde_mesh"])
    # the trace's LDE commit (the quotient chunks' LDEs are not meshed, as
    # in the JAX prover): two all-to-alls and one all-gather
    check(dict(coll64.calls) == {"all_to_all_single": 2, "all_gather": 1},
          f"prove-lde-mesh: collectives {dict(coll64.calls)}")
    trace = np.asarray(fibonacci_trace(1 << LOG_N), dtype=np.uint64)
    big = TorchProver(fib, LOG_N, fc, DEVICE, lde_mesh=mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pb = big.prove(trace)
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    text = compact(pb)
    check(hashlib.sha256(text.encode()).hexdigest() == prove_sha,
          f"prove-lde-mesh: fib(2^{LOG_N}) differs from [prove]'s proof")
    windows = pb.opening_proof.fri_proof.pow_witness // grind_window(fc) + 1
    path_shapes["prove_lde_mesh"] = prove_path_shapes(LOG_N, fc, fib, 1,
                                                      windows)
    # in turns with [prove]'s unmeshed prover; stage events on the last
    steady, plain = [], []
    for meshed in (True, False, False, True):
        t0 = time.perf_counter()
        if meshed:
            clock = StageClock()
            again, path_launches["prove_lde_mesh"] = counted(
                lambda: big.prove(trace, on_stage=clock))
            steady.append((time.perf_counter() - t0) * 1e3)
            check(compact(again) == text, "prove-lde-mesh: proofs differ "
                  "between runs")
        else:               # staged, as the meshed prover runs
            get_prover(fib, LOG_N, fc, DEVICE, quotient_eval_chunks_for(
                fib, LOG_N)).prove_columns(trace_columns([trace], DEVICE),
                                           fused=False)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
    check_launches("prove_lde_mesh", path_launches["prove_lde_mesh"],
                   path_shapes["prove_lde_mesh"])
    stage_ms = clock.ms()
    print(f"[prove-lde-mesh] TorchProver(lde_mesh=make_mesh()): fib(64) "
          f"byte-equal to the fixture (two all_to_all_single, one "
          f"all_gather); fib(2^{LOG_N}) equal to [prove]'s unmeshed proof "
          f"(sha256 {prove_sha[:16]}...); first {first_ms:.1f} ms, steady "
          f"{statistics.median(steady):.1f} ms (median of 2; unmeshed in "
          f"turns with it {statistics.median(plain):.1f} ms); peak "
          f"{peak:.2f} GB; launches {AOS} "
          f"{path_launches['prove_lde_mesh'][AOS]}, {SOA} "
          f"{path_launches['prove_lde_mesh'][SOA]} ([prove]'s shape); stage "
          f"ms: " + ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items()))
    report["prove_lde_mesh"] = {
        "first_ms": first_ms, "steady_ms": steady, "stage_ms": stage_ms,
        "unmeshed_steady_ms": plain,
        "peak_allocated_gb": peak, "windows": windows,
        "collectives_fib64": dict(coll64.calls),
        "collective_ms_fib64": dict(coll64.ms),
        "launches": path_launches["prove_lde_mesh"],
        "launches_fib64": path_launches["prove_64_lde_mesh"]}
    del big, pb, again, trace
    torch.cuda.empty_cache()


def _batch_prove_mesh_phase(fc, fixture_text, mesh, fib,
                            path_launches, path_shapes, report):
    traces = np.asarray([fibonacci_trace(64)] * B_PROVE, dtype=np.uint64)
    bp = BatchProver(fib, 6, fc, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Collectives() as coll:
        proofs, path_launches["batch_prove_mesh"] = counted(
            lambda: bp.prove(traces, mesh=mesh))
    runs = [(time.perf_counter() - t0) * 1e3]
    gather_ms = dict(coll.ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # lane 0's JSON is the fixture's, every other lane equals lane 0 (Proof
    # equality: 255 JSON texts cost seconds of host time)
    check(len(proofs) == B_PROVE and compact(proofs[0]) == fixture_text
          and all(p == proofs[0] for p in proofs),
          "batch-prove-mesh: a proof differs from the fixture")
    check(dict(coll.calls) == {"all_gather_object": 1},
          f"batch-prove-mesh: collectives {dict(coll.calls)}")
    windows = max(p.opening_proof.fri_proof.pow_witness
                  for p in proofs) // grind_window(fc) + 1
    path_shapes["batch_prove_mesh"] = prove_path_shapes(6, fc, fib, B_PROVE,
                                                        windows)
    check_launches("batch_prove_mesh", path_launches["batch_prove_mesh"],
                   path_shapes["batch_prove_mesh"])
    del proofs
    plain = []                          # in turns with the unmeshed batch
    for meshed in (False, True):
        t0 = time.perf_counter()
        bp.prove(traces, mesh=mesh if meshed else None, fused=False)
        (runs if meshed else plain).append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(runs)
    print(f"[batch-prove-mesh] BatchProver.prove(B={B_PROVE} x fib(64), "
          f"mesh=make_mesh()): every proof byte-equal to the fixture, "
          f"gathered by one all_gather_object "
          f"({gather_ms['all_gather_object']:.1f} ms); {ms:.1f} ms per batch "
          f"(median of 2), {B_PROVE / ms * 1e3:.1f} proofs/s (unmeshed in "
          f"turns with it {plain[0]:.1f} ms); peak "
          f"{peak:.2f} GB; "
          f"launches {AOS} {path_launches['batch_prove_mesh'][AOS]}, {SOA} "
          f"{path_launches['batch_prove_mesh'][SOA]} ({windows} grind "
          f"windows, [batch-prove]'s shape)")
    report["batch_prove_mesh"] = {
        "B": B_PROVE, "ms_runs": runs, "ms": ms, "unmeshed_ms": plain,
        "proofs_per_s": B_PROVE / ms * 1e3, "peak_allocated_gb": peak,
        "windows": windows, "collectives": dict(coll.calls),
        "collective_ms": gather_ms,
        "launches": path_launches["batch_prove_mesh"]}


def tooling_phase(proof, fc, cfg, verify_batch, want, batch_qps, at_2_21,
                  sms, clk_hz, report):
    """[tooling]: utils/profiling.py and utils/roofline.py on the card."""
    # StageTimer (wall, synchronised) and StageClock (CUDA events at the
    # stage boundaries) around one verification of the fixture
    v = get_verifier(FibonacciAir(), cfg, DEVICE)
    timer, clock = StageTimer(), StageClock()
    with timer.stage("verify_proof") as h:
        h["result"] = r = verify_proof(proof, FibonacciAir(), fc,
                                       device=DEVICE)
    clock("verify_proof")
    with timer.stage("pack_witness") as h:
        h["result"] = w = pack_witness(proof, cfg, DEVICE)
    clock("pack_witness")
    with timer.stage("stages") as h:
        h["result"] = rs = v.verify_witnesses(
            tree_map(lambda a: a[None], w), clock)
    check(bool(r.ok) and bool(rs["ok"][0]), "[tooling] fixture rejected")
    wall, dev = timer.summary(), clock.ms()
    stages = ["verify_proof", "pack_witness", "transcript", "merkle",
              "reduced_openings", "fold", "final"]
    check(list(dev) == stages and all(t >= 0 for t in dev.values())
          and all(x["n"] == 1 for x in wall.values()),
          f"[tooling] stage clock {dev} or timer {wall} malformed")
    # measure_throughput of the B x Q batch, beside [batch]'s own figure
    n_q = B * v.Q
    thr = measure_throughput(verify_batch, (), n_items=n_q, iters=3)
    # a torch.profiler trace of one batch, written under build/trace
    logdir = os.path.join(ROOT, "build", "trace")
    shutil.rmtree(logdir, ignore_errors=True)
    with trace(logdir):
        out, launched = counted(verify_batch)
    check(torch.equal(out, want), "[tooling] traced batch verdicts differ")
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"[tooling] trace files {files}")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = Counter(e.get("name", "") for e in events
                      if e.get("cat") == "kernel")
    aos_in_trace = sum(c for k, c in kernels.items() if "poseidon2_w12" in k)
    split_in_trace = sum(c for k, c in kernels.items()
                         if "poseidon2_w12_split" in k)
    if kernels:
        check(aos_in_trace > 0, f"[tooling] the trace's {sum(kernels.values())}"
              f" kernels hold no state-major Poseidon2 kernel")
        found = (f"{aos_in_trace} of the batch's {launched[AOS]} state-major"
                 f" launches in it ({split_in_trace} of them split)"
                 + ("" if aos_in_trace == launched[AOS]
                    else ", the profiler missed the rest"))
    else:
        found = ("the state-major kernel not measured (the profiler saw no "
                 "kernels)")
    # the same count on the CPU and on the card
    rng = np.random.default_rng(0x7001)
    states = rng.integers(0, P, size=(1 << 10, 12), dtype=np.uint64)
    cols = rng.integers(0, P, size=(4, 1 << 12), dtype=np.uint64)
    counts = {}
    for d in ("cpu", DEVICE):
        sd, cd = gl.from_u64(states, d), gl.from_u64(cols, d)
        ntt_ops.coset_ntt(cd, 7)        # its tables, cached per device
        counts[d] = {
            "poseidon2_permute": count_int_ops(p2.poseidon2_permute, sd),
            "coset_ntt": count_int_ops(ntt_ops.coset_ntt, cd, 7)}
    check(counts["cpu"] == counts[DEVICE], f"[tooling] op counts differ: "
          f"cpu {counts['cpu']}, {DEVICE} {counts[DEVICE]}")
    per_state = counts[DEVICE]["poseidon2_permute"]
    check(per_state.int_ops == (1 << 10) * P2_OPS["total"],
          f"[tooling] permutation counted {per_state}")
    # MFU and roofline share of both kernels at 2^21 states
    peak = int_peak(sms, clk_hz)
    per_item = OpCount(per_state.int_ops / (1 << 10), per_state.exact)
    mfu = {k: mfu_report(k, per_item, (1 << 21) / (at_2_21[k]["ms"] / 1e3),
                         peak=peak, bytes_per_item=P2_BYTES_PER_STATE)
           for k in (AOS, SOA)}
    for k, m in mfu.items():
        check(m["mfu"] <= 1.0 and m["roofline_share"] <= 1.0,
              f"[tooling] {k} above its roofline: {m}")
        check(math.isclose(m["roofline_share"], at_2_21[k]["bound_ms"]
                           / at_2_21[k]["ms"], rel_tol=1e-9),
              f"[tooling] {k}: mfu_report's roofline differs from bound_ms")
    size_mb = os.path.getsize(files[0]) / 1e6
    print(f"[tooling] StageTimer wall ms: "
          + ", ".join(f"{k} {x['mean_ms']:.1f}" for k, x in wall.items())
          + "; StageClock device ms: "
          + ", ".join(f"{k} {t:.1f}" for k, t in dev.items())
          + f"; measure_throughput of BatchVerifier B={B} x Q={v.Q}: "
          f"{thr['items_per_sec']:.0f} queries/s ({thr['sec_per_call'] * 1e3:.1f}"
          f" ms per batch; [batch] {batch_qps:.0f} queries/s in this run); "
          f"trace of one batch: {os.path.relpath(files[0], ROOT)} "
          f"({size_mb:.1f} MB, {sum(kernels.values())} kernels), {found}; "
          f"count_int_ops equal on cpu and {DEVICE}: poseidon2_permute at "
          f"2^10 states {per_state.int_ops:.0f} (exact {per_state.exact}), "
          f"coset_ntt at 2^12 x 4 {counts[DEVICE]['coset_ntt'].int_ops:.0f} "
          f"(exact {counts[DEVICE]['coset_ntt'].exact}); at 2^21 states, mfu"
          f" / roofline share against {peak:.4g} u32 ops/s: "
          + ", ".join(f"{k} {m['mfu']:.3f} / {m['roofline_share']:.3f}"
                      for k, m in mfu.items()))
    report["tooling"] = {
        "stage_timer": wall, "stage_clock_ms": dev, "throughput": thr,
        "batch_queries_per_s": batch_qps, "trace_file_mb": size_mb,
        "trace_kernels": sum(kernels.values()),
        "trace_poseidon2_w12": aos_in_trace if kernels else None,
        "trace_poseidon2_names": {k: c for k, c in kernels.items()
                                  if "poseidon2" in k},
        "batch_launches": launched,
        "int_ops": {d: {k: dataclasses.asdict(c) for k, c in cs.items()}
                    for d, cs in counts.items()},
        "mfu": mfu}


def field_operand(kind, n, seed):
    """n seeded canonical values on the card: a GL, or a GL2 ("gl2")."""
    rng = np.random.default_rng(seed)
    parts = [gl.from_u64(rng.integers(0, P, size=n, dtype=np.uint64), DEVICE)
             for _ in range(2 if kind == "gl2" else 1)]
    return gl2.GL2(*parts) if kind == "gl2" else parts[0]


def field_limbs(v):
    return list(v.c0) + list(v.c1) if isinstance(v, gl2.GL2) else list(v)


def field_phase(report):
    """[field]: each field kernel alone at FIELD_N elements against its
    plain version and its bytes bound, and at one element (its latency)."""
    rows = {}
    for op, (fn, plain, ka, kb) in FIELD_OPS.items():
        x, y = field_operand(ka, FIELD_N, 1), field_operand(kb, FIELD_N, 2)
        got, want = fn(x, y), plain(x, y)
        check(all(torch.equal(g, w) for g, w in
                  zip(field_limbs(got), field_limbs(want))),
              f"[field] {op} differs from its limb chain at {FIELD_N}")
        del got, want
        n_in, n_out = field_kernels.OPS[op]
        nbytes = 8 * (n_in + n_out) * FIELD_N
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: fn(x, y), 20)
        plain_ms = cuda_ms(lambda: plain(x, y), 3)
        x1, y1 = field_operand(ka, 1, 3), field_operand(kb, 1, 4)
        one_ms = cuda_ms(lambda: fn(x1, y1), 200)
        rows[op] = {"n": FIELD_N, "ms": ms, "plain_ms": plain_ms,
                    "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_share": bound_ms / ms, "ms_at_1": one_ms}
        del x, y
        torch.cuda.empty_cache()
    print(f"[field] {FIELD_N} elements a launch, ms (bytes bound at 3.35 "
          "TB/s, share; plain limb chain ms; ms at 1 element): "
          + "; ".join(f"{op} {r['ms']:.4f} ({r['bound_ms']:.4f}, "
                      f"{100 * r['bound_share']:.1f}%; plain "
                      f"{r['plain_ms']:.3f}; {r['ms_at_1']:.4f})"
                      for op, r in rows.items())
          + "; each bit-equal to its limb chain on the card")
    report["field"] = rows


class FieldLaunches:
    """observe_launches' callback on a main path.  Each distinct layout a
    field kernel is launched on (the op, each operand's shape and
    strides) is held, at its first launch outside a capture, bit-equal to
    the op's limb chain on the same card tensors; launches and their
    elements are counted per op outside captures (and the checks' own
    apart), and the layouts launched inside captures kept."""

    def __init__(self):
        self.checked = {}           # layout -> axes left by the plan
        self.captured = set()
        self.launches, self.elements = Counter(), Counter()
        self.extra, self.extra_elements = Counter(), Counter()
        self.broadcast = 0          # layouts with a stride-0 operand
        self._busy = False

    def __call__(self, op, tensors):
        if self._busy:              # the check's own launch
            return
        key = (op, tuple((tuple(t.shape), t.stride()) for t in tensors))
        if torch.cuda.is_current_stream_capturing():
            self.captured.add(key)
            return
        shape = tuple(torch.broadcast_shapes(*(t.shape for t in tensors)))
        self.launches[op] += 1
        self.elements[op] += math.prod(shape)
        if key in self.checked:
            return
        self._busy = True
        try:
            got = field_kernels.launch(op, tensors)
            ok = limb_chain_equal(op, tensors, shape, got)
        finally:
            self._busy = False
        self.extra[op] += 1
        self.extra_elements[op] += math.prod(shape)
        check(ok, f"[field] {op} on operands (shape, strides) {key[1]} "
              "differs from its limb chain")
        self.checked[key] = len(field_kernels.plan(tensors)[1])
        self.broadcast += any(0 in t.stride() for t in tensors
                              if t.numel() > 1)

    def counts(self):
        """(launches, elements, the checks' launches, their elements) so
        far, per op."""
        return tuple(Counter(c) for c in (self.launches, self.elements,
                                          self.extra, self.extra_elements))


def limb_chain_equal(op, tensors, shape, got):
    """Whether `got` (op's kernel outputs on `tensors`) is bit-equal to
    the op's limb chain on the same tensors, run on slices of the leading
    axis of at most FIELD_N elements."""
    chain = field_kernels.limb_chain(op)
    if not shape:
        return all(torch.equal(g, w) for g, w in zip(got, chain(*tensors)))
    full = [t.expand(shape) for t in tensors]
    step = max(1, FIELD_N // max(1, math.prod(shape[1:])))
    for i in range(0, shape[0], step):
        want = chain(*(t[i:i + step] for t in full))
        if not all(torch.equal(g[i:i + step], w) for g, w in zip(got, want)):
            return False
    return True


def field_path(name, call, plan, obs):
    """One main path run staged twice (the first call builds the cached
    tables), capturing and replaying (call(fused) -> its result,
    plan(fused) -> what the call will run) under the observer `obs` and
    tracing: the four results equal; each staged run's field.*.launches
    and .elements counters equal the launches observed (the checks' own
    included); every layout launched in a capture also launched eagerly
    (so it was checked); the replay's launches the warm staged run's.
    Returns (the result, {run: {op: launches}})."""
    launches, results = {}, {}
    for how, fused in (("staged", False), ("staged_warm", False),
                       ("capture", True), ("replay", True)):
        got = plan(fused)
        check(got == how.split("_")[0], f"[field] {name}: the call's plan "
              f"was {got}, not {how}")
        before = obs.counts()
        torch.cuda.synchronize()
        with recording() as t:
            results[how] = call(fused)
            torch.cuda.synchronize()
        after = obs.counts()
        seen = [after[i] - before[i] for i in range(4)]
        counters = [{op: t.counts.get(field_kernels.COUNTERS[op][i], 0)
                     for op in field_kernels.OPS} for i in (0, 1)]
        launches[how] = {op: n - seen[2][op] for op, n in counters[0].items()
                         if n - seen[2][op]}
        if how.startswith("staged"):
            for i, what in enumerate(("launches", "elements")):
                want = {op: seen[i][op] + seen[i + 2][op]
                        for op in field_kernels.OPS}
                check(counters[i] == want, f"[field] {name} ({how}): "
                      f"field.*.{what} counted {counters[i]}, observed {want}")
        check(results[how] == results["staged"], f"[field] {name}: the "
              f"{how} result differs from the staged one")
    missed = obs.captured - set(obs.checked)
    check(not missed, f"[field] {name}: {len(missed)} layouts launched only "
          f"inside a capture, unchecked: {sorted(missed)[:3]}")
    check(launches["replay"] == launches["staged_warm"]
          and launches["replay"], f"[field] {name}: a replay launched "
          f"{launches['replay']}, the warm staged run "
          f"{launches['staged_warm']}")
    return results["staged"], launches


def field_paths(report):
    """[field] on the main paths at the benchmark's shapes: a Keccak proof
    of 2^FIELD_LOG_N rows (TorchProver, the quotient and the fold), a
    batch of FIELD_B["keccak"] of its proof and one of FIELD_B["fib"]
    fixture proofs (BatchVerifier), each run by field_path under one
    FieldLaunches."""
    fc = FriConfig(log_blowup=1, num_queries=100, proof_of_work_bits=16)
    kair = KeccakAir()
    rng = np.random.default_rng(0xF1E1D)
    perms = (1 << FIELD_LOG_N) // 24
    trace = keccak_trace_np(rng.integers(0, 1 << 64, size=(perms, 25),
                                         dtype=np.uint64).tolist(),
                            1 << FIELD_LOG_N)
    cols = trace_columns([trace], DEVICE)
    prover = TorchProver(kair, FIELD_LOG_N, fc, DEVICE,
                         quotient_eval_chunks_for(kair, FIELD_LOG_N))
    rows, obs = {}, FieldLaunches()
    t0 = time.perf_counter()
    with field_kernels.observe_launches(obs):
        proof, rows["prove"] = field_path(
            "prove", lambda fused: prover.prove_columns(cols,
                                                        fused=fused)[0],
            lambda fused: prover.plan(cols, fused), obs)
        prover.release_programs()
        del prover, cols
        torch.cuda.empty_cache()
        fib = load_proof(os.path.join(FIXTURES,
                                      "proof_fibonacci_refimpl.json"))
        for name, air, pr in (("verify_keccak", kair, proof),
                              ("verify_fib", FibonacciAir(), fib)):
            cfg = derive_config(pr, fc)
            b = FIELD_B[name.split("_")[1]]
            ws = stack_witnesses([pack_witness(pr, cfg, DEVICE)] * b)
            bv = BatchVerifier(air, cfg, device=DEVICE)
            ok, rows[name] = field_path(
                name, lambda fused: bv.verify_witnesses(
                    ws, fused=fused).tolist(),
                lambda fused: bv.plan(ws, fused), obs)
            check(ok == [True] * b, f"[field] {name}: a proof was rejected")
            del bv, ws
            torch.cuda.empty_cache()
    ranks = Counter(obs.checked.values())
    seconds = time.perf_counter() - t0
    print(f"[field] main paths (keccak 2^{FIELD_LOG_N} prove, verify "
          f"B={FIELD_B['keccak']}, fib verify B={FIELD_B['fib']}; staged, "
          f"captured, replayed, {seconds:.1f} s): {len(obs.checked)} "
          f"distinct layouts, by axes left after merging "
          f"{dict(sorted(ranks.items()))}, {obs.broadcast} with a broadcast "
          "operand, each bit-equal to its limb chain on the same card "
          "tensors; field.*.launches counted = observed in the staged runs, "
          "and a replay's = the warm staged run's (launches a call: cold "
          "staged, replay): "
          + "; ".join(f"{p} {sum(v['staged'].values())}, "
                      f"{sum(v['replay'].values())}"
                      for p, v in rows.items()))
    report["field_paths"] = {
        "launches": rows, "layouts": len(obs.checked),
        "layouts_by_axes": dict(ranks), "broadcast_layouts": obs.broadcast,
        "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the measurements here as JSON")
    ap.add_argument("--phases", choices=("all", "field"), default="all",
                    help="field: [card], [build] and [field] alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    report = {"phase_seconds": {}}
    t_lap = [t_start]

    def lap(phase):
        """Record the wall seconds since the last phase ended."""
        now = time.perf_counter()
        report["phase_seconds"][phase] = now - t_lap[0]
        t_lap[0] = now
    path_launches, path_shapes = {}, {}

    # ---- card
    card = nvidia_smi("name,power.limit")
    print(card)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report["card"] = {"nvidia_smi": card, "max_sm_clock_mhz": max_sm_mhz,
                      "sm_count": sms}

    # ---- build
    t0 = time.perf_counter()
    libs = build.build_many(["poseidon2", "poseidon2_soa", "goldilocks"])
    build_s = time.perf_counter() - t0
    split_max = {AOS: p2.kernel_library().split_max,
                 SOA: p2.soa_kernel_library().split_max}
    mixes, report["build"] = {}, {"seconds": build_s,
                                  "permutation_ops": P2_OPS}
    for kernel, name in ((AOS, "poseidon2"), (SOA, "poseidon2_soa")):
        built = libs[name]
        regs = ptxas_report(built.log)
        variants = sass_mixes(built.path)
        check(set(variants) == set(regs) == {"whole", "split"},
              f"{name}: want two __global__s, found {sorted(variants)}")
        mixes[kernel] = variants["whole"]
        parts = []
        for var, m in sorted(variants.items(), reverse=True):
            per_state = 3 if var == "split" else 1
            parts.append(
                f"{var} {regs[var][0]} registers, {regs[var][1]} bytes "
                f"spilled, {m['total']} SASS instructions per thread (ALU "
                f"pipe {m['alu_pipe']}, FMA pipe {m['fma_pipe']}; per state "
                f"ALU {per_state * m['alu_pipe']})")
            check(regs[var][1] == 0, f"{name} {var}: ptxas spilled registers")
        print(f"[build] {os.path.relpath(built.path, ROOT)} for sm_90a (nvcc "
              f"{built.seconds:.1f} s; both built in {build_s:.1f} s): "
              + "; ".join(parts)
              + f"; the first kernel's ALU pipe {FIRST_SASS_ALU[kernel]}, the "
              f"arithmetic's fewest {P2_OPS['total']} instructions "
              f"({P2_OPS['fma_pipe']} FMA-pipe multiplies, "
              f"{P2_OPS['either_pipe']} adds on either pipe); split for "
              f"N <= {split_max[kernel]}")
        report["build"][kernel] = {"nvcc_seconds": built.seconds,
                                   "ptxas": built.log, "sass": variants,
                                   "registers_spills": regs,
                                   "split_max_states": split_max[kernel]}

    field_regs = ptxas_functions(libs["goldilocks"].log)
    print(f"[build] {os.path.relpath(libs['goldilocks'].path, ROOT)} for "
          f"sm_90a (nvcc {libs['goldilocks'].seconds:.1f} s): "
          f"{len(field_regs)} __global__s, registers "
          f"{min(r for r, _ in field_regs.values())}-"
          f"{max(r for r, _ in field_regs.values())}, spills "
          f"{sum(sp for _, sp in field_regs.values())} bytes")
    check(all(sp == 0 for _, sp in field_regs.values()),
          "goldilocks: ptxas spilled registers")
    report["build"]["goldilocks"] = {
        "nvcc_seconds": libs["goldilocks"].seconds,
        "registers_spills": field_regs}
    lap("build")
    field_phase(report)
    field_paths(report)
    lap("field")
    if args.phases == "field":
        return finish(report, args, t_start, [])
    # ---- fixtures and the shapes every path launches
    with open(os.path.join(FIXTURES, "proof_fibonacci_expected.json")) as f:
        expected = json.load(f)
    with open(os.path.join(FIXTURES, "proof_fibonacci8192_expected.json")) as f:
        expected_8192 = json.load(f)
    fixture_path = os.path.join(FIXTURES, "proof_fibonacci_refimpl.json")
    with open(fixture_path) as f:
        fixture_text = f.read()
    proof = load_proof(fixture_path)
    fc = FriConfig(**expected["fri_config"])
    cfg = derive_config(proof, fc)
    v = get_verifier(FibonacciAir(), cfg, DEVICE)
    path_shapes["verify_single"] = {AOS: verify_path_shapes(v, 1), SOA: {}}
    path_shapes["verify_batch"] = {AOS: verify_path_shapes(v, B), SOA: {}}
    w64 = proof.opening_proof.fri_proof.pow_witness
    path_shapes["prove_64"] = prove_path_shapes(
        6, fc, FibonacciAir(), 1, w64 // grind_window(fc) + 1)
    # the multi-stage paths' verifiers, from the shapes their proofs have
    with open(os.path.join(FIXTURES, "mmcs_multi_height.json")) as f:
        mm = json.load(f)
    mm_dev = mmcs_groups(mm, DEVICE)
    path_shapes["mmcs_multi"] = mmcs_path_shapes(mm_dev[0], mm_dev[1],
                                                 len(mm["indices"]))
    expected_ms = {}
    for name in ("rlc", "multiset"):
        with open(os.path.join(FIXTURES, f"proof_{name}64_expected.json")) as f:
            expected_ms[name] = json.load(f)
        check(FriConfig(**expected_ms[name]["fri_config"]) == fc,
              f"{name} fixture made at another FriConfig")
    v_rlc = get_verifier(RlcAir(), shape_config(RlcAir(), 6, fc), DEVICE)
    path_shapes["verify_batch_rlc"] = {AOS: verify_path_shapes(v_rlc, B),
                                       SOA: {}}
    # the Keccak paths: the fixtures, and the verifier of a 2^12-row proof
    with open(os.path.join(FIXTURES, "proof_keccak32_expected.json")) as f:
        expected_k32 = json.load(f)
    with open(os.path.join(FIXTURES, "proof_keccak_expected.json")) as f:
        expected_keccak = json.load(f)
    check(FriConfig(**expected_keccak["fri_config"]) == fc
          and expected_keccak["height"] == 1 << KECCAK_LOG_N,
          "keccak digest fixture made at another FriConfig or height")
    kair = KeccakAir()
    v_keccak = get_verifier(kair, shape_config(kair, KECCAK_LOG_N, fc), DEVICE)
    path_shapes["verify_keccak"] = {AOS: verify_path_shapes(v_keccak, 1),
                                    SOA: {}}
    path_shapes["verify_batch_keccak"] = {
        AOS: verify_path_shapes(v_keccak, B_KECCAK), SOA: {}}
    # the B=8 batch's proofs and a tampered copy through one BatchVerifier
    path_shapes["verify_batch_prove_keccak"] = {
        AOS: verify_path_shapes(v_keccak, B_KECCAK_PROVE + 1), SOA: {}}
    # every state count of the prover paths (the number of grind windows
    # does not change the counts)
    prove_runs = ((FibonacciAir(), 6, 1), (FibonacciAir(), 13, 1),
                  (FibonacciAir(), LOG_N, 1), (FibonacciAir(), 6, B_PROVE),
                  (RlcAir(), 6, 1), (MultisetAir(), 6, 1),
                  (RlcAir(), LOG_N, 1), (MultisetAir(), LOG_N, 1),
                  (RlcAir(), 6, B_PROVE), (kair, 5, 1), (kair, KECCAK_LOG_N, 1),
                  (kair, KECCAK_LOG_N, B_KECCAK_PROVE))
    prove_sizes = {k: sorted(set().union(*(
        prove_path_shapes(log_n, fc, a, b, 1)[k] for a, log_n, b in prove_runs)))
        for k in (AOS, SOA)}
    # the attestation paths' inputs, and every state count they launch
    att = attestation_inputs(proof, fc)
    prove_sizes = {k: sorted(set(prove_sizes[k]).union(
        *(a[k] for a in att["prove_shapes"]))) for k in (AOS, SOA)}

    # ---- state-major kernel against its plain version
    err_aos = 0
    sizes = [1, 255, 257, 1_048_579]
    edge_n = {k: [split_max[k], split_max[k] + 1] for k in (AOS, SOA)}
    for n in sizes + edge_n[AOS]:
        err_aos = max(err_aos, aos_vs_plain(random_states(n, n)))
    edges = edge_states()
    err_aos = max(err_aos, aos_vs_plain(edges))
    kat = expected["poseidon2_known_answers"]
    kat_in = gl.from_u64(np.asarray([k["input"] for k in kat], np.uint64), DEVICE)
    for variant in VARIANTS:
        out = (p2.poseidon2_permute(kat_in) if variant is None else
               p2._poseidon2_permute_variant(kat_in, variant))
        check(gl.to_u64(out).tolist() == [k["output"] for k in kat],
              f"state-major kernel (split={variant}) disagrees with the "
              f"fixture's known answers")
    verify_sizes = sorted(set().union(*(
        path_shapes[p][AOS] for p in ("verify_single", "verify_batch",
                                      "verify_batch_rlc", "mmcs_multi",
                                      "verify_keccak",
                                      "verify_batch_keccak",
                                      "verify_batch_prove_keccak")))
        | set(prove_sizes[AOS]) | att["aos_sizes"])
    for n in verify_sizes:
        err_aos = max(err_aos, aos_vs_plain(random_states(n, 7 * n + 1)))
    check(err_aos == 0, f"state-major kernel differs from the plain version "
          f"by {err_aos}")
    print(f"[kernel] {AOS}, both variants and the launcher's choice, "
          f"bit-equal to the plain version at N={','.join(map(str, sizes))}, "
          f"on both sides of the crossover (N={','.join(map(str, edge_n[AOS]))}"
          f"), on {edges.shape[0]} edge-value states, on {len(kat)} known "
          f"answers and at the verifier, MMCS, transcript and attestation "
          f"paths' N={','.join(map(str, verify_sizes))}")

    lap("kernel")
    # ---- one proof through verify_proof
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

    ok, path_launches["verify_single"] = counted(verify_one)
    check(ok, "fixture rejected")
    check_launches("verify_single", path_launches["verify_single"],
                   path_shapes["verify_single"])
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        check(verify_one(), "fixture rejected")
        lat.append((time.perf_counter() - t0) * 1e3)
    dev1, prof1 = device_summary(profile_device_time(verify_one),
                                 statistics.median(lat))
    print(f"[single] fixture accepted on cuda with the expected alpha, zeta, "
          f"betas and {len(expected['query_indices'])} query indices; "
          f"{len(flags)} tampers and a wrong query count rejected; "
          f"{path_launches['verify_single'][AOS]} kernel launches; latency "
          f"median {statistics.median(lat):.1f} ms, best {min(lat):.1f} ms; "
          f"{dev1}")
    report["single"] = {"latency_ms": lat,
                        "launches": path_launches["verify_single"],
                        "profile": prof1}

    lap("single")
    # ---- the fused verification: one captured CUDA graph
    line, report["fused"] = fused_phase(proof, fc, cfg, expected,
                                        path_launches, path_shapes)
    print(line)

    lap("fused")
    # ---- a batch of B proofs through BatchVerifier
    bv = BatchVerifier(FibonacciAir(), cfg, device=DEVICE)
    w = pack_witness(proof, cfg, DEVICE)
    lanes = [3, B // 3, 2 * B // 3, B - 1]    # one lane per tamper kind
    bad = {lane: pack_witness(tamper(proof, kind), cfg, DEVICE)
           for lane, kind in zip(lanes, TAMPERED)}
    ws = stack_witnesses([bad.get(b, w) for b in range(B)])
    want = torch.ones(B, dtype=torch.bool, device=DEVICE)
    want[lanes] = False

    def verify_batch(on_stage=None, fused=None):
        return bv.verify_witnesses(ws, on_stage, fused=fused)

    torch.cuda.reset_peak_memory_stats()
    first_ms, progs = batch_first_calls("batch", bv, ws, want)
    ok, path_launches["verify_batch"] = counted(verify_batch)
    check(torch.equal(ok, want), "batch verdicts differ")
    check_launches("verify_batch", path_launches["verify_batch"],
                   path_shapes["verify_batch"])
    wall = in_turns(lambda fused: check(torch.equal(
        verify_batch(fused=fused), want), "batch verdicts differ"), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    clock = StageClock()
    verify_batch(clock)
    stage_ms = clock.ms()
    runs = wall[True]
    ms_batch, ms_staged = (statistics.median(wall[k]) for k in (True, False))
    devb, profb = device_summary(profile_device_time(verify_batch), ms_batch)
    devs, profs = device_summary(profile_device_time(
        lambda: verify_batch(fused=False)), ms_staged)
    qps = B * v.Q / (ms_batch / 1e3)
    print(f"[batch] B={B} x Q={v.Q}: verdicts exact ({len(lanes)} tampered "
          f"lanes rejected), the stage programs' verdicts and samples the "
          f"staged path's; {path_launches['verify_batch'][AOS]} kernel "
          f"launches per replay of the five; {ms_batch:.1f} ms per batch "
          f"(median of {len(runs)}, in turns with staged {ms_staged:.1f} ms)"
          f", {qps:.0f} queries/s; peak {peak_gb:.2f} GB (the phase, "
          f"captures included); stage ms: "
          + ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items())
          + f"; programs: {devb}; staged: {devs}; "
          + first_calls_text(first_ms) + "; " + programs_text(progs))
    batch_in = (ws, want.clone(), bv)   # [multihost] verifies them again
    want_batch = batch_in[1]            # and [tooling]
    report["batch"] = {"B": B, "Q": v.Q, "ms_runs": runs, "ms": ms_batch,
                       "staged_ms_runs": wall[False], "staged_ms": ms_staged,
                       "queries_per_s": qps, "peak_allocated_gb": peak_gb,
                       "stage_ms": stage_ms,
                       "launches": path_launches["verify_batch"],
                       "profile": profb, "staged_profile": profs,
                       "first_ms": first_ms, "programs": progs}

    lap("batch")
    # ---- lane-major kernel against its plain version and the other kernel
    # at every state count of the prover paths
    prover_sizes = prove_sizes[SOA]
    err_soa = 0
    for n in sizes + edge_n[SOA]:
        err_soa = max(err_soa, soa_vs_plain_and_aos(
            random_states(n, n, lane_major=True)))
    err_soa = max(err_soa, soa_vs_plain_and_aos(transposed(edges)))
    for variant in VARIANTS:
        out = (p2.poseidon2_permute_soa(transposed(kat_in)) if variant is None
               else p2._poseidon2_permute_soa_variant(transposed(kat_in),
                                                      variant))
        check(gl.to_u64(transposed(out)).tolist()
              == [k["output"] for k in kat],
              f"lane-major kernel (split={variant}) disagrees with the "
              f"fixture's known answers")
    for n in prover_sizes:
        err_soa = max(err_soa, soa_vs_plain_and_aos(
            random_states(n, 3 * n + 2, lane_major=True)))
        torch.cuda.empty_cache()
    check(err_soa == 0, f"lane-major kernel differs from the plain version or "
          f"the state-major kernel by {err_soa}")
    print(f"[kernel-soa] {SOA}, both variants and the launcher's choice, "
          f"bit-equal to its plain version and to {AOS} (transposed) at "
          f"N={','.join(map(str, sizes))}, on both sides of the crossover "
          f"(N={','.join(map(str, edge_n[SOA]))}), on the edge-value states, "
          f"on the known answers and at the prover paths' "
          f"N={','.join(map(str, prover_sizes))}")

    lap("kernel-soa")
    # ---- prove fib(64): the fixture, byte for byte
    air = FibonacciAir()
    p64, path_launches["prove_64"] = counted(
        lambda: prove(air, fibonacci_trace(64), fc, device=DEVICE))
    check(compact(p64) == fixture_text,
          "fib(64) proof differs from tests/fixtures/proof_fibonacci_refimpl.json")
    check_launches("prove_64", path_launches["prove_64"],
                   path_shapes["prove_64"])
    print(f"[prove-64] fib(64) proof byte-equal to the fixture "
          f"({len(fixture_text)} bytes, PoW witness {w64}); launches: "
          f"{AOS} {path_launches['prove_64'][AOS]}, {SOA} "
          f"{path_launches['prove_64'][SOA]} (as the shape gives)")

    lap("prove-64")
    # ---- prove fib(2^13): the JAX package's digest
    p8k = prove(air, fibonacci_trace(1 << 13), fc, device=DEVICE)
    cfg8k = derive_config(p8k, fc)
    got = proof_digest(p8k, get_verifier(air, cfg8k, DEVICE), cfg8k)
    for k, val in got.items():
        check(val == expected_8192[k], f"fib(2^13) {k} differs from the JAX "
              f"package's")
    check(verdict(verify_proof(p8k, air, fc, device=DEVICE))["ok"],
          "fib(2^13) proof rejected")
    print(f"[prove-8192] fib(2^13) proof ({got['bytes']} bytes) equal to the "
          f"JAX package's: sha256 {got['sha256'][:16]}..., commitments, alpha, "
          f"zeta, PoW witness {got['pow_witness']}, query indices; accepted")

    lap("prove-8192")
    # ---- prove fib(2^20)
    t0 = time.perf_counter()
    trace = np.asarray(fibonacci_trace(1 << LOG_N), dtype=np.uint64)
    setup_s = time.perf_counter() - t0
    big, line, report["prove"] = measure_prove(
        air, trace, fc, "prove", path_launches, path_shapes)
    report["prove"]["trace_setup_s"] = setup_s
    prove_sha = hashlib.sha256(compact(big).encode()).hexdigest()
    report["prove"]["sha256"] = prove_sha
    check(verdict(verify_proof(big, air, fc, device=DEVICE))["ok"],
          "fib(2^20) proof rejected by verify_proof")
    rt = verdict(verify_proof(tamper(big, "merkle_sibling"), air, fc,
                              device=DEVICE))
    check(not rt["ok"] and not rt["merkle_ok"],
          "fib(2^20) proof with a flipped Merkle sibling accepted")
    # a fresh prover of that shape (its own tables): warmup captures its
    # stage programs (dropping the cached prover's: one set per device),
    # its first proof replays them, byte-equal to the cached prover's;
    # dropping the prover gives the programs' memory back
    get_prover(air, LOG_N, fc, DEVICE,
               quotient_eval_chunks_for(air, LOG_N)).release_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved() / 2**30
    warmed = TorchProver(air, LOG_N, fc, DEVICE,
                         quotient_eval_chunks_for(air, LOG_N))
    t0 = time.perf_counter()
    warmed.warmup()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_plan = prover_plan(warmed, 1)
    check(warm_plan == "replay", f"prove: the first proof after warmup() "
          f"would run {warm_plan}")
    t0 = time.perf_counter()
    wp, warm_launches = counted(lambda: warmed.prove(trace))
    warm_first_ms = (time.perf_counter() - t0) * 1e3
    check(hashlib.sha256(compact(wp).encode()).hexdigest() == prove_sha,
          "fib(2^20): the warmed prover's proof differs")
    check(warm_launches == path_launches["prove"], "prove: the first proof "
          "after warmup() launched other counts than a replay")
    warm_pools = sum(prog.stats["pool_bytes"]
                     for prog in warmed.programs().values()) / 2**30
    del warmed, wp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved_after = torch.cuda.memory_reserved() / 2**30
    check(reserved_after - reserved_before < 0.5, f"prove: {reserved_after:.2f}"
          f" GiB reserved after the warmed prover was dropped, "
          f"{reserved_before:.2f} GiB before its capture")
    report["prove"].update(warmup_ms=warm_ms,
                           first_after_warmup_ms=warm_first_ms,
                           reserved_before_gib=reserved_before,
                           reserved_after_gib=reserved_after,
                           warm_pools_gib=warm_pools)
    print(f"[prove] fib(2^{LOG_N}) at FriConfig(1, 100, 16): "
          f"{report['prove']['bytes']} bytes, accepted by verify_proof, "
          f"flipped Merkle sibling rejected; trace made in {setup_s:.1f} s "
          f"beforehand; " + line + f"; a fresh prover of this shape: "
          f"warmup() {warm_ms:.1f} ms (its capture), then its first proof "
          f"{warm_first_ms:.1f} ms, a replay, byte-equal; reserved "
          f"{reserved_before:.2f} GiB before the capture, "
          f"{reserved_after:.2f} GiB once the prover was dropped (pools "
          f"{warm_pools:.2f} GiB)")

    lap("prove")
    # ---- BatchProver on B_PROVE copies of fib(64), one lane tampered
    bad_lane = B_PROVE // 3
    traces = np.asarray([fibonacci_trace(64)] * B_PROVE, dtype=np.uint64)
    traces[bad_lane, 10, 2] = (int(traces[bad_lane, 10, 2]) + 1) % P
    bp = BatchProver(air, 6, fc, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    proofs, path_shapes["batch_prove"], bp_first, bp_counts, bp_progs = \
        first_proofs("batch_prove", bp.base, B_PROVE,
                     lambda: bp.prove(traces))
    bp_first_peak = torch.cuda.max_memory_allocated() / 1e9
    path_launches["batch_prove"] = bp_counts["replay"]
    # lane 0's JSON is the fixture's, every other valid lane equals lane 0
    # (Proof equality: 255 JSON texts cost seconds of host time)
    check(compact(proofs[0]) == fixture_text, "batch lane 0: proof differs "
          "from the fixture")
    for i, pr in enumerate(proofs):
        if i != bad_lane:
            check(pr == proofs[0], f"batch lane {i}: proof differs from the "
                  f"fixture")
    check(compact(proofs[bad_lane]) != fixture_text, "tampered lane unchanged")
    rbad = verify_proof(proofs[bad_lane], air, fc, device=DEVICE)
    check([bool(rbad.ok), bool(rbad.pow_ok), bool(rbad.merkle_ok),
           bool(rbad.fold_ok), bool(rbad.quotient_ok)]
          == [False, True, True, True, False],
          "tampered lane not rejected by its quotient check alone")
    bp_windows = max(pr.opening_proof.fri_proof.pow_witness
                     for pr in proofs) // grind_window(fc) + 1
    one = path_launches["prove_64"]
    check(path_launches["batch_prove"][AOS] == one[AOS]
          and path_launches["batch_prove"][SOA] - bp_windows
          == one[SOA] - path_shapes["prove_64"][SOA][grind_window(fc)],
          "a batch launched the kernels more often than one proof")
    bp_turns = prove_turns("batch_prove", lambda fused, clock: bp.prove(
        traces, clock, fused=fused), 1, proofs, True)
    ms_bp = bp_turns["replay"]["median_ms"]
    # warmup(B) captures (after the programs are dropped): the first
    # batch after it replays them
    bp.release_programs()
    t0 = time.perf_counter()
    bp.warmup(B_PROVE)
    bp_warm_ms = (time.perf_counter() - t0) * 1e3
    check(prover_plan(bp.base, B_PROVE) == "replay", "batch-prove: the "
          "first batch after warmup() would not replay")
    t0 = time.perf_counter()
    again, warm_counts = counted(lambda: bp.prove(traces))
    bp_first_ms = (time.perf_counter() - t0) * 1e3
    check(again == proofs and warm_counts == bp_counts["replay"],
          "batch-prove: the first batch after warmup() differs")
    del again
    print(f"[batch-prove] B={B_PROVE} x fib(64): {B_PROVE - 1} proofs "
          f"byte-equal to the fixture, lane {bad_lane} (tampered trace) "
          f"rejected by its quotient check alone; first batches: "
          + ", ".join(f"{how} {t:.1f} ms" for how, t in bp_first.items())
          + f" (peak {bp_first_peak:.2f} GB), each byte-equal; launches "
          f"{AOS} {bp_counts['replay'][AOS]}, {SOA} {bp_counts['replay'][SOA]}"
          f" ({bp_windows} grind windows; one proof's counts apart from "
          f"windows) staged and replayed, at the capture {AOS} "
          f"{bp_counts['capture'][AOS]}, {SOA} {bp_counts['capture'][SOA]}; "
          + prover_programs_text(bp_progs) + f"; {turns_text(bp_turns)}; "
          f"replayed {B_PROVE / ms_bp * 1e3:.1f} proofs/s, staged "
          f"{B_PROVE / bp_turns['staged']['median_ms'] * 1e3:.1f}; "
          f"warmup({B_PROVE}) {bp_warm_ms:.1f} ms (its capture), then the "
          f"first batch {bp_first_ms:.1f} ms, a replay")
    report["batch_prove"] = {"B": B_PROVE, "ms_runs": bp_turns["replay"]["ms"],
                             "ms": ms_bp,
                             "proofs_per_s": B_PROVE / ms_bp * 1e3,
                             "first_calls_ms": bp_first,
                             "peak_allocated_gb": bp_first_peak,
                             "turns": bp_turns, "programs": bp_progs,
                             "stage_ms": bp_turns["replay"]["stage_ms"],
                             "windows": bp_windows,
                             "warmup_ms": bp_warm_ms,
                             "first_after_warmup_ms": bp_first_ms,
                             "launches": path_launches["batch_prove"],
                             "launches_by_plan": bp_counts,
                             "profile": bp_turns["replay"]["profile"]}
    bp.release_programs()
    del proofs
    torch.cuda.empty_cache()

    lap("batch-prove")
    # ---- multi-height MMCS verify_batch on the fixture's openings
    rows, logs, sibs, index, root = mm_dev
    q = len(mm["indices"])
    ok, path_launches["mmcs_multi"] = counted(
        lambda: mmcs_verify_batch(root, rows, logs, index, sibs))
    check(bool(ok.all()), "mmcs-multi: an opening of the fixture rejected")
    check_launches("mmcs_multi", path_launches["mmcs_multi"],
                   path_shapes["mmcs_multi"])
    # tampers, each on a lane of its own: a sibling flipped just below each
    # fold-in (the walk's last compression before it), a row value of each
    # short group changed
    fold_levels = [logs[0] - lh for lh in logs[1:]]
    bad_sibs = tree_map(torch.clone, sibs)
    bad_rows = tree_map(torch.clone, rows)
    want = torch.ones(q, dtype=torch.bool)
    lane = 0
    for t in fold_levels:
        bad_sibs.lo[lane, t - 1, 2] ^= 1
        want[lane] = False
        lane += 7
    for g in range(1, len(rows)):
        bad_rows[g].lo[lane, 0] = (bad_rows[g].lo[lane, 0] + 1) & 0xFFFFFFFF
        want[lane] = False
        lane += 7
    got_dev = mmcs_verify_batch(root, bad_rows, logs, index, bad_sibs).cpu()
    check(torch.equal(got_dev, want), "mmcs-multi: tamper verdicts differ")
    cpu = mmcs_groups(mm, "cpu")
    got_cpu = mmcs_verify_batch(
        cpu[4], tree_map(torch.Tensor.cpu, bad_rows), cpu[1], cpu[3],
        tree_map(torch.Tensor.cpu, bad_sibs))
    check(torch.equal(got_cpu, got_dev) and bool(
        mmcs_verify_batch(cpu[4], cpu[0], cpu[1], cpu[3], cpu[2]).all()),
        "mmcs-multi: the card's verdicts differ from the plain path's")
    mm_ms = cuda_ms(lambda: mmcs_verify_batch(root, rows, logs, index, sibs), 20)
    print(f"[mmcs-multi] heights {mm['heights']}, widths {mm['widths']}: "
          f"{q} openings accepted; {len(fold_levels)} flipped siblings (below "
          f"the fold-ins after compressions {fold_levels}) and "
          f"{len(rows) - 1} changed rows of the short groups rejected, "
          f"verdicts equal to the plain path on the CPU; "
          f"{path_launches['mmcs_multi'][AOS]} launches of {q} states; "
          f"{mm_ms:.2f} ms per call")
    report["mmcs_multi"] = {"queries": q, "ms": mm_ms,
                            "launches": path_launches["mmcs_multi"],
                            "fold_levels": fold_levels}

    lap("mmcs-multi")
    # ---- multi-stage 64-row proofs: the fixtures' digests
    ms_airs = {"rlc": RlcAir(), "multiset": MultisetAir()}
    ms_proofs = {}
    for name, ms_air in ms_airs.items():
        exp = expected_ms[name]
        trace = np.asarray(exp["trace"], dtype=np.uint64)
        path = f"prove_{name}_64"
        pr, path_launches[path] = counted(
            lambda: prove(ms_air, trace, fc, device=DEVICE))
        cfg_ms = derive_config(pr, fc)
        check(cfg_ms == shape_config(ms_air, 6, fc),
              f"{path}: proof shape differs from the AIR's")
        got = proof_digest(pr, get_verifier(ms_air, cfg_ms, DEVICE), cfg_ms)
        for k, val in got.items():
            check(val == exp[k], f"{path}: {k} differs from the fixture")
        r = verify_proof(pr, ms_air, fc, device=DEVICE)
        check(verdict(r) == {k: v for k, v in exp["verdict"].items()
                             if k != "shape_ok"} and r.shape_ok,
              f"{path}: verify_proof verdict differs from the fixture's")
        report.setdefault("fused_programs", {})[path] = fused_vs_staged(
            path, pr, ms_air, fc)
        path_shapes[path] = prove_path_shapes(
            6, fc, ms_air, 1, pr.opening_proof.fri_proof.pow_witness
            // grind_window(fc) + 1)
        check_launches(path, path_launches[path], path_shapes[path])
        ms_proofs[name] = pr
        print(f"[prove-{name}-64] {ms_air.name()}Air, 64 rows: proof "
              f"({got['bytes']} bytes) equal to the JAX package's digest "
              f"(sha256 {got['sha256'][:16]}..., trace, stage-2, quotient "
              f"and phase commitments, {len(got['challenges'])} challenges, "
              f"alpha, zeta, PoW witness {got['pow_witness']}, query indices); "
              f"accepted by verify_proof, fused and staged alike ("
              + program_text(report["fused_programs"][path])
              + f"); launches {AOS} "
              f"{path_launches[path][AOS]}, {SOA} {path_launches[path][SOA]} "
              f"(as the shape gives)")

    lap("prove-ms-64")
    # ---- BatchVerifier on copies of the RLC proof, five lanes tampered
    rlc64 = ms_proofs["rlc"]
    cfg_rlc = derive_config(rlc64, fc)
    bv_rlc = BatchVerifier(RlcAir(), cfg_rlc, device=DEVICE)
    check(bv_rlc.base is v_rlc, "the RLC verifier was not the shape's")
    kinds = TAMPERED + ("stage2_leaf",)
    lanes = [5, B // 5, 2 * B // 5, 3 * B // 5, B - 2]
    w_rlc = pack_witness(rlc64, cfg_rlc, DEVICE)
    bad = {lane: pack_witness(tamper(rlc64, kind), cfg_rlc, DEVICE)
           for lane, kind in zip(lanes, kinds)}
    ws_rlc = stack_witnesses([bad.get(b, w_rlc) for b in range(B)])
    want = torch.ones(B, dtype=torch.bool, device=DEVICE)
    want[lanes] = False

    def verify_batch_rlc(on_stage=None, fused=None):
        return bv_rlc.verify_witnesses(ws_rlc, on_stage, fused=fused)

    torch.cuda.reset_peak_memory_stats()
    first_ms, progs = batch_first_calls("batch-rlc", bv_rlc, ws_rlc, want)
    ok, path_launches["verify_batch_rlc"] = counted(verify_batch_rlc)
    check(torch.equal(ok, want), "batch-rlc verdicts differ")
    check_launches("verify_batch_rlc", path_launches["verify_batch_rlc"],
                   path_shapes["verify_batch_rlc"])
    wall = in_turns(lambda fused: check(torch.equal(
        verify_batch_rlc(fused=fused), want), "batch-rlc verdicts differ"), 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    clock = StageClock()
    verify_batch_rlc(clock)
    stage_ms = clock.ms()
    runs = wall[True]
    ms_batch, ms_staged = (statistics.median(wall[k]) for k in (True, False))
    devb, profb = device_summary(profile_device_time(verify_batch_rlc), ms_batch)
    qps = B * v_rlc.Q / (ms_batch / 1e3)
    print(f"[batch-rlc] B={B} x Q={v_rlc.Q} RlcAir proofs (3 batches per "
          f"query): verdicts exact ({len(lanes)} tampered lanes: "
          f"{', '.join(kinds)}), the stage programs' verdicts and samples "
          f"the staged path's; {path_launches['verify_batch_rlc'][AOS]} "
          f"kernel launches; {ms_batch:.1f} ms per batch (median of 3, in "
          f"turns with staged {ms_staged:.1f} ms), {qps:.0f} queries/s; peak"
          f" {peak_gb:.2f} GB (the phase); stage ms: "
          + ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items())
          + f"; {devb}; " + first_calls_text(first_ms) + "; "
          + programs_text(progs))
    report["batch_rlc"] = {"B": B, "Q": v_rlc.Q, "ms_runs": runs,
                           "ms": ms_batch, "staged_ms_runs": wall[False],
                           "staged_ms": ms_staged, "queries_per_s": qps,
                           "peak_allocated_gb": peak_gb, "stage_ms": stage_ms,
                           "launches": path_launches["verify_batch_rlc"],
                           "profile": profb, "first_ms": first_ms,
                           "programs": progs}

    lap("batch-rlc")
    # ---- RlcAir at 2^LOG_N rows
    n_big = 1 << LOG_N
    rng = np.random.default_rng(0x41C20)
    trace = rng.integers(0, P, size=(n_big, 2), dtype=np.uint64)
    big, line, report["prove_rlc"] = measure_prove(
        RlcAir(), trace, fc, "prove_rlc", path_launches, path_shapes,
        profiled=False, rounds=1)
    check(verdict(verify_proof(big, RlcAir(), fc, device=DEVICE))["ok"],
          "RLC 2^20 proof rejected by verify_proof")
    flags = {}
    for kind in ("stage2_sibling", "stage2_local", "stage2_commit"):
        flags[kind] = verdict(verify_proof(tamper(big, kind), RlcAir(), fc,
                                           device=DEVICE))
        check(not flags[kind]["ok"], f"RLC 2^20 proof with {kind} accepted")
    check(not flags["stage2_sibling"]["merkle_ok"],
          "RLC 2^20 flipped stage-2 sibling passed the Merkle check")
    report["prove_rlc"]["tampers"] = flags
    print(f"[prove-rlc] RlcAir at 2^{LOG_N} rows, FriConfig(1, 100, 16): "
          f"{report['prove_rlc']['bytes']} bytes, accepted by verify_proof; a "
          f"flipped stage-2 sibling, a changed stage2_local value and a "
          f"changed stage-2 commitment rejected; " + line)

    drop_programs(RlcAir(), LOG_N, fc)
    lap("prove-rlc")
    # ---- MultisetAir at 2^LOG_N pairs: side B a permutation of side A
    rng = np.random.default_rng(0x5E720)
    va = rng.integers(0, P, size=n_big, dtype=np.uint64)
    perm = rng.permutation(n_big)
    tags = np.arange(1, n_big + 1, dtype=np.uint64)
    trace = np.stack([tags, va, tags[perm], va[perm]], axis=1)
    big, line, report["prove_multiset"] = measure_prove(
        MultisetAir(), trace, fc, "prove_multiset", path_launches,
        path_shapes, profiled=False, rounds=1)
    check(verdict(verify_proof(big, MultisetAir(), fc, device=DEVICE))["ok"],
          "multiset 2^20 proof rejected by verify_proof")
    trace[n_big // 3, 3] = (int(trace[n_big // 3, 3]) + 1) % P
    not_perm = verdict(verify_proof(
        prove(MultisetAir(), trace, fc, device=DEVICE), MultisetAir(), fc,
        device=DEVICE))
    check(not_perm == {"ok": False, "pow_ok": True, "merkle_ok": True,
                       "fold_ok": True, "quotient_ok": False},
          f"multiset 2^20 non-permutation not rejected by its quotient check "
          f"alone: {not_perm}")
    report["prove_multiset"]["non_permutation"] = not_perm
    print(f"[prove-multiset] MultisetAir at 2^{LOG_N} pairs (two quotient "
          f"chunks): {report['prove_multiset']['bytes']} bytes, accepted by "
          f"verify_proof; side B with one value changed proves and is "
          f"rejected by its quotient check alone; " + line)
    del trace, va, perm, tags, big
    drop_programs(MultisetAir(), LOG_N, fc)
    torch.cuda.empty_cache()

    lap("prove-multiset")
    # ---- BatchProver on B_PROVE distinct RLC traces, one lane faulty.  A
    # changed trace still proves RlcAir (its stage-2 column is built from
    # whatever trace is given), so the faulty lane's stage-2 column is
    # changed at one row instead, by a prover that is wrong on that lane.
    bad_lane = B_PROVE // 3
    rng = np.random.default_rng(0xBA7C)
    traces = rng.integers(0, P, size=(B_PROVE, 64, 2), dtype=np.uint64)
    traces[0] = np.asarray(expected_ms["rlc"]["trace"], dtype=np.uint64)

    class FaultyLaneRlc(RlcAir):
        def build_stage2_device(self, cols, challenges):
            s2 = super().build_stage2_device(cols, challenges)
            s2.lo[bad_lane, 0, 9] ^= 1
            return s2

    bp_rlc = BatchProver(FaultyLaneRlc(), 6, fc, device=DEVICE)
    proofs, path_launches["batch_prove_rlc"] = counted(
        lambda: bp_rlc.prove(traces))
    cfg_rlc_b = derive_config(proofs[0], fc)
    got = proof_digest(proofs[0], v_rlc, cfg_rlc_b)
    check(got["sha256"] == expected_ms["rlc"]["sha256"],
          "batch-prove-rlc lane 0 differs from the fixture")
    bv_all = BatchVerifier(RlcAir(), cfg_rlc_b, device=DEVICE)
    oks = bv_all.verify(proofs)
    want = torch.ones(B_PROVE, dtype=torch.bool, device=DEVICE)
    want[bad_lane] = False
    check(torch.equal(oks, want),
          "batch-prove-rlc: BatchVerifier verdicts differ")
    rbad = verdict(verify_proof(proofs[bad_lane], RlcAir(), fc, device=DEVICE))
    check(rbad == {"ok": False, "pow_ok": True, "merkle_ok": True,
                   "fold_ok": True, "quotient_ok": False},
          f"batch-prove-rlc faulty lane not rejected by its quotient check "
          f"alone: {rbad}")
    bp_windows = max(pr.opening_proof.fri_proof.pow_witness
                     for pr in proofs) // grind_window(fc) + 1
    path_shapes["batch_prove_rlc"] = prove_path_shapes(
        6, fc, RlcAir(), B_PROVE, bp_windows)
    check_launches("batch_prove_rlc", path_launches["batch_prove_rlc"],
                   path_shapes["batch_prove_rlc"])
    # staged, as a one-shot batch runs ([batch-prove] measures the
    # programs)
    runs, peak_gb, stage_ms = timed_runs(bp_rlc.prove, traces, fused=False)
    ms_bp = statistics.median(runs)
    print(f"[batch-prove-rlc] B={B_PROVE} distinct 64-row RlcAir traces: lane "
          f"0 equal to the fixture's digest; all {B_PROVE} proofs in one "
          f"BatchVerifier call, {B_PROVE - 1} accepted, lane {bad_lane} "
          f"(stage-2 column changed at one row) rejected by its quotient "
          f"check alone; {ms_bp:.1f} ms per batch (staged, median of 3), "
          f"{B_PROVE / ms_bp * 1e3:.1f} proofs/s; peak {peak_gb:.2f} GB; "
          f"launches {AOS} {path_launches['batch_prove_rlc'][AOS]}, {SOA} "
          f"{path_launches['batch_prove_rlc'][SOA]} ({bp_windows} grind "
          f"windows); stage ms: "
          + ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items()))
    report["batch_prove_rlc"] = {
        "B": B_PROVE, "ms_runs": runs, "ms": ms_bp,
        "proofs_per_s": B_PROVE / ms_bp * 1e3, "peak_allocated_gb": peak_gb,
        "stage_ms": stage_ms, "windows": bp_windows,
        "launches": path_launches["batch_prove_rlc"]}

    lap("batch-prove-rlc")
    # ---- keccak-f[1600] as PyTorch ops, 2^16 states
    rng = np.random.default_rng(0xF1600)
    states = rng.integers(0, 1 << 64, size=(1 << 16, 25), dtype=np.uint64,
                          endpoint=False)
    states[0] = 0
    lanes_kf = keccak_ops.from_u64(states, DEVICE)
    out = keccak_ops.to_u64(keccak_ops.keccak_f(lanes_kf))
    sample = range(0, 1 << 16, 1021)
    for i in sample:
        check(out[i].tolist() == keccak_f_flat(states[i].tolist()),
              f"keccak-f of state {i} differs from refimpl.keccak_f_flat")
    check([int(out[0][i]) for i in (0, 1, 24)] == [
        0xF1258F7940E1DDE7, 0x84D5CCF933C0478A, 0xEAF1FF7B5CECA249],
        "keccak-f of the zero state differs from the known answer")
    kf_ms = cuda_ms(lambda: keccak_ops.keccak_f(lanes_kf), 5)
    print(f"[keccak-f] keccak-f[1600] on 2^16 states (PyTorch ops, 24 "
          f"rounds): {len(sample)} sampled states equal to "
          f"refimpl.keccak_f_flat, the zero state's known answer; "
          f"{kf_ms:.2f} ms per call, {(1 << 16) / kf_ms * 1e3:.0f} keccak-f/s")
    report["keccak_f"] = {"states": 1 << 16, "ms": kf_ms,
                          "sampled": len(sample)}
    del states, lanes_kf, out

    lap("keccak-f")
    # ---- the one-keccak-f proof: the int oracle's fixture, byte for byte
    fc32 = FriConfig(**expected_k32["fri_config"])
    with open(os.path.join(FIXTURES, "proof_keccak32_refimpl.json")) as f:
        k32_text = f.read()
    rows32 = keccak_trace_np([expected_k32["inputs"]])
    p32, path_launches["prove_keccak_32"] = counted(
        lambda: prove(kair, rows32, fc32, device=DEVICE))
    check(compact(p32) == k32_text, "the 32-row Keccak proof differs from "
          "tests/fixtures/proof_keccak32_refimpl.json")
    path_shapes["prove_keccak_32"] = prove_path_shapes(
        5, fc32, kair, 1, p32.opening_proof.fri_proof.pow_witness
        // grind_window(fc32) + 1)
    check_launches("prove_keccak_32", path_launches["prove_keccak_32"],
                   path_shapes["prove_keccak_32"])
    r = verify_proof(p32, kair, fc32, device=DEVICE)
    check(verdict(r) == {k: v for k, v in expected_k32["verdict"].items()
                         if k != "shape_ok"} and r.shape_ok,
          "the 32-row Keccak proof's verdict differs from the fixture's")
    check(ext_int(r.alpha) == expected_k32["alpha"]
          and ext_int(r.zeta) == expected_k32["zeta"]
          and r.query_indices.tolist() == expected_k32["query_indices"],
          "the 32-row Keccak proof's transcript differs from the fixture's")
    k32_program = fused_vs_staged("prove_keccak_32", p32, kair, fc32)
    want_t = {k: v for k, v in
              expected_k32["tamper_a_prime_bit"]["verdict"].items()
              if k != "shape_ok"}
    k32_flags = {kind: verdict(verify_proof(tamper(p32, kind), kair, fc32,
                                            device=DEVICE))
                 for kind in ("a_prime_bit", "trace_leaf")}
    check(k32_flags["a_prime_bit"] == want_t,
          f"a_prime-bit tamper: {k32_flags['a_prime_bit']}, the JAX "
          f"verifier gave {want_t}")
    check(not k32_flags["trace_leaf"]["ok"]
          and not k32_flags["trace_leaf"]["merkle_ok"],
          "a changed trace-leaf value passed the Merkle check")
    print(f"[prove-keccak-32] KeccakAir, 32 rows x {kair.width()} columns, "
          f"FriConfig(1, 20, 8): proof byte-equal to the fixture "
          f"({len(k32_text)} bytes); accepted by verify_proof with the "
          f"fixture's alpha, zeta and query indices; a_prime-bit tamper "
          f"rejected with the JAX verifier's flags {want_t}; changed "
          f"trace-leaf value rejected (merkle_ok False); fused and staged "
          f"alike ({program_text(k32_program)}); launches {AOS} "
          f"{path_launches['prove_keccak_32'][AOS]}, {SOA} "
          f"{path_launches['prove_keccak_32'][SOA]} (as the shape gives)")
    report["prove_keccak_32"] = {"bytes": len(k32_text),
                                 "launches": path_launches["prove_keccak_32"],
                                 "tampers": k32_flags,
                                 "fused_program": k32_program}

    lap("prove-keccak-32")
    # ---- KeccakAir at 2^12 rows: the JAX package's digest, measurements
    n_perm = len(expected_keccak["inputs"])
    t0 = time.perf_counter()
    ktrace = keccak_trace_np(expected_keccak["inputs"], 1 << KECCAK_LOG_N)
    ksetup_s = time.perf_counter() - t0
    kbig, line, report["prove_keccak"] = measure_prove(
        kair, ktrace, fc, "prove_keccak", path_launches, path_shapes,
        profiled=False, rounds=1)
    del ktrace
    cfg_k = derive_config(kbig, fc)
    check(cfg_k == v_keccak.config, "the Keccak proof's shape differs")
    got = proof_digest(kbig, v_keccak, cfg_k)
    for k, val in got.items():
        check(val == expected_keccak[k], f"Keccak 2^{KECCAK_LOG_N} {k} "
              f"differs from the JAX package's")
    steady = statistics.median(report["prove_keccak"]["steady_ms"])
    report["prove_keccak"].update(
        trace_setup_s=ksetup_s, permutations=n_perm,
        keccak_f_per_s=n_perm / (steady / 1e3))
    print(f"[prove-keccak] KeccakAir at 2^{KECCAK_LOG_N} rows x "
          f"{kair.width()} columns ({n_perm} permutations), FriConfig(1, 100, "
          f"16): {report['prove_keccak']['bytes']} bytes, equal to the JAX "
          f"package's digest (sha256, commitments, alpha, zeta, PoW witness, "
          f"query indices); "
          f"{n_perm / (steady / 1e3):.1f} keccak-f/s replayed; trace made in "
          f"{ksetup_s:.1f} s beforehand; " + line)

    drop_programs(kair, KECCAK_LOG_N, fc)
    lap("prove-keccak")
    # ---- verify_proof on that proof

    def verify_keccak():
        return verdict(verify_proof(kbig, kair, fc, device=DEVICE))

    vk_program = fused_vs_staged("verify_keccak", kbig, kair, fc)
    got, path_launches["verify_keccak"] = counted(verify_keccak)
    check(got["ok"], "the Keccak 2^12 proof was rejected by verify_proof")
    check_launches("verify_keccak", path_launches["verify_keccak"],
                   path_shapes["verify_keccak"])
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        check(verify_keccak()["ok"], "the Keccak 2^12 proof was rejected")
        lat.append((time.perf_counter() - t0) * 1e3)
    devk, profk = UNPROFILED, None
    print(f"[verify-keccak] verify_proof of the 2^{KECCAK_LOG_N}-row Keccak "
          f"proof: accepted; {path_launches['verify_keccak'][AOS]} kernel "
          f"launches ({-(-kair.width() // RATE)} sponge chunks per trace "
          f"leaf); latency median {statistics.median(lat):.1f} ms, best "
          f"{min(lat):.1f} ms (host packing of the proof included; the "
          f"fused program, equal to the staged path: "
          f"{program_text(vk_program)}); {devk}")
    report["verify_keccak"] = {"latency_ms": lat,
                               "launches": path_launches["verify_keccak"],
                               "profile": profk, "fused_program": vk_program}

    lap("verify-keccak")
    # ---- BatchVerifier on B_KECCAK copies of that proof, four tampered
    torch.cuda.empty_cache()
    reserved_before = torch.cuda.memory_reserved()
    bvk = BatchVerifier(kair, cfg_k, device=DEVICE)
    check(bvk.base is v_keccak, "the Keccak verifier was not the shape's")
    wk = pack_witness(kbig, cfg_k, DEVICE)
    lanes = [3, B_KECCAK // 3, 2 * B_KECCAK // 3, B_KECCAK - 1]
    bad = {lane: pack_witness(tamper(kbig, kind), cfg_k, DEVICE)
           for lane, kind in zip(lanes, TAMPERED)}
    wsk = stack_witnesses([bad.get(b, wk) for b in range(B_KECCAK)])
    del wk, bad
    want = torch.ones(B_KECCAK, dtype=torch.bool, device=DEVICE)
    want[lanes] = False

    def verify_batch_keccak(on_stage=None, fused=None):
        return bvk.verify_witnesses(wsk, on_stage, fused=fused)

    torch.cuda.reset_peak_memory_stats()
    first_ms, progs = batch_first_calls("batch-keccak", bvk, wsk, want)
    ok, path_launches["verify_batch_keccak"] = counted(verify_batch_keccak)
    check(torch.equal(ok, want), "batch-keccak verdicts differ")
    check_launches("verify_batch_keccak", path_launches["verify_batch_keccak"],
                   path_shapes["verify_batch_keccak"])
    wall = in_turns(lambda fused: check(torch.equal(
        verify_batch_keccak(fused=fused), want),
        "batch-keccak verdicts differ"), 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    clock = StageClock()
    verify_batch_keccak(clock)
    stage_ms = clock.ms()
    runs = wall[True]
    ms_batch, ms_staged = (statistics.median(wall[k]) for k in (True, False))
    devb, profb = UNPROFILED, None
    qps = B_KECCAK * v_keccak.Q / (ms_batch / 1e3)
    print(f"[batch-keccak] B={B_KECCAK} x Q={v_keccak.Q} KeccakAir 2^"
          f"{KECCAK_LOG_N} proofs: verdicts exact ({len(lanes)} tampered "
          f"lanes: {', '.join(TAMPERED)}), the stage programs' verdicts and "
          f"samples the staged path's; "
          f"{path_launches['verify_batch_keccak'][AOS]} kernel launches; "
          f"{ms_batch:.1f} ms per batch (median of 2, in turns with staged "
          f"{ms_staged:.1f} ms), {qps:.0f} queries/s, "
          f"{B_KECCAK / (ms_batch / 1e3):.1f} proofs/s; peak {peak_gb:.2f} GB"
          f" (the phase); stage ms: "
          + ", ".join(f"{k} {t:.1f}" for k, t in stage_ms.items())
          + f"; {devb}; " + first_calls_text(first_ms) + "; "
          + programs_text(progs))
    report["batch_keccak"] = {
        "B": B_KECCAK, "Q": v_keccak.Q, "ms_runs": runs, "ms": ms_batch,
        "staged_ms_runs": wall[False], "staged_ms": ms_staged,
        "queries_per_s": qps, "peak_allocated_gb": peak_gb,
        "stage_ms": stage_ms, "launches": path_launches["verify_batch_keccak"],
        "profile": profb, "first_ms": first_ms, "programs": progs}
    # the programs, their pool and buffers go with their BatchVerifier,
    # before the provers' phases
    del bvk, wsk, kbig
    torch.cuda.empty_cache()
    reserved_after = torch.cuda.memory_reserved()
    pools = sum(st["pool_bytes"] for st in progs.values())
    check(reserved_after - reserved_before < pools / 4,
          f"batch-keccak: {(reserved_after - reserved_before) / 2**20:.0f} "
          f"MiB more reserved after the phase than before it (the programs' "
          f"pools: {pools / 2**20:.0f} MiB)")
    print(f"[batch-keccak] its BatchVerifier dropped: "
          f"{reserved_before / 2**30:.2f} GiB reserved before the phase, "
          f"{reserved_after / 2**30:.2f} GiB after (the programs' pools "
          f"{pools / 2**30:.2f} GiB)")
    report["batch_keccak"].update(reserved_before=reserved_before,
                                  reserved_after=reserved_after)

    lap("batch-keccak")
    # ---- the 2^12 Keccak trace with every memory strategy at once
    ktraces = keccak_traces(expected_keccak["inputs"], B_KECCAK_PROVE)
    kp = TorchProver(kair, KECCAK_LOG_N, fc, DEVICE,
                     quotient_eval_chunks=S_KECCAK, quotient_col_groups=4)
    kp.commit_col_chunks = 4
    kp._ro_col_slab = kp._bary_col_slab = 256
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kch, path_launches["prove_keccak_chunked"] = counted(
        lambda: kp.prove(ktraces[0]))
    ch_ms = (time.perf_counter() - t0) * 1e3
    ch_peak = torch.cuda.max_memory_allocated() / 1e9
    got = proof_digest(kch, v_keccak, cfg_k)
    for k, val in got.items():
        check(val == expected_keccak[k], f"chunked Keccak 2^{KECCAK_LOG_N} "
              f"{k} differs from the JAX package's")
    path_shapes["prove_keccak_chunked"] = prove_path_shapes(
        KECCAK_LOG_N, fc, kair, 1, kch.opening_proof.fri_proof.pow_witness
        // grind_window(fc) + 1)
    check_launches("prove_keccak_chunked",
                   path_launches["prove_keccak_chunked"],
                   path_shapes["prove_keccak_chunked"])
    del kch
    off = unchunked_prover(kair, KECCAK_LOG_N, fc)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with no_slab_budget():
        off.prove_columns(trace_columns(ktraces[:2], DEVICE))
    torch.cuda.synchronize()
    b2_peak = torch.cuda.max_memory_allocated() / 1e9
    del off
    torch.cuda.empty_cache()
    print(f"[prove-keccak-chunked] KeccakAir 2^{KECCAK_LOG_N} x {kair.width()}"
          f" with S={kp.quotient_eval_chunks} quotient segments, "
          f"{kp.quotient_col_groups} column groups, {kp.commit_col_chunks} LDE"
          f" column chunks and both slabs at {kp._ro_col_slab} columns: equal "
          f"to the JAX package's digest (sha256 {got['sha256'][:16]}..., "
          f"commitments, alpha, zeta, PoW witness, query indices); "
          f"{ch_ms:.1f} ms (first call of this prover); peak "
          f"{ch_peak:.2f} GB (the unchunked [prove-keccak] proof's: "
          f"{report['prove_keccak']['peak_allocated_gb']:.2f} GB); unchunked "
          f"B=2 peak {b2_peak:.2f} GB; launches {AOS} "
          f"{path_launches['prove_keccak_chunked'][AOS]}, {SOA} "
          f"{path_launches['prove_keccak_chunked'][SOA]} (as the shape gives)")
    report["prove_keccak_chunked"] = {
        "ms": ch_ms, "peak_allocated_gb": ch_peak,
        "unchunked_b2_peak_allocated_gb": b2_peak,
        "launches": path_launches["prove_keccak_chunked"]}

    lap("prove-keccak-chunked")
    # ---- BatchProver at B=8 x 2^12 x 2,633, S=4
    bpk = BatchProver(kair, KECCAK_LOG_N, fc, device=DEVICE,
                      quotient_eval_chunks=S_KECCAK)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bk_reserved_before = torch.cuda.memory_reserved() / 2**30
    torch.cuda.reset_peak_memory_stats()
    (kproofs, path_shapes["prove_batch_keccak"], bk_first_ms, bk_counts,
     bk_progs) = first_proofs("prove_batch_keccak", bpk.base, B_KECCAK_PROVE,
                              lambda: bpk.prove(ktraces))
    bk_first = bk_first_ms["staged"]
    bk_peak = torch.cuda.max_memory_allocated() / 1e9
    path_launches["prove_batch_keccak"] = bk_counts["replay"]
    got = proof_digest(kproofs[0], v_keccak, cfg_k)
    for k, val in got.items():
        check(val == expected_keccak[k], f"batch-prove-keccak lane 0 {k} "
              f"differs from the JAX package's")
    bvk8 = BatchVerifier(kair, cfg_k, device=DEVICE)
    lanes8 = kproofs + [tamper(kproofs[1], "final_poly")]
    runs = 1                # a BatchVerifier's first batch is staged
    oks, path_launches["verify_batch_prove_keccak"] = counted(
        lambda: bvk8.verify(lanes8))
    check(oks.tolist() == [True] * B_KECCAK_PROVE + [False],
          f"batch-prove-keccak: BatchVerifier verdicts {oks.tolist()}")
    path_shapes["verify_batch_prove_keccak"][AOS] = scaled(
        path_shapes["verify_batch_prove_keccak"][AOS], runs)
    check_launches("verify_batch_prove_keccak",
                   path_launches["verify_batch_prove_keccak"],
                   path_shapes["verify_batch_prove_keccak"])
    bk_windows = max(pr.opening_proof.fri_proof.pow_witness
                     for pr in kproofs) // grind_window(fc) + 1
    del lanes8, bvk8
    # the staged batch runs with the programs dropped: beside their
    # pools it would reserve nearly the whole card
    bk_turns = prove_turns("prove_batch_keccak", lambda fused, clock:
                           bpk.prove(ktraces, clock, fused=fused), 1,
                           kproofs, False, release=bpk.release_programs)
    bk_ms = bk_turns["replay"]["median_ms"]
    bk_pools = sum(st["pool_bytes"] for st in bk_progs.values()) / 2**30
    bpk.release_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    bk_reserved_after = torch.cuda.memory_reserved() / 2**30
    check(bk_reserved_after - bk_reserved_before < 0.5,
          f"batch-prove-keccak: {bk_reserved_after:.2f} GiB reserved once the"
          f" programs were dropped, {bk_reserved_before:.2f} GiB before")
    other = B_KECCAK_PROVE // 2
    check(prove(kair, ktraces[other], fc, device=DEVICE) == kproofs[other],
          f"batch-prove-keccak lane {other} differs from the port's single "
          f"proof of its trace")
    del kproofs
    kfs = B_KECCAK_PROVE * n_perm / (bk_ms / 1e3)
    kfs_staged = (B_KECCAK_PROVE * n_perm
                  / (bk_turns["staged"]["median_ms"] / 1e3))
    lk = path_launches["prove_batch_keccak"]
    print(f"[batch-prove-keccak] BatchProver, B={B_KECCAK_PROVE} x 2^"
          f"{KECCAK_LOG_N} x {kair.width()} KeccakAir traces (the fixture's "
          f"and {B_KECCAK_PROVE - 1} of seeded inputs), S={S_KECCAK}, default "
          f"groups and slabs: lane 0 equal to the JAX digest, lane {other} "
          f"byte-equal to the single proof of its trace, all "
          f"{B_KECCAK_PROVE} accepted by one BatchVerifier call and a "
          f"tampered copy (final_poly) rejected; first batches: "
          + ", ".join(f"{how} {t:.1f} ms" for how, t in bk_first_ms.items())
          + f" (peak {bk_peak:.2f} GB), each byte-equal; {kfs:.1f} keccak-f/s"
          f" replayed, {kfs_staged:.1f} staged; launches {AOS} "
          f"{lk[AOS]} ({lk[AOS + '.states']} states), {SOA} {lk[SOA]} "
          f"({lk[SOA + '.states']} states; {bk_windows} grind windows) "
          f"staged and replayed, as the "
          f"shape gives, at the capture {AOS} {bk_counts['capture'][AOS]}, "
          f"{SOA} {bk_counts['capture'][SOA]}; "
          + prover_programs_text(bk_progs) + f"; {turns_text(bk_turns)}; "
          f"reserved {bk_reserved_before:.2f} GiB before the phase, "
          f"{bk_reserved_after:.2f} GiB once the programs were dropped")
    report["batch_prove_keccak"] = {
        "B": B_KECCAK_PROVE, "S": S_KECCAK, "first_ms": bk_first,
        "first_calls_ms": bk_first_ms, "steady_ms": bk_turns["replay"]["ms"],
        "ms": bk_ms, "keccak_f_per_s": kfs, "keccak_f_per_s_staged":
        kfs_staged, "peak_allocated_gb": bk_peak,
        "stage_ms": bk_turns["replay"]["stage_ms"], "turns": bk_turns,
        "programs": bk_progs, "pools_gib": bk_pools,
        "reserved_before_gib": bk_reserved_before,
        "reserved_after_gib": bk_reserved_after,
        "windows": bk_windows, "launches": lk,
        "launches_by_plan": bk_counts,
        "verify_launches": path_launches["verify_batch_prove_keccak"],
        "profile": None}
    del bpk, ktraces
    torch.cuda.empty_cache()

    lap("batch-prove-keccak")
    # ---- GF(p^3) on the card against the int oracle
    rng = np.random.default_rng(0x6F3)
    n3 = 4096
    a3, b3 = (rng.integers(0, P, size=(3, n3), dtype=np.uint64)
              for _ in range(2))
    a3[:, :4] = [[0, 1, P - 1, 1 << 32]] * 3
    x3, y3 = (gl3.GL3(*(gl.from_u64(c, DEVICE) for c in v)) for v in (a3, b3))
    rows_a = [tuple(int(v) for v in a3[:, i]) for i in range(n3)]
    rows_b = [tuple(int(v) for v in b3[:, i]) for i in range(n3)]

    def gl3_ints(x):
        cs = [gl.to_u64(c).tolist() for c in x]
        return [tuple(t) for t in zip(*cs)]

    gl3_ms = {}
    for name, fn, want in (
            ("mul", lambda: gl3.mul(x3, y3),
             [Gl3.mul(u, v) for u, v in zip(rows_a, rows_b)]),
            ("inv", lambda: gl3.inv(y3), [Gl3.inv(v) for v in rows_b]),
            ("div", lambda: gl3.div(x3, y3),
             [Gl3.div(u, v) for u, v in zip(rows_a, rows_b)])):
        check(gl3_ints(fn()) == want, f"GF(p^3) {name} on the card differs "
              f"from the int Gl3")
        gl3_ms[name] = cuda_ms(fn, 5)
    print(f"[gl3] GF(p^3) mul, inv and div on {n3} seeded values on the card "
          f"(edge values 0, 1, p - 1, 2^32 among them) equal to the int Gl3; "
          f"ms per call " + ", ".join(f"{k} {t:.3f}" for k, t in gl3_ms.items()))
    report["gl3"] = {"n": n3, "ms": gl3_ms}

    lap("gl3")
    attestation_phases(att, proof, fc, cfg, path_launches,
                       path_shapes, report, lap)
    composed_phases(att, proof, fc, path_launches, path_shapes,
                    report, lap)
    multi_device_phases(proof, fc, cfg, fixture_text, expected, *batch_in,
                        prove_sha, path_launches, path_shapes,
                        report, lap)
    del batch_in
    line, report["graphs"] = graphs_summary()
    print(line)
    # ---- each kernel at each path's shapes
    clk_hz = max_sm_mhz * 1e6
    timed = {}

    def time_kernel(kernel, n):
        if (kernel, n) not in timed:
            lane_major = kernel == SOA
            s = random_states(n, n, lane_major)
            fn, plain = ((p2.poseidon2_permute_soa, p2.poseidon2_permute_soa_plain)
                         if lane_major else
                         (p2.poseidon2_permute, p2.poseidon2_permute_plain))
            bound, bound_by = poseidon2_bound_ms(n, sms, clk_hz)
            timed[kernel, n] = {
                "states": n,
                "ms": cuda_ms(lambda: fn(s), 20 if n < 10**5 else 5),
                "plain_ms": once_ms(lambda: plain(s)),
                "bound_ms": bound, "bound_by": bound_by,
                "sass_bound_ms": poseidon2_bound_ms(
                    n, sms, clk_hz, mixes[kernel])[0]}
            del s
            torch.cuda.empty_cache()
        return timed[kernel, n]

    paths = {AOS: {}, SOA: {}}
    for path, shapes in path_shapes.items():
        for kernel in (AOS, SOA):
            rows = [dict(time_kernel(kernel, n), launches=c)
                    for n, c in sorted(shapes[kernel].items())]
            tot = {k: sum(r["launches"] * r[k] for r in rows)
                   for k in ("ms", "plain_ms", "bound_ms", "sass_bound_ms")}
            ops = sum(r["launches"] * r["bound_ms"] for r in rows
                      if r["bound_by"] == "operations")
            paths[kernel][path] = dict(
                tot, launches=path_launches[path][kernel],
                bound_by="operations" if 2 * ops >= tot["bound_ms"] else "bytes",
                per_launch=rows)
    same_n = {k: time_kernel(k, 1 << 21) for k in (AOS, SOA)}
    print(f"[timing] at 2^21 states (the trace tree's leaf hash): {AOS} "
          f"{same_n[AOS]['ms']:.3f} ms, {SOA} {same_n[SOA]['ms']:.3f} ms, "
          f"bound {same_n[SOA]['bound_ms']:.3f} ms from the permutation's "
          f"arithmetic ({P2_OPS['total']} instructions, "
          f"{clocks_per_state(P2_OPS):.1f} clocks per state), "
          f"{same_n[AOS]['sass_bound_ms']:.3f} and "
          f"{same_n[SOA]['sass_bound_ms']:.3f} ms at the kernels' own SASS "
          f"counts; per path (ms / bound_ms): "
          + "; ".join(f"{k} {p} {v['ms']:.2f}/{v['bound_ms']:.2f}"
                      for k in (AOS, SOA) for p, v in paths[k].items()
                      if v["launches"]))
    # each variant at the latency-bound sizes, across the crossover and at
    # 2^21, whatever the launcher would choose there: CUDA events around
    # the calls (host time of the wrapper included) and the device time
    # of the kernel alone
    variant_ms = {AOS: {}, SOA: {}}
    for kernel in (AOS, SOA):
        fn = (p2._poseidon2_permute_soa_variant if kernel == SOA else
              p2._poseidon2_permute_variant)
        for n in sorted(set(SMALL_N + CROSSOVER_N + (1 << 21,))):
            s = random_states(n, n, kernel == SOA)
            reps = 25 if n < 10**5 else 5
            variant_ms[kernel][n] = {
                f"{var}{key}": timer(lambda: fn(s, var == "split"), reps)
                for var in ("whole", "split")
                for key, timer in (("", cuda_ms),
                                   ("_device", kernel_device_ms))}
            del s
            torch.cuda.empty_cache()

    def faster(t, var, other):
        measured = None not in (t[var + "_device"], t[other + "_device"])
        key = "_device" if measured else ""
        return t[var + key] < t[other + key]

    crossover = {k: max([n for n, t in variant_ms[k].items()
                         if faster(t, "split", "whole")], default=0)
                 for k in (AOS, SOA)}

    def fmt(x):
        return "not measured" if x is None else f"{x:.4f}"

    for kernel in (AOS, SOA):
        print(f"[timing] {kernel} variants, ms whole / split (events; device"
              f" time alone): "
              + ", ".join(f"N={n} {t['whole']:.4f}/{t['split']:.4f} "
                          f"({fmt(t['whole_device'])}/"
                          f"{fmt(t['split_device'])})"
                          for n, t in variant_ms[kernel].items())
              + f"; split faster up to N={crossover[kernel]} of these, the "
              f"launcher splits N <= {split_max[kernel]}")
    kernel_rows = []
    for kernel, src, rep, err in (
            (AOS, p2.KERNEL_SOURCE, p2.REPLACES, err_aos),
            (SOA, p2.SOA_KERNEL_SOURCE, p2.SOA_REPLACES, err_soa)):
        main_path = paths[kernel][MAIN_PATH]
        kernel_rows.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": rep,
            "launches": main_path["launches"],
            "launches_by_path": {p: v["launches"]
                                 for p, v in paths[kernel].items()},
            "bit_equal": err == 0, "max_abs_err": float(err), "tolerance": 0,
            "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"],
            "bound_by": main_path["bound_by"], "library_ms": None,
            "sass_bound_ms": main_path["sass_bound_ms"],
            "at_2_pow_21": same_n[kernel], "paths": paths[kernel],
            "split_max_states": split_max[kernel],
            "main_path": MAIN_PATH,
            "states": path_launches[MAIN_PATH][kernel + ".states"],
            "states_by_path": {p: v[kernel + ".states"]
                               for p, v in path_launches.items()},
            "variant_ms": variant_ms[kernel],
            "split_faster_up_to": crossover[kernel],
            "sass_alu_per_state": {
                var: (3 if var == "split" else 1) * m["alu_pipe"]
                for var, m in report["build"][kernel]["sass"].items()},
        })
    report["kernels"] = kernel_rows
    by_path = {p: sum(v[FIELD].values()) for p, v in path_launches.items()}
    for p in (MAIN_PATH, "verify_batch", "verify_batch_keccak"):
        check(by_path[p] > 0, f"{p}: no field kernel launched")
    print("[field] launches by path (field.*.launches, as counted): "
          + ", ".join(f"{p} {n}" for p, n in by_path.items()))
    report["field_launches_by_path"] = {p: v[FIELD]
                                        for p, v in path_launches.items()}
    lap("timing")
    tooling_phase(proof, fc, cfg, verify_batch, want_batch,
                  report["batch"]["queries_per_s"], same_n, sms, clk_hz,
                  report)
    lap("tooling")
    return finish(report, args, t_start, kernel_rows)


def finish(report, args, t_start, kernel_rows):
    """Write the report (--report), print the kernel table line and the
    last line; the script's exit code."""
    report["seconds"] = time.perf_counter() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
