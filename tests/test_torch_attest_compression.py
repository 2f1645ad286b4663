"""The in-trace recomputation rows of attest_program (the composed
attestations' building blocks, not yet driven on the card): held at the
trace level on the CPU.  build_compression_rows of the fib(8) schedule of
artifacts/attestation_small.json equals the JAX package's row by row, and
its trace, built by the port (the 'w' runs through the gamma sponge's
chain, one recorded step per pair), satisfies every VerifierAir
constraint: so its 'g' row's permutation output is the bundle's gammas,
re-derived inside the trace.  make_zero_proof equals JAX's.  The 'w' runs
are 256 sequential plain permutations of 5 states on the CPU (about 20 s).
"""

import json
import os

import numpy as np
import pytest
import torch

import plonky25_torch.attest as A
import plonky25_torch.attest_program as ap
from plonky25_torch.air import Main, VerifierConstraintFolder
from plonky25_torch.fields import gl, gl2
from plonky25_torch.models import FibonacciAir
from plonky25_torch.models.verifier_air import VerifierAir
from plonky25_torch.proof import (FriConfig, derive_config, proof_from_json,
                                  proof_to_json)
from plonky25_torch.refimpl.verifier import verify as ref_verify
from plonky25_torch.verifier import _publics
import plonky25_tpu.attest_program as jap
from plonky25_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from plonky25_tpu.proof import FriConfig as JFriConfig
from plonky25_tpu.proof import derive_config as j_derive_config
from plonky25_tpu.proof import proof_from_json as j_proof_from_json
from plonky25_tpu.proof import proof_to_json as j_proof_to_json

P = 0xFFFFFFFF00000001
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's PyTorch work (the test run
    shares the CPU between several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts():
    """The fib(8) schedule of both packages, and the bundle's gamma/acc."""
    with open(os.path.join(ROOT, "artifacts", "attestation_small.json")) as f:
        d = json.load(f)
    fc = FriConfig(**d["fc"])
    proof = proof_from_json(d["proofs"][0])
    jproof = j_proof_from_json(d["proofs"][0])
    ch = A._RecordingChallenger()
    assert ref_verify(proof, FibonacciAir(), fc, challenger=ch).ok
    rows = ap.build_verification_schedule(
        proof, derive_config(proof, fc), FibonacciAir(), ch.samples)
    jrows = jap.build_verification_schedule(
        jproof, j_derive_config(jproof, JFriConfig(**d["fc"])),
        JFibonacciAir(), ch.samples)
    return (rows, jrows, tuple(d["bundle"]["gamma"]),
            tuple(d["bundle"]["acc"]), proof, jproof, fc)


def _violations(air, trace: np.ndarray):
    """Rows where any constraint of `air` is nonzero (local row i, next
    row i + 1 cyclically; selectors as on the trace domain)."""
    h = trace.shape[0]

    def ext(a):
        return gl2.from_base(gl.from_u64(np.ascontiguousarray(a.T), "cpu"))

    def sel(vals):
        return gl2.from_base(gl.from_u64(np.asarray(vals, np.uint64), "cpu"))

    folder = VerifierConstraintFolder(
        ops=gl2.Ops((h,), "cpu"),
        main=Main(ext(trace), ext(np.roll(trace, -1, axis=0))),
        is_first_row=sel([1] + [0] * (h - 1)),
        is_last_row=sel([0] * (h - 1) + [1]),
        is_transition=sel([1] * (h - 1) + [0]),
        alpha=gl2.zeros((), "cpu"),
        publics=_publics(air, "cpu"))
    air.eval(folder)
    bad = torch.zeros(h, dtype=torch.bool)
    for c in folder._constraints:
        nz = ((c.c0.lo != 0) | (c.c0.hi != 0) | (c.c1.lo != 0)
              | (c.c1.hi != 0))
        bad |= nz.reshape(-1, h).any(0) if nz.dim() > 1 else nz.expand(h)
    return set(torch.nonzero(bad).reshape(-1).tolist())


def test_compression_rows_match_jax_and_rederive_the_gammas(parts):
    rows, jrows, gamma, acc = parts[:4]
    comp = ap.build_compression_rows(len(rows), ap.sequence_pairs(rows),
                                     ap.pair_exponents(rows), gamma, acc)
    jcomp = jap.build_compression_rows(len(jrows), jap.sequence_pairs(jrows),
                                       jap.pair_exponents(jrows), gamma, acc)
    assert [vars(r) for r in comp] == [vars(r) for r in jcomp]
    assert sum(r.sel == "w" for r in comp) == ap.padded_pair_count(
        len(ap.sequence_pairs(rows)))
    # any gammas bind the outer accumulator: the trace's columns and the
    # AIR's publics are made with the same ones
    outer = (3, 5)
    trace = ap.build_trace_rowmajor(comp, outer, device="cpu")
    air = VerifierAir({"gamma": outer,
                       "acc": ap.fold_accumulator(comp, outer)})
    assert _violations(air, trace) == set()
    g_row = next(i for i, r in enumerate(comp) if r.sel == "g")
    bad = trace.copy()
    bad[g_row - 1, 0] = (int(bad[g_row - 1, 0]) + 1) % P
    assert _violations(air, bad)


def test_zero_proof_matches_jax(parts):
    proof, jproof, fc = parts[4:]
    zero = ap.make_zero_proof(derive_config(proof, fc))
    jzero = jap.make_zero_proof(j_derive_config(jproof, JFriConfig(
        fc.log_blowup, fc.num_queries, fc.proof_of_work_bits)))
    assert json.dumps(proof_to_json(zero)) == json.dumps(j_proof_to_json(jzero))
