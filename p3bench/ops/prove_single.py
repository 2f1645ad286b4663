"""Single proofs: TorchProver.prove_columns on one trace per call, replaying
its stage programs, one caller in a closed loop (a prover draining a
backlog of traces of one shape).

Inputs, from the seed: `distinct_traces` traces made by the reference's
trace builder, uploaded once in set-up and used in turn.  Set-up warms the
prover up, which captures its stage programs, so the first timed proof
replays them.

Timed: the call, with the proof's assembly on the host.  Judged:
`checked_proofs` proofs of the window, drawn from the seed, each verified
by the plain reference and required to open, at the reference's zeta, the
trace it was given; and every proof of the window equal to the first one
of its trace (proving is deterministic)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from p3bench.harness import shapes
from p3bench.harness.core import load_object


def digest(proof) -> tuple:
    """The values that fix a proof: its commitments, final polynomial and
    PoW witness, and its openings at zeta."""
    fp = proof.opening_proof.fri_proof
    return (tuple(proof.commitments.trace.value),
            tuple(proof.commitments.quotient_chunks.value),
            tuple(tuple(c.value) for c in fp.commit_phase_commits),
            tuple(fp.final_poly), fp.pow_witness,
            tuple(map(tuple, proof.opened_values.trace_local)))


class Op:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.outputs: List = []       # (trace index, proof)
        self.stats: Dict = {}
        self.phases: Dict[str, float] = {}   # set-up seconds by phase

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    def setup(self):
        t = time.perf_counter()
        import torch
        from plonky25_torch.proof import FriConfig
        from plonky25_torch.prover.prove import (TorchProver,
                                                 quotient_eval_chunks_for,
                                                 trace_columns)

        c = self.config
        self.air = load_object(c["air"]["program"])()
        self.fc = FriConfig(**c["fri"])
        if self.device == "cuda":
            torch.zeros(1, device=self.device)      # the CUDA context
        t = self._phase("imports", t)
        build = load_object(c["trace_builder"])
        rng = np.random.default_rng([self.seed, 2])
        self.traces = [build(rng, c["log_n"])
                       for _ in range(self.traffic["distinct_traces"])]
        t = self._phase("traces", t)
        self.cols = [trace_columns([tr], self.device) for tr in self.traces]
        self.prover = TorchProver(
            self.air, c["log_n"], self.fc, self.device,
            quotient_eval_chunks_for(self.air, c["log_n"]))
        t = self._phase("upload", t)
        if self.device == "cuda":
            # captures the stage programs: the first timed proof replays
            self.prover.warmup()
            torch.cuda.synchronize()
            if self.prover.plan(self.cols[0]) != "replay":
                raise RuntimeError("the prover's warm-up left nothing to "
                                   "replay")
        self._phase("capture", t)
        self.stats = {k: dict(p.stats)
                      for k, p in self.prover.programs().items()}

    # ------------------------------------------------------------ timed
    def prove(self, cols, on_stage):
        """The timed path: one proof, assembled on the host."""
        return self.prover.prove_columns(cols, on_stage)[0]

    def call(self, i: int, on_stage=None) -> int:
        k = i % len(self.cols)
        self.outputs.append((k, self.prove(self.cols[k], on_stage)))
        return 1

    def release(self):
        import torch

        self.prover.release_programs()
        self.prover = self.cols = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ judged
    def check(self) -> Dict:
        from plonky25_torch.proof import proof_to_json

        from p3bench.reference import lde
        from p3bench.reference import proof as rp
        from p3bench.reference.verifier import verify_many

        c = self.config
        rng = np.random.default_rng([self.seed, 4])
        n = len(self.outputs)
        picks = sorted(rng.choice(n, min(self.traffic["checked_proofs"], n),
                                  replace=False).tolist()) if n else []
        proofs = [rp.proof_from_json(proof_to_json(self.outputs[i][1]))
                  for i in picks]
        trs = verify_many(proofs, load_object(c["air"]["reference"])(),
                          rp.FriConfig(**c["fri"]))
        rejected = sum(not tr.ok for tr in trs)
        unbound = 0
        for i, p, tr in zip(picks, proofs, trs):
            want = lde.evaluate(self.traces[self.outputs[i][0]], tr.zeta)
            unbound += want != [tuple(v) for v in p.opened_values.trace_local]
        first: Dict[int, tuple] = {}
        differ = 0
        for k, proof in self.outputs:
            d = digest(proof)
            differ += first.setdefault(k, d) != d
        return {"correct": n > 0 and rejected == 0 and unbound == 0
                and differ == 0,
                "attempted": n, "failed": differ + rejected + unbound,
                "checks": {"proofs_rejected": (rejected, 0),
                           "proofs_not_of_their_trace": (unbound, 0),
                           "proofs_differing_on_one_trace": (differ, 0)}}

    # ------------------------------------------------------------ counts
    def poseidon2_states(self, calls) -> int:
        """Lane-major Poseidon2 states the given calls' proofs needed (the
        grind tries windows until one holds the proof's witness)."""
        c, fc = self.config, self.fc
        qd = getattr(self.air, "quotient_degree", lambda: 1)()
        total = 0
        for _, proof in calls:
            windows = (proof.opening_proof.fri_proof.pow_witness
                       // shapes.grind_window(fc.proof_of_work_bits) + 1)
            total += shapes.total_states(shapes.prove_states(
                c["log_n"], fc.log_blowup, fc.proof_of_work_bits,
                self.air.width(), 1 << (qd - 1).bit_length(), 1, windows,
                self.air.stage2_width()))
        return total

    def rates(self, proofs_per_s: float) -> Dict:
        out = {}
        if "permutations_per_trace" in self.config:
            out["keccak_f_per_s"] = (proofs_per_s
                                     * self.config["permutations_per_trace"])
        return out

    def program_stats(self) -> Dict:
        return self.stats
