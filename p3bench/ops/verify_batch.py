"""Batch verification: BatchVerifier.verify_witnesses on batches of B
lanes, one caller in a closed loop (an aggregator draining a backlog of
proofs of one shape).

Inputs, from the seed: the configuration's proofs (its proof file, or
`distinct_proofs` proved by the port in set-up from seeded traces), tiled
over the lanes in a seeded order, and one proof the port makes in set-up
of a trace that breaks the AIR (the configuration's `broken_trace`): it
passes the transcript, Merkle, proof-of-work and FRI checks, and only the
constraint check at zeta rejects it.  In each of `distinct_batches`
batches, `tampered_per_batch` lanes, half in each half of the batch, are
bad: the four tamper kinds and the broken proof in turn, in a seeded
order, each at a seeded position.  The batches are packed and stacked on
the device in set-up and used in turn, so each call's verdict vector
differs from the last.

Timed: the call and the verdicts' copy to the host.  Judged: every lane of
every timed call against the reference's verdict on the same proof."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from p3bench.harness import shapes
from p3bench.harness.core import load_json, load_object
from p3bench.harness.tamper import KINDS, tamper

# what a bad lane holds: a tampered copy of its proof, or the broken proof
LANE_KINDS = KINDS + ("constraint",)


class Op:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.outputs: List = []          # (batch index, verdicts (B,) bool)
        self.stats: Dict = {}
        self.phases: Dict[str, float] = {}   # set-up seconds by phase
        self._traces = None              # the reference's, once computed

    def _phase(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t
        return now

    # ------------------------------------------------------------ set-up
    def _prove(self, traces) -> List[Dict]:
        """The port's proofs of row-major traces, as JSON trees (staged:
        set-up proves only a few, and holds no prover programs after)."""
        from plonky25_torch.proof import proof_to_json
        from plonky25_torch.prover.prove import (TorchProver,
                                                 quotient_eval_chunks_for,
                                                 trace_columns)

        log_n = self.config["log_n"]
        prover = TorchProver(self.air, log_n, self.fc, self.device,
                             quotient_eval_chunks_for(self.air, log_n))
        return [proof_to_json(prover.prove_columns(
            trace_columns([t], self.device), fused=False)[0])
            for t in traces]

    def _originals(self) -> List[Dict]:
        """The valid proofs' JSON trees: the configuration's file, or
        proofs the port makes now from seeded traces."""
        c = self.config
        if "proof_file" in c:
            return [load_json(c["proof_file"])]
        build = load_object(c["trace_builder"])
        rng = np.random.default_rng([self.seed, 3])
        return self._prove([build(rng, c["log_n"])
                            for _ in range(self.traffic["distinct_proofs"])])

    def setup(self):
        t = time.perf_counter()
        import torch
        from plonky25_torch.parallel.batch import BatchVerifier
        from plonky25_torch.proof import FriConfig, derive_config, proof_from_json
        from plonky25_torch.utils.tree import tree_map
        from plonky25_torch.witness import pack_witness

        c, tr = self.config, self.traffic
        self.air = load_object(c["air"]["program"])()
        self.fc = FriConfig(**c["fri"])
        if self.device == "cuda":
            torch.zeros(1, device=self.device)      # the CUDA context
        t = self._phase("imports", t)
        originals = self._originals()
        t = self._phase("prove_originals", t)
        broken = self._prove([load_object(c["broken_trace"])(
            np.random.default_rng([self.seed, 5]), c["log_n"])])[0]
        t = self._phase("prove_broken", t)
        rng = np.random.default_rng([self.seed, 1])
        B, k = tr["batch"], tr["tampered_per_batch"]
        # JSON trees; a lane holds an index: the originals, the broken
        # proof, then the tampered copies
        self.inputs = list(originals) + [broken]
        self.n_originals = len(originals)
        self.broken = len(originals)
        self.lanes = []                  # per batch: input index per lane
        for _ in range(tr["distinct_batches"]):
            lanes = rng.permutation(np.arange(B) % len(originals))
            half = B // 2
            picks = np.concatenate([
                rng.choice(half, k // 2, replace=False),
                half + rng.choice(B - half, k - k // 2, replace=False)])
            first = int(rng.integers(len(LANE_KINDS)))
            kinds = [LANE_KINDS[(first + j) % len(LANE_KINDS)]
                     for j in rng.permutation(k)]
            for lane, kind in zip(picks, kinds):
                if kind == "constraint":
                    lanes[lane] = self.broken
                    continue
                self.inputs.append(tamper(self.inputs[lanes[lane]], kind, rng))
                lanes[lane] = len(self.inputs) - 1
            self.lanes.append(lanes)
        t = self._phase("tamper", t)

        proofs = [proof_from_json(d) for d in self.inputs]
        t = self._phase("parse", t)
        self.cfg = derive_config(proofs[0], self.fc)
        ws = [pack_witness(p, self.cfg, self.device) for p in proofs]
        t = self._phase("pack", t)
        stacked = tree_map(lambda *xs: torch.stack(xs), ws[0], *ws[1:])
        del ws, proofs
        self.batches = []
        for lanes in self.lanes:
            idx = torch.as_tensor(lanes, device=self.device)
            self.batches.append(tree_map(lambda x: x[idx].contiguous(),
                                         stacked))
        del stacked
        self.bv = BatchVerifier(self.air, self.cfg, self.device)
        t = self._phase("stack", t)
        # warm up: on the card the stage programs are captured at the
        # first batch (each program's eager warm-up run builds what a
        # capture may not), then every batch replays once; on the CPU,
        # where every call is staged, one call
        if self.device == "cuda":
            self.bv.verify_witnesses(self.batches[0], fused=True)
            t = self._phase("capture", t)
            if self.bv.plan(self.batches[0]) != "replay":
                raise RuntimeError("the verifier's warm-up left nothing "
                                   "to replay")
            for ws_ in self.batches:
                self.verify(ws_, None)
            torch.cuda.synchronize()
        else:
            self.verify(self.batches[0], None)
        self._phase("replay_each", t)
        self.stats = {k: dict(p.stats) for k, p in self.bv.programs().items()}

    # ------------------------------------------------------------ timed
    def verify(self, ws, on_stage) -> np.ndarray:
        """The timed path: verdicts (B,) on the host."""
        return self.bv.verify_witnesses(ws, on_stage).cpu().numpy()

    def call(self, i: int, on_stage=None) -> int:
        k = i % len(self.batches)
        self.outputs.append((k, self.verify(self.batches[k], on_stage)))
        return self.traffic["batch"]

    def release(self):
        """Drop the program's state before the reference runs."""
        import torch

        self.bv = self.batches = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ judged
    def reference_traces(self, check_merkle: bool = True) -> List:
        """The plain reference's verification of every distinct input
        (with the Merkle checks: computed once)."""
        from p3bench.reference import proof as rp
        from p3bench.reference.verifier import verify_many

        if check_merkle and self._traces is not None:
            return self._traces
        c = self.config
        proofs = [rp.proof_from_json(d) for d in self.inputs]
        trs = verify_many(proofs, load_object(c["air"]["reference"])(),
                          rp.FriConfig(**c["fri"]), check_merkle)
        if check_merkle:
            self._traces = trs
        return trs

    def reference_verdicts(self, check_merkle: bool = True,
                           check_constraints: bool = True) -> np.ndarray:
        """The reference's verdicts; without a check, as a verifier that
        leaves it out would give them (the controls)."""
        return np.asarray([
            tr.shape_ok and tr.pow_ok and tr.merkle_ok and tr.fold_ok
            and (tr.quotient_ok or not check_constraints)
            for tr in self.reference_traces(check_merkle)])

    def check(self) -> Dict:
        trs = self.reference_traces()
        want = self.reference_verdicts()
        differ = sum(int((ok != want[self.lanes[k]]).sum())
                     for k, ok in self.outputs)
        lanes = sum(len(ok) for _, ok in self.outputs)
        rejected = self.n_originals - int(want[:self.n_originals].sum())
        # the broken proof has to pass every check but the constraints',
        # or its lanes test something else
        b = trs[self.broken]
        isolated = (b.shape_ok and b.pow_ok and b.merkle_ok and b.fold_ok
                    and not b.quotient_ok)
        return {"correct": (differ == 0 and rejected == 0 and isolated
                            and lanes > 0),
                "attempted": lanes, "failed": differ,
                "checks": {"originals_rejected": (rejected, 0),
                           "broken_proof_not_isolated": (int(not isolated), 0),
                           "verdicts_differing": (differ, 0)}}

    # ------------------------------------------------------------ counts
    def poseidon2_states(self, calls) -> int:
        """State-major Poseidon2 states the given calls needed."""
        cfg = self.cfg
        return len(calls) * shapes.total_states(shapes.verify_states(
            cfg.log_trace_height, self.fc.num_queries, self.fc.log_blowup,
            cfg.trace_width, 1 << cfg.log_quotient_degree,
            self.traffic["batch"], cfg.stage2_width,
            self.air.num_challenges()))

    def rates(self, proofs_per_s: float) -> Dict:
        out = {"fri_queries_per_s": proofs_per_s * self.fc.num_queries}
        if "permutations_per_trace" in self.config:
            out["keccak_f_verified_per_s"] = (
                proofs_per_s * self.config["permutations_per_trace"])
        return out

    def program_stats(self) -> Dict:
        """{program: its warm-up, capture and instantiation ms, pool
        bytes}, as set-up left them."""
        return self.stats
