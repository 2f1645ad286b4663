"""Recursive attestation: a STARK proving "this Plonky3 proof verified"
(the depth-1 part of plonky25_tpu/attest.py, on PyTorch).

The analogue of the reference's whole purpose — building a plonky2 circuit
that re-executes Plonky3 verification and proving it (`p3_verify_proof` +
`data.prove`, src/p3/mod.rs:66-94, 261).  There, every verification step
becomes circuit constraints; here, the ENTIRE verification becomes one
VerifierAir trace (models/verifier_air.py): the Fiat-Shamir transcript and
every Merkle opening as hash rows (one Poseidon2 permutation each), and
the verification's field algebra — reduced-opening accumulation
(verifier.rs:296-344), FRI fold interpolation (:419-519), quotient
reconstruction / Lagrange selectors / AIR folding (:169-239) — as FMA
rows, assembled by attest_program.build_verification_schedule.

## Protocol

attest(proof, air, fc) -> AttestationBundle:
  1. Run the verification, recording every Fiat-Shamir sample (the port's
     verifier, or the int oracle).  Refuse to attest unless it accepts.
  2. Compile the verification into the canonical row schedule; derive two
     binding gammas by hashing the canonical slot sequence; fold the
     canonical accumulator finals.
  3. Execute the program (prover-side only: inverses, interpolations,
     register dataflow), build the VerifierAir trace, prove it.
  4. Bundle {stark, samples, gamma, acc}.

check_attestation(bundle, proof, air, fc) — NO re-execution of the
verification; in particular no field algebra beyond the binding
accumulator itself:
  1. Structural checks: proof shape (fail-closed), exact sample count,
     sample canonicality, the proof-of-work bit mask.
  2. Rebuild the canonical schedule from proof bytes + bundled samples +
     shape constants; recompute gamma/accumulators; require equality with
     the bundle.
  3. Verify ONE STARK (VerifierAir, checker-pinned FRI config).

Why this binds is set out in plonky25_tpu/attest.py's module docstring and
docs/SOUNDNESS.md; the port computes the same values bit for bit.

Every entry point takes `device=` ("cuda" by default) and runs the gamma
sponge, the trace builder and the port's prover and verifier there; the
flags `use_device_prover` / `use_device_verifier` choose, as in the JAX
package, between the port's TorchProver / TorchVerifier (True) and the int
oracle of refimpl/ (False).  The composed (depth-2) attestations of the
JAX package are not part of this module.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import attest_program as ap
from .constants import GOLDILOCKS_P as P
from .device import resolve_device
from .errors import InvalidProofShape, P25Error, check_proof_shape
from .fields import gl
from .fields.goldilocks import GL
from .models.verifier_air import VerifierAir
from .parallel.batch import BatchVerifier, stack_witnesses
from .proof import (FriConfig, Proof, derive_config, proof_from_json,
                    proof_to_json)
from .prover.prove import get_prover
from .refimpl.challenger import DuplexChallenger
from .refimpl.prover import prove as refimpl_prove
from .refimpl.verifier import verify as refimpl_verify
from .utils.bits import log2_strict
from .utils.tree import tree_map
from .verifier import get_verifier, verify_proof
from .witness import pack_witness


class CannotAttest(P25Error):
    """The proof did not verify; refusing to attest."""


@dataclass
class AttestationBundle:
    stark: Proof                  # the attestation STARK proof
    samples: List[int]            # every Fiat-Shamir sample, in order
    gamma: Tuple[int, int]
    acc: Tuple[int, int]
    att_fri_config: FriConfig
    n_rows: int                   # active rows (pre-padding)
    # canonical claim digest (statement_digest): sha256 over the target
    # proof bytes + binding values — a stable identifier external systems
    # can pin without speaking this framework's STARK protocol
    statement: Optional[str] = None


@dataclass
class MultiAttestationBundle:
    stark: Proof
    samples: List[List[int]]      # per proof, in verification order
    gamma: Tuple[int, int]
    acc: Tuple[int, int]
    att_fri_config: FriConfig
    n_rows: int
    statement: Optional[str] = None


class _RecordingChallenger(DuplexChallenger):
    """DuplexChallenger that records every raw sample in order."""

    def __init__(self):
        super().__init__()
        self.samples: List[int] = []

    def sample(self) -> int:
        v = super().sample()
        self.samples.append(v)
        return v


def _device_instrumented_verify(proof: Proof, air, fri_config: FriConfig,
                                device="cuda"):
    """The port's verification of one proof on `device`, also yielding
    the raw Fiat-Shamir samples (TorchVerifier.verify_witnesses returns
    them beside the verdict): (ok, samples), one host copy."""
    config = derive_config(proof, fri_config)
    v = get_verifier(air, config, device)
    if not v.check_shape(proof):
        return False, []
    w = pack_witness(proof, config, v.device)
    r = v.verify_witnesses(tree_map(lambda a: a[None], w))
    samples = gl.to_u64_np(r["samples"][0])
    return bool(r["ok"][0]), [int(x) for x in samples]


DEFAULT_ATT_FRI_CONFIG = FriConfig(
    log_blowup=1, num_queries=100, proof_of_work_bits=16)


def _att_config_acceptable(bundle_fc: FriConfig,
                           pinned: Optional[FriConfig]) -> bool:
    """The attestation STARK's own FRI config travels in the (untrusted)
    bundle; verifying under it verbatim would let a forged bundle carry
    FriConfig(num_queries=0, ...) and make the STARK check vacuous.  The
    checker pins the config: either the caller's `att_fri_config` or the
    library default."""
    want = pinned or DEFAULT_ATT_FRI_CONFIG
    return (bundle_fc.log_blowup == want.log_blowup
            and bundle_fc.num_queries == want.num_queries
            and bundle_fc.proof_of_work_bits == want.proof_of_work_bits)


def _record_verifications_device(proofs: List[Proof], air,
                                 fri_config: FriConfig,
                                 device="cuda") -> List[List[int]]:
    """Batched sample-recording verification: same-shape proofs share one
    pass of the port's verifier stages (BatchVerifier.verify_witnesses
    with_samples).  Raises CannotAttest naming the first failing proof."""
    groups: Dict[tuple, List[int]] = {}
    cfgs = []
    for i, p in enumerate(proofs):
        cfg = derive_config(p, fri_config)
        cfgs.append(cfg)
        key = (cfg.log_quotient_degree, cfg.log_trace_height,
               cfg.trace_width, cfg.opening_matrix_log_max_height,
               cfg.quotient_opened_values_len, cfg.degree_bits,
               cfg.stage2_width)
        groups.setdefault(key, []).append(i)

    out: List[Optional[List[int]]] = [None] * len(proofs)
    for idxs in groups.values():
        cfg = cfgs[idxs[0]]
        v = get_verifier(air, cfg, device)
        for i in idxs:
            if not v.check_shape(proofs[i]):
                raise CannotAttest(f"proof {i}: malformed shape")
        if len(idxs) == 1:
            i = idxs[0]
            ok, samples = _device_instrumented_verify(proofs[i], air,
                                                      fri_config, device)
            if not ok:
                raise CannotAttest(f"proof {i}: verification failed")
            out[i] = samples
            continue
        bv = BatchVerifier(air, cfg, device)
        ws = stack_witnesses([pack_witness(proofs[i], cfg, v.device)
                              for i in idxs])
        ok_d, samples_d = bv.verify_witnesses(ws, with_samples=True)
        oks = ok_d.cpu().tolist()
        samples_h = gl.to_u64_np(samples_d)
        for k, i in enumerate(idxs):
            if not oks[k]:
                raise CannotAttest(f"proof {i}: verification failed")
            out[i] = [int(x) for x in samples_h[k]]
    return out


def _record_verification(proof: Proof, air, fri_config: FriConfig,
                         use_device: bool, device="cuda") -> List[int]:
    """Verify + record samples; raises CannotAttest on rejection."""
    if use_device:
        ok, samples = _device_instrumented_verify(proof, air, fri_config,
                                                  device)
        if not ok:
            raise CannotAttest("verification failed (device verifier)")
        return samples
    ch = _RecordingChallenger()
    tr = refimpl_verify(proof, air, fri_config, challenger=ch)
    if not tr.ok:
        raise CannotAttest(
            f"verification failed (pow={tr.pow_ok} merkle={tr.merkle_ok} "
            f"fold={tr.fold_ok} quotient={tr.quotient_ok})")
    return ch.samples


def _prove_schedule(rows, gamma, acc, att_fc: FriConfig,
                    use_device_prover: bool, device="cuda",
                    on_step=None) -> Proof:
    """Build the VerifierAir trace on `device` and prove it: with the
    port's prover from its columns (the JAX package's prove_on_device of
    a column-major trace), or with the int prover from its rows."""
    mark = on_step or (lambda name: None)
    v_air = VerifierAir({"gamma": gamma, "acc": acc})
    if use_device_prover:
        cols = ap.build_trace_cols(rows, gamma, device=device)   # (W, H)
        mark("trace")
        prover = get_prover(v_air, log2_strict(cols.shape[1]), att_fc,
                            device)
        stark = prover.prove_columns(GL(cols.lo[None], cols.hi[None]))[0]
        mark("prove")
        return stark
    trace = ap.build_trace_rowmajor(rows, gamma, device=device)
    mark("trace")
    stark = refimpl_prove(v_air, trace, att_fc)
    mark("prove")
    return stark


def statement_digest(bundle, proofs) -> str:
    """Canonical digest of the CLAIM an attestation makes: sha256 over the
    canonical JSON bytes of the target proof(s) plus the bundle's binding
    values (gamma, acc, att_fri_config, n_rows).

    The attestation STARK itself is framework-internal — unlike the
    reference, whose output is a standard plonky2 proof any ecosystem
    verifier consumes (src/p3/mod.rs:250-266).  This digest is the stable,
    toolchain-agnostic handle external systems pin instead: plain sha256
    over plain JSON, recomputable with any standard library."""
    if not isinstance(proofs, list):
        proofs = [proofs]
    h = hashlib.sha256()
    for p in proofs:
        blob = json.dumps(proof_to_json(p), sort_keys=True,
                          separators=(",", ":")).encode()
        h.update(hashlib.sha256(blob).digest())
    fc = bundle.att_fri_config
    claim = {
        "target_proofs_sha256": h.hexdigest(),
        "gamma": list(bundle.gamma),
        "acc": list(bundle.acc),
        "att_fri_config": [fc.log_blowup, fc.num_queries,
                           fc.proof_of_work_bits],
        "n_rows": bundle.n_rows,
    }
    return hashlib.sha256(json.dumps(claim, sort_keys=True,
                                     separators=(",", ":")).encode()).hexdigest()


def attest(proof: Proof, air, fri_config: FriConfig,
           att_fri_config: Optional[FriConfig] = None,
           use_device_prover: bool = True, device="cuda",
           on_step=None) -> AttestationBundle:
    """Verify `proof` and emit a STARK attesting the entire verification.

    Raises CannotAttest if the proof does not verify — a failed
    verification cannot be attested.  `on_step(name)`, if given, is called
    after each step (record, schedule, gammas, trace, prove)."""
    mark = on_step or (lambda name: None)
    device = resolve_device(device)
    config = derive_config(proof, fri_config)
    if getattr(config, "ext_degree", 2) != 2:
        raise CannotAttest(
            "attestation schedules are GF(p^2) programs (VerifierAir's "
            "FMA rows); D=3 proofs verify via refimpl but cannot be "
            "attested")
    samples = _record_verification(proof, air, fri_config,
                                   use_device_prover, device)
    mark("record")
    rows = ap.build_verification_schedule(proof, config, air, samples)
    mark("schedule")
    gamma = ap.derive_gammas(rows, device)
    acc = ap.fold_accumulator(rows, gamma)
    mark("gammas")
    att_fc = att_fri_config or DEFAULT_ATT_FRI_CONFIG
    stark = _prove_schedule(rows, gamma, acc, att_fc, use_device_prover,
                            device, on_step)
    bundle = AttestationBundle(
        stark=stark, samples=list(samples), gamma=gamma, acc=acc,
        att_fri_config=att_fc, n_rows=len(rows))
    bundle.statement = statement_digest(bundle, proof)
    return bundle


def _structural_ok(proof: Proof, air, fri_config: FriConfig,
                   samples: List[int]) -> bool:
    """Fail-closed structural gate: proof shape, sample count/canonicality,
    and the proof-of-work bit mask (the only sample the schedule does not
    itself constrain beyond exposure)."""
    try:
        config = derive_config(proof, fri_config)
        check_proof_shape(proof, config)
    except InvalidProofShape:
        return False
    if getattr(config, "ext_degree", 2) != 2:
        return False    # the attestation machinery is a GF(p^2) machine
    if len(proof.opened_values.trace_local) != air.width():
        return False
    if config.stage2_width != air.stage2_width():
        return False
    n_ch = air.num_challenges()
    if len(samples) != ap.expected_sample_count(config, n_ch):
        return False
    if not all(isinstance(s, int) and 0 <= s < P for s in samples):
        return False
    pow_sample = samples[ap.n_presamples(config, n_ch) - 1]
    if pow_sample & ((1 << fri_config.proof_of_work_bits) - 1) != 0:
        return False
    return True


def _check_one_schedule(bundle, schedules, use_device_verifier,
                        device) -> bool:
    """Shared tail of check_attestation(s): canonical recompute + STARK."""
    rows = [r for sched in schedules for r in sched]
    gamma = ap.derive_gammas(rows, device)
    acc = ap.fold_accumulator(rows, gamma)
    if (gamma != tuple(bundle.gamma) or acc != tuple(bundle.acc)
            or len(rows) != bundle.n_rows):
        return False
    height = 1 << (max(len(rows), 4) - 1).bit_length()
    if bundle.stark.degree_bits != height.bit_length() - 1:
        return False

    v_air = VerifierAir({"gamma": gamma, "acc": acc})
    if use_device_verifier:
        r = verify_proof(bundle.stark, v_air, bundle.att_fri_config, device)
        return bool(r.ok)
    return bool(refimpl_verify(bundle.stark, v_air,
                               bundle.att_fri_config).ok)


def check_attestation(bundle: AttestationBundle, proof: Proof, air,
                      fri_config: FriConfig,
                      use_device_verifier: bool = True,
                      att_fri_config: Optional[FriConfig] = None,
                      device="cuda") -> bool:
    """Accept iff `bundle` attests a valid verification of `proof`.

    Self-contained: no re-execution of the verification — only schedule
    marshaling, the binding-accumulator fold, and one STARK verification
    (the port's verifier on `device`, or with use_device_verifier=False
    the int oracle)."""
    device = resolve_device(device)
    if not _att_config_acceptable(bundle.att_fri_config, att_fri_config):
        return False
    if not _structural_ok(proof, fri_config=fri_config, air=air,
                          samples=bundle.samples):
        return False
    # attest() ALWAYS sets the statement digest, so a bundle without one
    # is itself tamper evidence (stripping the field must not silently
    # downgrade the interop binding) — fail closed on absence, not just
    # on mismatch.
    if bundle.statement != statement_digest(bundle, proof):
        return False
    try:
        config = derive_config(proof, fri_config)
        rows = ap.build_verification_schedule(proof, config, air,
                                              bundle.samples)
    except Exception:
        # fail-closed: a schedule the builder cannot express is not a
        # valid attestation (the structural gate covers everything a
        # well-formed proof can present; this guards the contract)
        return False
    return _check_one_schedule(bundle, [rows], use_device_verifier, device)


def attest_many(proofs: List[Proof], air, fri_config: FriConfig,
                att_fri_config: Optional[FriConfig] = None,
                use_device_prover: bool = True, device="cuda",
                on_step=None) -> MultiAttestationBundle:
    """One STARK attesting the verification of a whole batch of proofs.

    The per-proof row schedules concatenate into one VerifierAir trace
    (each proof's transcript opens a fresh chain and its program frees
    every register, so nothing crosses proof boundaries except the
    running accumulator): B verifications collapse into one proof whose
    own verification cost does not grow with B's hashing work.
    `on_step` as in attest."""
    mark = on_step or (lambda name: None)
    device = resolve_device(device)
    if use_device_prover:
        samples_list = _record_verifications_device(proofs, air, fri_config,
                                                     device)
    else:
        samples_list = [
            _record_verification(p, air, fri_config, False) for p in proofs
        ]
    mark("record")
    rows: List[ap.VRow] = []
    for proof, samples in zip(proofs, samples_list):
        config = derive_config(proof, fri_config)
        rows += ap.build_verification_schedule(proof, config, air, samples)
    mark("schedule")
    gamma = ap.derive_gammas(rows, device)
    acc = ap.fold_accumulator(rows, gamma)
    mark("gammas")
    att_fc = att_fri_config or DEFAULT_ATT_FRI_CONFIG
    stark = _prove_schedule(rows, gamma, acc, att_fc, use_device_prover,
                            device, on_step)
    bundle = MultiAttestationBundle(
        stark=stark, samples=[list(s) for s in samples_list], gamma=gamma,
        acc=acc, att_fri_config=att_fc, n_rows=len(rows))
    bundle.statement = statement_digest(bundle, proofs)
    return bundle


def check_attestations(bundle: MultiAttestationBundle, proofs: List[Proof],
                       air, fri_config: FriConfig,
                       use_device_verifier: bool = True,
                       att_fri_config: Optional[FriConfig] = None,
                       device="cuda") -> bool:
    """Accept iff `bundle` attests valid verifications of ALL `proofs`
    (in order).  Self-contained, like check_attestation."""
    device = resolve_device(device)
    if not _att_config_acceptable(bundle.att_fri_config, att_fri_config):
        return False
    if len(bundle.samples) != len(proofs):
        return False
    # statement is REQUIRED (see check_attestation): absence fails closed
    if bundle.statement != statement_digest(bundle, proofs):
        return False
    schedules = []
    for proof, samples in zip(proofs, bundle.samples):
        if not _structural_ok(proof, air, fri_config, samples):
            return False
        try:
            config = derive_config(proof, fri_config)
            schedules.append(ap.build_verification_schedule(
                proof, config, air, samples))
        except Exception:
            return False
    return _check_one_schedule(bundle, schedules, use_device_verifier,
                               device)


# ----------------------------------------------------------- serialization

def bundle_to_json(bundle) -> Dict:
    """JSON form of an Attestation/MultiAttestationBundle — the analogue of
    the reference persisting its output proof (src/p3/mod.rs:261).  The
    inner STARK reuses the byte-exact proof schema (proof.py)."""
    fc = bundle.att_fri_config
    out = {
        # protocol 3: the gammas come from the rate-2 sponge chains
        # (attest_program.derive_gammas_from_pairs); the JAX package's v2
        # bundles (tree-digest gammas) are refused on load
        "protocol": 3,
        "stark": proof_to_json(bundle.stark),
        "gamma": list(bundle.gamma),
        "acc": list(bundle.acc),
        "att_fri_config": {
            "log_blowup": fc.log_blowup,
            "num_queries": fc.num_queries,
            "proof_of_work_bits": fc.proof_of_work_bits,
        },
        "n_rows": bundle.n_rows,
    }
    if bundle.statement is not None:
        out["statement"] = bundle.statement
    if isinstance(bundle, MultiAttestationBundle):
        out["samples"] = [list(s) for s in bundle.samples]
    else:
        out["samples"] = list(bundle.samples)
    return out


def bundle_from_json(obj: Dict):
    """Inverse of bundle_to_json; nested samples select the multi form."""
    if obj.get("protocol") != 3:
        raise ValueError("unsupported attestation bundle protocol "
                         f"{obj.get('protocol')!r} (expected 3; v2's "
                         "tree-digest gammas are not chain-derivable)")
    fc = FriConfig(**obj["att_fri_config"])
    multi = bool(obj["samples"]) and isinstance(obj["samples"][0], list)
    cls = MultiAttestationBundle if multi else AttestationBundle
    return cls(
        stark=proof_from_json(obj["stark"]),
        samples=obj["samples"],
        gamma=tuple(obj["gamma"]),
        acc=tuple(obj["acc"]),
        att_fri_config=fc,
        n_rows=obj["n_rows"],
        statement=obj.get("statement"),
    )


def save_bundle(bundle, path: str) -> None:
    with open(path, "w") as f:
        json.dump(bundle_to_json(bundle), f)


def load_bundle(path: str):
    with open(path) as f:
        return bundle_from_json(json.load(f))
