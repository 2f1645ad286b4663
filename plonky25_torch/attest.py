"""Recursive attestation: a STARK proving "this Plonky3 proof verified"
(plonky25_tpu/attest.py on PyTorch: depth 1 and the depth-2 composition).

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
oracle of refimpl/ (False).

## Composition (depth 2)

attest_composed attests an attestation with the in-trace compression:
the outer VerifierAir trace verifies the inner STARK (as a schedule) and
re-derives the inner (gamma, acc) from the inner canonical pair stream in
'w' rows (attest_program.build_compression_rows).  check_composed needs
the outer schedule and one STARK verification, never the target proof's
bytes: the inner schedule's slot structure comes from a zero-valued
proof of the target's shape (attest_program.make_zero_proof).
attest_attestation / check_attested_attestation attest the verification
of an attestation STARK and bind it to the target proof on the host.
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
from .models.verifier_air import VerifierAir
from .parallel.batch import BatchVerifier, stack_witnesses
from .proof import (FriConfig, P3Config, Proof, derive_config,
                    proof_from_json, proof_to_json)
from .prover.prove import get_prover, quotient_eval_chunks_for
from .refimpl.challenger import DuplexChallenger
from .refimpl.prover import prove as refimpl_prove
from .refimpl.verifier import verify as refimpl_verify
from .utils.bits import log2_strict
from .utils.tree import tree_map
from .verifier import _publics, fused_default, get_verifier, verify_proof
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
    the raw Fiat-Shamir samples (the verifier returns them beside the
    verdict): (ok, samples).  Where `fused_default(device)` holds (a CUDA
    device) it runs the fused program, its samples in the same replay, as
    the JAX package does on a TPU (plonky25_tpu/attest.py:136-145); on the
    CPU the staged verify_witnesses."""
    config = derive_config(proof, fri_config)
    v = get_verifier(air, config, device)
    if not v.check_shape(proof):
        return False, []
    w = pack_witness(proof, config, v.device)
    if fused_default(v.device):
        r = v._s_all(w, _publics(air, v.device))
    else:
        r = tree_map(lambda a: a[0],
                     v.verify_witnesses(tree_map(lambda a: a[None], w)))
    samples = gl.to_u64_np(r["samples"])
    return bool(r["ok"]), [int(x) for x in samples]


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
    with_samples; a BatchVerifier's first batch takes the staged path).
    Raises CannotAttest naming the first failing proof."""
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
    port's prover from its columns (the quotient segmented by the trace's
    size, as prove_on_device and the JAX package segment it), or with the
    int prover from its rows.  The device proof runs staged
    (`fused=False`): an attestation proves its STARK once, and capturing
    the prover's stage programs for it, which the plan rule would do
    where the device's last proof had the same signature, would cost
    several staged proofs' time and hold their memory pool for a replay
    that may never come."""
    mark = on_step or (lambda name: None)
    v_air = VerifierAir({"gamma": gamma, "acc": acc})
    if use_device_prover:
        cols = ap.build_trace_cols(rows, gamma, device=device)   # (W, H)
        mark("trace")
        log_n = log2_strict(cols.shape[1])
        prover = get_prover(v_air, log_n, att_fc, device,
                            quotient_eval_chunks_for(v_air, log_n))
        stark = prover.prove_columns(gl.GL(cols.lo[None], cols.hi[None]),
                                     fused=False)[0]
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
                        device, on_step=None) -> bool:
    """Shared tail of check_attestation(s): canonical recompute + STARK
    (`on_step` after the gammas and after the STARK's verification)."""
    mark = on_step or (lambda name: None)
    rows = [r for sched in schedules for r in sched]
    gamma = ap.derive_gammas(rows, device)
    acc = ap.fold_accumulator(rows, gamma)
    mark("gammas")
    if (gamma != tuple(bundle.gamma) or acc != tuple(bundle.acc)
            or len(rows) != bundle.n_rows):
        return False
    height = 1 << (max(len(rows), 4) - 1).bit_length()
    if bundle.stark.degree_bits != height.bit_length() - 1:
        return False

    v_air = VerifierAir({"gamma": gamma, "acc": acc})
    if use_device_verifier:
        ok = bool(verify_proof(bundle.stark, v_air, bundle.att_fri_config,
                               device).ok)
    else:
        ok = bool(refimpl_verify(bundle.stark, v_air,
                                 bundle.att_fri_config).ok)
    mark("verify")
    return ok


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


def composed_to_json(c: "ComposedAttestation") -> Dict:
    """JSON form of a ComposedAttestation: protocol 3, kind "composed",
    the outer bundle as bundle_to_json."""
    return {
        "protocol": 3,
        "kind": "composed",
        "outer": bundle_to_json(c.outer),
        "inner_stark": proof_to_json(c.inner_stark),
        "inner_gamma": list(c.inner_gamma),
        "inner_acc": list(c.inner_acc),
        "inner_samples": list(c.inner_samples),
        "inner_n_rows": c.inner_n_rows,
        "target_shape": dict(c.target_shape),
        "statement": c.statement,
    }


def composed_from_json(obj: Dict) -> "ComposedAttestation":
    if obj.get("protocol") != 3 or obj.get("kind") != "composed":
        raise ValueError("not a protocol-3 composed attestation")
    return ComposedAttestation(
        outer=bundle_from_json(obj["outer"]),
        inner_stark=proof_from_json(obj["inner_stark"]),
        inner_gamma=tuple(obj["inner_gamma"]),
        inner_acc=tuple(obj["inner_acc"]),
        inner_samples=list(obj["inner_samples"]),
        inner_n_rows=obj["inner_n_rows"],
        target_shape=dict(obj["target_shape"]),
        statement=obj.get("statement"),
    )


# ------------------------------------------------------ recursive composition

def _verifier_air_of(bundle) -> VerifierAir:
    return VerifierAir({"gamma": tuple(bundle.gamma),
                        "acc": tuple(bundle.acc)})


@dataclass
class ComposedAttestation:
    """Depth-2 recursion with in-trace inner binding: `outer` attests the
    verification of `inner_stark` and carries, as 'w' rows, the in-trace
    recomputation of (inner_gamma, inner_acc) from the inner canonical
    sequence.  The target is identified succinctly by inner_gamma, the
    sponge digest of its canonical verification sequence."""

    outer: AttestationBundle
    inner_stark: Proof
    inner_gamma: Tuple[int, int]
    inner_acc: Tuple[int, int]
    inner_samples: List[int]
    inner_n_rows: int
    target_shape: Dict            # P3Config fields of the target proof
    statement: Optional[str] = None


def _target_shape_of(config) -> Dict:
    return {
        "log_quotient_degree": config.log_quotient_degree,
        "log_trace_height": config.log_trace_height,
        "trace_width": config.trace_width,
        "opening_matrix_log_max_height": config.opening_matrix_log_max_height,
        "quotient_opened_values_len": config.quotient_opened_values_len,
        "degree_bits": config.degree_bits,
        "stage2_width": config.stage2_width,
    }


def composed_statement_digest(c: ComposedAttestation) -> str:
    """sha256 handle over the composed claim (like statement_digest): the
    inner binding pair, the target shape and the outer binding values."""
    claim = {
        "inner_gamma": list(c.inner_gamma),
        "inner_acc": list(c.inner_acc),
        "inner_n_rows": c.inner_n_rows,
        "target_shape": c.target_shape,
        "outer_gamma": list(c.outer.gamma),
        "outer_acc": list(c.outer.acc),
        "outer_n_rows": c.outer.n_rows,
    }
    return hashlib.sha256(json.dumps(claim, sort_keys=True,
                                     separators=(",", ":")).encode()).hexdigest()


def attest_composed(proof: Proof, air, fri_config: FriConfig,
                    att_fri_config: Optional[FriConfig] = None,
                    use_device_prover: bool = True,
                    inner: Optional[AttestationBundle] = None,
                    device="cuda", on_step=None) -> ComposedAttestation:
    """Attest `proof`, then attest that attestation with the in-trace
    compression: the outer VerifierAir trace verifies the inner STARK and
    re-derives the inner (gamma, acc) from the inner canonical sequence
    witnessed in 'w' rows.  Pass `inner` to reuse an attestation of
    `proof` (it is made otherwise).  `on_step(name)`, if given, is called
    after each step (inner when it is made, record, schedule,
    outer-schedule, gammas, trace, prove)."""
    mark = on_step or (lambda name: None)
    device = resolve_device(device)
    config = derive_config(proof, fri_config)
    if inner is None:
        inner = attest(proof, air, fri_config, att_fri_config,
                       use_device_prover, device)
        mark("inner")
    att_fc = att_fri_config or DEFAULT_ATT_FRI_CONFIG

    v_air = _verifier_air_of(inner)
    outer_samples = _record_verification(inner.stark, v_air,
                                         inner.att_fri_config,
                                         use_device_prover, device)
    mark("record")
    inner_rows = ap.build_verification_schedule(proof, config, air,
                                                inner.samples)
    comp = ap.build_compression_rows(
        len(inner_rows), ap.sequence_pairs(inner_rows),
        ap.pair_exponents(inner_rows), inner.gamma, inner.acc)
    mark("schedule")
    outer_cfg = derive_config(inner.stark, inner.att_fri_config)
    outer_rows = ap.build_verification_schedule(
        inner.stark, outer_cfg, v_air, outer_samples) + comp
    mark("outer-schedule")
    gamma_o = ap.derive_gammas(outer_rows, device)
    acc_o = ap.fold_accumulator(outer_rows, gamma_o)
    mark("gammas")
    stark_o = _prove_schedule(outer_rows, gamma_o, acc_o, att_fc,
                              use_device_prover, device, on_step)
    outer = AttestationBundle(
        stark=stark_o, samples=list(outer_samples), gamma=gamma_o,
        acc=acc_o, att_fri_config=att_fc, n_rows=len(outer_rows))
    c = ComposedAttestation(
        outer=outer, inner_stark=inner.stark,
        inner_gamma=tuple(inner.gamma), inner_acc=tuple(inner.acc),
        inner_samples=list(inner.samples), inner_n_rows=inner.n_rows,
        target_shape=_target_shape_of(config))
    c.statement = composed_statement_digest(c)
    return c


def check_composed(c: ComposedAttestation, air, fri_config: FriConfig,
                   use_device_verifier: bool = True,
                   att_fri_config: Optional[FriConfig] = None,
                   target_proof: Optional[Proof] = None,
                   device="cuda", on_step=None) -> bool:
    """Accept iff `c.outer` attests a valid verification of
    `c.inner_stark` whose trace also re-derives (inner_gamma, inner_acc)
    from the witnessed inner sequence.

    No inner schedule is marshalled from proof bytes: the inner slot
    structure comes from a zero-valued proof of `c.target_shape`, and the
    inner values are bound in the trace (chain digest == gamma, re-folded
    accumulator == acc).  Everything before the outer gammas refuses
    without deriving them.  Pass `target_proof` to also pin the claim to
    concrete bytes (one schedule marshal and one gamma derivation, the
    depth-1 binding).  `on_step(name)`, if given, is called after each
    step reached (schedule, gammas, verify, target)."""
    mark = on_step or (lambda name: None)
    device = resolve_device(device)
    if not _att_config_acceptable(c.outer.att_fri_config, att_fri_config):
        return False
    if c.statement != composed_statement_digest(c):
        return False
    # target-shape sanity against the caller's AIR + config
    try:
        cfg = P3Config(fri_config=fri_config, **c.target_shape)
    except TypeError:
        return False
    if cfg.trace_width != air.width():
        return False
    if cfg.stage2_width != air.stage2_width():
        return False
    n_ch = air.num_challenges()
    if len(c.inner_samples) != ap.expected_sample_count(cfg, n_ch):
        return False
    if not all(isinstance(s, int) and 0 <= s < P
               for s in c.inner_samples):
        return False
    pow_sample = c.inner_samples[ap.n_presamples(cfg, n_ch) - 1]
    if pow_sample & ((1 << fri_config.proof_of_work_bits) - 1) != 0:
        return False

    # the inner slot structure from a value-free proof of the shape
    try:
        template = ap.build_verification_schedule(
            ap.make_zero_proof(cfg), cfg, air, c.inner_samples)
    except Exception:
        return False
    if len(template) != c.inner_n_rows:
        return False
    comp = ap.build_compression_rows(
        len(template), ap.sequence_pairs(template),
        ap.pair_exponents(template), tuple(c.inner_gamma),
        tuple(c.inner_acc))

    # the outer schedule: the inner STARK's verification under the pinned
    # attestation config (never the bundle's word for it)
    pinned = att_fri_config or DEFAULT_ATT_FRI_CONFIG
    v_air = VerifierAir({"gamma": tuple(c.inner_gamma),
                         "acc": tuple(c.inner_acc)})
    if not _structural_ok(c.inner_stark, v_air, pinned, c.outer.samples):
        return False
    try:
        outer_cfg = derive_config(c.inner_stark, pinned)
        outer_rows = ap.build_verification_schedule(
            c.inner_stark, outer_cfg, v_air, c.outer.samples) + comp
    except Exception:
        return False
    mark("schedule")
    if not _check_one_schedule(c.outer, [outer_rows], use_device_verifier,
                               device, on_step):
        return False
    if target_proof is not None:
        # the depth-1 binding: the presented bytes' canonical sequence
        # must be the one inner_gamma identifies
        if not _structural_ok(target_proof, air, fri_config,
                              c.inner_samples):
            return False
        try:
            t_cfg = derive_config(target_proof, fri_config)
            rows = ap.build_verification_schedule(
                target_proof, t_cfg, air, c.inner_samples)
        except Exception:
            return False
        gamma = ap.derive_gammas(rows, device)
        acc = ap.fold_accumulator(rows, gamma)
        if (gamma != tuple(c.inner_gamma) or acc != tuple(c.inner_acc)
                or len(rows) != c.inner_n_rows):
            return False
        mark("target")
    return True


def attest_attestation(bundle, att_fri_config: Optional[FriConfig] = None,
                       use_device_prover: bool = True, device="cuda",
                       on_step=None) -> AttestationBundle:
    """Attest the verification of an attestation STARK: its VerifierAir
    is just another attestable AIR.  The output attests "this VerifierAir
    STARK verifies under publics (gamma, acc)"; binding those publics to
    the original target proof stays the checker's schedule recomputation
    (check_attested_attestation)."""
    return attest(bundle.stark, _verifier_air_of(bundle),
                  bundle.att_fri_config, att_fri_config=att_fri_config,
                  use_device_prover=use_device_prover, device=device,
                  on_step=on_step)


def check_attested_attestation(outer: AttestationBundle,
                               inner, proof: Proof, air,
                               fri_config: FriConfig,
                               use_device_verifier: bool = True,
                               att_fri_config: Optional[FriConfig] = None,
                               device="cuda",
                               inner_att_fri_config: Optional[
                                   FriConfig] = None) -> bool:
    """Accept iff `outer` attests a valid verification of `inner`'s STARK
    and `inner` is bound to (proof, air, fri_config): the inner schedule
    is recomputed from the proof bytes (marshalling and the accumulator
    fold; no STARK verification of the inner proof, which `outer`
    carries).  `att_fri_config` pins the outer STARK's config and
    `inner_att_fri_config` the inner's, each the library default when
    not given (the JAX package pins the inner's to the default always)."""
    device = resolve_device(device)
    if not _att_config_acceptable(inner.att_fri_config,
                                  inner_att_fri_config):
        return False
    if not _structural_ok(proof, fri_config=fri_config, air=air,
                          samples=inner.samples):
        return False
    try:
        config = derive_config(proof, fri_config)
        rows = ap.build_verification_schedule(proof, config, air,
                                              inner.samples)
    except Exception:
        return False
    gamma = ap.derive_gammas(rows, device)
    acc = ap.fold_accumulator(rows, gamma)
    if (gamma != tuple(inner.gamma) or acc != tuple(inner.acc)
            or len(rows) != inner.n_rows):
        return False
    return check_attestation(outer, inner.stark, _verifier_air_of(inner),
                             inner.att_fri_config,
                             use_device_verifier=use_device_verifier,
                             att_fri_config=att_fri_config, device=device)
