"""Plonky3 STARK verifier on PyTorch tensors, batched over proofs.

The counterpart of plonky25_tpu/verifier.py (the reference's verifier,
src/p3/verifier.rs:100-519), in the same five stages:

  * `_transcript_fn`: the Fiat-Shamir transcript (a static duplex schedule,
    one permutation per step), the PoW check, query indices, challenges;
  * `_batch_all_fn`: every commitment batch's Merkle opening, the batches
    laid side by side on one lane axis;
  * `_ro_fn`: the reduced-opening accumulators;
  * `_fold_core`: the FRI fold recurrence, then all of its hashing;
  * `_final_fn`: quotient reconstruction and the AIR's constraint fold.

Every stage takes a leading proof axis B: one proof is a batch of one, and
`parallel.batch.BatchVerifier` runs the same stages on B proofs.  The hash
stages flatten (B, Q) into one lane axis (as the JAX package's
_batched_*_fn do), so each sponge chunk or path level is one Poseidon2
launch over the whole batch.  `verify_witnesses` runs the stages one
after the other on the caller's device (the staged path: the sharded and
multi-host verifiers, the stage clocks, and the batch verifier's first
batch of a shape take it); its `run=` lets the batch verifier run each
stage as a program of its own.

A single proof can also take the fused path, as in the JAX package
(parallel/batch.py's BatchVerifier has its own, one program per stage):
`_verify_all_fn` is the five stages on one proof, and `_s_all` runs it as
one program (utils/graphs.py's StaticProgram), where JAX runs
`jax.jit(_verify_all_fn)`: on the card a CUDA graph captured at the
verifier's first fused call and replayed on static input buffers, one
host launch for some 29k kernels of a fib(64) verification; on the CPU the
function itself on those buffers.  `verify_witness_fused` and
`verify(proof, fused=None)` take it, the latter when `fused_default(device)`
says so: on a CUDA device, as JAX does on a TPU.  The values are the
staged path's, bit for bit.  JAX's P25_FUSED_VERIFY environment switch has
no counterpart: the port reads no environment; pass `fused=`.
`TpuVerifier` itself is `TorchVerifier` here.

Host-derivable scalars (domain shifts, generators, inverses, the zps
first-point factors) are computed on Python ints from the proof's shape.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict

import torch

from .air import (Air, Main, VerifierConstraintFolder,
                  check_multistage_consistency)
from .challenger import SymbolicChallenger, run_transcript
from .constants import EXT_DEGREE, RATE
from .device import resolve_device
from .errors import InvalidProofShape, check_proof_shape
from .fields import gl, gl2
from .fields.extension import GL2
from .fields.goldilocks import GL
from .ops.sponge import hash_rows, merkle_path, verify_batch_single
from .proof import FriChallenges, FriConfig, P3Config, Proof, derive_config
from .refimpl.domains import TwoAdicMultiplicativeCoset
from .refimpl.field import Gl
from .utils.bits import log2_strict, reverse_bits_len_u32
from .utils.graphs import StaticProgram
from .utils.tree import tree_map
from .witness import fold_valid_mask, pack_witness


@dataclass
class VerifyResult:
    ok: object
    pow_ok: object
    merkle_ok: object
    fold_ok: object
    quotient_ok: object
    shape_ok: bool
    # diagnostics (transcript cross-check against the oracle)
    alpha: GL2 = None
    zeta: GL2 = None
    query_indices: object = None


def _columns_first(x: GL2) -> GL2:
    """(B, w) -> the view (w, B)."""
    return tree_map(lambda a: a.T, x)


class TorchVerifier:
    """Shape-specialized verifier; build once per (air, P3Config, device).

    Verifies single- and multi-stage AIRs over GF(p^2), the reference's
    proof family; a D=3 proof is refused with NotImplementedError, as the
    JAX TpuVerifier refuses it (tests/test_d3.py:105-110).  A multi-stage
    AIR commits a second, challenge-dependent matrix between the trace and
    quotient commitments (air.py): the transcript samples its challenges
    after the trace commitment, and the stage-2 matrix is one more batch,
    at the trace's height, with its own reduced-opening terms."""

    def __init__(self, air: Air, config: P3Config, device="cuda"):
        self.device = resolve_device(device)
        # the JAX verifier's order: an inconsistent AIR is a ValueError
        # whatever the proof's extension degree
        check_multistage_consistency(air)
        if config.ext_degree != 2:
            raise NotImplementedError("only D=2 proofs are ported")
        self.s2w = config.stage2_width
        self.n_challenges = air.num_challenges() if self.s2w else 0
        self.air = air
        self.config = config
        fc = config.fri_config
        self.Q = fc.num_queries
        self.n_phases = config.log_trace_height
        self.log_max_height = self.n_phases + fc.log_blowup
        if self.log_max_height > 32:
            raise ValueError("query indices beyond 32 bits are unsupported")
        self.degree_bits = config.degree_bits
        self.quotient_degree = 1 << config.log_quotient_degree

        # ---- host domain math (two_adic.rs semantics)
        self.trace_domain = TwoAdicMultiplicativeCoset.natural_domain_for_degree(
            config.log_trace_height, 1 << self.degree_bits)
        qd = self.trace_domain.create_disjoint_domain(
            1 << (self.degree_bits + config.log_quotient_degree))
        self.quotient_chunks_domains = qd.split_domains(self.quotient_degree)
        # zps host factors: prod_{j != i} 1 / zp_j(first_i) (verifier.rs:169-197)
        self.zps_host = []
        for i, dom in enumerate(self.quotient_chunks_domains):
            acc = 1
            for j, other in enumerate(self.quotient_chunks_domains):
                if j != i:
                    acc = Gl.mul(acc, Gl.inv(
                        other.zp_at_single_point(dom.first_point())))
            self.zps_host.append(acc)

        # ---- transcript schedule (symbolic replay; see challenger.py)
        sym = SymbolicChallenger()
        sym.observe(4)                              # trace commitment
        self.challenge_idx = [sym.sample_ext()      # multi-stage challenges
                              for _ in range(self.n_challenges)]
        if self.s2w:
            sym.observe(4)                          # stage-2 commitment
        self.alpha_idx = sym.sample_ext()
        sym.observe(4)                              # quotient commitment
        self.zeta_idx = sym.sample_ext()
        self.alpha_fri_idx = sym.sample_ext()       # verifier.rs:258
        self.beta_idx = []
        for _ in range(self.n_phases):
            sym.observe(4)
            self.beta_idx.append(sym.sample_ext())
        sym.observe(1)                              # pow witness
        self.pow_idx = sym.sample()
        query_idx = [sym.sample() for _ in range(self.Q)]
        self.schedule = tuple(torch.as_tensor(a, device=self.device)
                              for a in sym.schedule())
        self.query_idx = torch.tensor(query_idx, device=self.device)
        self.n_steps = len(sym.steps)

        # observation layout (witness.pack_witness order): trace commit,
        # [stage-2 commit,] quotient commit, phase commits, pow witness
        s2off = 4 if self.s2w else 0
        self.obs_quotient = slice(4 + s2off, 8 + s2off)
        self.obs_phases = slice(8 + s2off, 8 + s2off + 4 * self.n_phases)

        # ---- matrix and reduced-opening term schedule (verifier.rs:266-344):
        # batch 0 is the trace (one matrix, points zeta and zeta*g), [batch
        # 1 the stage-2 matrix (the same,)] the last batch the quotient (one
        # matrix per chunk, point zeta)
        h_tr = log2_strict(self.trace_domain.size()) + fc.log_blowup
        self.mat_heights = [h_tr] * (2 if self.s2w else 1) + [
            log2_strict(dom.size()) + fc.log_blowup
            for dom in self.quotient_chunks_domains]
        w = config.trace_width
        terms_at_height: Dict[int, int] = {h_tr: 2 * w + 2 * self.s2w}
        h_q = self.mat_heights[-1]
        terms_at_height[h_q] = terms_at_height.get(h_q, 0) + (
            self.quotient_degree * EXT_DEGREE)
        self.max_alpha_pow = max(terms_at_height.values())
        self.fold_heights = [self.log_max_height - 1 - l
                             for l in range(self.n_phases)]
        self.fold_valid = torch.as_tensor(fold_valid_mask(config),
                                          device=self.device)
        # the fused program (_s_all), made at the first fused call as JAX
        # compiles its _s_all lazily
        self._program = None
        self._program_lock = threading.Lock()

    # ---------------------------------------------------------------- stages
    def _transcript_fn(self, obs: GL) -> Dict:
        """The whole Fiat-Shamir transcript of B proofs: obs GL (B, n_obs)."""
        B = obs.shape[0]
        ch = run_transcript(self.schedule, obs)              # (B, n_samples)
        bits = self.config.fri_config.proof_of_work_bits
        pow_s = ch[:, self.pow_idx]
        pow_ok = (pow_s.lo & ((1 << min(bits, 32)) - 1)) == 0
        if bits > 32:
            pow_ok &= (pow_s.hi & ((1 << (bits - 32)) - 1)) == 0
        index = ch[:, self.query_idx].lo & ((1 << self.log_max_height) - 1)

        def ext(ip) -> GL2:
            return GL2(ch[:, ip[0]], ch[:, ip[1]])

        zeta = ext(self.zeta_idx)
        gen = gl.full((), self.trace_domain.gen(), self.device)
        out = {
            "pow_ok": pow_ok,
            "index": index,                                  # (B, Q)
            "samples": ch,          # every raw FS sample, in sample order
            "alpha": ext(self.alpha_idx),
            "zeta": zeta,
            "zeta_next": gl2.mul_base(zeta, gen),
            "alpha_fri": ext(self.alpha_fri_idx),
            "betas_stack": gl2.stack([ext(ix) for ix in self.beta_idx], dim=1),
            "trace_commit": obs[:, 0:4],
            "quotient_commit": obs[:, self.obs_quotient],
            "phase_commits": obs[:, self.obs_phases].reshape(
                B, self.n_phases, 4),
        }
        if self.s2w:
            out["stage2_commit"] = obs[:, 4:8]
            out["challenges"] = [ext(ix) for ix in self.challenge_idx]
        return out

    def _batch_all_fn(self, index, vals_list, sibs_list, commits):
        """All commitment batches' Merkle openings (verifier.rs:276-294).

        index: (N,) lanes; vals_list[b]: GL (N, rows, cols); sibs_list[b]:
        GL (N, D, 4); commits[b]: GL (N, 4).  Returns ok (N,).

        When every batch's leaf row fits one sponge chunk and the paths
        share a depth (the Fibonacci family), the walks fuse: leaves
        zero-pad to RATE (the overwrite sponge starts at zero, so this is
        hash-identical, commit.rs:37-45) and the batches stack on the lane
        axis, so 1 + D launches cover them all.  Otherwise (wider rows,
        mixed depths) each batch walks on its own."""
        N = index.shape[0]
        widths = [v.shape[-2] * v.shape[-1] for v in vals_list]
        depths = {s.shape[-2] for s in sibs_list}
        if len(depths) != 1 or any(wd > RATE for wd in widths):
            ok = None
            for v, s, c in zip(vals_list, sibs_list, commits):
                okb = verify_batch_single(c, v.reshape(N, -1), index, s)
                ok = okb if ok is None else ok & okb
            return ok

        NB = len(vals_list)
        leaves = []
        for v, wd in zip(vals_list, widths):
            leaf = v.reshape(N, wd)
            if wd < RATE:
                leaf = gl.concatenate(
                    [leaf, gl.zeros((N, RATE - wd), self.device)], dim=-1)
            leaves.append(leaf)
        root, _ = merkle_path(hash_rows(gl.concatenate(leaves)),
                              index.repeat(NB),
                              gl.concatenate(list(sibs_list)))
        roots = root.reshape(NB, N, 4)
        return gl.eq(roots, gl.stack(list(commits))).all(dim=-1).all(dim=0)

    def _batched_batch_all_fn(self, index, vals_list, sibs_list, commits):
        """_batch_all_fn on (B, Q): index (B, Q), vals_list[b] (B, Q, M, C),
        sibs_list[b] (B, Q, D, 4), commits[b] (B, 4) -> ok (B, Q)."""
        B, Q = index.shape

        def flat(x):
            return tree_map(lambda a: a.reshape(B * Q, *a.shape[2:]), x)

        coms = [tree_map(lambda a: a[:, None, :].expand(B, Q, 4)
                         .reshape(B * Q, 4), c) for c in commits]
        ok = self._batch_all_fn(index.reshape(B * Q),
                                [flat(v) for v in vals_list],
                                [flat(s) for s in sibs_list], coms)
        return ok.reshape(B, Q)

    def _ro_fn(self, index, zeta: GL2, zeta_next: GL2, alpha_fri: GL2,
               batch_values, trace_local: GL2, trace_next: GL2,
               quotient_chunks: GL2, stage2_local: GL2 = None,
               stage2_next: GL2 = None) -> GL2:
        """Reduced-opening accumulators (verifier.rs:296-344): index (B, Q);
        zeta, zeta_next, alpha_fri (B,); batch_values[b] (B, Q, M, C);
        trace_local/next (B, w); quotient_chunks (B, n, 2); stage2_local/
        next (B, s2w) for a multi-stage AIR.  Returns GL2 (B, L, Q).

        Terms sharing (point z, log_height) share the denominator (x - z),
        so each group reduces to inv(x - z) * sum_c alpha^(k0+c) *
        (p_c(x) - p_c(z)), with one inversion for all groups: the
        reference's per-term loop (verifier.rs:313-338), reassociated."""
        B, Q = index.shape
        dev = self.device
        w = self.config.trace_width

        x_of_h = {}  # x per distinct log_height (verifier.rs:306-311)
        for h in self.mat_heights:
            if h not in x_of_h:
                rev = reverse_bits_len_u32(
                    index >> (self.log_max_height - h), h)
                x_of_h[h] = gl.mul(gl.full((), 7, dev),
                                   gl.pow_u32(Gl.two_adic_generator(h), rev, h))

        pow_stack = tree_map(lambda a: a.T, gl2.power_stack(
            alpha_fri, self.max_alpha_pow))                  # (B, K)

        h_trace, h_quot = self.mat_heights[0], self.mat_heights[-1]
        nq = self.quotient_degree * EXT_DEGREE
        s2w = self.s2w
        groups = [
            # (p_at_x (B, Q, C), p_at_z (B, C), z (B,), height, k0)
            (batch_values[0][:, :, 0, :], trace_local, zeta, h_trace, 0),
            (batch_values[0][:, :, 0, :], trace_next, zeta_next, h_trace, w),
        ]
        if s2w:
            groups += [
                (batch_values[1][:, :, 0, :], stage2_local, zeta, h_trace,
                 2 * w),
                (batch_values[1][:, :, 0, :], stage2_next, zeta_next,
                 h_trace, 2 * w + s2w)]
        groups.append(
            (batch_values[-1].reshape(B, Q, nq), quotient_chunks.reshape(B, nq),
             zeta, h_quot, 2 * w + 2 * s2w if h_quot == h_trace else 0))
        sums, dens, heights = [], [], []
        for p_at_x, p_at_z, z, h, k0 in groups:
            C = p_at_x.shape[-1]
            num = gl2.add_base(
                gl2.broadcast_to(gl2.neg(p_at_z)[:, None, :], (B, Q, C)),
                p_at_x)
            weighted = gl2.mul(pow_stack[:, None, k0:k0 + C], num)
            sums.append(gl2.sum_dim(weighted, -1))           # (B, Q)
            dens.append(gl2.add_base(
                gl2.broadcast_to(gl2.neg(z)[:, None], (B, Q)), x_of_h[h]))
            heights.append(h)

        inv_dens = gl2.inv(gl2.stack(dens))                  # (G, B, Q)
        ro_by_height: Dict[int, GL2] = {}
        for gi, h in enumerate(heights):
            c = gl2.mul(sums[gi], inv_dens[gi])
            ro_by_height[h] = (c if h not in ro_by_height
                               else gl2.add(ro_by_height[h], c))
        zero = gl2.zeros((B, Q), dev)
        return gl2.stack([ro_by_height.get(h + 1, zero)
                          for h in self.fold_heights], dim=1)

    def _fold_core(self, index, phase_commits: GL, betas: GL2,
                   sib_vals: GL2, ro_stack: GL2, fold_sibs: GL,
                   final_poly: GL2):
        """FRI fold and query (verifier.rs:419-519) on N lanes: index (N,),
        phase_commits GL (L, N, 4), betas/sib_vals/ro_stack GL2 (L, N),
        fold_sibs GL (L, N, D, 4), final_poly GL2 (N,).  Returns ok (N,).

        Phase A runs the fold recurrence level by level (field arithmetic,
        no hashing).  Phase B then does all the hashing: the L per-level
        2-row leaves hash as one (L*N)-lane batch, and the L Merkle paths
        walk together over the largest depth with a per-lane validity mask
        (level l's path is L - l deep, serde/proof.rs:204-211).  This is the
        JAX package's uniform-depth walk.  Its depth-grouped walk, which
        masks fewer lanes but launches the kernel more often, is not
        ported: on the card this path is bound by launches, so fewer
        launches win (1 + 1 + L of them here).

        The interpolation denominator 1/(xs1 - xs0) = ±1/(2x) comes from a
        carried inv_x = g^-rev(idx), squared alongside x each level: the
        same field values as the reference's per-level division."""
        N = index.shape[0]
        L = self.n_phases
        dev = self.device
        g = Gl.two_adic_generator(self.log_max_height)
        rev = reverse_bits_len_u32(index, self.log_max_height)
        x = gl.pow_u32(g, rev, self.log_max_height)
        inv_x = gl.pow_u32(Gl.inv(g), rev, self.log_max_height)
        half = gl.full((), Gl.inv(2), dev)

        folded, idx = gl2.zeros((N,), dev), index
        e0s, e1s = [], []
        for l in range(L):
            folded = gl2.add(ro_stack[l], folded)
            is_odd = ((idx ^ 1) & 1).bool()          # index_sibling & 1
            e0 = gl2.select(is_odd, folded, sib_vals[l])
            e1 = gl2.select(is_odd, sib_vals[l], folded)
            # the sibling's x differs by the order-2 generator (-1):
            # xs0 = ±x and 1/(xs1 - xs0) = ±(1/2)·inv_x
            xs0 = gl.select(is_odd, x, gl.neg(x))
            inv_denom = gl.mul(half, inv_x)
            inv_denom = gl.select(is_odd, gl.neg(inv_denom), inv_denom)
            num = gl2.mul(gl2.sub(e1, e0), gl2.sub_base(betas[l], xs0))
            folded = gl2.add(e0, gl2.mul_base(num, inv_denom))
            e0s.append(e0)
            e1s.append(e1)
            idx, x, inv_x = idx >> 1, gl.square(x), gl.square(inv_x)

        # leaf row = [e0.c0, e0.c1, e1.c0, e1.c1] (verifier.rs:471-481)
        leaf = gl.stack([gl.stack([e0.c0, e0.c1, e1.c0, e1.c1], dim=-1)
                         for e0, e1 in zip(e0s, e1s)])       # (L, N, 4)
        digest = hash_rows(leaf.reshape(L * N, 4))
        # level l's path starts at the pair index, index >> (l + 1)
        shifts = torch.arange(1, L + 1, device=dev)[:, None]
        idx_paths = (index[None, :] >> shifts).reshape(L * N)
        D = fold_sibs.shape[-2]
        valid = self.fold_valid[:, None, :D].expand(L, N, D).reshape(L * N, D).T
        root, _ = merkle_path(digest, idx_paths,
                              fold_sibs.reshape(L * N, D, 4), valid)
        ok = gl.eq(root.reshape(L, N, 4), phase_commits).all(dim=-1).all(dim=0)
        return gl2.eq(folded, final_poly) & ok

    def _batched_fold_fn(self, index, phase_commits: GL, betas_stack: GL2,
                         sib_vals: GL2, ro_stack: GL2, fold_sibs: GL,
                         final_poly: GL2):
        """_fold_core on (B, Q): index (B, Q), phase_commits (B, L, 4),
        betas_stack (B, L), sib_vals/ro_stack (B, L, Q), fold_sibs
        (B, L, Q, D, 4), final_poly (B,) -> verdicts (B,)."""
        B, Q = index.shape
        L = self.n_phases

        def lvl_flat(x):      # (B, L, Q, ...) -> (L, B*Q, ...)
            return tree_map(lambda a: a.movedim(0, 1)
                            .reshape(L, B * Q, *a.shape[3:]), x)

        def lvl_bcast(x):     # (B, L, ...) -> (L, B*Q, ...)
            return tree_map(lambda a: a.movedim(0, 1)[:, :, None]
                            .expand(L, B, Q, *a.shape[2:])
                            .reshape(L, B * Q, *a.shape[2:]), x)

        fp = tree_map(lambda a: a[:, None].expand(B, Q).reshape(B * Q),
                      final_poly)
        per_q = self._fold_core(
            index.reshape(B * Q), lvl_bcast(phase_commits),
            lvl_bcast(betas_stack), lvl_flat(sib_vals), lvl_flat(ro_stack),
            lvl_flat(fold_sibs), fp)
        return per_q.reshape(B, Q).all(dim=1)

    def _quotient_at(self, zeta: GL2, quotient_chunks: GL2) -> GL2:
        """The quotient at zeta from its chunks' openings (verifier.rs:
        169-197): zeta (B,), quotient_chunks (B, n, 2) -> GL2 (B,).  Chunk
        i weighs in by prod_{j != i} zp_j(zeta) / zp_j(first_i)."""
        B = zeta.shape[0]
        dev = self.device
        one = gl2.ones((), dev)
        zp_at_zeta = []
        for dom in self.quotient_chunks_domains:
            u = gl2.mul_base(zeta, gl.full((), Gl.inv(dom.shift), dev))
            zp_at_zeta.append(gl2.sub(gl2.exp_power_of_2(u, dom.log_n), one))
        quotient = gl2.zeros((B,), dev)
        for i in range(self.quotient_degree):
            zps_i = gl2.from_base(gl.full((B,), self.zps_host[i], dev))
            for j in range(self.quotient_degree):
                if j != i:
                    zps_i = gl2.mul(zps_i, zp_at_zeta[j])
            for e in range(EXT_DEGREE):
                c = quotient_chunks[:, i, e]
                quotient = gl2.add(quotient, gl2.mul(
                    zps_i, gl2.mul(gl2.monomial(e, (), dev), c)))
        return quotient

    def _final_fn(self, alpha: GL2, zeta: GL2, trace_local: GL2,
                  trace_next: GL2, quotient_chunks: GL2, publics=None,
                  stage2_local: GL2 = None, stage2_next: GL2 = None,
                  challenges=None):
        """Quotient reconstruction, Lagrange selectors and the AIR fold
        (verifier.rs:169-239): alpha, zeta (B,); trace_local/next (B, w);
        quotient_chunks (B, n, 2); for a multi-stage AIR stage2_local/next
        (B, s2w) and the challenges, GL2 (B,) each.  Returns ok (B,)."""
        B = zeta.shape[0]
        dev = self.device
        one = gl2.ones((), dev)

        def base(v: int) -> GL:
            return gl.full((), v, dev)

        quotient = self._quotient_at(zeta, quotient_chunks)

        # Lagrange selectors (two_adic.rs:92-122), one inversion for three
        unshifted = gl2.mul_base(zeta, base(Gl.inv(self.trace_domain.shift)))
        z_h = gl2.sub(
            gl2.exp_power_of_2(unshifted, self.trace_domain.log_n), one)
        d_first = gl2.sub_base(unshifted, base(1))
        d_last = gl2.sub_base(unshifted, base(Gl.inv(self.trace_domain.gen())))
        invs3 = gl2.inv(gl2.stack([d_first, d_last, z_h]))

        main = Main(
            _columns_first(trace_local), _columns_first(trace_next),
            quotient_chunks=[[quotient_chunks[:, c, e] for e in range(EXT_DEGREE)]
                             for c in range(self.quotient_degree)],
            stage2_local_vec=(_columns_first(stage2_local) if self.s2w
                              else None),
            stage2_next_vec=(_columns_first(stage2_next) if self.s2w
                             else None),
        )
        folder = VerifierConstraintFolder(
            ops=gl2.Ops((B,), dev),
            main=main,
            is_first_row=gl2.mul(z_h, invs3[0]),
            is_last_row=gl2.mul(z_h, invs3[1]),
            is_transition=d_last,
            alpha=alpha,
            publics=publics,
            challenges=challenges,
        )
        self.air.eval(folder)
        return gl2.eq(gl2.mul(folder.accumulator, invs3[2]), quotient)

    # ------------------------------------------------------------ entry points
    def verify_witnesses(self, ws: Dict, on_stage=None,
                         publics=None, run=None) -> Dict:
        """Run the five stages on a stacked witness (leading proof axis B).

        Returns a dict of per-proof tensors: ok, pow_ok, merkle_ok, fold_ok,
        quotient_ok (B,), alpha, zeta GL2 (B,), index (B, Q) and samples
        (B, n_samples).  `on_stage(name)`, if given, is called after each
        stage is enqueued (chip_smoke.py records CUDA events there).
        `publics` (GL2 scalars by name) defaults to the AIR's own.
        `run(name, fn, *args)` runs each stage, by the JAX BatchVerifier's
        program names `_t`, `_b`, `_r`, `_f`, `_fin` (parallel/batch.py
        runs them as its stage programs); by default it calls fn(*args)."""
        mark = on_stage or (lambda name: None)
        run = run or (lambda name, fn, *args: fn(*args))
        if publics is None:
            publics = _publics(self.air, self.device)
        t = run("_t", self._transcript_fn, ws["obs"])
        index = t["index"]
        mark("transcript")
        commits = [t["trace_commit"]]
        if self.s2w:
            commits.append(t["stage2_commit"])
        commits.append(t["quotient_commit"])
        merkle_ok = run("_b", self._batched_batch_all_fn, index,
                        ws["batch_values"], ws["batch_sibs"],
                        commits).all(dim=-1)
        mark("merkle")
        ro_stack = run(
            "_r", self._ro_fn, index, t["zeta"], t["zeta_next"],
            t["alpha_fri"], ws["batch_values"], ws["trace_local"],
            ws["trace_next"], ws["quotient_chunks"], ws.get("stage2_local"),
            ws.get("stage2_next"))
        mark("reduced_openings")
        fold_ok = run(
            "_f", self._batched_fold_fn, index, t["phase_commits"],
            t["betas_stack"], ws["fold_sibling_values"], ro_stack,
            ws["fold_sibs"], ws["final_poly"])
        mark("fold")
        # publics broadcast across the proof axis (JAX's in_axes None)
        quotient_ok = run(
            "_fin", self._final_fn, t["alpha"], t["zeta"], ws["trace_local"],
            ws["trace_next"], ws["quotient_chunks"], publics,
            ws.get("stage2_local"), ws.get("stage2_next"),
            t.get("challenges"))
        mark("final")
        return {
            "ok": t["pow_ok"] & merkle_ok & fold_ok & quotient_ok,
            "pow_ok": t["pow_ok"], "merkle_ok": merkle_ok,
            "fold_ok": fold_ok, "quotient_ok": quotient_ok,
            "alpha": t["alpha"], "zeta": t["zeta"], "index": index,
            "samples": t["samples"],
        }

    def verify_witness(self, w: Dict) -> VerifyResult:
        """Verify one packed witness (a batch of one)."""
        r = self.verify_witnesses(tree_map(lambda a: a[None], w))
        return VerifyResult(
            ok=r["ok"][0], pow_ok=r["pow_ok"][0], merkle_ok=r["merkle_ok"][0],
            fold_ok=r["fold_ok"][0], quotient_ok=r["quotient_ok"][0],
            shape_ok=True, alpha=r["alpha"][0], zeta=r["zeta"][0],
            query_indices=r["index"][0])

    def _verify_all_fn(self, w: Dict, publics: Dict) -> Dict:
        """All five stages on one packed witness, with the publics as an
        input (plonky25_tpu/verifier.py:752-798): verify_witnesses at
        B = 1.  Returns ok, pow_ok, merkle_ok, fold_ok, quotient_ok (0-d),
        alpha, zeta (GL2 scalars), index (Q,) and samples (n_samples,)."""
        r = self.verify_witnesses(tree_map(lambda a: a[None], w),
                                  publics=publics)
        return tree_map(lambda a: a[0], r)

    def _s_all(self, w: Dict, publics: Dict) -> Dict:
        """_verify_all_fn as one program (the JAX verifier's jitted
        `_s_all`): a CUDA graph on the card, captured at the first call;
        copies of its outputs."""
        with self._program_lock:
            if self._program is None:
                self._program = StaticProgram(self._verify_all_fn,
                                              (w, publics), self.device,
                                              name="verify_all")
        return self._program(w, publics)

    def verify_witness_fused(self, w: Dict) -> VerifyResult:
        """Verify one packed witness in one program (see _s_all); the
        publics are the AIR's, read at every call."""
        r = self._s_all(w, _publics(self.air, self.device))
        return VerifyResult(
            ok=r["ok"], pow_ok=r["pow_ok"], merkle_ok=r["merkle_ok"],
            fold_ok=r["fold_ok"], quotient_ok=r["quotient_ok"],
            shape_ok=True, alpha=r["alpha"], zeta=r["zeta"],
            query_indices=r["index"])

    def check_shape(self, proof: Proof) -> bool:
        """Host-side shape validation (verifier.rs:126-133, 372-374)."""
        try:
            check_proof_shape(proof, self.config)
        except InvalidProofShape:
            return False
        return (len(proof.opened_values.trace_local) == self.air.width()
                and len(proof.opened_values.stage2_local or [])
                == self.air.stage2_width())

    def fri_challenges(self, proof: Proof) -> FriChallenges:
        """The proof's FRI betas and query indices (serde/fri.rs:10-13)."""
        obs = pack_witness(proof, self.config, self.device)["obs"]
        t = self._transcript_fn(obs[None])
        bs = t["betas_stack"][0]
        betas = [(int(c0), int(c1)) for c0, c1 in
                 zip(gl.to_u64(bs.c0), gl.to_u64(bs.c1))]
        return FriChallenges(query_indices=t["index"][0].tolist(), betas=betas)

    def verify(self, proof: Proof, fused: bool = None) -> VerifyResult:
        """Verify one proof: fused (verify_witness_fused) or staged
        (verify_witness), by `fused_default(device)` when fused is None."""
        if not self.check_shape(proof):
            return _shape_fail(self.device)
        w = pack_witness(proof, self.config, self.device)
        if fused is None:
            fused = fused_default(self.device)
        return self.verify_witness_fused(w) if fused else self.verify_witness(w)


def fused_default(device="cuda") -> bool:
    """Whether a verification on `device` takes the fused programs (a
    single proof's `_s_all`; a batch's five stage programs from the second
    batch of a shape on, parallel/batch.py): on a CUDA device (where the
    staged path's host dispatch dominates its latency), not on the CPU,
    as the JAX package chooses for a TPU and a CPU.  The values are the
    same either way (tests/test_torch_fused.py,
    tests/test_torch_batch_programs.py)."""
    return torch.device(device).type == "cuda"


_verifier_cache: Dict = {}


def get_verifier(air: Air, config: P3Config, device="cuda") -> TorchVerifier:
    """A cached TorchVerifier for (AIR class, proof shape, device).  As in
    the JAX package, a cache hit takes the caller's `air` (its publics),
    which the fused program copies into its input buffers at every call."""
    device = resolve_device(device)
    key = (
        type(air).__module__, type(air).__qualname__, air.name(), air.width(),
        config.log_quotient_degree, config.log_trace_height,
        config.trace_width, config.opening_matrix_log_max_height,
        config.quotient_opened_values_len, config.degree_bits,
        config.fri_config.log_blowup, config.fri_config.num_queries,
        config.fri_config.proof_of_work_bits, config.stage2_width,
        air.num_challenges() if config.stage2_width else 0,
        config.ext_degree, str(device),
    )
    v = _verifier_cache.get(key)
    if v is None:
        v = TorchVerifier(air, config, device)
        _verifier_cache[key] = v
    else:
        v.air = air
    return v


def _shape_fail(device) -> VerifyResult:
    f = torch.tensor(False, device=device)
    return VerifyResult(ok=f, pow_ok=f, merkle_ok=f, fold_ok=f,
                        quotient_ok=f, shape_ok=False)


def verify_proof(proof: Proof, air: Air, fri_config: FriConfig,
                 device="cuda") -> VerifyResult:
    """One-call API mirroring CircuitBuilder::p3_verify_proof
    (p3/mod.rs:66-94); the config is derived from the proof's own shape.

    Fail-closed on malformed proofs: the exhaustive shape check runs before
    the shape-specialized verifier is built, so a damaged proof yields
    shape_ok=False and cannot crash specialization or witness packing."""
    device = resolve_device(device)
    try:
        config = derive_config(proof, fri_config)
        check_proof_shape(proof, config)
    except InvalidProofShape:
        return _shape_fail(device)
    if (len(proof.opened_values.trace_local) != air.width()
            or config.stage2_width != air.stage2_width()):
        return _shape_fail(device)
    return get_verifier(air, config, device).verify(proof)


def _publics(air: Air, device) -> Dict[str, GL2]:
    """Air.public_values() host ints -> GL2 scalars."""
    return {k: gl2.from_base(gl.full((), v, device))
            for k, v in air.public_values().items()}
