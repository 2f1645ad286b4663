"""Plonky3-compatible STARK prover on PyTorch tensors; the counterpart of
plonky25_tpu/prover/prove.py (TpuProver, prove_on_device).

Proofs are bit-identical to the JAX package's and the int oracle's
(plonky25_tpu/refimpl/prover.py).  The stages are those of TpuProver:

  * `_commit_matrix`: the trace's coset LDE in bit-reversed order, kept
    as columns (B, W, N), the layout the lane-major Merkle trees take
    (`_commit_trace_fn` over column chunks);
  * `_stage2_cols`: a multi-stage AIR's stage-2 columns, from the trace and
    the challenges sampled after its commitment (committed like the
    trace);
  * `_quotient_fn`: the AIR's constraint fold over the quotient coset,
    divided by the vanishing polynomial;
  * `_commit_chunks_fn`: the quotient chunks' LDEs as base columns;
  * `_opened_fn`: openings at zeta and zeta * g (barycentric);
  * `_ro_fn`: the FRI input, the reduced openings at every LDE point;
  * `_fold_phase_raw`: one FRI commit phase (sibling rows, fold step);
  * `_grind_fn`: one window of proof-of-work witnesses (2^16, fewer for a
    low proof_of_work_bits: `grind_window`).

Every stage takes a leading proof axis B: one proof is a batch of one, and
`batch_prove.BatchProver` runs the same stages on B traces in lockstep.
Every Merkle tree level and grind window is one launch of the lane-major
Poseidon2 kernel over the whole batch; every transcript duplex is one
launch of the state-major kernel.  Tables that depend only on the shape
(selectors, coset points, fold twiddles and their inverses) are built on
the device and cached per prover instance.  The transcript stays on the
device until the grind's first `found` check, and the proof is assembled
from one device-to-host copy.

Wide AIRs (KeccakAir: 2,633 columns) bound their temporaries with the JAX
prover's four memory strategies, each giving the same proof bytes as the
one-shot stage (every transform is per column, the field is exact):

  * column chunks of the LDE commits (`commit_col_chunks`);
  * strided sub-coset segmentation of the quotient (`quotient_eval_chunks`
    = S): segment c is the coset 7 * g_q^c * <g_M>, M = q / S, evaluated
    from the trace's coefficients by a weighted fold and one length-M NTT,
    so the AIR's eval runs S times at (B, M) points and the (W, B, q)
    locals and nexts are never made;
  * column groups of that segmentation's transforms (`quotient_col_groups`);
  * column slabs of the opened values (`_bary_col_slab`) and of the reduced
    openings (`_ro_col_slab`).

A knob left at None is worked out per call from the batch size and the
byte budgets below; `prove_on_device` picks S from the trace's size and
QUOTIENT_EVAL_BYTES, as the JAX package's prove_on_device does from its
own budget.

`TpuProver` is `TorchProver` here.  Its `warmup` runs every stage once
on zero-filled inputs of the prover's shape, so that the first proof
pays no first-use cost: here the kernel libraries' build, the loading of
PyTorch's kernel modules, the caching allocator's growth and the
prover's tables, where JAX compiled its XLA modules.

With `lde_mesh` (a 1-D torch.distributed DeviceMesh) the LDE commits take
the JAX prover's multi-device route: the coefficients, zero-padded, go
through the four-step transform with its rows split over the mesh's ranks
(`ops.ntt.coset_ntt_four_step`, two all-to-alls and an all-gather), then
the bit-reversal gather; every rank holds the whole LDE and runs the rest
of the proof replicated.  The proof bytes are those of the unmeshed route.

Stage programs.  The JAX prover compiles every stage (`_s_commit_trace`,
`_s_quotient`, `_s_commit_chunks`, `_s_opened`, `_s_ro`, `_grind`, a
rows and a step program per FRI phase, the tree builds and path
openings of ops/mmcs.py).  Here each runs either staged, op by op from
the host, or as a utils/graphs.py StaticProgram: on the card a CUDA graph
captured once and replayed, on the CPU the stage function on the
program's buffers.  `_prove_device` names the programs: commit_trace
(`_commit_matrix`, every column chunk inside), tree_trace, stage2 (an
AIR's device builder), commit_stage2, tree_stage2, quotient,
commit_chunks, tree_quotient, opened, reduced_openings, fold_rows_k,
fold_tree_k and fold_step_k per phase, grind (one window, its first
witness a device input) and queries (every tree's `_open_paths` and the
query gathers).  A utils/graphs.py `ProgramSet` holds the programs of one
signature (the prover and its batch size); they share one memory pool,
always replay in capture order under one lock, held until the proof's
values are pulled, and pass their LDEs and trees on without a copy.

These stay eager, between the programs: the DeviceChallenger's duplexes
(one kernel launch and a copy each, which a graph launch would not make
cheaper; JAX runs them as small jits), the grind's data-dependent window
loop (a host loop in JAX too), the host stage-2 builder of an AIR without
a device one, and the proofs' assembly.  An `lde_mesh` prover runs staged:
collectives run between its stages.

`plan(cols, fused)` decides, as parallel/batch.py's BatchVerifier does
for its batches: with fused=None on the card a signature's first proof
runs staged (a one-shot proof pays no capture), its second in a row on
the device captures, later ones replay; fused=True or False decides
outright (attest.py proves an attestation's STARK, which it proves once,
with fused=False); on the CPU None means staged.  `warmup` captures on the card,
so the first proof after it replays.  At most one set of programs is
held per device, that of the last signature proved there: a proof of any
other signature, on any prover, staged or not, first drops it with its
pool and buffers (so two signatures proved in turns both run staged),
and so does `release_programs()` or dropping the prover.  A replayed
proof launches the kernels of a staged one and gives the same bytes; a
failed capture raises.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List

import numpy as np
import torch

from ..air import (Air, Main, VerifierConstraintFolder,
                   check_multistage_consistency)
from ..constants import EXT_DEGREE, GOLDILOCKS_P as P
from ..device import resolve_device
from ..fields import gl, gl2
from ..fields.extension import GL2, Ops
from ..fields.goldilocks import GL
from ..models.multiset_air import ZERO_DENOMINATOR
from ..ops.mmcs import _build_tree, _open_paths
from ..ops.ntt import (_bitrev, barycentric_eval_ext, coset_intt,
                       coset_lde_pair, coset_lde_to_rev, coset_ntt_four_step,
                       coset_points, intt, ntt, powers)
from ..ops.poseidon2 import load_kernels, poseidon2_permute_soa
from ..proof import (
    BatchOpening,
    Commitment,
    Commitments,
    CommitPhaseProofStep,
    FriConfig,
    FriProof,
    OpenedValues,
    Proof,
    QueryProof,
    TwoAdicFriPcsProof,
)
from ..refimpl.field import Gl
from ..utils.bits import log2_ceil, log2_strict, reverse_bits_len_u32
from ..utils import profiling
from ..utils.graphs import ProgramSet, StaticProgram
from ..utils.tree import tree_map, tree_signature
from ..verifier import _publics, fused_default
from .device_challenger import DeviceChallenger

GRIND_WINDOW = 1 << 16

# Byte budgets of the memory strategies, for knobs left at None.  A base
# value is two int64 limbs (16 bytes), a GF(p^2) value 32.  Derived from
# scripts/prover_memory.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# on KeccakAir 2^12 x 2,633 every stage's peak grows linearly with
# B, and a stage's temporaries beyond what it holds are about 7.65 times
# the base-field output of an NTT-based transform (the LDE commit: 3.29 GB
# per proof one-shot, 1.31 GB in 4 chunks) and about 5.2 times the GF(p^2)
# product of a column sum (opened 2.34 GB, reduced openings 4.16 GB
# one-shot; 0.71, 0.89 GB in 256-column slabs).  Each budget keeps those
# temporaries near 16 GB, a fifth of the card, so that no stage needs
# more than the AIR's eval at the batched Keccak shape (B=8, S=4: 19.8 GB);
# splitting further only adds kernel launches (the JAX prover's 256-column
# reduced-opening slab, sized for a 15.75 GB TPU, cost a 2^12 Keccak proof
# 11k more kernels here).
LDE_CHUNK_BYTES = 2 << 30       # LDE output of one column chunk
QUOTIENT_GROUP_BYTES = 2 << 30  # coefficients of one column group
SLAB_BYTES = 3 << 30            # GF(p^2) (B, slab, N) product of one slab
# prove_on_device's quotient segmentation: S doubles while the eval's
# working set, W * q * 32 bytes (locals and nexts as GF(p^2) values at the
# q = 2^(log_n + lqd) quotient points), divided by S exceeds this budget.
# From scripts/prover_memory.py --air verifier on the same card (PERF.md):
# on VerifierAir (620 columns) the quotient stage's temporaries are about
# 9.8 times the working set per segment (2^16: 25.3, 13.0, 6.5 GB at S = 1,
# 2, 4; 2^19: 25.7 and 12.9 GB at S = 8 and 16, beside 21.8 GB that the
# trace, its LDE and coefficients hold).  3 GiB keeps S = 1 up to 2^16 rows
# (peak 28.0 GB) and gives the 2^19 outer STARK of a composed attestation
# S = 8 (peak 47.5 GB, 53 s) rather than JAX's 16 (34.6 GB, 77 s); JAX's
# 2 GiB was sized for a 15.75 GB TPU.
QUOTIENT_EVAL_BYTES = 3 << 30


def grind_window(fri_config: FriConfig) -> int:
    """PoW witnesses one grind launch tries: 2^(bits + 4), at most
    GRIND_WINDOW.  A window holds a witness unless all its 2^(bits + 4)
    tries miss (probability below e^-16), so a low-bit grind costs a
    small launch; the windows ascend, so the first witness found is the
    same whatever the window."""
    return min(GRIND_WINDOW, 1 << (fri_config.proof_of_work_bits + 4))


class TorchProver:
    """Shape-specialized prover for GF(p^2) AIRs, single- or multi-stage;
    tables are cached per instance."""

    def __init__(self, air: Air, log_n: int, fri_config: FriConfig,
                 device="cuda", quotient_eval_chunks: int = 1,
                 quotient_col_groups: int = None, lde_mesh=None,
                 lde_log_rows: int = 3):
        self.device = resolve_device(device)
        check_multistage_consistency(air)
        if lde_mesh is not None and lde_mesh.device_type != self.device.type:
            raise ValueError(f"a {lde_mesh.device_type} lde_mesh for a "
                             f"{self.device.type} prover")
        # the four-step LDE's mesh and its (2^lde_log_rows, N / 2^...) view
        self.lde_mesh = lde_mesh
        self.lde_log_rows = lde_log_rows
        self.air = air
        self.log_n = log_n
        self.fc = fri_config
        self.width = air.width()
        self.s2w = air.stage2_width()
        self.n_challenges = air.num_challenges()
        self.lqd = log2_ceil(getattr(air, "quotient_degree", lambda: 1)())
        self.n_chunks = 1 << self.lqd
        self.q_log_n = log_n + self.lqd
        self.log_max = log_n + fri_config.log_blowup
        if self.log_max > 32:
            raise ValueError("query indices beyond 32 bits are unsupported")
        self.g_t = Gl.two_adic_generator(log_n)
        self.g_q = Gl.two_adic_generator(self.q_log_n)
        self.chunk_shifts = [7 * pow(self.g_q, ci, P) % P
                             for ci in range(self.n_chunks)]
        s = quotient_eval_chunks
        if s < 1 or s & (s - 1) or s > 1 << self.q_log_n:
            raise ValueError(f"quotient_eval_chunks={s}: want a power of "
                             f"two in [1, {1 << self.q_log_n}]")
        # the memory strategies (module docstring); None: from the budgets
        self.quotient_eval_chunks = s
        self.quotient_col_groups = quotient_col_groups
        self.commit_col_chunks = None
        self._ro_col_slab = None        # None: from the width; halved
        self._bary_col_slab = None
        self._selectors = None
        self._segment_weights = None
        self._ro_xs = None
        self._fold_cache: Dict = {}
        self._programs = None   # ProgramSet of one signature (plan)

    def table_sizes(self) -> Dict[str, int]:
        """The entries of this prover's tables: a capture checks that none
        is made during it (utils/graphs.py)."""
        return {"selectors": self._selectors is not None,
                "segment_weights": self._segment_weights is not None,
                "ro_points": self._ro_xs is not None,
                "fold": len(self._fold_cache)}

    # ------------------------------------------------------------ tables
    def selectors(self):
        """(is_first, is_last, is_transition, 1/Z_H) on the quotient coset
        7 * <g_q> (two_adic.rs:92-122; trace domain shift 1), GL (q,)."""
        if self._selectors is None:
            dev = self.device
            q_size = 1 << self.q_log_n
            xs = coset_points(self.q_log_n, 7, dev)
            zh = gl.sub(gl.pow_const(xs, 1 << self.log_n), gl.ones((q_size,), dev))
            d_first = gl.sub(xs, gl.ones((q_size,), dev))
            d_last = gl.sub(xs, gl.full((q_size,), Gl.inv(self.g_t), dev))
            invs = gl.inv(gl.stack([d_first, d_last, zh]))    # one inversion
            self._selectors = (gl.mul(zh, invs[0]), gl.mul(zh, invs[1]),
                               d_last, invs[2])
        return self._selectors

    def ro_points(self) -> GL:
        """7 * g^rev(i) at the LDE's bit-reversed positions, GL (N,)."""
        if self._ro_xs is None:
            self._ro_xs = coset_points(self.log_max, 7, self.device)[
                _bitrev(self.log_max, self.device)]
        return self._ro_xs

    def segment_weights(self):
        """The fold weights of the strided quotient segments, GL (S, h)
        each: shift_c^j for j in [h], shift_c = 7 * g_q^c for the locals
        and g_t * 7 * g_q^c for the nexts (the JAX prover's w[c, k, m] =
        shift_c^(m + kM), one row per segment)."""
        if self._segment_weights is None:
            h, s = 1 << self.log_n, self.quotient_eval_chunks
            shifts = [7 * pow(self.g_q, c, P) % P for c in range(s)]
            self._segment_weights = tuple(
                gl.stack([powers(f * sc, h, self.device) for sc in shifts])
                for f in (1, self.g_t))
        return self._segment_weights

    # ------------------------------------------------------------ stages
    def _commit_trace_fn(self, cols: GL) -> GL:
        """cols (B, W, H) on <g_H> -> the LDE on 7 * <g_N>, bit-reversed,
        as columns (B, W, N).  With lde_mesh, the JAX prover's route
        (:184-194): coefficients, zero padding to N, the four-step coset
        transform over the mesh, the bit-reversal gather."""
        if self.lde_mesh is None:
            return coset_lde_to_rev(cols, 1, self.log_max - self.log_n)
        coeffs = coset_intt(cols, 1)
        pad = gl.zeros(cols.shape[:-1] + ((1 << self.log_max)
                                          - (1 << self.log_n),), self.device)
        lde = coset_ntt_four_step(
            gl.concatenate([coeffs, pad], dim=-1), 7,
            log_rows=self.lde_log_rows, mesh=self.lde_mesh,
            axis=self.lde_mesh.mesh_dim_names[0])
        return lde[..., _bitrev(self.log_max, self.device)]

    def _commit_matrix(self, cols: GL) -> GL:
        """_commit_trace_fn in `commit_col_chunks` column chunks, each
        written into one (B, W, N) output (the JAX prover's :166-177); in
        one piece with lde_mesh, as there (:171)."""
        b, w, h = cols.shape
        n = h << (self.log_max - self.log_n)
        k = self.commit_col_chunks or _pieces(b * w * n * 16, LDE_CHUNK_BYTES)
        if k <= 1 or w < 2 * k or self.lde_mesh is not None:
            return self._commit_trace_fn(cols)
        return _by_columns(cols, self._commit_trace_fn, n, -(-w // k))

    def _col_groups(self, b: int, w: int) -> int:
        """Columns per group of the segmented quotient's transforms: the
        JAX prover's exact-divisor search near G (:284-303), so that every
        group but a narrower last one has the same width."""
        g = self.quotient_col_groups or _pieces(
            b * w * (1 << self.log_n) * 16, QUOTIENT_GROUP_BYTES)
        if g <= 1 or w < 2 * g:
            return w
        for d in range(g, min(2 * g, w) + 1):
            if w % d == 0:
                return w // d
        return -(-w // g)

    def _stage2_cols(self, cols: GL, challenges):
        """Stage-2 columns (B, s2w, H) from the trace columns (B, W, H) and
        the sampled challenges, GL2 (B,) each -> (columns, zero).  An AIR
        with `build_stage2_device` stays on the device (the stage2
        program), through its `build_stage2_device_flagged` form where it
        has one: zero is then a device bool, true where the builder
        divided by zero, which the proof raises at its first sync, so
        that the program never waits for the host.  Otherwise zero is None
        and the challenges and the trace come to the host once, where
        `Air.build_stage2` runs for each proof of the batch (the same
        values either way)."""
        if self._device_stage2:
            flagged = getattr(self.air, "build_stage2_device_flagged", None)
            if flagged is not None:
                return flagged(cols, challenges)
            return self.air.build_stage2_device(cols, challenges), None
        host = _pull({"cols": cols, "ch": challenges})
        out = []
        for b in range(cols.shape[0]):
            rows = host["cols"][b].T.tolist()
            chs = [(int(c0[b]), int(c1[b])) for c0, c1 in host["ch"]]
            out.append([[v % P for v in col]
                        for col in self.air.build_stage2(rows, chs)])
        return gl.from_u64(np.asarray(out, dtype=object), self.device), None

    @property
    def _device_stage2(self) -> bool:
        """Whether the AIR builds its stage-2 columns on the device."""
        return getattr(self.air, "build_stage2_device", None) is not None

    def _quotient_fn(self, cols: GL, alpha: GL2, s2_cols: GL = None,
                     challenges=None, publics=None) -> GL2:
        """Constraint fold over the quotient coset divided by Z_H: cols
        (B, W, H), alpha (B,) -> quotient evaluations GL2 (B, q).  A
        multi-stage AIR also passes its stage-2 columns (B, s2w, H) and the
        challenges, GL2 (B,) each.  `publics` (GL2 scalars by name, an
        input of the quotient program) defaults to the AIR's own.  With
        quotient_eval_chunks S > 1 the coset is evaluated in S strided
        segments (`_quotient_segments`)."""
        if publics is None:
            publics = _publics(self.air, self.device)
        if self.quotient_eval_chunks > 1:
            return self._quotient_segments(cols, alpha, s2_cols, challenges,
                                           publics)
        q_size = 1 << self.q_log_n
        is_first, is_last, is_trans, inv_zh = self.selectors()

        def local_next(c: GL):
            """The columns (B, W, H) on the quotient coset and one row on,
            each as one GL2 (W, B, q): a view of the LDE with the column
            axis leading, c1 a broadcast zero."""
            locals_ = coset_lde_pair(c, 1, self.q_log_n - self.log_n)
            # the next row on the quotient coset is a rotation of the
            # locals: g_t * 7 * g_q^j = 7 * g_q^(j + 2^lqd)
            nexts = GL(torch.roll(locals_.lo, -self.n_chunks, -1),
                       torch.roll(locals_.hi, -self.n_chunks, -1))
            return _ext_columns_first(locals_), _ext_columns_first(nexts)

        main = Main(*local_next(cols), (),
                    *(local_next(s2_cols) if self.s2w else ()))
        acc = self._fold(main, (cols.shape[0], q_size),
                         (is_first, is_last, is_trans), alpha, challenges,
                         publics)
        return gl2.mul_base(acc, inv_zh)

    def _fold(self, main: Main, shape, selectors, alpha: GL2,
              challenges, publics) -> GL2:
        """The AIR's constraints folded at the points `shape` (B, q'), the
        selectors GL (q',) at those points."""
        is_first, is_last, is_trans = selectors
        folder = VerifierConstraintFolder(
            ops=Ops(shape, self.device),
            main=main,
            is_first_row=gl2.from_base(is_first),
            is_last_row=gl2.from_base(is_last),
            is_transition=gl2.from_base(is_trans),
            alpha=alpha[:, None],
            publics=publics,
            challenges=[c[:, None] for c in challenges or []],
        )
        self.air.eval(folder)
        return folder.accumulator

    def _quotient_segments(self, cols: GL, alpha: GL2, s2_cols: GL,
                           challenges, publics) -> GL2:
        """_quotient_fn in S strided sub-coset segments (the JAX prover's
        chunked branch, :305-404).  Segment c holds the quotient points
        j = c + S t, the coset 7 * g_q^c * <g_M>, M = q / S.  With the
        coefficients a of a column, its value there is

            sum_m (sum_k a_(m + kM) shift_c^(m + kM)) g_M^(m t),

        a weighted fold over k then one plain length-M NTT (`_segment`);
        the nexts take shift g_t * shift_c.  The coefficient transform and
        the folds run in column groups (`_col_groups`), and the AIR's eval
        runs once per segment at (B, M) points: its temporaries shrink by
        S, its kernel launches grow by S."""
        s = self.quotient_eval_chunks
        b = cols.shape[0]
        q_size = 1 << self.q_log_n
        m = q_size // s
        w_loc, w_nxt = self.segment_weights()
        *sel, inv_zh = self.selectors()
        step = self._col_groups(b, self.width)
        coeffs = _by_columns(cols, intt, cols.shape[-1], step)
        s2_coeffs = intt(s2_cols) if self.s2w else None
        dev = self.device
        out = GL2(*(GL(torch.empty((b, q_size), dtype=torch.int64, device=dev),
                       torch.empty((b, q_size), dtype=torch.int64, device=dev))
                    for _ in range(2)))
        for c in range(s):
            vecs = [_ext_columns_first(_by_columns(
                coeffs, lambda x, w=w: _segment(x, w, m), m, step))
                for w in (w_loc[c], w_nxt[c])]
            if self.s2w:
                vecs += [_ext_columns_first(_segment(s2_coeffs, w, m))
                         for w in (w_loc[c], w_nxt[c])]
            acc = self._fold(Main(vecs[0], vecs[1], (), *vecs[2:]), (b, m),
                             [x[c::s] for x in sel], alpha, challenges,
                             publics)
            # out[c + S t] = acc[t]
            tree_map(lambda d, v: d[:, c::s].copy_(v), out,
                     gl2.mul_base(acc, inv_zh[c::s]))
        return out

    def _commit_chunks_fn(self, q_evals: GL2) -> GL:
        """Split the quotient evaluations (B, q) into chunks and LDE each as
        EXT_DEGREE base columns: (B, n_chunks * D, 2^l), bit-reversed."""
        l = self.q_log_n - self.lqd + self.fc.log_blowup
        outs = []
        for ci in range(self.n_chunks):
            ev = q_evals[..., ci::self.n_chunks]
            cols = gl.stack([ev.c0, ev.c1], dim=-2)          # (B, D, q/ch)
            blow = l - log2_strict(cols.shape[-1])
            outs.append(coset_lde_to_rev(cols, self.chunk_shifts[ci], blow))
        return gl.concatenate(outs, dim=-2)

    def _fold_phase_raw(self, log_folded: int):
        """(rows_fn, step_fn) of the FRI commit phase folding 2m -> m
        values, m = 2^log_folded, with the phase's x0 and 1/(-2 x0) tables
        built once per instance."""
        if log_folded not in self._fold_cache:
            m = 1 << log_folded
            dev = self.device
            g_cur = Gl.two_adic_generator(log_folded + 1)
            e = reverse_bits_len_u32(
                2 * torch.arange(m, dtype=torch.int64, device=dev),
                log_folded + 1)
            x0 = powers(g_cur, 2 * m, dev)[e]
            den_inv = gl.inv(gl.neg(gl.double(x0)))

            def rows_fn(u: GL2):
                e0, e1 = u[..., 0::2], u[..., 1::2]
                rows = gl.stack([e0.c0, e0.c1, e1.c0, e1.c1], dim=-2)
                return rows, e0, e1                           # (B, 4, m)

            def step_fn(e0: GL2, e1: GL2, beta: GL2) -> GL2:
                num = gl2.mul(gl2.sub(e1, e0), gl2.sub_base(beta[..., None], x0))
                return gl2.add(e0, gl2.mul_base(num, den_inv))

            self._fold_cache[log_folded] = (rows_fn, step_fn, x0, den_inv)
        return self._fold_cache[log_folded][:2]

    def _opened_fn(self, cols: GL, q_evals: GL2, zeta: GL2,
                   s2_cols: GL = None):
        """Opened values: the trace at zeta and zeta * g (B, W), the
        quotient chunks at zeta (B, n_chunks, D), and for a multi-stage AIR
        the stage-2 columns at zeta and zeta * g (B, s2w)."""
        zeta_next = gl2.mul_base(zeta, gl.full((), self.g_t, self.device))
        b, h = cols.shape[0], cols.shape[-1]
        slab = self._bary_col_slab or max(8, SLAB_BYTES // (b * h * 32))

        def bary(m: GL, z: GL2) -> GL2:
            return barycentric_eval_ext(m, 1, z, col_slab=slab)

        tl, tn = bary(cols, zeta), bary(cols, zeta_next)
        qc = []
        for ci in range(self.n_chunks):
            ev = q_evals[..., ci::self.n_chunks]
            qc.append(barycentric_eval_ext(gl.stack([ev.c0, ev.c1], dim=-2),
                                           self.chunk_shifts[ci], zeta))
        out = (tl, tn, gl2.stack(qc, dim=-2))
        if self.s2w:
            out += (bary(s2_cols, zeta), bary(s2_cols, zeta_next))
        return out

    def _ro_fn(self, trace_lde: GL, q_lde: GL, tl: GL2, tn: GL2, qc: GL2,
               zeta: GL2, alpha_fri: GL2, s2_lde: GL = None,
               s2l: GL2 = None, s2n: GL2 = None) -> GL2:
        """FRI input at the LDE points (B, N), bit-reversed order, grouped
        as the verifier's reduced openings: for each (matrix, point)
        group, sum_c alpha^k (p_c(x) - p_c(z)) / (x - z).  The groups:
        the trace at zeta and zeta * g, [the stage-2 matrix at both,] the
        quotient chunks at zeta."""
        xs = self.ro_points()
        zeta_next = gl2.mul_base(zeta, gl.full((), self.g_t, self.device))
        w, s2w = self.width, self.s2w
        pow_stack = tree_map(lambda a: a.movedim(0, -1), gl2.power_stack(
            alpha_fri, 2 * w + 2 * s2w + self.n_chunks * EXT_DEGREE))  # (B, T)
        qc_flat = qc.reshape(qc.shape[0], -1)
        groups = [(trace_lde, tl, zeta, 0), (trace_lde, tn, zeta_next, w)]
        if s2w:
            groups += [(s2_lde, s2l, zeta, 2 * w),
                       (s2_lde, s2n, zeta_next, 2 * w + s2w)]
        groups.append((q_lde, qc_flat, zeta, 2 * w + 2 * s2w))
        b, n = trace_lde.shape[0], xs.shape[0]

        def col_sum(p_at_x: GL, p_at_z: GL2, coef: GL2) -> GL2:
            """sum_c coef_c (p_c(x) - p_c(z)) over the columns (B, C, N),
            in column slabs (the JAX prover's _col_sum, :592-618): the
            width starts at _ro_col_slab (C when None) and halves while a
            slab's (B, slab, N) product exceeds SLAB_BYTES; only that
            product is live."""
            c = p_at_x.shape[-2]
            slab = self._ro_col_slab or c
            while b * n * slab * 32 > SLAB_BYTES and slab > 32:
                slab //= 2
            step = c if c <= 2 * slab else slab
            acc = None
            for i in range(0, c, step):
                num = gl2.add_base(gl2.neg(p_at_z[..., i:i + step])[..., None],
                                   p_at_x[..., i:i + step, :])
                part = gl2.sum_dim(gl2.mul(coef[..., i:i + step, None], num),
                                   -2)
                acc = part if acc is None else gl2.add(acc, part)
            return acc

        sums, dens = [], []
        for p_at_x, p_at_z, z, k0 in groups:
            c = p_at_x.shape[-2]
            acc = col_sum(p_at_x, p_at_z, pow_stack[..., k0:k0 + c])
            sums.append(acc)
            dens.append(gl2.broadcast_to(
                gl2.add_base(gl2.neg(z)[..., None], xs), acc.shape))
        inv_dens = gl2.inv(gl2.stack(dens))                   # one inversion
        ro = gl2.mul(sums[0], inv_dens[0])
        for g in range(1, len(groups)):
            ro = gl2.add(ro, gl2.mul(sums[g], inv_dens[g]))
        return ro

    def _grind_fn(self, state_rest: GL, base, window: int = GRIND_WINDOW):
        """Try the witnesses [base, base + window) for every proof of the
        batch in one lane-major launch: state_rest (B, 11) -> (found (B,),
        first offset (B,)) for the first w whose permute([w, rest]) has
        lane 11's low proof_of_work_bits zero.  `base` is an int or a 0-d
        int64 tensor on the device (the grind program's input, loaded for
        each window)."""
        b = state_rest.shape[0]
        dev = self.device
        win = (1, b, window)
        w_lo = (torch.arange(window, dtype=torch.int64, device=dev)
                + base).expand(win)
        # witnesses < 2^32: lane 0's hi limb is zero
        lo = torch.cat([w_lo, state_rest.lo.T[:, :, None].expand(11, *win[1:])])
        hi = torch.cat([torch.zeros(win, dtype=torch.int64, device=dev),
                        state_rest.hi.T[:, :, None].expand(11, *win[1:])])
        out = poseidon2_permute_soa(GL(lo, hi))              # (12, B, 2^16)
        bits = self.fc.proof_of_work_bits
        ok = (out.lo[11] & ((1 << min(bits, 32)) - 1)) == 0
        if bits > 32:
            ok &= (out.hi[11] & ((1 << (bits - 32)) - 1)) == 0
        return ok.any(-1), ok.to(torch.uint8).argmax(-1)

    def _grind_window_fn(self, state_rest: GL, base: torch.Tensor):
        """_grind_fn over this prover's grind_window: the grind program."""
        return self._grind_fn(state_rest, base, grind_window(self.fc))

    # ------------------------------------------------------------ programs
    def plan(self, cols: GL, fused: bool = None) -> str:
        """What prove_columns(cols, fused=fused) will do: "staged",
        "capture" (make the stage programs of cols's signature and run
        them) or "replay" (module docstring).  Only the shapes of cols
        are read."""
        sig = tree_signature(cols)
        held = self._programs is not None and self._programs.signature == sig
        if self.lde_mesh is not None:
            if fused:
                raise ValueError("an lde_mesh prover runs staged: "
                                 "collectives run between its stages")
            return "staged"
        if fused is None:
            owner, last = _last_proof(self.device)
            fused = fused_default(self.device) and (
                held or (owner is self and last == sig))
        if not fused:
            return "staged"
        return "replay" if held else "capture"

    def programs(self) -> Dict[str, StaticProgram]:
        """The stage programs this prover holds, by name; empty when it
        holds none."""
        held = self._programs
        return dict(held.programs) if held is not None else {}

    def release_programs(self) -> None:
        """Drop this prover's stage programs, their memory pool and input
        buffers with them."""
        with _LAST_LOCK:
            self._programs = None

    # ------------------------------------------------------------ warmup
    def warmup(self, max_workers: int = 8) -> None:
        """Prove zero-filled columns of this prover's shape once and
        discard the values (the JAX TpuProver.warmup,
        plonky25_tpu/prover/prove.py:655): the kernel libraries are built,
        the tables cached and every kernel module loaded, and on the card
        the stage programs are captured, as JAX compiles its programs
        here, so the first proof replays them.  On the CPU, and with
        `lde_mesh` (every rank calls it: the LDE's collectives run), the
        stages run staged.  The proofs are the same bytes with or without
        it.  `max_workers` is kept for JAX's signature and unused: JAX
        compiled its modules in that many threads, and nothing here
        compiles in parallel."""
        self._warmup(1)

    def _warmup(self, b: int) -> None:
        """warmup at a batch of b proofs (BatchProver.warmup)."""
        if self.device.type == "cuda":
            load_kernels()
        cols = gl.zeros((b, self.width, 1 << self.log_n), self.device)
        self._host_values(cols, None, self.device.type == "cuda"
                          and self.lde_mesh is None)

    # ------------------------------------------------------------ prove
    def prove(self, trace, on_stage=None) -> Proof:
        """Prove one row-major trace (H rows of W host ints, or an
        (H, W) integer array)."""
        return self.prove_columns(trace_columns([trace], self.device),
                                  on_stage)[0]

    def prove_columns(self, cols: GL, on_stage=None, gather=None,
                      fused: bool = None) -> List[Proof]:
        """Prove the traces cols (B, W, H) in lockstep -> B proofs.
        `on_stage(name)` is called after each stage is enqueued (the
        hook the chip run times stages with).  `gather`, if given, maps
        the host arrays pulled for these B proofs to those of every proof
        to assemble (the meshed BatchProver's all-gather).  The stages run
        staged or as programs, as `plan(cols, fused)` says; the same
        bytes either way.  The call is the span `prove.call`, the proofs'
        assembly on the host `prove.assemble` (utils/profiling.py)."""
        mark = on_stage or (lambda name: None)
        if cols.shape[1:] != (self.width, 1 << self.log_n):
            raise ValueError(f"trace columns {cols.shape}: want (B, "
                             f"{self.width}, {1 << self.log_n})")
        with profiling.span("prove.call"):
            host = self._host_values(cols, mark, fused)
            if not host["pow_ok"]:
                raise AssertionError("PoW self-check failed")
            if not host["low_degree_ok"]:
                raise AssertionError("FRI input not low-degree")
            if gather is not None:
                host = gather(host)
            with profiling.span("prove.assemble"):
                proofs = [self._assemble(host, i)
                          for i in range(len(host["wit"]))]
            mark("queries")
            return proofs

    def _host_values(self, cols: GL, mark, fused) -> Dict:
        """The host arrays of the proofs of cols, through the stage
        programs or staged as `plan` says.  Any other signature's programs
        on this device are dropped first; a capture makes this
        signature's; the proof becomes the device's last (module
        docstring)."""
        mark = mark or (lambda name: None)
        sig = tree_signature(cols)
        with _LAST_LOCK:
            how = self.plan(cols, fused)
            owner, _ = _last_proof(self.device)
            if owner is not None and owner._programs is not None and (
                    owner is not self or owner._programs.signature != sig):
                owner._programs = None      # the old pool goes first
            if how == "capture":
                self._programs = ProgramSet(sig, self.device,
                                            self.table_sizes)
            _LAST[_device_key(self.device)] = (weakref.ref(self), sig)
            progs = None if how == "staged" else self._programs
        if progs is None:
            return _pull(self._prove_device(cols, _STAGED, mark))
        # the programs overwrite their outputs at the next replay: hold
        # the set until the proof's values are on the host
        with progs.lock:
            return _pull(self._prove_device(cols, progs, mark))

    def _prove_device(self, cols: GL, run, mark) -> Dict:
        """Every stage of the proofs of cols (B, W, H), each through
        `run(name, fn, *args)` (`_STAGED` calls fn; a ProgramSet runs its
        program of that name) -> the device values the proofs are
        assembled from, and the self-checks."""
        fc = self.fc
        b = cols.shape[0]
        cols = run.input("cols", cols)
        ch = DeviceChallenger((b,), self.device)

        trace_lde = run("commit_trace", self._commit_matrix, cols)  # (B, W, N)
        committed = {"trace": (trace_lde,
                               run("tree_trace", _build_tree, trace_lde))}
        ch.observe_many(_root(committed["trace"][1]))
        mark("commit_trace")

        # stage 2 (multi-stage AIRs): sample the challenges, build and
        # commit the challenge-dependent matrix (refimpl/prover.py:127-140)
        challenges = [ch.sample_ext() for _ in range(self.n_challenges)]
        s2_cols = s2_lde = zero = None
        if self.s2w:
            if self._device_stage2:
                s2_cols, zero = run("stage2", self._stage2_cols, cols,
                                    challenges)                # (B, s2w, H)
            else:
                s2_cols, zero = self._stage2_cols(cols, challenges)
                s2_cols = run.input("s2_cols", s2_cols)
            s2_lde = run("commit_stage2", self._commit_matrix, s2_cols)
            committed["s2"] = (s2_lde,
                               run("tree_stage2", _build_tree, s2_lde))
            ch.observe_many(_root(committed["s2"][1]))
            mark("stage2")
        alpha = ch.sample_ext()

        q_evals = run("quotient", self._quotient_fn, cols, alpha, s2_cols,
                      challenges, _publics(self.air, self.device))
        mark("quotient")
        q_lde = run("commit_chunks", self._commit_chunks_fn, q_evals)
        committed["q"] = (q_lde, run("tree_quotient", _build_tree, q_lde))
        ch.observe_many(_root(committed["q"][1]))
        zeta = ch.sample_ext()
        mark("commit_quotient")

        opened = run("opened", self._opened_fn, cols, q_evals, zeta, s2_cols)
        tl, tn, qc = opened[:3]
        mark("opened")
        alpha_fri = ch.sample_ext()
        u = run("reduced_openings", self._ro_fn, trace_lde, q_lde, tl, tn,
                qc, zeta, alpha_fri, s2_lde, *opened[3:])
        mark("reduced_openings")

        phase_trees, phase_vectors = [], []
        for log_folded in range(self.log_max - 1, fc.log_blowup - 1, -1):
            rows_fn, step_fn = self._fold_phase_raw(log_folded)
            rows, e0, e1 = run(f"fold_rows_{log_folded}", rows_fn, u)
            levels = run(f"fold_tree_{log_folded}", _build_tree, rows)
            phase_trees.append(levels)
            phase_vectors.append(u)
            ch.observe_many(_root(levels))
            u = run(f"fold_step_{log_folded}", step_fn, e0, e1,
                    ch.sample_ext())
        low_degree_ok = gl2.eq(u, u[..., :1]).all()
        mark("fri_commit")

        # PoW grind: shared ascending windows, each proof's first hit (the
        # witness order of the sequential grind).  The first `found` check
        # is the proof's first device-to-host wait; it also reads the
        # stage-2 builder's zero flag.
        if ch.input_buffer:
            raise AssertionError("observations pending before the grind")
        state_rest = ch.state[..., 1:12]
        found = torch.zeros(b, dtype=torch.bool, device=self.device)
        wit = torch.zeros(b, dtype=torch.int64, device=self.device)
        base, window = 0, grind_window(fc)
        while True:
            f, off = run("grind", self._grind_window_fn, state_rest,
                         torch.full((), base, dtype=torch.int64,
                                    device=self.device))
            wit = torch.where(f & ~found, base + off, wit)
            found |= f
            if zero is None:
                done = bool(found.all())
            else:
                done, bad = torch.stack([found.all(), zero]).tolist()
                zero = None
                if bad:
                    raise ZeroDivisionError(ZERO_DENOMINATOR)
            if done:
                break
            base += window
            if base >= 1 << 32:
                raise RuntimeError("no proof-of-work witness below 2^32")
        ch.observe(GL(wit, torch.zeros_like(wit)))
        pow_ok = (ch.sample_bits(fc.proof_of_work_bits) == 0).all()
        mark("grind")

        qidx = ch.sample_many_bits(fc.num_queries, self.log_max)   # (B, Q)
        pulls = run("queries", _queries_fn, qidx, committed, phase_trees,
                    phase_vectors)
        pulls = dict(pulls, pow_ok=pow_ok, low_degree_ok=low_degree_ok,
                     wit=wit, tl=tl, tn=tn, qc=qc, final=u[..., 0],
                     phase_roots=[_root(t) for t in phase_trees],
                     **{f"{k}_root": _root(t) for k, (_, t) in
                        committed.items()})
        if self.s2w:
            pulls["s2l"], pulls["s2n"] = opened[3:]
        return pulls

    def _assemble(self, h: Dict, b: int) -> Proof:
        """Proof b of the batch from the pulled host arrays."""
        D = EXT_DEGREE

        def ext_list(pair, *ix):
            return list(zip(pair[0][(b, *ix)].tolist(),
                            pair[1][(b, *ix)].tolist()))

        trace_open = h["trace_open"][b].tolist()               # (Q, W)
        q_open = h["q_open"][b].tolist()                       # (Q, ch*D)
        trace_paths = h["trace_paths"][b].tolist()             # (Q, d, 4)
        q_paths = h["q_paths"][b].tolist()
        fold_sibs = [(s[0][b].tolist(), s[1][b].tolist())
                     for s in h["fold_sibs"]]
        fold_paths = [p[b].tolist() for p in h["fold_paths"]]
        if self.s2w:
            s2_open = h["s2_open"][b].tolist()                 # (Q, s2w)
            s2_paths = h["s2_paths"][b].tolist()
        query_openings, query_proofs = [], []
        for qi in range(self.fc.num_queries):
            batches = [BatchOpening(opened_values=[trace_open[qi]],
                                    opening_proof=trace_paths[qi])]
            if self.s2w:
                batches.append(BatchOpening(opened_values=[s2_open[qi]],
                                            opening_proof=s2_paths[qi]))
            batches.append(
                BatchOpening(opened_values=[q_open[qi][ci * D:(ci + 1) * D]
                                            for ci in range(self.n_chunks)],
                             opening_proof=q_paths[qi]))
            query_openings.append(batches)
            query_proofs.append(QueryProof(commit_phase_openings=[
                CommitPhaseProofStep(
                    sibling_value=(fold_sibs[l][0][qi], fold_sibs[l][1][qi]),
                    opening_proof=fold_paths[l][qi])
                for l in range(len(fold_paths))]))
        return Proof(
            commitments=Commitments(
                trace=Commitment(value=h["trace_root"][b].tolist()),
                quotient_chunks=Commitment(value=h["q_root"][b].tolist()),
                stage2=(Commitment(value=h["s2_root"][b].tolist())
                        if self.s2w else None)),
            opened_values=OpenedValues(
                trace_local=ext_list(h["tl"]),
                trace_next=ext_list(h["tn"]),
                quotient_chunks=[ext_list(h["qc"], ci)
                                 for ci in range(self.n_chunks)],
                stage2_local=ext_list(h["s2l"]) if self.s2w else None,
                stage2_next=ext_list(h["s2n"]) if self.s2w else None),
            opening_proof=TwoAdicFriPcsProof(
                fri_proof=FriProof(
                    commit_phase_commits=[Commitment(value=r[b].tolist())
                                          for r in h["phase_roots"]],
                    query_proofs=query_proofs,
                    final_poly=(int(h["final"][0][b]), int(h["final"][1][b])),
                    pow_witness=int(h["wit"][b])),
                query_openings=query_openings),
            degree_bits=self.log_n,
        )


class _Staged:
    """The staged path's stage runner: each stage function called as it
    is, on the caller's tensors."""

    def __call__(self, name, fn, *args):
        return fn(*args)

    def input(self, name, x):
        return x


_STAGED = _Staged()


# The last proof on each device: (a weak reference to its prover, its
# signature).  Only that prover may hold stage programs on the device, and
# only of that signature (module docstring).
_LAST: Dict = {}
_LAST_LOCK = threading.Lock()


def _device_key(device: torch.device):
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def _last_proof(device: torch.device):
    """(the prover of the device's last proof or None, its signature)."""
    ref, sig = _LAST.get(_device_key(device), (None, None))
    return (ref() if ref is not None else None), sig


def _root(levels: List[GL]) -> GL:
    """The roots (B, 4) of trees built by ops.mmcs._build_tree."""
    return levels[-1][..., 0]


def _queries_fn(qidx: torch.Tensor, committed: Dict, phase_trees: List,
                phase_vectors: List) -> Dict:
    """The query openings at qidx (B, Q): for each committed matrix
    (name: (matrix (B, C, N), tree levels)) its opened rows and their
    paths (`{name}_open`, `{name}_paths`); for each FRI phase the sibling
    values and the paths of its tree (`fold_sibs`, `fold_paths`)."""
    out = {}
    for name, (m, levels) in committed.items():
        out[f"{name}_open"] = _gather_cols(m, qidx)
        out[f"{name}_paths"] = _open_paths(levels, qidx)
    out["fold_sibs"], out["fold_paths"] = [], []
    idx = qidx
    for vec, levels in zip(phase_vectors, phase_trees):
        out["fold_sibs"].append(GL2(_gather_last(vec.c0, idx ^ 1),
                                    _gather_last(vec.c1, idx ^ 1)))
        out["fold_paths"].append(_open_paths(levels, idx >> 1))
        idx = idx >> 1
    return out


def _pieces(nbytes: int, budget: int) -> int:
    """How many pieces keep each below `budget` bytes."""
    return -(-nbytes // budget)


def _by_columns(x: GL, fn, n_out: int, step: int) -> GL:
    """fn over the column ranges [i, i + step) of x (B, W, n), each result
    (B, w', n_out) written into one (B, W, n_out) output: fn's temporaries
    are those of `step` columns.  fn(x) itself when one range covers W."""
    b, w = x.shape[:2]
    if step >= w:
        return fn(x)
    out = GL(*(torch.empty((b, w, n_out), dtype=torch.int64, device=x.device)
               for _ in range(2)))
    for i in range(0, w, step):
        tree_map(lambda d, v: d[:, i:i + step].copy_(v), out,
                 fn(x[:, i:i + step]))
    return out


def _segment(coeffs: GL, w: GL, m: int) -> GL:
    """The polynomials with coefficients (..., h) at shift * g_M^t for t in
    [M]: w holds shift^j (h,); the weighted coefficients are folded to
    length M (summed over k at m + kM, or zero-padded when h < M), then
    one plain NTT."""
    x = gl.mul(coeffs, w)
    h = x.shape[-1]
    if h > m:
        parts = x.reshape(*x.shape[:-1], h // m, m)
        x = parts[..., 0, :]
        for k in range(1, h // m):
            x = gl.add(x, parts[..., k, :])
    elif h < m:
        x = gl.concatenate([x, gl.zeros(x.shape[:-1] + (m - h,), x.device)],
                           dim=-1)
    return ntt(x)


def _ext_columns_first(x: GL) -> GL2:
    """Base columns (B, W, q) as the GF(p^2) view (W, B, q): c0 the columns
    moved axis-first (no copy), c1 a zero broadcast to that shape."""
    c0 = GL(x.lo.movedim(1, 0), x.hi.movedim(1, 0))
    zero = torch.zeros((), dtype=torch.int64, device=x.lo.device)
    z = zero.expand(c0.shape)
    return GL2(c0, GL(z, z))


def _gather_last(x: GL, idx: torch.Tensor) -> GL:
    """x (B, n), idx (B, Q) -> x[b, idx[b, q]] (B, Q)."""
    return GL(torch.gather(x.lo, -1, idx), torch.gather(x.hi, -1, idx))


def _gather_cols(m: GL, idx: torch.Tensor) -> GL:
    """Rows idx (B, Q) of the column-major matrices m (B, C, N): (B, Q, C)."""
    ix = idx[:, None, :].expand(m.shape[0], m.shape[1], idx.shape[-1])
    return GL(torch.gather(m.lo, -1, ix).transpose(1, 2),
              torch.gather(m.hi, -1, ix).transpose(1, 2))


def _pull(values: Dict) -> Dict:
    """Copy GL / GL2 / tensor values (and lists of them) to the host in one
    transfer: GL -> uint64 array, GL2 -> (c0, c1) uint64 arrays, a tensor ->
    a numpy array (a 0-d bool -> bool).  The span `prove.pull`."""
    with profiling.span("prove.pull"):
        flat = []

        def collect(x):
            if isinstance(x, list):
                return [collect(v) for v in x]
            if isinstance(x, GL2):
                return GL2(collect(x.c0), collect(x.c1))
            if isinstance(x, GL):
                return GL(collect(x.lo), collect(x.hi))
            flat.append(x.reshape(-1).to(torch.int64))
            return (len(flat) - 1, tuple(x.shape), x.dtype)

        layout = {k: collect(v) for k, v in values.items()}
        host = torch.cat(flat).cpu().numpy()
        offsets = np.cumsum([0] + [t.numel() for t in flat])

        def rebuild(x):
            if isinstance(x, list):
                return [rebuild(v) for v in x]
            if isinstance(x, GL2):
                return (rebuild(x.c0), rebuild(x.c1))
            if isinstance(x, GL):
                lo, hi = rebuild(x.lo), rebuild(x.hi)
                return ((hi.astype(np.uint64) << np.uint64(32))
                        | lo.astype(np.uint64))
            i, shape, dtype = x
            a = host[offsets[i]:offsets[i + 1]].reshape(shape)
            return bool(a) if dtype == torch.bool and not shape else a

        return {k: rebuild(v) for k, v in layout.items()}


def trace_columns(traces, device) -> GL:
    """Row-major traces (B of them, H rows of W values each: host ints or
    integer arrays) -> columns GL (B, W, H) on `device`."""
    try:
        a = np.asarray(traces, dtype=np.uint64)
    except (OverflowError, TypeError, ValueError):
        a = np.asarray(traces, dtype=object)     # exact, reduced mod p
    if a.ndim != 3:
        raise ValueError(f"traces of shape {a.shape}: want (B, H, W)")
    return gl.from_u64(np.ascontiguousarray(a.transpose(0, 2, 1)), device)


_prover_cache: Dict = {}


def get_prover(air: Air, log_n: int, fri_config: FriConfig, device="cuda",
               quotient_eval_chunks: int = 1,
               quotient_col_groups: int = None, lde_mesh=None,
               lde_log_rows: int = 3) -> TorchProver:
    """A cached TorchProver for (AIR class, shape, FRI config, device,
    memory knobs, LDE mesh and its row split); a cache hit takes the
    caller's `air` (its publics)."""
    device = resolve_device(device)
    key = (type(air).__module__, type(air).__qualname__, air.name(),
           air.width(), air.stage2_width(), air.num_challenges(), log_n,
           fri_config.log_blowup, fri_config.num_queries,
           fri_config.proof_of_work_bits, str(device), quotient_eval_chunks,
           quotient_col_groups, lde_mesh, lde_log_rows)
    p = _prover_cache.get(key)
    if p is None:
        p = TorchProver(air, log_n, fri_config, device, quotient_eval_chunks,
                        quotient_col_groups, lde_mesh, lde_log_rows)
        _prover_cache[key] = p
    else:
        p.air = air
    return p


def quotient_eval_chunks_for(air: Air, log_n: int) -> int:
    """The quotient segments S that prove_on_device gives a trace of
    2^log_n rows of `air`: the JAX prover's rule (plonky25_tpu/prover/
    prove.py:978-1010) over the port's budget, QUOTIENT_EVAL_BYTES."""
    lqd = log2_ceil(getattr(air, "quotient_degree", lambda: 1)())
    q_size = 1 << (log_n + lqd)
    ws = air.width() * q_size * 32
    s = 1
    while ws // s > QUOTIENT_EVAL_BYTES and s < q_size:
        s *= 2
    return s


def prove_on_device(air: Air, trace, fri_config: FriConfig, device="cuda",
                    on_stage=None) -> Proof:
    """Prove one trace, row-major (H rows of W values) or a GL of columns
    (W, H) on `device`, with the quotient segmented as
    quotient_eval_chunks_for gives (the same bytes at every S)."""
    if isinstance(trace, GL):
        log_n = log2_strict(trace.shape[1])
    else:
        log_n = log2_strict(len(trace))
    p = get_prover(air, log_n, fri_config, device,
                   quotient_eval_chunks_for(air, log_n))
    if isinstance(trace, GL):
        return p.prove_columns(GL(trace.lo[None], trace.hi[None]),
                               on_stage)[0]
    return p.prove(trace, on_stage)


# The port's older name for the same entry point.
prove = prove_on_device
