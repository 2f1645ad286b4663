"""AIR abstraction: constraint folding for the verifier (a frozen copy of
plonky25_torch/air.py).

Backend-agnostic mirror of src/p3/air.rs.  An `Air` subclass writes its
constraints against a `VerifierConstraintFolder`, whose `ops` member supplies
the GF(p^2) arithmetic (here fields.extension.Ops, on GL2 tensors).  Folding semantics are
identical to the reference: `assert_zero(x)` performs
`acc = acc * alpha + x` (air.rs:63-69), and filtered builders multiply the
asserted value by their selector condition first (air.rs:94-123).
"""

from __future__ import annotations


class Air:
    """User-implemented AIR (air.rs:10-18)."""

    def name(self) -> str:
        raise NotImplementedError

    def width(self) -> int:
        raise NotImplementedError

    def eval(self, folder: "VerifierConstraintFolder") -> None:
        raise NotImplementedError

    # ---- multi-stage AIRs (framework extension) -------------------------
    # A second trace matrix committed AFTER transcript challenges are
    # sampled from the main-trace commitment — the standard Fiat-Shamir
    # mechanism behind permutation / lookup / accumulator arguments (the
    # reference's plonky2 core has the same capability as its permutation
    # argument over wire copies).  Single-stage AIRs leave all three
    # defaults; the proof JSON then stays byte-identical to the reference
    # schema (serde/proof.rs).

    def stage2_width(self) -> int:
        """Number of stage-2 columns (0 = single-stage)."""
        return 0

    def num_challenges(self) -> int:
        """GF(p^2) challenges sampled between the main-trace and stage-2
        commitments.  Each is one `sample_ext()` (= two base samples)."""
        return 0

    def build_stage2(self, trace, challenges):
        """Prover callback: stage-2 columns from the main trace + sampled
        challenges.  `trace`: row-major host rows (height x width) of the
        main trace; `challenges`: list of (c0, c1) host int pairs.
        Returns column-major host ints (stage2_width x height)."""
        raise NotImplementedError

    def public_values(self) -> dict:
        """Named public scalars (host ints) the constraints may reference.

        Prover/verifier call sites convert these to backend values and hand
        them to the folder as `publics`.  The reference has no public-values channel (its verifier circuit
        wires everything through witness targets); this is a framework
        extension."""
        return {}


def check_multistage_consistency(air: "Air") -> None:
    """Reject AIRs declaring transcript challenges without a stage-2
    matrix.  Challenges are sampled between the trace and stage-2
    commitments; with stage2_width()==0 there is no second commitment, the
    device verifier skips the samples while the refimpl paths would emit
    them, and the two transcripts diverge (every proof of such an AIR
    would verify on one path and fail on the other).  Called by both
    provers and the device verifier so the inconsistency is an error at
    construction, not a silent rejection at verify time."""
    if air.num_challenges() and not air.stage2_width():
        raise ValueError(
            f"{air.name()}: num_challenges()={air.num_challenges()} "
            "requires stage2_width() > 0")


class Columns:
    """The per-column list view of a stacked matrix (a GL2 with the column
    axis leading): item i is vec[i], made when asked for, so a 2,633-column
    AIR that reads the stacked matrix makes no per-column values."""

    def __init__(self, vec):
        self.vec = vec

    def __len__(self):
        return self.vec.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.vec[j] for j in range(len(self))[i]]
        return self.vec[i]

    def __iter__(self):
        return (self.vec[i] for i in range(len(self)))


class Main:
    """The folder's `main`: the trace at the evaluation points and one row
    on, each stacked with the column axis leading (`local_vec`,
    `next_vec`: GL2 (w, B) at the verifier's zeta, (w, B, q) on the
    prover's quotient coset, as the JAX verifier and prover set them), the
    per-column lists as views of them, the quotient chunks' openings (the
    verifier's), and a multi-stage AIR's stage-2 columns the same way."""

    def __init__(self, local_vec, next_vec, quotient_chunks=(),
                 stage2_local_vec=None, stage2_next_vec=None):
        self.local_vec = local_vec
        self.next_vec = next_vec
        self.trace_local = Columns(local_vec)
        self.trace_next = Columns(next_vec)
        self.quotient_chunks = list(quotient_chunks)
        self.stage2_local = self.stage2_next = None
        if stage2_local_vec is not None:
            self.stage2_local_vec = stage2_local_vec
            self.stage2_next_vec = stage2_next_vec
            self.stage2_local = Columns(stage2_local_vec)
            self.stage2_next = Columns(stage2_next_vec)


class VerifierConstraintFolder:
    """air.rs:20-27 plus the builder methods at air.rs:34-92."""

    def __init__(self, ops, main, is_first_row, is_last_row, is_transition,
                 alpha, publics=None, challenges=None):
        self.ops = ops
        self.main = main              # has .trace_local / .trace_next / .quotient_chunks
        self.is_first_row = is_first_row
        self.is_last_row = is_last_row
        self.is_transition = is_transition
        self.alpha = alpha
        self.publics = publics or {}  # backend ext scalars by name
        # multi-stage: sampled GF(p^2) challenges (backend ext scalars, in
        # sample order) available to the constraints; stage-2 columns are
        # exposed via main.stage2_local / main.stage2_next (and the
        # stacked stage2_local_vec / stage2_next_vec on vector backends)
        self.challenges = challenges or []
        # Constraints are recorded and folded at the end, by the backend's
        # fold_constraints where it has one.
        self._constraints = []

    # -- filters ----------------------------------------------------------
    def when(self, condition) -> "FilteredAirBuilder":
        return FilteredAirBuilder(self, condition)

    def when_first_row(self) -> "FilteredAirBuilder":
        return self.when(self.is_first_row)

    def when_last_row(self) -> "FilteredAirBuilder":
        return self.when(self.is_last_row)

    def when_transition(self) -> "FilteredAirBuilder":
        return self.when(self.is_transition)

    # -- assertions (air.rs:63-91) ----------------------------------------
    def assert_zero(self, x):
        """Record a constraint.  `x` may be a single value or a VECTOR of
        constraints (leading axes beyond the evaluation-point shape fold as
        consecutive constraints in index order) — wide AIRs like Keccak
        must express their thousands of constraints as array ops, not
        unrolled scalars."""
        self._constraints.append(x)

    def assert_eq(self, x, y):
        self.assert_zero(self.ops.sub(x, y))

    def assert_bool(self, x):
        self.assert_zero(self.ops.mul(x, self.ops.sub(x, self.ops.one())))

    @property
    def accumulator(self):
        """Folded constraints: acc = acc * alpha + c_i in recording order
        (identical math to air.rs:63-69)."""
        fold = getattr(self.ops, "fold_constraints", None)
        if fold is not None:
            return fold(self.alpha, self._constraints)
        acc = self.ops.zero()
        for c in self._constraints:
            acc = self.ops.add(self.ops.mul(acc, self.alpha), c)
        return acc


class FilteredAirBuilder:
    """air.rs:29-32, 94-123: assertions scaled by a selector condition."""

    def __init__(self, inner: VerifierConstraintFolder, condition):
        self.inner = inner
        self.condition = condition

    def assert_zero(self, x):
        self.inner.assert_zero(self.inner.ops.mul(self.condition, x))

    def assert_eq(self, x, y):
        self.assert_zero(self.inner.ops.sub(x, y))

    def assert_bool(self, x):
        self.inner.assert_bool(self.inner.ops.mul(self.condition, x))
