"""The work a call needs, counted from the configuration's shapes, and the
card's least time for it: frozen copies of chip_smoke.py's path-shape
arithmetic (verify_path_shapes, transcript_steps, prove_path_shapes) and
of plonky25_torch/utils/roofline.py's Poseidon2 bound (bound_ms,
poseidon2_bound_ms), so that the count is the same whatever implements
the permutation and a change to the program cannot move it."""

from __future__ import annotations

from collections import Counter
from typing import Dict

WIDTH, RATE, EXT_DEGREE = 12, 4, 2
GRIND_WINDOW = 1 << 16

# The H100 SXM's data-sheet figures: 132 SMs at a 1,980 MHz boost clock,
# 128 32-bit integer instructions dispatched per SM per clock, HBM at
# 3.35 TB/s.
H100_SMS = 132
H100_SM_CLOCK_HZ = 1.98e9
DISPATCH_PER_CLK = 128
HBM_BYTES_PER_S = 3.35e12

# One Poseidon2 permutation's fewest 32-bit instructions (roofline.py):
# 736 Goldilocks products (x^7 is 4, in 8 x 12 full-round and 22
# partial-round S-boxes; 22 x 12 internal-diagonal products), each 4
# partial products and 6 adds, and 1,182 modular adds of 2 each; its
# state read and written once: 12 lanes x 2 int64 limbs x 8 B, twice.
P2_PRODUCTS = 4 * (8 * 12 + 22) + 22 * 12
P2_ADDS = (8 * 12 + 22) + 9 * (3 * 14 + 4 * 5) + 22 * (11 + 12)
P2_INSTRUCTIONS = P2_PRODUCTS * (4 + 6) + P2_ADDS * 2
P2_CLOCKS_PER_STATE = P2_INSTRUCTIONS / DISPATCH_PER_CLK
P2_BYTES_PER_STATE = 12 * 2 * 8 * 2


def bound_ms(n_items: float, clocks_per_item: float, bytes_per_item: float,
             sms: int = H100_SMS, sm_clock_hz: float = H100_SM_CLOCK_HZ):
    """(least ms, "operations" or "bytes") for n items: the larger of
    their dispatch time and their HBM time."""
    ops_ms = n_items * clocks_per_item / (sms * sm_clock_hz) * 1e3
    bytes_ms = n_items * bytes_per_item / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def poseidon2_bound_ms(n_states: float):
    """(least ms, which bound) of permuting n states on the card."""
    return bound_ms(n_states, P2_CLOCKS_PER_STATE, P2_BYTES_PER_STATE)


def transcript_steps(log_n: int, num_queries: int, n_challenges: int = 0,
                     s2w: int = 0) -> int:
    """Duplex steps of the transcript (the verifier's and the prover's):
    the challenger absorbs up to 12 observations before it must permute,
    and a sample after an observation, or with its output spent, permutes
    (src/p3/challenger.rs)."""
    steps, buffered, outputs = 0, 0, 0

    def observe(n):
        nonlocal steps, buffered, outputs
        for _ in range(n):
            outputs = 0
            buffered += 1
            if buffered == WIDTH:
                steps, buffered, outputs = steps + 1, 0, WIDTH

    def sample(n=1):
        nonlocal steps, buffered, outputs
        for _ in range(n):
            if buffered or not outputs:
                steps, buffered, outputs = steps + 1, 0, WIDTH
            outputs -= 1

    observe(4)                       # trace commitment
    sample(2 * n_challenges)         # stage-2 challenges
    if s2w:
        observe(4)                   # stage-2 commitment
    sample(2)                        # alpha
    observe(4)                       # quotient commitment
    sample(2)                        # zeta
    sample(2)                        # alpha_fri
    for _ in range(log_n):           # FRI commit phases
        observe(4)
        sample(2)
    observe(1)                       # PoW witness
    sample(1 + num_queries)
    return steps


def commit_states(log_n: int, num_queries: int, log_blowup: int,
                  trace_width: int, quotient_chunks: int, b: int,
                  s2w: int = 0, n_challenges: int = 0) -> Dict[int, int]:
    """{states per launch: launches} of the state-major permutation in one
    verification of b proofs, the FRI fold's walks left out: the
    transcript's duplex steps and the Merkle walks over the trace,
    [stage-2] and quotient batches (one leaf hash and one compression per
    level for all of them when every row fits one sponge chunk; otherwise
    each batch alone, a launch per sponge chunk of its row and one per
    level).  chip_smoke.py's verify_path_shapes counts these the same."""
    widths = [trace_width] + ([s2w] if s2w else []) + [
        quotient_chunks * EXT_DEGREE]
    log_max = log_n + log_blowup
    shapes = Counter()
    shapes[b] += transcript_steps(log_n, num_queries, n_challenges, s2w)
    if max(widths) <= RATE:
        shapes[len(widths) * b * num_queries] += 1 + log_max
    else:
        for w in widths:
            shapes[b * num_queries] += -(-w // RATE) + log_max
    return dict(shapes)


def fold_states(log_n: int, num_queries: int, log_blowup: int,
                b: int) -> Dict[int, int]:
    """{states per launch: launches} the FRI fold's Merkle walks need in
    one verification of b proofs: per query, each commit phase's leaf hash
    (its 4 values fit one sponge chunk) and one compression per level of
    that phase's tree, which has 2^(log_n + log_blowup - 1 - i) leaves at
    phase i.  (chip_smoke.py's verify_path_shapes counts the program's
    lock-step walk instead: every phase as deep as the first.)"""
    log_max = log_n + log_blowup
    per_query = sum(1 + log_folded
                    for log_folded in range(log_max - 1, log_blowup - 1, -1))
    return {b * num_queries: per_query}


def verify_states(log_n: int, num_queries: int, log_blowup: int,
                  trace_width: int, quotient_chunks: int, b: int,
                  s2w: int = 0, n_challenges: int = 0) -> Dict[int, int]:
    """{states per launch: launches} of the state-major permutation that
    one verification of b proofs needs: commit_states and fold_states."""
    shapes = Counter(commit_states(log_n, num_queries, log_blowup,
                                   trace_width, quotient_chunks, b, s2w,
                                   n_challenges))
    shapes.update(fold_states(log_n, num_queries, log_blowup, b))
    return dict(shapes)


def grind_window(proof_of_work_bits: int) -> int:
    """PoW witnesses one grind launch tries (prover/prove.py)."""
    return min(GRIND_WINDOW, 1 << (proof_of_work_bits + 4))


def prove_states(log_n: int, log_blowup: int, proof_of_work_bits: int,
                 width: int, quotient_chunks: int, b: int,
                 windows: int, s2w: int = 0) -> Dict[int, int]:
    """{states per launch: launches} of the lane-major permutation in
    proving b traces of 2^log_n rows: the trace tree (a launch per sponge
    chunk of a row, then one compression per level), [the stage-2 tree,]
    the quotient tree (its chunks' 2 columns each), the FRI commit trees
    (4 columns, one per phase) and `windows` grind windows."""
    log_max = log_n + log_blowup
    soa = Counter()

    def tree(log_h, w):
        soa[b << log_h] += -(-w // RATE)
        for t in range(log_h):
            soa[b << t] += 1

    tree(log_max, width)
    if s2w:
        tree(log_max, s2w)
    tree(log_max, quotient_chunks * EXT_DEGREE)
    for log_folded in range(log_max - 1, log_blowup - 1, -1):
        tree(log_folded, 4)
    soa[b * grind_window(proof_of_work_bits)] += windows
    return dict(soa)


def total_states(shapes: Dict[int, int]) -> int:
    return sum(n * c for n, c in shapes.items())
