"""MMCS Merkle hashing, trees and batch verification on plain Python ints
(src/p3/commit.rs; a copy of plonky25_tpu/refimpl/commit.py)."""

from ..constants import RATE, DIGEST_ELEMS, WIDTH
from .poseidon2 import poseidon2


def hash_iter_slices(rows):
    """Overwrite-mode sponge over the flattened rows (commit.rs:23-46).

    State starts at zero; each RATE-sized chunk of the flattened input
    overwrites the state prefix, then a permutation runs.  A final partial
    chunk still triggers a permutation."""
    state = [0] * WIDTH
    flat = [v for row in rows for v in row]
    for i in range(0, len(flat), RATE):
        chunk = flat[i:i + RATE]
        for j, v in enumerate(chunk):
            state[j] = v
        state = poseidon2(state)
    return state[:DIGEST_ELEMS]


def compress(left, right):
    """2-to-1 compression: permute [left||right||0^4], keep 4 (commit.rs:48-60)."""
    state = list(left) + list(right) + [0] * (WIDTH - 2 * DIGEST_ELEMS)
    return poseidon2(state)[:DIGEST_ELEMS]


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def build_mmcs_tree(matrices):
    """Build a mixed-height MMCS Merkle tree (the commitment scheme
    verify_batch checks, commit.rs:62-129, mirrored from the prover side).

    matrices: list of row-major matrices (lists of rows of ints); heights
    must be powers of two.  Returns (root, levels) where levels[t] is the
    list of tree nodes after t compress steps (each POST fold-in, which is
    what the opening paths reference).

    Matrices are consumed tallest-first (stable): the tallest group's rows
    are the leaves; as the tree climbs past a shorter group's height, each
    node absorbs that group's row digest via one extra compress."""
    order = sorted(range(len(matrices)), key=lambda i: -len(matrices[i]))
    tallest = len(matrices[order[0]])
    assert tallest & (tallest - 1) == 0, "heights must be powers of two"
    by_height = {}
    for i in order:
        by_height.setdefault(len(matrices[i]), []).append(i)

    nodes = [
        hash_iter_slices([matrices[i][r] for i in by_height[tallest]])
        for r in range(tallest)
    ]
    levels = [list(nodes)]
    h = tallest
    while h > 1:
        nodes = [compress(nodes[2 * j], nodes[2 * j + 1])
                 for j in range(h // 2)]
        h //= 2
        if h in by_height and h != tallest:
            nodes = [
                compress(nodes[j],
                         hash_iter_slices([matrices[i][j]
                                           for i in by_height[h]]))
                for j in range(h)
            ]
        levels.append(list(nodes))
    return nodes[0], levels


def open_mmcs(matrices, levels, index):
    """Opening for `index` against a tree from build_mmcs_tree: per-matrix
    opened rows (row index >> height difference) and the sibling path."""
    tallest = max(len(m) for m in matrices)
    log_t = tallest.bit_length() - 1
    opened = [m[index >> (log_t - (len(m).bit_length() - 1))]
              for m in matrices]
    proof = []
    idx = index
    for t in range(log_t):
        proof.append(list(levels[t][idx ^ 1]))
        idx >>= 1
    return opened, proof


def verify_batch(commit, dimensions, index, opened_values, proof):
    """Batched Merkle-path check (commit.rs:62-129).

    dimensions: list of (width, height) per matrix, aligned with
    opened_values rows.  Returns True iff the recomputed root equals
    `commit`.  Matrices are consumed tallest-first (stable sort); shorter
    matrices' leaf digests are folded in when the path reaches their padded
    height."""
    order = sorted(range(len(dimensions)), key=lambda i: -dimensions[i][1])
    pos = 0

    curr_height_padded = _next_pow2(dimensions[order[0]][1])

    first_rows = []
    while pos < len(order) and _next_pow2(dimensions[order[pos]][1]) == curr_height_padded:
        first_rows.append(opened_values[order[pos]])
        pos += 1
    root = hash_iter_slices(first_rows)

    for sibling in proof:
        is_odd = index & 1
        if is_odd:
            left, right = sibling, root
        else:
            left, right = root, sibling
        root = compress(left, right)
        index >>= 1
        curr_height_padded >>= 1

        if pos < len(order) and _next_pow2(dimensions[order[pos]][1]) == curr_height_padded:
            next_height = dimensions[order[pos]][1]
            rows = []
            while pos < len(order) and dimensions[order[pos]][1] == next_height:
                rows.append(opened_values[order[pos]])
                pos += 1
            digest = hash_iter_slices(rows)
            root = compress(root, digest)

    return list(root) == list(commit)
