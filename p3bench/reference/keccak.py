"""keccak-f[1600] on plain Python ints (a frozen copy of
plonky25_torch/refimpl/keccak.py): the round tables that the Keccak AIR
wires its constraints with, and the oracle of ops/keccak.py and of the
AIR's trace generator."""

MASK64 = (1 << 64) - 1

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
R = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

NUM_ROUNDS = 24


def _rol(v, n):
    n %= 64
    return ((v << n) | (v >> (64 - n))) & MASK64


def keccak_round(lanes, rc):
    """One round on a 5x5 lane matrix (lanes[x][y]); returns a new matrix."""
    # theta
    C = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
         for x in range(5)]
    D = [C[(x - 1) % 5] ^ _rol(C[(x + 1) % 5], 1) for x in range(5)]
    A = [[lanes[x][y] ^ D[x] for y in range(5)] for x in range(5)]
    # rho + pi
    B = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            B[y][(2 * x + 3 * y) % 5] = _rol(A[x][y], R[x][y])
    # chi
    out = [[B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y] & MASK64)
            for y in range(5)] for x in range(5)]
    # iota
    out[0][0] ^= rc
    return out


def keccak_f(lanes):
    """Full 24-round permutation on a 5x5 int matrix."""
    s = [list(col) for col in lanes]
    for r in range(NUM_ROUNDS):
        s = keccak_round(s, RC[r])
    return s


def keccak_f_flat(state64):
    """Flat [25] lane list, index = x + 5*y (standard keccak ordering)."""
    lanes = [[state64[x + 5 * y] for y in range(5)] for x in range(5)]
    out = keccak_f(lanes)
    return [out[x][y] for y in range(5) for x in range(5)]
