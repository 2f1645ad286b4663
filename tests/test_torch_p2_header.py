"""The CUDA kernels' arithmetic (plonky25_torch/csrc/poseidon2_common.cuh),
compiled with the host C++ compiler and run on the CPU.

Every inline-PTX helper of the header has a host branch in unsigned
__int128, so a small host program that defines the CUDA qualifiers away includes
the header and runs `p25::permute` and the lazy helpers.  The permutation
is held bit-equal to `poseidon2_permute_plain` and the int oracle; each
helper is held, on inputs at the limits of the range its comment states, to
exact integer arithmetic (the wide sums and products) or to its value mod p
and the 64-bit range (the reductions).  The kernels' own PTX branches run
only on the card (tests/test_torch_poseidon2.py, `cuda` cases, and
chip_smoke.py).

    python -m pytest tests/test_torch_p2_header.py -q
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from plonky25_torch.constants import (
    GOLDILOCKS_P as P,
    RC,
    RC_MID,
)
from plonky25_torch.fields import gl as tgl
from plonky25_torch.ops import poseidon2 as tp2
from test_torch_poseidon2 import _edge_states

CSRC = os.path.join(os.path.dirname(tp2.__file__), os.pardir, "csrc")
EPS = (1 << 32) - 1
U64 = (1 << 64) - 1
M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]

HOST_PROGRAM = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include <cstdio>
#include <cstring>
#include "poseidon2_common.cuh"
using namespace p25;
typedef unsigned long long ull;
static ull get() { ull v; if (scanf("%llu", &v) != 1) v = 0; return v; }
static Wide wide() { ull lo = get(); return Wide{lo, (uint32_t)get()}; }
static void put(Wide w) { printf("%llu %llu\n", (ull)w.lo, (ull)w.hi); }
int main() {
  char cmd[32];
  while (scanf("%31s", cmd) == 1) {
    if (!strcmp(cmd, "permute")) {
      uint64_t s[12];
      for (int k = 0; k < 12; ++k) s[k] = get();
      permute(s);
      for (int k = 0; k < 12; ++k) printf("%llu ", (ull)s[k]);
      printf("\n");
    } else if (!strcmp(cmd, "reduce_wide")) {
      printf("%llu\n", (ull)reduce(wide()));
    } else if (!strcmp(cmd, "reduce128")) {
      U128 x;
      for (int i = 0; i < 4; ++i) x.w[i] = (uint32_t)get();
      printf("%llu\n", (ull)reduce(x));
    } else if (!strcmp(cmd, "mul") || !strcmp(cmd, "mul_add")) {
      const bool with_c = cmd[3] == '_';
      const uint64_t a = get(), b = get();
      const U128 r = with_c ? mul_add(a, b, wide()) : mul(a, b);
      printf("%u %u %u %u\n", r.w[0], r.w[1], r.w[2], r.w[3]);
    } else if (!strcmp(cmd, "add_wide_u64")) {
      const Wide a = wide();
      put(add(a, (uint64_t)get()));
    } else if (!strcmp(cmd, "add_wide_wide")) {
      const Wide a = wide();
      put(add(a, wide()));
    } else if (!strcmp(cmd, "add_u64_u64")) {
      const uint64_t a = get();
      put(add(a, (uint64_t)get()));
    } else if (!strcmp(cmd, "shl1")) {
      put(shl<1>(wide()));
    } else if (!strcmp(cmd, "shl2")) {
      put(shl<2>(wide()));
    } else if (!strcmp(cmd, "m4")) {
      Wide y[4];
      for (int i = 0; i < 4; ++i) y[i] = wide();
      m4(y);
      for (int i = 0; i < 4; ++i) put(y[i]);
    } else if (!strcmp(cmd, "sbox")) {
      printf("%llu\n", (ull)sbox(get()));
    } else if (!strcmp(cmd, "canonical")) {
      printf("%llu\n", (ull)canonical(get()));
    } else if (!strcmp(cmd, "rc_after")) {
      const int layer = (int)get();
      printf("%llu\n", (ull)rc_after(layer, (int)get()));
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def prog(tmp_path_factory):
    """The host program, built once per module with the host C++ compiler."""
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    if cxx is None:
        pytest.skip("no host C++ compiler (g++, c++ or clang++) found")
    d = tmp_path_factory.mktemp("p2_header")
    src, exe = d / "host_program.cpp", d / "host_program"
    src.write_text(HOST_PROGRAM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", CSRC, "-o", str(exe),
                    str(src)], check=True, capture_output=True, text=True)
    return str(exe)


def run(prog, lines):
    """Feed the host program one command per line; one list of ints per line."""
    out = subprocess.run([prog], input="".join(f"{ln}\n" for ln in lines),
                         capture_output=True, text=True, check=True).stdout
    return [[int(v) for v in row.split()] for row in out.strip().split("\n")]


def _permute(prog, rows):
    return run(prog, ["permute " + " ".join(str(int(v)) for v in row)
                        for row in rows])


def _plain(rows):
    """The plain PyTorch permutation of canonical rows."""
    s = np.asarray([[int(v) % P for v in row] for row in rows],
                   dtype=np.uint64)
    return tgl.to_u64(tp2.poseidon2_permute_plain(tgl.from_u64(s, "cpu"))
                      ).tolist()


def _wide(v):
    return f"{v & U64} {v >> 64}"


def _val(pair):
    lo, hi = pair
    return lo + (hi << 64)


# ------------------------------------------------------------ the permutation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permute_matches_plain_and_oracle_on_random_states(prog, seed):
    from plonky25_tpu.refimpl.poseidon2 import poseidon2

    rows = np.random.default_rng(seed).integers(0, P, size=(16, 12),
                                                dtype=np.uint64)
    got = _permute(prog, rows)
    assert got == _plain(rows)
    assert got[:4] == [poseidon2([int(v) for v in row]) for row in rows[:4]]


def _all_edge_states():
    """tests/test_torch_poseidon2.py's edge states, and every rotation of
    the seven edge values of chip_smoke.py."""
    edge = [0, 1, P - 1, 1 << 32, EPS, (EPS << 32) % P, P - (1 << 32)]
    rows = [[edge[(i * k + j) % len(edge)] for i in range(12)]
            for k in range(1, 8) for j in range(len(edge))]
    return [list(map(int, r)) for r in _edge_states()] + rows


def test_permute_matches_plain_and_oracle_on_edge_states(prog):
    from plonky25_tpu.refimpl.poseidon2 import poseidon2

    rows = _all_edge_states()
    got = _permute(prog, rows)
    assert got == _plain(rows)
    assert got == [poseidon2(row) for row in rows]


@pytest.mark.parametrize("lanes", ["p", "above_p", "top"])
def test_permute_takes_any_64_bit_lanes(prog, lanes):
    """Lazy reduction: a lane may hold any 64-bit representative, on entry
    too; the result is the canonical permutation of the values mod p."""
    rng = np.random.default_rng(7)
    base = {"p": P, "above_p": P + EPS // 2, "top": U64 - 12}[lanes]
    rows = [[min(base + int(rng.integers(0, 2)) * k, U64) for k in range(12)],
            [U64] * 12, [P] * 12]
    got = _permute(prog, rows)
    assert got == _plain(rows)
    assert all(v < P for row in got for v in row)


# ------------------------------------------------------------ the helpers

LIMITS_64 = [0, 1, 2, EPS, 1 << 32, P - 1, P, P + 1, P + EPS // 2,
             U64 - EPS, U64 - 1, U64, 1 << 63]


@pytest.mark.parametrize("hi", [0, 1, 63, 64, 1 << 31, EPS])
def test_reduce_wide_at_its_limits(prog, hi):
    """reduce(Wide) takes any value below 2^96 (M_E's outputs are below
    2^70: hi < 64) to a 64-bit representative."""
    got = run(prog, [f"reduce_wide {lo} {hi}" for lo in LIMITS_64])
    for lo, (r,) in zip(LIMITS_64, got):
        assert r <= U64 and r % P == (lo + (hi << 64)) % P


WORDS = [0, 1, 1 << 31, EPS - 1, EPS]


@pytest.mark.parametrize("w3", WORDS)
def test_reduce128_at_its_limits(prog, w3):
    """reduce(U128) takes any 128-bit value: every combination of low,
    middle and top words, and 2^128 - 1."""
    cases = [(w0, w1, w2, w3) for w0 in WORDS for w1 in WORDS for w2 in WORDS]
    got = run(prog, ["reduce128 " + " ".join(map(str, c)) for c in cases])
    for c, (r,) in zip(cases, got):
        x = sum(w << (32 * i) for i, w in enumerate(c))
        assert r <= U64 and r % P == x % P, c


@pytest.mark.parametrize("b", [0, 1, EPS, 1 << 32, P - 1])
def test_mul_and_mul_add_are_exact_at_their_limits(prog, b):
    """mul(a, b) for any a, b < 2^64 (also b >= p), and mul_add(a, b, c)
    for b < p and c < 2^96, exactly: among the addends the top of the
    internal layer's lane sum plus a constant, 12 (2^64 - 1) + p - 1."""
    addends = [0, U64, (1 << 96) - 1, 12 * U64 + P - 1]
    lines, want = [], []
    for a in LIMITS_64:
        for bb in (b, U64 - b):
            lines.append(f"mul {a} {bb}")
            want.append(a * bb)
        for c in addends:
            lines.append(f"mul_add {a} {b} {_wide(c)}")
            want.append(a * b + c)
    got = run(prog, lines)
    for line, words, w in zip(lines, got, want):
        assert sum(v << (32 * i) for i, v in enumerate(words)) == w, line
        assert w < 1 << 128


def test_wide_sums_and_shifts_are_exact_at_their_limits(prog):
    """add and shl at the top of their stated ranges: a + b < 2^96 for the
    sums, a * 2^K < 2^96 for the shifts."""
    top = (1 << 96) - 1
    lines, want = [], []
    for a in LIMITS_64:
        for b in LIMITS_64:
            lines.append(f"add_u64_u64 {a} {b}")
            want.append(a + b)
        lines.append(f"add_wide_u64 {_wide(top - U64)} {a}")
        want.append(top - U64 + a)
        lines.append(f"add_wide_wide {_wide(top - a)} {_wide(a)}")
        want.append(top)
        for k in (1, 2):
            x = (top >> k) - a
            lines.append(f"shl{k} {_wide(x)}")
            want.append(x << k)
    got = run(prog, lines)
    for line, pair, w in zip(lines, got, want):
        assert _val(pair) == w, line


@pytest.mark.parametrize("case", ["top", "mixed", "zero"])
def test_m4_is_exact_below_2_pow_70(prog, case):
    """M4 on exact inputs below 2^66 (x_b + S in M_E), at the top of that
    range: each output is the integer row sum, below 2^70."""
    top = (1 << 66) - 1
    y = {"top": [top] * 4, "mixed": [top, 0, top - P, 1 << 65],
         "zero": [0, 0, 0, 0]}[case]
    (got,) = [sum(run(prog, ["m4 " + " ".join(_wide(v) for v in y)]), [])]
    outs = [_val(got[2 * i:2 * i + 2]) for i in range(4)]
    assert outs == [sum(m * v for m, v in zip(row, y)) for row in M4]
    assert all(o < 1 << 70 for o in outs)


def test_sbox_and_canonical_take_any_64_bit_value(prog):
    got = run(prog, [f"sbox {x}" for x in LIMITS_64]
              + [f"canonical {x}" for x in LIMITS_64])
    n = len(LIMITS_64)
    for x, (r,) in zip(LIMITS_64, got[:n]):
        assert r <= U64 and r % P == pow(x, 7, P)
    assert [r for (r,) in got[n:]] == [x % P for x in LIMITS_64]


def test_round_constant_schedule(prog):
    """rc_after(layer, lane): after the initial M_E and the first three
    external rounds RC[0..3]; after the fourth and the first 21 internal
    rounds RC_MID[r] on lane 0 only; after the last internal round RC[4];
    after external rounds 5-7 RC[5..7]; after the last, nothing."""
    want = [[RC[layer][k] % P for k in range(12)] for layer in range(4)]
    want += [[RC_MID[r] % P] + [0] * 11 for r in range(22)]
    want += [[RC[r][k] % P for k in range(12)] for r in range(4, 8)]
    want += [[0] * 12]
    got = run(prog, [f"rc_after {layer} {k}" for layer in range(31)
                       for k in range(12)])
    assert [got[12 * layer + k][0] for layer in range(31)
            for k in range(12)] == sum(want, [])
