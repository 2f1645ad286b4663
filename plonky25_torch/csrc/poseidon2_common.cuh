// The Poseidon2 permutation shared by the two kernels (poseidon2.cu,
// state-major; poseidon2_soa.cu, lane-major), which differ only in where a
// thread loads and stores its 12 lanes: Goldilocks arithmetic, the linear
// layers and the rounds.  Every value is canonical (< p) on entry and on
// exit.
//
// As in the TPU kernels, the round constants are baked in: the rounds are
// template instances unrolled by fold expressions, and each constant is
// read from poseidon2_constants.cuh in a constant expression, so it is an
// immediate operand and no constant table is loaded or passed.

#pragma once

#include <cstdint>
#include <utility>

#include "poseidon2_constants.cuh"

namespace p25 {

constexpr int kWidth = 12;
constexpr int kRoundsFBegin = 4;
constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p

// a + b mod p for canonical a, b.
__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // A carry out of 2^64 is worth EPS; a, b < p keeps s + EPS below p then.
  if (s < a) s += kEps;
  return s >= kP ? s - kP : s;
}

// (hi * 2^64 + lo) mod p, canonical.
__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t x3 = hi >> 32;  // weight 2^96 = -1
  const uint64_t x2 = hi & kEps; // weight 2^64 = EPS
  uint64_t t = lo - x3;
  // A borrow is worth -2^64 = -EPS; t is then >= 2^64 - 2^32, so no second
  // borrow.
  if (lo < x3) t -= kEps;
  const uint64_t m = x2 * kEps;  // < 2^64
  uint64_t r = t + m;
  // A carry is worth EPS; r <= 2^64 - 2^33 then, so no second carry.
  if (r < m) r += kEps;
  return r >= kP ? r - kP : r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// x^7 (poseidon2.rs:114-121).
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  const uint64_t x4 = gl_mul(x2, x2);
  const uint64_t x3 = gl_mul(x, x2);
  return gl_mul(x3, x4);
}

// M4 on four lanes in place: the add/double chain of poseidon2.rs:185-243.
__device__ __forceinline__ void m4(uint64_t* x) {
  const uint64_t t0 = gl_add(x[0], x[1]);
  const uint64_t t1 = gl_add(x[2], x[3]);
  const uint64_t t2 = gl_add(t1, gl_add(x[1], x[1]));
  const uint64_t t3 = gl_add(t0, gl_add(x[3], x[3]));
  const uint64_t t1_2 = gl_add(t1, t1);
  const uint64_t t0_2 = gl_add(t0, t0);
  const uint64_t t4 = gl_add(t3, gl_add(t1_2, t1_2));
  const uint64_t t5 = gl_add(t2, gl_add(t0_2, t0_2));
  x[0] = gl_add(t3, t5);
  x[1] = t5;
  x[2] = gl_add(t2, t4);
  x[3] = t4;
}

// M_E = circ(2 M4, M4, M4) (poseidon2.rs:127-147).
__device__ __forceinline__ void matmul_external(uint64_t* s) {
  m4(s);
  m4(s + 4);
  m4(s + 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t stored = gl_add(gl_add(s[i], s[4 + i]), s[8 + i]);
    s[i] = gl_add(s[i], stored);
    s[4 + i] = gl_add(s[4 + i], stored);
    s[8 + i] = gl_add(s[8 + i], stored);
  }
}

using Lanes = std::make_integer_sequence<int, kWidth>;

// Add RC[R][K] to lane K and raise it to the 7th power.
template <int R, int K>
__device__ __forceinline__ void external_lane(uint64_t* s) {
  constexpr uint64_t c = rc_ext(R, K);
  s[K] = sbox(gl_add(s[K], c));
}

template <int R, int... K>
__device__ __forceinline__ void external_round(
    uint64_t* s, std::integer_sequence<int, K...>) {
  (external_lane<R, K>(s), ...);
  matmul_external(s);
}

// (MAT_DIAG_M_1[K] - 1) * s[K] + sum.
template <int K>
__device__ __forceinline__ uint64_t internal_lane(const uint64_t* s,
                                                  uint64_t sum) {
  constexpr uint64_t d = diag(K);
  return gl_add(gl_mul(s[K], d), sum);
}

// x^7 on lane 0 after RC_MID[R], then M_I = diag(MAT_DIAG_M_1 - 1) + ones
// (poseidon2.rs:164-182).
template <int R, int... K>
__device__ __forceinline__ void internal_round(
    uint64_t* s, std::integer_sequence<int, K...>) {
  constexpr uint64_t c = rc_mid(R);
  s[0] = sbox(gl_add(s[0], c));
  uint64_t sum = s[0];
#pragma unroll
  for (int k = 1; k < kWidth; ++k) sum = gl_add(sum, s[k]);
  ((s[K] = internal_lane<K>(s, sum)), ...);
}

template <int First, int... R>
__device__ __forceinline__ void external_rounds(
    uint64_t* s, std::integer_sequence<int, R...>) {
  (external_round<First + R>(s, Lanes{}), ...);
}

template <int... R>
__device__ __forceinline__ void internal_rounds(
    uint64_t* s, std::integer_sequence<int, R...>) {
  (internal_round<R>(s, Lanes{}), ...);
}

// The whole permutation on one state held in registers: initial M_E, 4
// external, 22 internal and 4 external rounds.
__device__ __forceinline__ void permute(uint64_t* s) {
  matmul_external(s);
  external_rounds<0>(s, std::make_integer_sequence<int, kRoundsFBegin>{});
  internal_rounds(s, std::make_integer_sequence<int, kRoundsP>{});
  external_rounds<kRoundsFBegin>(
      s, std::make_integer_sequence<int, kRoundsF - kRoundsFBegin>{});
}

}  // namespace p25
