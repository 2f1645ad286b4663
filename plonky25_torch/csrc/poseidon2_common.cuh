// The Poseidon2 permutation shared by the two kernels (poseidon2.cu,
// state-major; poseidon2_soa.cu, lane-major), which differ only in where a
// thread loads and stores its lanes: Goldilocks arithmetic, the linear
// layers and the rounds, in two forms.  `permute` runs one state on one
// thread; `permute_split` (device only) spreads one state over the three
// threads of a group, one M4 block of 4 lanes each, for launches too small
// to fill the card: a thread then issues about 8,300 instructions instead
// of 18,700, and a latency-bound launch waits for that stream.  Each
// kernel file gives the crossover between the two and their registers.
//
// What bounds the kernels on an H100: the integer instructions one thread
// issues.  A state needs 736 Goldilocks products and the linear layers'
// additions against 384 B of traffic, so the large launches are bound by
// integer issue and the small ones (a tree level near the root, a
// transcript step) by the latency of one thread's dependent stream.  The
// first kernels corrected every operation to its canonical value (< p):
// their SASS issued about 39,000 instructions per state, 27,000 of them on
// the ALU pipe, where the arithmetic needs about 9,700 (2,944 multiplies
// on the FMA pipe, 6,780 adds on either pipe); this header's permutation
// issues about 18,700, 9,300 on each pipe (chip_smoke.py [build]).
//
// What this header does about it:
//  * Lazy reduction.  Between operations a lane holds any 64-bit
//    representative of its value (x and x + p are the same element); only
//    the final store reduces it below p (`canonical`, 12 per state).
//  * Linear layers as wide integer sums.  M_E = circ(2 M4, M4, M4) is
//    M4 applied to x_b + S per block b, S the lane-wise sum of the three
//    blocks, and the internal layer adds the sum of all 12 lanes: every
//    intermediate is an exact integer below 2^70 (`Wide`, three 32-bit
//    words), and each output lane takes one reduction, with 2^64 = 2^32 - 1
//    (mod p).  The next round's constants are added to that wide sum
//    before its reduction, so no round-constant add has a reduction of
//    its own.
//  * Products as carry chains.  The 128-bit product, with an optional
//    wide addend, is a chain of mad.lo.cc / madc.hi.cc on 32-bit words,
//    and the 128-to-64-bit reduction uses add.cc / sub.cc / subc, so nvcc
//    emits carry-chained adds (IADD3 / IMAD.X with carry predicates)
//    instead of compare-and-select pairs.  The 12 internal-diagonal
//    factors have no special form (no small or sparse 32-bit half), so
//    there is nothing to special-case: their products take the general
//    chain, the factor's halves as immediate operands.
//
// Every helper states the range its inputs may have and the range of its
// result.  Every inline-PTX helper has a host branch in unsigned __int128,
// so the header also compiles with a host C++ compiler
// (tests/test_torch_p2_header.py runs `permute` and the helpers that way).
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

// An exact integer lo + hi * 2^64 with hi < 2^32 (below 2^96).
struct Wide {
  uint64_t lo;
  uint32_t hi;
};

// ------------------------------------------------------------ wide sums

// a + b for a < 2^96 - 2^64 (so the sum stays below 2^96), b < 2^64.
__host__ __device__ __forceinline__ Wide add(Wide a, uint64_t b) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %0;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 %1, %1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t}"
      : "+l"(a.lo), "+r"(a.hi)
      : "l"(b));
  return a;
#else
  const unsigned __int128 s =
      ((static_cast<unsigned __int128>(a.hi) << 64) | a.lo) + b;
  return {static_cast<uint64_t>(s), static_cast<uint32_t>(s >> 64)};
#endif
}

// a + b for a + b < 2^96.
__host__ __device__ __forceinline__ Wide add(Wide a, Wide b) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %0;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 %1, %1, %3;\n\t"
      "mov.b64 %0, {a0, a1};\n\t}"
      : "+l"(a.lo), "+r"(a.hi)
      : "l"(b.lo), "r"(b.hi));
  return a;
#else
  const unsigned __int128 s =
      ((static_cast<unsigned __int128>(a.hi) << 64) | a.lo) +
      ((static_cast<unsigned __int128>(b.hi) << 64) | b.lo);
  return {static_cast<uint64_t>(s), static_cast<uint32_t>(s >> 64)};
#endif
}

// a + b for a, b < 2^64: the exact sum, below 2^65.
__host__ __device__ __forceinline__ Wide add(uint64_t a, uint64_t b) {
  return add(Wide{a, 0}, b);
}

// a * 2^K for a * 2^K < 2^96, K in [1, 31].
template <int K>
__host__ __device__ __forceinline__ Wide shl(Wide a) {
  static_assert(K >= 1 && K < 32, "shift by 1..31");
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 a0, a1;\n\t"
      "mov.b64 {a0, a1}, %0;\n\t"
      "shf.l.wrap.b32 %1, a1, %1, %2;\n\t"
      "shf.l.wrap.b32 a1, a0, a1, %2;\n\t"
      "shl.b32 a0, a0, %2;\n\t"
      "mov.b64 %0, {a0, a1};\n\t}"
      : "+l"(a.lo), "+r"(a.hi)
      : "n"(K));
  return a;
#else
  return {a.lo << K, (a.hi << K) | static_cast<uint32_t>(a.lo >> (64 - K))};
#endif
}

// ------------------------------------------------------------ reductions

// Some 64-bit representative of a (mod p), for any a < 2^96: a.lo +
// a.hi * EPS, a carry out of 2^64 folded back as + EPS.  a.hi * EPS <=
// (2^32 - 1)^2 = 2^64 - 2^33 + 1, so after a carry the sum is below
// 2^64 - 2^33 + 1 and the + EPS cannot carry again.
//
// In this header's PTX a carry is read only by add-with-carry instructions
// and a borrow only by subtract-with-borrow ones: read across the two
// kinds, the flag follows the hardware (on sm_90a subc after add.cc sees
// "no carry" as a borrow), not the formula of the PTX manual.
__host__ __device__ __forceinline__ uint64_t reduce(Wide a) {
#ifdef __CUDA_ARCH__
  uint64_t r;
  asm("{\n\t.reg .u32 s0, s1, x0, x1, c;\n\t"
      ".reg .u64 x;\n\t"
      "mul.wide.u32 x, %2, 0xFFFFFFFF;\n\t"
      "mov.b64 {s0, s1}, %1;\n\t"
      "mov.b64 {x0, x1}, x;\n\t"
      "add.cc.u32 s0, s0, x0;\n\t"
      "addc.cc.u32 s1, s1, x1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"             // carry * EPS = 0 : -carry
      "add.cc.u32 s0, s0, c;\n\t"
      "addc.u32 s1, s1, 0;\n\t"
      "mov.b64 %0, {s0, s1};\n\t}"
      : "=l"(r)
      : "l"(a.lo), "r"(a.hi));
  return r;
#else
  const uint64_t x = static_cast<uint64_t>(a.hi) * kEps;
  uint64_t s = a.lo + x;
  if (s < x) s += kEps;
  return s;
#endif
}

// A 128-bit integer as four 32-bit words, least significant first.
struct U128 {
  uint32_t w[4];
};

// a * b + c, exactly, for a < 2^64, b < p and c < 2^96: a * b <=
// (2^64 - 1)(2^64 - 2^32) < 2^128 - 2^96, so a * b + c < 2^128.  The four
// partial products and the addend go through one carry chain.
__host__ __device__ __forceinline__ U128 mul_add(uint64_t a, uint64_t b,
                                                 Wide c) {
  U128 r;
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .u32 a0, a1, b0, b1, c0, c1, c2;\n\t"
      "mov.b32 c2, %7;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mov.b64 {b0, b1}, %5;\n\t"
      "mov.b64 {c0, c1}, %6;\n\t"
      "mad.lo.cc.u32 %0, a0, b0, c0;\n\t"
      "madc.hi.cc.u32 %1, a0, b0, c1;\n\t"
      "madc.lo.cc.u32 %2, a1, b1, c2;\n\t"
      "madc.hi.u32 %3, a1, b1, 0;\n\t"
      "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
      "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
      "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t}"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
      : "l"(a), "l"(b), "l"(c.lo), "r"(c.hi));
#else
  const unsigned __int128 p =
      static_cast<unsigned __int128>(a) * b +
      ((static_cast<unsigned __int128>(c.hi) << 64) | c.lo);
  for (int i = 0; i < 4; ++i) r.w[i] = static_cast<uint32_t>(p >> (32 * i));
#endif
  return r;
}

// a * b, exactly, for a, b < 2^64.
__host__ __device__ __forceinline__ U128 mul(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  U128 r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1;\n\t"
      "mov.b64 {a0, a1}, %4;\n\t"
      "mov.b64 {b0, b1}, %5;\n\t"
      "mul.lo.u32 %0, a0, b0;\n\t"
      "mul.hi.u32 %1, a0, b0;\n\t"
      "mul.lo.u32 %2, a1, b1;\n\t"
      "mul.hi.u32 %3, a1, b1;\n\t"
      "mad.lo.cc.u32 %1, a0, b1, %1;\n\t"
      "madc.hi.cc.u32 %2, a0, b1, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t"
      "mad.lo.cc.u32 %1, a1, b0, %1;\n\t"
      "madc.hi.cc.u32 %2, a1, b0, %2;\n\t"
      "addc.u32 %3, %3, 0;\n\t}"
      : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
      : "l"(a), "l"(b));
  return r;
#else
  return mul_add(a, b, Wide{0, 0});
#endif
}

// Some 64-bit representative of x (mod p), for any 128-bit x, with
// 2^64 = EPS and 2^96 = -1 (mod p): t = x mod 2^64 - w3, a borrow folded
// back as - EPS (t >= 2^64 - 2^32 + 1 then, so no second borrow); then
// t + w2 * EPS, a carry folded back as + EPS (no second carry, as in
// `reduce`).
__host__ __device__ __forceinline__ uint64_t reduce(U128 x) {
#ifdef __CUDA_ARCH__
  uint64_t r;
  asm("{\n\t.reg .u32 t0, t1, x0, x1, m;\n\t"
      ".reg .u64 x;\n\t"
      "sub.cc.u32 t0, %1, %4;\n\t"
      "subc.cc.u32 t1, %2, 0;\n\t"
      "subc.u32 m, 0, 0;\n\t"          // m = 2^32 - 1 after a borrow, else 0
      "sub.cc.u32 t0, t0, m;\n\t"
      "subc.u32 t1, t1, 0;\n\t"
      "mul.wide.u32 x, %3, 0xFFFFFFFF;\n\t"
      "mov.b64 {x0, x1}, x;\n\t"
      "add.cc.u32 t0, t0, x0;\n\t"
      "addc.cc.u32 t1, t1, x1;\n\t"
      "addc.u32 m, 0, 0;\n\t"
      "neg.s32 m, m;\n\t"             // carry * EPS = 0 : -carry
      "add.cc.u32 t0, t0, m;\n\t"
      "addc.u32 t1, t1, 0;\n\t"
      "mov.b64 %0, {t0, t1};\n\t}"
      : "=l"(r)
      : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]));
  return r;
#else
  const uint64_t lo = (static_cast<uint64_t>(x.w[1]) << 32) | x.w[0];
  uint64_t t = lo - x.w[3];
  if (lo < x.w[3]) t -= kEps;
  const uint64_t m = static_cast<uint64_t>(x.w[2]) * kEps;
  uint64_t s = t + m;
  if (s < m) s += kEps;
  return s;
#endif
}

// The canonical value (< p) of any 64-bit x: x < 2^64 < 2p, so one
// subtraction at most.
__host__ __device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= kP ? x - kP : x;
}

// x^7 (poseidon2.rs:114-121), any 64-bit x in, some 64-bit representative
// out.
__host__ __device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = reduce(mul(x, x));
  const uint64_t x4 = reduce(mul(x2, x2));
  const uint64_t x3 = reduce(mul(x, x2));
  return reduce(mul(x3, x4));
}

// M4 (poseidon2.rs:185-243) on four exact integers y[i] < 2^66, in place:
// its add/double chain on wide sums.  Each output is at most 16 times the
// largest input (the rows of M4 sum to 16, 12, 16, 12), below 2^70.
__host__ __device__ __forceinline__ void m4(Wide* y) {
  const Wide t0 = add(y[0], y[1]);
  const Wide t1 = add(y[2], y[3]);
  const Wide t2 = add(t1, shl<1>(y[1]));
  const Wide t3 = add(t0, shl<1>(y[3]));
  const Wide t4 = add(t3, shl<2>(t1));
  const Wide t5 = add(t2, shl<2>(t0));
  y[0] = add(t3, t5);
  y[1] = t5;
  y[2] = add(t2, t4);
  y[3] = t4;
}

// ------------------------------------------------------------ schedule

// The rounds' linear layers in order: layer 0 is the initial M_E, 1-4 the
// first four external rounds, 5-26 the 22 internal rounds, 27-30 the last
// four external rounds.  rc_after(layer, lane) is the constant the next
// round adds to `lane` before its S-box, 0 where it adds none (no round
// constant is 0), so that each layer adds it to its wide sum before the
// one reduction.
constexpr int kLayers = 1 + kRoundsF + kRoundsP;
constexpr int kFirstInternal = 1 + kRoundsFBegin;
constexpr int kLastInternal = kFirstInternal + kRoundsP - 1;

__host__ __device__ constexpr uint64_t rc_after(int layer, int lane) {
  return layer < kFirstInternal - 1   ? rc_ext(layer, lane)
         : layer < kLastInternal      ? (lane == 0 ? rc_mid(layer - 4) : 0)
         : layer < kLayers - 1        ? rc_ext(layer - kRoundsP, lane)
                                      : 0;
}

constexpr bool no_zero_round_constant() {
  for (int r = 0; r < kRoundsF; ++r)
    for (int k = 0; k < kWidth; ++k)
      if (rc_ext(r, k) == 0) return false;
  for (int r = 0; r < kRoundsP; ++r)
    if (rc_mid(r) == 0) return false;
  return true;
}
static_assert(no_zero_round_constant(), "0 marks 'no constant' in rc_after");

// w + rc_after(Layer, Lane), for w < 2^96 - 2^64.
template <int Layer, int Lane>
__host__ __device__ __forceinline__ Wide plus_rc(Wide w) {
  constexpr uint64_t c = rc_after(Layer, Lane);
  if constexpr (c != 0) w = add(w, c);
  return w;
}

// A compile-time index, usable as an int in device code (the conversion of
// std::integral_constant is a host function).
template <int I>
struct Index {
  static constexpr int value = I;
  __host__ __device__ constexpr operator int() const { return I; }
};

// f(Index<I>{}) for each I in turn.
template <int... I, class F>
__host__ __device__ __forceinline__ void unroll(
    std::integer_sequence<int, I...>, F&& f) {
  (f(Index<I>{}), ...);
}

using Four = std::make_integer_sequence<int, 4>;
using Lanes = std::make_integer_sequence<int, kWidth>;

// ------------------------------------------------------------ one thread

// M_E = circ(2 M4, M4, M4) (poseidon2.rs:127-147) on 12 lanes < 2^64,
// then the next round's constants: block b is M4(x_b + S), S the lane-wise
// sum of the three blocks (x_b + S < 2^66).
template <int Layer>
__host__ __device__ __forceinline__ void matmul_external(uint64_t* s) {
  Wide sum[4];
  unroll(Four{}, [&](auto i) {
    sum[i] = add(add(s[i], s[4 + i]), s[8 + i]);
  });
  unroll(std::make_integer_sequence<int, 3>{}, [&](auto b) {
    constexpr int B = decltype(b)::value;
    Wide y[4];
    unroll(Four{}, [&](auto i) { y[i] = add(sum[i], s[4 * B + i]); });
    m4(y);
    unroll(Four{}, [&](auto i) {
      constexpr int K = 4 * B + decltype(i)::value;
      s[K] = reduce(plus_rc<Layer, K>(y[K - 4 * B]));
    });
  });
}

// M_I = diag(MAT_DIAG_M_1 - 1) + ones (poseidon2.rs:164-182) on 12 lanes
// < 2^64, then the next round's constants: lane k is
// reduce(diag(k) * s[k] + sum + c_k), the lane sum below 12 * 2^64 < 2^68.
template <int Layer>
__host__ __device__ __forceinline__ void matmul_internal(uint64_t* s) {
  Wide sum = add(s[0], s[1]);
  unroll(std::make_integer_sequence<int, kWidth - 2>{},
         [&](auto k) { sum = add(sum, s[k + 2]); });
  unroll(Lanes{}, [&](auto k) {
    constexpr int K = decltype(k)::value;
    s[K] = reduce(mul_add(s[K], diag(K), plus_rc<Layer, K>(sum)));
  });
}

// One round, by its linear layer: the S-boxes (none before the initial
// M_E), then the layer and the next round's constants.
template <int Layer>
__host__ __device__ __forceinline__ void step(uint64_t* s) {
  if constexpr (Layer >= kFirstInternal && Layer <= kLastInternal) {
    s[0] = sbox(s[0]);
    matmul_internal<Layer>(s);
  } else {
    if constexpr (Layer > 0) unroll(Lanes{}, [&](auto k) { s[k] = sbox(s[k]); });
    matmul_external<Layer>(s);
  }
}

template <int... L>
__host__ __device__ __forceinline__ void steps(
    uint64_t* s, std::integer_sequence<int, L...>) {
  (step<L>(s), ...);
}

// The whole permutation on one state held in registers: initial M_E, 4
// external, 22 internal and 4 external rounds.  Any 64-bit lanes in;
// canonical lanes (< p) out.
__host__ __device__ __forceinline__ void permute(uint64_t* s) {
  steps(s, std::make_integer_sequence<int, kLayers>{});
  unroll(Lanes{}, [&](auto k) { s[k] = canonical(s[k]); });
}

// ------------------------------------------------------------ three threads

#ifdef __CUDACC__
// One state over the three threads of a group: thread `part` (0, 1 or 2)
// holds lanes 4 * part + i in x[i].  `a` and `b` are the warp lanes of
// the group's parts part + 1 and part + 2 (mod 3); every thread of the
// warp runs every step (the warp's two spare threads on a copy of some
// group's values, which they do not store), as __shfl_sync(~0u, ...) needs.
struct Group {
  int part;
  int a, b;
  bool p0, p1;  // part == 0, part == 1

  // The group of warp lane `lane`: lanes 3j, 3j + 1, 3j + 2 hold state j
  // of the warp's 10; lanes 30 and 31 are spare (their a, b wrap into
  // lanes 0 and 1, which __shfl_sync takes mod 32).
  __device__ __forceinline__ static Group of(int lane) {
    const int base = lane / 3 * 3;
    const int part = lane - base;
    return {part, base + (part + 1) % 3, base + (part + 2) % 3, part == 0,
            part == 1};
  }

  // c[part], for constants known at compile time.
  __device__ __forceinline__ uint64_t pick(uint64_t c0, uint64_t c1,
                                           uint64_t c2) const {
    return p0 ? c0 : (p1 ? c1 : c2);
  }

  // x + (x at thread a) + (x at thread b).
  __device__ __forceinline__ Wide sum3(uint64_t x) const {
    return add(add(x, __shfl_sync(~0u, x, a)), __shfl_sync(~0u, x, b));
  }
  __device__ __forceinline__ Wide sum3(Wide x) const {
    const Wide xa{__shfl_sync(~0u, x.lo, a), __shfl_sync(~0u, x.hi, a)};
    const Wide xb{__shfl_sync(~0u, x.lo, b), __shfl_sync(~0u, x.hi, b)};
    return add(add(x, xa), xb);
  }
};

// w + rc_after(Layer, 4 * part + I), for w < 2^96 - 2^64.
template <int Layer, int I>
__device__ __forceinline__ Wide plus_rc(Wide w, const Group& g) {
  constexpr uint64_t c0 = rc_after(Layer, I);
  constexpr uint64_t c1 = rc_after(Layer, 4 + I);
  constexpr uint64_t c2 = rc_after(Layer, 8 + I);
  if constexpr (c0 != 0 || c1 != 0 || c2 != 0) w = add(w, g.pick(c0, c1, c2));
  return w;
}

template <int Layer>
__device__ __forceinline__ void step_split(uint64_t* x, const uint64_t* d,
                                            const Group& g) {
  if constexpr (Layer >= kFirstInternal && Layer <= kLastInternal) {
    // Lane 0's S-box on part 0; the diagonal products of the others do
    // not wait for it.
    const uint64_t y = sbox(x[0]);
    if (g.p0) x[0] = y;
    const Wide sum = g.sum3(add(add(add(x[0], x[1]), x[2]), x[3]));
    unroll(Four{}, [&](auto i) {
      constexpr int I = decltype(i)::value;
      x[I] = reduce(mul_add(x[I], d[I], plus_rc<Layer, I>(sum, g)));
    });
  } else {
    if constexpr (Layer > 0) unroll(Four{}, [&](auto i) { x[i] = sbox(x[i]); });
    Wide y[4];
    unroll(Four{}, [&](auto i) { y[i] = add(g.sum3(x[i]), x[i]); });
    m4(y);
    unroll(Four{}, [&](auto i) {
      x[i] = reduce(plus_rc<Layer, decltype(i)::value>(y[i], g));
    });
  }
}

template <int... L>
__device__ __forceinline__ void steps_split(
    uint64_t* x, const uint64_t* d, const Group& g,
    std::integer_sequence<int, L...>) {
  (step_split<L>(x, d, g), ...);
}

// The permutation of the group's state: any 64-bit lanes in, this
// thread's 4 lanes canonical (< p) out.
__device__ __forceinline__ void permute_split(uint64_t* x, const Group& g) {
  uint64_t d[4];
  unroll(Four{}, [&](auto i) {
    d[i] = g.pick(diag(i), diag(4 + i), diag(8 + i));
  });
  steps_split(x, d, g, std::make_integer_sequence<int, kLayers>{});
  unroll(Four{}, [&](auto i) { x[i] = canonical(x[i]); });
}
#endif  // __CUDACC__

}  // namespace p25
