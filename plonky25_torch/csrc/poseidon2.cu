// Poseidon2 width-12 permutation over Goldilocks, one state per thread.
//
// Replaces the Pallas TPU kernel `_kernel` of
// plonky25_tpu/ops/pallas/poseidon2_pallas.py:103 (launched by _permute_cols).
// Python side: plonky25_torch/ops/poseidon2.py (wrapper, plain version).
//
// What bounds it on an H100: integer instruction throughput, not bytes.  A
// state moves 192 B in and 192 B out (12 lanes as the port's two int64
// limb planes) and costs 736 Goldilocks products (8 full rounds x 12 lanes
// x 4 for x^7, plus 22 partial rounds x (4 + 12)) and 1,182 modular adds,
// each product a 64x64->128-bit multiply and a reduction: tens of
// thousands of integer instructions against 384 B of traffic.
//
// What the design does about it: one thread keeps its state in 12 64-bit
// registers for all 30 rounds, so only the state itself touches memory;
// the product is the hardware's wide multiply (a * b and __umul64hi); the
// reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p) with branch-free
// corrections; the round constants travel in the kernel's parameter block
// (__grid_constant__, so it stays in constant memory when the rounds take
// its address), and every round is unrolled so each constant is a fixed
// constant-bank operand.  Blocks share nothing, and the ragged tail of the
// batch is masked by an index test.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (plonky25_torch/ops/build.py); plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 12;
constexpr int kRoundsFBegin = 4;
constexpr int kRoundsF = 8;
constexpr int kRoundsP = 22;
constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr int kThreads = 128;

// Round constants, reduced mod p (plonky25_torch/constants.py).
struct Constants {
  uint64_t rc[kRoundsF][kWidth];
  uint64_t rc_mid[kRoundsP];
  uint64_t diag[kWidth];  // MAT_DIAG_M_1 - 1
};

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

__device__ __forceinline__ void external_round(uint64_t* s,
                                               const uint64_t* rc) {
#pragma unroll
  for (int k = 0; k < kWidth; ++k) s[k] = sbox(gl_add(s[k], rc[k]));
  matmul_external(s);
}

// x^7 on lane 0, then M_I = diag(MAT_DIAG_M_1 - 1) + ones
// (poseidon2.rs:164-182).
__device__ __forceinline__ void internal_round(uint64_t* s, uint64_t rc,
                                               const uint64_t* diag) {
  s[0] = sbox(gl_add(s[0], rc));
  uint64_t sum = s[0];
#pragma unroll
  for (int k = 1; k < kWidth; ++k) sum = gl_add(sum, s[k]);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) s[k] = gl_add(gl_mul(diag[k], s[k]), sum);
}

// in_lo/in_hi/out_lo/out_hi: (n, 12) int64 limb planes, limbs in [0, 2^32),
// values canonical.  out may alias in.
__global__ void __launch_bounds__(kThreads)
    poseidon2_w12_kernel(const int64_t* in_lo, const int64_t* in_hi,
                         int64_t* out_lo, int64_t* out_hi, int64_t n,
                         const __grid_constant__ Constants c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t base = i * kWidth;
  uint64_t s[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    s[k] = static_cast<uint64_t>(in_lo[base + k]) |
           (static_cast<uint64_t>(in_hi[base + k]) << 32);
  }
  matmul_external(s);
#pragma unroll
  for (int r = 0; r < kRoundsFBegin; ++r) external_round(s, c.rc[r]);
#pragma unroll
  for (int r = 0; r < kRoundsP; ++r) internal_round(s, c.rc_mid[r], c.diag);
#pragma unroll
  for (int r = kRoundsFBegin; r < kRoundsF; ++r) external_round(s, c.rc[r]);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    out_lo[base + k] = static_cast<int64_t>(s[k] & kEps);
    out_hi[base + k] = static_cast<int64_t>(s[k] >> 32);
  }
}

}  // namespace

// Launches the permutation of n states on `stream`; allocates nothing and
// does not synchronise.  `constants` points to host memory holding the
// Constants struct's 130 words.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int p25_poseidon2_permute_w12(const int64_t* in_lo,
                                         const int64_t* in_hi,
                                         int64_t* out_lo, int64_t* out_hi,
                                         int64_t n, const uint64_t* constants,
                                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  Constants c;
  std::memcpy(&c, constants, sizeof(c));
  poseidon2_w12_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in_lo, in_hi, out_lo, out_hi, n, c);
  return static_cast<int>(cudaGetLastError());
}
