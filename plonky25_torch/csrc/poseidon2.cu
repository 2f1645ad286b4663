// Poseidon2 width-12 permutation over Goldilocks on state-major states: the
// state is (n, 12), lane k of state i at i * 12 + k.  One state per thread.
//
// Replaces the Pallas TPU kernel `_kernel` of
// plonky25_tpu/ops/pallas/poseidon2_pallas.py:103 (launched by _permute_cols).
// Python side: plonky25_torch/ops/poseidon2.py (wrapper, plain version).
// Callers: the verifier's sponge and Merkle walks, and every transcript's
// duplex steps.
//
// What bounds it on an H100: integer instruction throughput, not bytes.  A
// state moves 192 B in and 192 B out (12 lanes as the port's two int64
// limb planes) and costs 736 Goldilocks products (8 full rounds x 12 lanes
// x 4 for x^7, plus 22 partial rounds x (4 + 12)) and 1,182 modular adds,
// each product a 64x64->128-bit multiply and a reduction: thousands of
// integer instructions against 384 B of traffic.
//
// What the design does about it: one thread keeps its state in 12 64-bit
// registers for all 30 rounds, so only the state itself touches memory; the
// rounds, with their constants as immediates, are p25::permute
// (poseidon2_common.cuh), shared with the lane-major kernel.  Blocks share
// nothing, and the ragged tail of the batch is masked by an index test.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (plonky25_torch/ops/build.py); plain C interface, loaded with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

#include "poseidon2_common.cuh"

namespace {

using p25::kEps;
using p25::kWidth;

constexpr int kThreads = 128;

// in_lo/in_hi/out_lo/out_hi: (n, 12) int64 limb planes, limbs in [0, 2^32),
// values canonical.  out may alias in.
__global__ void __launch_bounds__(kThreads)
    poseidon2_w12_kernel(const int64_t* in_lo, const int64_t* in_hi,
                         int64_t* out_lo, int64_t* out_hi, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t base = i * kWidth;
  uint64_t s[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    s[k] = static_cast<uint64_t>(in_lo[base + k]) |
           (static_cast<uint64_t>(in_hi[base + k]) << 32);
  }
  p25::permute(s);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    out_lo[base + k] = static_cast<int64_t>(s[k] & kEps);
    out_hi[base + k] = static_cast<int64_t>(s[k] >> 32);
  }
}

}  // namespace

// Launches the permutation of n states on `stream`; allocates nothing and
// does not synchronise.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int p25_poseidon2_permute_w12(const int64_t* in_lo,
                                         const int64_t* in_hi,
                                         int64_t* out_lo, int64_t* out_hi,
                                         int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  poseidon2_w12_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in_lo, in_hi, out_lo, out_hi, n);
  return static_cast<int>(cudaGetLastError());
}
