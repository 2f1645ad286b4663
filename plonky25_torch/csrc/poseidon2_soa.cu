// Poseidon2 width-12 permutation over Goldilocks on lane-major states: the
// state is (12, n), lane k of state i at k * n + i.  One state per thread.
//
// Replaces the Pallas TPU kernel `_soa_kernel` of
// plonky25_tpu/ops/pallas/poseidon2_pallas.py:219 (launched by _permute_soa).
// Python side: plonky25_torch/ops/poseidon2.py (poseidon2_permute_soa and
// its plain version).  Callers: the prover's Merkle trees (leaf hash and
// every compression level) and its proof-of-work grind windows, whose
// states come out of the column-major LDE already lane-major.
//
// What bounds it on an H100: integer instruction issue, as for the
// state-major kernel (poseidon2.cu): 736 Goldilocks products and 1,182
// modular adds per state against 192 B read and 192 B written.
//
// What the design does about it: thread i reads lane k at k * n + i, so a
// warp's 32 loads of one lane are 256 contiguous bytes (the state-major
// kernel's threads sit 96 B apart).  The state stays in 12 64-bit registers
// for all 30 rounds, which are p25::permute (poseidon2_common.cuh), shared
// with the state-major kernel, round constants baked in as immediates as in
// the TPU kernel.  Blocks share nothing; the ragged tail is masked.
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

// in_lo/in_hi/out_lo/out_hi: (12, n) int64 limb planes, limbs in
// [0, 2^32), values canonical.  out may alias in: each thread reads its
// whole state before it writes.
__global__ void __launch_bounds__(kThreads)
    poseidon2_soa_kernel(const int64_t* in_lo, const int64_t* in_hi,
                         int64_t* out_lo, int64_t* out_hi, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint64_t s[kWidth];
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    s[k] = static_cast<uint64_t>(in_lo[k * n + i]) |
           (static_cast<uint64_t>(in_hi[k * n + i]) << 32);
  }
  p25::permute(s);
#pragma unroll
  for (int k = 0; k < kWidth; ++k) {
    out_lo[k * n + i] = static_cast<int64_t>(s[k] & kEps);
    out_hi[k * n + i] = static_cast<int64_t>(s[k] >> 32);
  }
}

}  // namespace

// Launches the permutation of the n lane-major states on `stream`;
// allocates nothing and does not synchronise.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int p25_poseidon2_permute_soa(const int64_t* in_lo,
                                         const int64_t* in_hi,
                                         int64_t* out_lo, int64_t* out_hi,
                                         int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  poseidon2_soa_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in_lo, in_hi, out_lo, out_hi, n);
  return static_cast<int>(cudaGetLastError());
}
