// Poseidon2 width-12 permutation over Goldilocks on lane-major states: the
// state is (12, n), lane k of state i at k * n + i.
//
// Replaces the Pallas TPU kernel `_soa_kernel` of
// plonky25_tpu/ops/pallas/poseidon2_pallas.py:219 (launched by _permute_soa).
// Python side: plonky25_torch/ops/poseidon2.py (poseidon2_permute_soa and
// its plain version).  Callers: the prover's Merkle trees (leaf hash and
// every compression level) and its proof-of-work grind windows, whose
// states come out of the column-major LDE already lane-major.
//
// What bounds it on an H100: integer instruction issue, as for the
// state-major kernel (poseidon2.cu): 736 Goldilocks products and the linear
// layers' sums per state against 192 B read and 192 B written.  A tree's
// leaf hash and lower levels (2^21 states down to about 2^16) and the
// grind windows fill the card and are bound by integer issue (the ALU and
// FMA pipes, about equally loaded); its upper
// levels and the late FRI trees (most of a proof's launches) carry too
// few states to fill it and wait on one thread's dependent stream.
//
// What the design does about it: both variants run the lean permutation of
// poseidon2_common.cuh (lazy reduction, linear layers as wide integer
// sums, carry-chained products; constants as immediates), shared with the
// state-major kernel.
//  * `poseidon2_soa_kernel`, one state per thread: thread i reads lane k at
//    k * n + i, so a warp's 32 loads of one lane are 256 contiguous bytes;
//    the state stays in registers for all 30 rounds.
//  * `poseidon2_soa_split_kernel`, one state per three threads of a warp,
//    one M4 block of 4 lanes each (10 states per warp, 2 spare lanes),
//    exchanging M_E's lane sums and the internal layer's sum with
//    __shfl_sync: each thread's stream is about 45% of a whole state's.
//    Three threads of 4 lanes, not four of 3, because M4 acts on 4-lane
//    blocks, so with one block per thread only sums cross threads.
// p25_poseidon2_permute_soa runs the split variant for n <= kSplitMaxStates
// and the other above.  The crossover, 32,768 states, is where the split
// variant's 3.2x as many warps start to fill the card and its extra work
// (the shuffles, and the constants it selects by part at run time) stops
// paying: measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py
// [timing], which times both variants across it (PERF.md).
//
// Registers (ptxas -v for sm_90a, chip_smoke.py [build]): one thread per
// state 64, so 8 blocks of 128 threads (32 warps, half the SM's 64) fit
// an SM; split 42, 12 blocks (48 warps).  No spills; both keep
// __launch_bounds__(128).  After the redesign a state costs about 18,700
// SASS instructions, split evenly between the ALU and FMA pipes (the
// first kernel issued about 39,000, 27,000 of them on the ALU pipe).
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
constexpr int kStatesPerWarp = 10;
constexpr int kSplitStatesPerBlock = kThreads / 32 * kStatesPerWarp;
// The split variant runs launches of at most this many states.
constexpr int64_t kSplitMaxStates = 32768;

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

// The same on three threads per state.  Every thread of a warp runs the
// permutation, as its shuffles need; those without a state (the spare
// lanes, the ragged tail) load zeros and store nothing.  out may alias in:
// the group's shuffles follow its loads, and its stores follow them.
__global__ void __launch_bounds__(kThreads)
    poseidon2_soa_split_kernel(const int64_t* in_lo, const int64_t* in_hi,
                               int64_t* out_lo, int64_t* out_hi, int64_t n) {
  const int lane = threadIdx.x % 32;
  const p25::Group g = p25::Group::of(lane);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSplitStatesPerBlock +
                    threadIdx.x / 32 * kStatesPerWarp + lane / 3;
  const bool live = lane < 3 * kStatesPerWarp && i < n;
  const int64_t base = 4 * g.part * n + i;
  uint64_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[j] = live ? static_cast<uint64_t>(in_lo[base + j * n]) |
                      (static_cast<uint64_t>(in_hi[base + j * n]) << 32)
                : 0;
  }
  p25::permute_split(x, g);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out_lo[base + j * n] = static_cast<int64_t>(x[j] & kEps);
    out_hi[base + j * n] = static_cast<int64_t>(x[j] >> 32);
  }
}

int launch(const int64_t* in_lo, const int64_t* in_hi, int64_t* out_lo,
           int64_t* out_hi, int64_t n, bool split, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = split ? kSplitStatesPerBlock : kThreads;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = split ? poseidon2_soa_split_kernel : poseidon2_soa_kernel;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(in_lo, in_hi, out_lo, out_hi,
                                                n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the permutation of the n lane-major states on `stream`, on the
// variant that n selects (three threads per state for n <= kSplitMaxStates,
// else one), and stores that variant in *split (1: three threads per
// state, 0: one), so that the caller counts what ran.  Allocates nothing
// and does not synchronise.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int p25_poseidon2_permute_soa(const int64_t* in_lo,
                                         const int64_t* in_hi,
                                         int64_t* out_lo, int64_t* out_hi,
                                         int64_t n, void* stream, int* split) {
  *split = n <= kSplitMaxStates;
  return launch(in_lo, in_hi, out_lo, out_hi, n, *split != 0, stream);
}

// A measurement hook, not part of the wrapper's contract: the variant
// named by `split` (1: three threads per state, 0: one), whatever n is,
// so that each variant can be held to the plain version and timed on both
// sides of the crossover.
extern "C" int p25_poseidon2_permute_soa_variant(
    const int64_t* in_lo, const int64_t* in_hi, int64_t* out_lo,
    int64_t* out_hi, int64_t n, int split, void* stream) {
  return launch(in_lo, in_hi, out_lo, out_hi, n, split != 0, stream);
}

// The largest launch that p25_poseidon2_permute_soa runs split.
extern "C" int64_t p25_poseidon2_soa_split_max_states() {
  return kSplitMaxStates;
}
