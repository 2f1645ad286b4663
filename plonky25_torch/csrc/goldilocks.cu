// Goldilocks (p = 2^64 - 2^32 + 1) and GF(p^2) = GF(p)[X]/(X^2 - 7) add,
// sub and mul on the port's int64 limb tensors: one launch per field op.
//
// Replaces no TPU kernel: the JAX package leaves its limb arithmetic
// (plonky25_tpu/fields/goldilocks.py, extension.py) to XLA, which fuses the
// chain of limb ops into one loop.  PyTorch runs the same chain
// (plonky25_torch/fields/goldilocks.py) as 12 to 280 elementwise kernels,
// each reading and writing whole int64 tensors.  These kernels take their
// place on CUDA tensors; the limb chains stay as the CPU implementation,
// and the kernels are held bit-equal to them.
// Python side: plonky25_torch/ops/goldilocks.py (plan and launch), called
// by fields/goldilocks.py (gl_add, gl_sub, gl_mul) and fields/extension.py
// (gl2_add, gl2_sub, gl2_mul, gl2_mul_base).
//
// What bounds them on an H100: bytes.  An element is two int64 limbs (16
// B); a GL mul reads two elements and writes one, 48 B, for about 30
// integer instructions, and a GF(p^2) mul 96 B for about 120.  At 3.35 TB/s
// and about 14 T integer instructions/s the card needs some 200 integer
// instructions an element before issue binds, so every op here is bound
// by device memory, and a small launch by its latency.
//
// What the design does about it: each thread reads its operands' lo/hi
// limbs once, forms the 64-bit values, computes in registers (64-bit
// products with __umul64hi, reduction with 2^64 = 2^32 - 1 and 2^96 = -1
// mod p) and writes canonical limbs once.  The outputs are fresh
// contiguous tensors, written at the flat index: coalesced.  The inputs
// are read through the strides the launcher passes, 0 on a broadcast axis,
// so broadcast constants, expanded zeros and transposed views are read as
// they are, without a copy; adjacent axes that every operand spans densely
// are merged by the launcher first, so the common case is rank 1 and the
// index arithmetic vanishes.  Grid-stride loops over a grid of at most
// kBlocksPerSm blocks of kThreads per SM.
//
// Every input value is taken canonical (in [0, p)), as every op of the
// port returns; mul reduces any 64-bit inputs exactly, as the limb chain
// does.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -shared
// (plonky25_torch/ops/build.py); plain C interface, loaded with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 0xFFFFFFFF00000001ull;
constexpr uint64_t kEps = 0xFFFFFFFFull;  // 2^64 mod p
constexpr uint64_t kW = 7;                // X^2 = 7 in GF(p^2)
constexpr int kMaxRank = 6;
constexpr int kMaxIn = 8;
constexpr int kMaxOut = 4;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

// ---------------------------------------------------------------- field

__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= kP ? x - kP : x;
}

// a, b < p.  A carry out of 64 bits leaves a + b - 2^64 + eps = a + b - p,
// below p.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s < a ? s + kEps : canonical(s);
}

// a, b < p.  A borrow leaves a - b + 2^64 - eps = a - b + p, in (0, p).
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - kEps : d;
}

// x = hi * 2^64 + lo = lo + (hi mod 2^32) * 2^64 + (hi >> 32) * 2^96
//   = lo + (hi mod 2^32) * eps - (hi >> 32)  (mod p), canonical.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & kEps;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= kEps;            // borrow: + 2^64 - eps; no underflow
  const uint64_t t1 = hi_lo * kEps;      // < 2^64 - 2^33 + 2
  uint64_t t2 = t0 + t1;
  if (t2 < t1) t2 += kEps;               // carry: + eps; no overflow
  return canonical(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// ---------------------------------------------------------------- ops
// Each op reads kIn limb tensors (lo, hi of each operand, in order) and
// writes kOut; apply() maps the operands' values to the outputs' values.

struct GlAdd {
  static constexpr int kIn = 4, kOut = 2;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = add(x[0], x[1]);
  }
};

struct GlSub {
  static constexpr int kIn = 4, kOut = 2;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = sub(x[0], x[1]);
  }
};

struct GlMul {
  static constexpr int kIn = 4, kOut = 2;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = mul(x[0], x[1]);
  }
};

// GF(p^2) operands: x = (a0, a1, b0, b1).
struct Gl2Add {
  static constexpr int kIn = 8, kOut = 4;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = add(x[0], x[2]);
    y[1] = add(x[1], x[3]);
  }
};

struct Gl2Sub {
  static constexpr int kIn = 8, kOut = 4;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = sub(x[0], x[2]);
    y[1] = sub(x[1], x[3]);
  }
};

// (a0 + a1 X)(b0 + b1 X) = (a0 b0 + 7 a1 b1) + (a0 b1 + a1 b0) X
struct Gl2Mul {
  static constexpr int kIn = 8, kOut = 4;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = add(mul(x[0], x[2]), mul(mul(x[1], x[3]), kW));
    y[1] = add(mul(x[0], x[3]), mul(x[1], x[2]));
  }
};

// GF(p^2) times GF(p): x = (a0, a1, b).
struct Gl2MulBase {
  static constexpr int kIn = 6, kOut = 4;
  __device__ static void apply(const uint64_t* x, uint64_t* y) {
    y[0] = mul(x[0], x[2]);
    y[1] = mul(x[1], x[2]);
  }
};

// ---------------------------------------------------------------- kernels

// The broadcast shape (outermost axis first, right-aligned into kMaxRank
// slots: a kernel of rank R reads the last R) and each input's element
// strides over it; outputs contiguous in that shape.
struct Operands {
  const int64_t* in[kMaxIn];
  int64_t* out[kMaxOut];
  int64_t stride[kMaxIn][kMaxRank];
  int64_t shape[kMaxRank];
  int64_t n;
};

// A limb through the read-only data cache.
__device__ __forceinline__ uint64_t load(const int64_t* p) {
  return static_cast<uint64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

template <class Op, int R, typename I>
__device__ __forceinline__ void run(const Operands& o) {
  constexpr int kVals = Op::kIn / 2;
  constexpr int kOutVals = Op::kOut / 2;
  constexpr int kLead = kMaxRank - R;
  const I n = static_cast<I>(o.n);
  const I step = static_cast<I>(gridDim.x) * kThreads;
  for (I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += step) {
    int64_t off[Op::kIn];
    I rest = i;
#pragma unroll
    for (int k = 0; k < Op::kIn; ++k) off[k] = 0;
#pragma unroll
    for (int d = kMaxRank - 1; d > kLead; --d) {
      const I size = static_cast<I>(o.shape[d]);
      const I c = rest % size;
      rest /= size;
#pragma unroll
      for (int k = 0; k < Op::kIn; ++k)
        off[k] += static_cast<int64_t>(c) * o.stride[k][d];
    }
#pragma unroll
    for (int k = 0; k < Op::kIn; ++k)
      off[k] += static_cast<int64_t>(rest) * o.stride[k][kLead];
    uint64_t x[kVals];
#pragma unroll
    for (int v = 0; v < kVals; ++v)
      x[v] = load(o.in[2 * v] + off[2 * v]) |
             (load(o.in[2 * v + 1] + off[2 * v + 1]) << 32);
    uint64_t y[kOutVals];
    Op::apply(x, y);
#pragma unroll
    for (int v = 0; v < kOutVals; ++v) {
      o.out[2 * v][i] = static_cast<int64_t>(y[v] & kEps);
      o.out[2 * v + 1][i] = static_cast<int64_t>(y[v] >> 32);
    }
  }
}

// One __global__ per op, named after it (the profiler's rows read
// gl_mul_kernel<...>, gl2_mul_kernel<...>); R is the rank after the
// launcher merged axes, I the index type (32-bit below 2^31 elements).
#define P25_FIELD_KERNEL(name, Op)                                   \
  template <int R, typename I>                                       \
  __global__ void __launch_bounds__(kThreads) name(Operands o) {     \
    run<Op, R, I>(o);                                                \
  }

P25_FIELD_KERNEL(gl_add_kernel, GlAdd)
P25_FIELD_KERNEL(gl_sub_kernel, GlSub)
P25_FIELD_KERNEL(gl_mul_kernel, GlMul)
P25_FIELD_KERNEL(gl2_add_kernel, Gl2Add)
P25_FIELD_KERNEL(gl2_sub_kernel, Gl2Sub)
P25_FIELD_KERNEL(gl2_mul_kernel, Gl2Mul)
P25_FIELD_KERNEL(gl2_mul_base_kernel, Gl2MulBase)

#undef P25_FIELD_KERNEL

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

using Kernel = void (*)(Operands);

// args: rank r (1..kMaxRank), n (> 0), device, shape[r], the kIn input
// pointers, their strides (kIn x r, row by row), the kOut output pointers.
template <int kIn, int kOut>
int launch(const int64_t* args, cudaStream_t stream, const Kernel* by_rank,
           Kernel wide) {
  const int rank = static_cast<int>(args[0]);
  const int64_t n = args[1];
  const int device = static_cast<int>(args[2]);
  if (rank < 1 || rank > kMaxRank || n <= 0) return cudaErrorInvalidValue;
  const int64_t* shape = args + 3;
  const int64_t* in = shape + rank;
  const int64_t* stride = in + kIn;
  const int64_t* out = stride + kIn * rank;
  Operands o{};
  for (int d = 0; d < kMaxRank; ++d) o.shape[d] = 1;
  const int lead = kMaxRank - rank;
  for (int d = 0; d < rank; ++d) o.shape[lead + d] = shape[d];
  for (int k = 0; k < kIn; ++k) {
    o.in[k] = reinterpret_cast<const int64_t*>(in[k]);
    for (int d = 0; d < rank; ++d) o.stride[k][lead + d] = stride[k * rank + d];
  }
  for (int k = 0; k < kOut; ++k) o.out[k] = reinterpret_cast<int64_t*>(out[k]);
  o.n = n;

  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const int64_t cap = static_cast<int64_t>(sm_count(device)) * kBlocksPerSm;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  // rank-R kernels for R <= 4 and below 2^31 elements; the rank-kMaxRank
  // one above 4, and the 64-bit-index one above 2^31 elements
  Kernel k = n < (int64_t{1} << 31) ? by_rank[rank <= 4 ? rank : 0] : wide;
  k<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(o);
  const cudaError_t err = cudaGetLastError();
  if (current != device && current >= 0) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

#define P25_FIELD_ENTRY(entry, kernel, Op)                                    \
  extern "C" int entry(const int64_t* args, void* stream) {                   \
    static const Kernel by_rank[5] = {                                        \
        kernel<kMaxRank, uint32_t>, kernel<1, uint32_t>, kernel<2, uint32_t>, \
        kernel<3, uint32_t>, kernel<4, uint32_t>};                            \
    return launch<Op::kIn, Op::kOut>(args,                                    \
                                     static_cast<cudaStream_t>(stream),       \
                                     by_rank, kernel<kMaxRank, uint64_t>);    \
  }

P25_FIELD_ENTRY(gl_add, gl_add_kernel, GlAdd)
P25_FIELD_ENTRY(gl_sub, gl_sub_kernel, GlSub)
P25_FIELD_ENTRY(gl_mul, gl_mul_kernel, GlMul)
P25_FIELD_ENTRY(gl2_add, gl2_add_kernel, Gl2Add)
P25_FIELD_ENTRY(gl2_sub, gl2_sub_kernel, Gl2Sub)
P25_FIELD_ENTRY(gl2_mul, gl2_mul_kernel, Gl2Mul)
P25_FIELD_ENTRY(gl2_mul_base, gl2_mul_base_kernel, Gl2MulBase)

#undef P25_FIELD_ENTRY

// The largest rank a launch takes after the launcher merged axes.
extern "C" int64_t gl_max_rank() { return kMaxRank; }
