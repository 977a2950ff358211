// Roofline probes for Hopper (sm_90a): measured ceilings of the operations
// the port's kernels spend their time on.
//
// The counterpart of tools/profiling/roofline.py, whose probes are XLA
// fusions of jnp chains.  In eager PyTorch a chain of K elementwise ops is K
// kernels that each stream device memory, so each probe here is one kernel
// that keeps its chain in registers:
//
//   * stream:  y = x * 0.5 + 0.25 over a large array (reads 4 bytes and
//              writes 4 bytes an element): device-memory bandwidth.  Each
//              thread moves one 16-byte float4.
//   * chain:   K dependent steps an element, in registers: fmaf(y, a, b)
//              (2 float operations a step), sinf(y), powf(y, 1.001) * 0.999,
//              or 2.25 / (y + 0.01).  Four independent chains a thread (one
//              float4) give each warp scheduler instruction-level parallelism
//              besides its resident warps; the loads and stores are
//              amortised over K steps.
//   * gather:  R random rows of a (rows, width) float32 table, one warp a
//              row: the lanes read the row as float4s and reduce its sum, and
//              lane 0 writes idx + int(sum * 0), so the next call depends on
//              this one, as in the JAX probe.  With ``sums`` it also stores
//              each row's sum, for the check against the plain version.
//
// The library is built with the port's flags (--fmad=false, no
// --use_fast_math): sinf and powf are the IEEE library forms and the
// division rounds correctly, the rates the port's kernels pay.  The FMA
// probe calls fmaf explicitly (one rounding a step); the other steps spell
// their roundings out with the _rn intrinsics.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): each entry
// point returns cudaGetLastError() after its launch; 0 means launched.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// JAX probes' constants (tools/profiling/roofline.py)
constexpr float kFmaA = 0.999999f;
constexpr float kFmaB = 1e-7f;
constexpr float kPowE = 1.001f;
constexpr float kPowM = 0.999f;
constexpr float kDivN = 2.25f;
constexpr float kDivD = 0.01f;

enum Op : int { kFma = 0, kSin = 1, kPow = 2, kDiv = 3 };

__global__ void stream_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int64_t n) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t e = 4 * i;
  if (e + 3 < n) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<float4*>(y)[i] = make_float4(
        __fadd_rn(__fmul_rn(v.x, 0.5f), 0.25f),
        __fadd_rn(__fmul_rn(v.y, 0.5f), 0.25f),
        __fadd_rn(__fmul_rn(v.z, 0.5f), 0.25f),
        __fadd_rn(__fmul_rn(v.w, 0.5f), 0.25f));
  } else {
    for (int64_t j = e; j < n; ++j)
      y[j] = __fadd_rn(__fmul_rn(x[j], 0.5f), 0.25f);
  }
}

template <int OP>
__device__ __forceinline__ float step(float v) {
  if (OP == kFma) return fmaf(v, kFmaA, kFmaB);
  if (OP == kSin) return sinf(v);
  if (OP == kPow) return __fmul_rn(powf(v, kPowE), kPowM);
  return __fdiv_rn(kDivN, __fadd_rn(v, kDivD));
}

template <int OP>
__global__ void chain_kernel(const float* __restrict__ x,
                             float* __restrict__ y, int64_t n, int k) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t e = 4 * i;
  if (e + 3 < n) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      v.x = step<OP>(v.x);
      v.y = step<OP>(v.y);
      v.z = step<OP>(v.z);
      v.w = step<OP>(v.w);
    }
    reinterpret_cast<float4*>(y)[i] = v;
  } else {
    for (int64_t j = e; j < n; ++j) {
      float v = x[j];
      for (int s = 0; s < k; ++s) v = step<OP>(v);
      y[j] = v;
    }
  }
}

__global__ void gather_kernel(const float* __restrict__ tbl,
                              const int32_t* __restrict__ idx_in,
                              int32_t* __restrict__ idx_out,
                              float* __restrict__ sums, int64_t r_total,
                              int width) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x) >> 5;
  if (r >= r_total) return;
  const int32_t row = idx_in[r];
  const float4* src = reinterpret_cast<const float4*>(
      tbl + static_cast<int64_t>(row) * width);
  float acc = 0.0f;
  for (int c = lane; c < width / 4; c += 32) {
    const float4 v = src[c];
    acc = __fadd_rn(acc, __fadd_rn(__fadd_rn(v.x, v.y),
                                   __fadd_rn(v.z, v.w)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) {
    idx_out[r] = row + __float2int_rz(__fmul_rn(acc, 0.0f));
    if (sums != nullptr) sums[r] = acc;
  }
}

unsigned blocks_for(int64_t work) {
  return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int crt_roofline_stream(const void* x, void* y, int64_t n,
                                   void* stream) {
  if (n > 0) {
    stream_kernel<<<blocks_for((n + 3) / 4), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// op: 0 fmaf, 1 sinf, 2 powf, 3 division (see Op); k steps an element
extern "C" int crt_roofline_chain(const void* x, void* y, int64_t n, int k,
                                  int op, void* stream) {
  if (n > 0) {
    const unsigned grid = blocks_for((n + 3) / 4);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    switch (op) {
      case kFma: chain_kernel<kFma><<<grid, kThreads, 0, s>>>(xi, yo, n, k);
        break;
      case kSin: chain_kernel<kSin><<<grid, kThreads, 0, s>>>(xi, yo, n, k);
        break;
      case kPow: chain_kernel<kPow><<<grid, kThreads, 0, s>>>(xi, yo, n, k);
        break;
      case kDiv: chain_kernel<kDiv><<<grid, kThreads, 0, s>>>(xi, yo, n, k);
        break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// width must be a multiple of 4 and the table 16-byte aligned; sums may be
// NULL
extern "C" int crt_roofline_gather(const void* tbl, const void* idx_in,
                                   void* idx_out, void* sums, int64_t r,
                                   int width, void* stream) {
  if (r > 0) {
    gather_kernel<<<blocks_for(32 * r), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tbl), static_cast<const int32_t*>(idx_in),
        static_cast<int32_t*>(idx_out), static_cast<float*>(sums), r, width);
  }
  return static_cast<int>(cudaGetLastError());
}
