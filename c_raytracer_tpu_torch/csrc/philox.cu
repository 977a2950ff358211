// Philox4x32-10 uniform fill for Hopper (sm_90a).
//
// Replaces the TPU hardware-PRNG Pallas kernels of c_raytracer_tpu/core/rng.py
// (_hw_bits/_bits_kernel and _hw_bits_2d/kernel).  A counter-based generator
// needs no state between launches: element i of the output is word i % 4 of
// the Philox block i / 4, whose counter is (block lo, block hi, 0, 0) and whose
// key is the two words the host derives from (seed, sample path).  The float
// is the top 24 bits times 2^-24, the conversion of core/rng.py hw_uniform.
//
// Bound on the H100: device-memory writes (4 bytes out per element, no input);
// ten rounds of two 32x32 multiplies per 16 output bytes sit far below the
// ALU limit.  Each thread computes one whole block and stores its four floats
// as one 16-byte float4 store, so neighbouring threads write neighbouring
// 16-byte words.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x);
    const uint32_t lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z);
    const uint32_t lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_unit(uint32_t w) {
  return static_cast<float>(w >> 8) * 0x1p-24f;
}

__global__ void philox_uniform_kernel(float* __restrict__ out, int64_t n,
                                      uint32_t k0, uint32_t k1) {
  const int64_t n_blocks = (n + 3) / 4;
  for (int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       b < n_blocks; b += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32),
                   0u, 0u),
        k0, k1);
    const int64_t i = 4 * b;
    if (i + 3 < n) {
      reinterpret_cast<float4*>(out)[b] =
          make_float4(to_unit(w.x), to_unit(w.y), to_unit(w.z), to_unit(w.w));
    } else {
      const float f[4] = {to_unit(w.x), to_unit(w.y), to_unit(w.z),
                          to_unit(w.w)};
      for (int j = 0; i + j < n; ++j) out[i + j] = f[j];
    }
  }
}

}  // namespace

extern "C" int crt_philox_uniform(void* out, int64_t n, uint32_t k0,
                                  uint32_t k1, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t n_blocks = (n + 3) / 4;
    int64_t grid = (n_blocks + threads - 1) / threads;
    if (grid > 65535 * 32) grid = 65535 * 32;
    philox_uniform_kernel<<<static_cast<unsigned>(grid), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), n, k0, k1);
  }
  return static_cast<int>(cudaGetLastError());
}
