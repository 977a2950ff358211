// Fused soft-shadow chunk for Hopper (sm_90a).
//
// Replaces the Pallas kernel of c_raytracer_tpu/render/fused_shadow.py
// (_run/_kernel): one light-sample chunk of direct lighting for every pixel —
// sphere-emitter points from the pre-drawn uniforms u with the reference's
// direction flip, light direction and distance, the unrolled sphere and plane
// occlusion test that skips the emitter, none/lin/sqr attenuation, the diffuse
// cosine, Phong or Blinn specular through the C powf, the mask
// okf > 0 & !blocked & sample < n_valid, and the sum over the chunk's samples.
// The formula chain is that of the plain version,
// fused_shadow.fused_chunk_reference (the torch form of
// c_raytracer_tpu/render/shading.py _packed_sphere_chunk_ref).
//
// Layouts: u (2, lc, P), px (17, P), scal_f (8 + 5*ns + 5*npl), out (3, P),
// all float32 and contiguous.  px rows: hit point, normal, ray direction,
// texture colour, ks (3 each), shininess, okf.  scal_f: emitter centre,
// radius, intensity (3), attenuation offset, then [cx cy cz r eps] for each
// sphere and [nx ny nz d eps] for each plane.
//
// Bound on the H100: the ALU.  Per live sample a thread does 4 sin/cos, 2
// sqrt, 2 divisions, one powf (log + exp) and a handful of occluder tests,
// against 8 bytes of u read; nothing between the uniform draw and the (3, P)
// sums touches device memory.  The first design ran one thread per pixel over
// all lc samples: 65,536 threads, ~16 warps an SM, each warp a serial chain
// of 40 samples that nothing hid, so a chunk took as long with a tenth of its
// pixels live as with half.  This design splits each pixel's samples over
// the kSlices = 8 warps of a block (blockDim = (32, 8)): lane x of every
// warp holds pixel blockIdx.x * 32 + x, and warp y takes samples y, y + 8,
// ... (a warp's u loads stay 128 contiguous bytes).  The chain per thread is
// lc / 8 samples and the SMs hold 8 times the warps.
// The warps' partial sums meet in shared memory and warp 0 adds them in warp
// order, so the sum has a fixed order.  A block whose 32 pixels have no
// live sample (most blocks of a late round, where the chunk's time is that
// of its many dead blocks) reads only its okf row, writes zeros and
// leaves.  Any other block stages its 32 pixels' 17 rows and the scene
// scalars in shared memory once (one barrier), the
// shininess-only parts of powf (integral, odd) are computed once per pixel,
// and Phong/Blinn x none/lin/sqr are template parameters; ns, npl, egid and
// n_valid stay runtime ints.  Each block masks its own ragged edge, so P
// need not be a multiple of 32.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 10; PERF.md), on the dense stand-in's first-round
// chunk (lc = 40, P = 65,536): 0.032 ms, against 0.074 ms for one thread
// per pixel; a sweep of 1-16 warps a block found 4 and 8 tied and 16 slower.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// the launch's cudaError_t (0 means launched), or cudaErrorInvalidValue for
// an attenuation kind outside none/lin/sqr.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmitF = 8;
constexpr int kPxRows = 17;
constexpr int kLanes = 32;    // pixels per block: one per lane
constexpr int kSlices = 8;    // warps per block: the samples' split
constexpr float kPi2 = 2.0f * 3.1415927f;  // 2·PI in float32 (type.h:32)

__device__ __forceinline__ float where_nonzero_inv(float x) {
  return 1.0f / (x == 0.0f ? 1.0f : x);
}

__device__ __forceinline__ float safe_mag(float m2) {
  return m2 > 0.0f ? sqrtf(m2) : 0.0f;
}

// fmaxf(0, powf(base, e)) with C99 powf semantics (core/cmath.py c_powf,
// fmaxf_zero): 0^0 = 1, 0^pos = 0, 0^neg = inf; negative bases give a
// signed power for integral e and NaN otherwise; NaN clamps to 0.  is_int
// and is_odd depend on e alone, the pixel's shininess.
__device__ __forceinline__ float fmax0_powf(float b, float e, bool is_int,
                                            bool is_odd) {
  const bool is_zero = b == 0.0f;
  const float safe = is_zero ? 1.0f : fabsf(b);
  float mag = powf(safe, e);
  if (is_zero) mag = e > 0.0f ? 0.0f : (e == 0.0f ? 1.0f : INFINITY);
  const float signed_mag = is_odd ? -mag : mag;
  const float neg = is_int ? signed_mag : NAN;
  const float pw = b < 0.0f ? neg : mag;
  return pw > 0.0f ? pw : 0.0f;
}

// Dynamic shared memory: the scene scalars, the block's pixel rows, the
// warps' partial sums.
size_t smem_bytes(int n_scal) {
  return sizeof(float) *
         (static_cast<size_t>(n_scal) + kPxRows * kLanes + 3 * kSlices * kLanes);
}

template <bool kPhong, int kAtten>
__global__ void __launch_bounds__(kLanes * kSlices)
fused_shadow_kernel(const float* __restrict__ u,
                    const float* __restrict__ px,
                    const float* __restrict__ scal_g, float* __restrict__ out,
                    int P, int lc, int n_valid, int ns, int npl, int egid,
                    int n_scal) {
  extern __shared__ float smem[];
  float* scal = smem;                           // [n_scal]
  float* spx = scal + n_scal;                   // [17][32]
  float* part = spx + kPxRows * kLanes;         // [3][kSlices][32]
  constexpr int S = kSlices;
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int tid = slice * kLanes + lane;
  const int p0 = blockIdx.x * kLanes;
  const size_t sP = static_cast<size_t>(P);

  // a block with no live sample (most blocks of a late round) writes its
  // zeros and leaves before it stages anything
  const bool in_p = p0 + lane < P;
  const bool live = slice == 0 && in_p && min(lc, n_valid) > 0 &&
                    px[16 * sP + p0 + lane] > 0.0f;
  if (!__syncthreads_or(live)) {
    if (slice == 0 && in_p) {
      out[0 * sP + p0 + lane] = 0.0f;
      out[1 * sP + p0 + lane] = 0.0f;
      out[2 * sP + p0 + lane] = 0.0f;
    }
    return;
  }

  for (int i = tid; i < n_scal; i += kLanes * S) scal[i] = scal_g[i];
  for (int i = tid; i < kPxRows * kLanes; i += kLanes * S) {
    const int p = p0 + i % kLanes;
    spx[i] = p < P ? px[(i / kLanes) * sP + p] : 0.0f;  // okf 0 past P
  }
  __syncthreads();

  const float hx = spx[0 * kLanes + lane], hy = spx[1 * kLanes + lane],
              hz = spx[2 * kLanes + lane];
  const float nx = spx[3 * kLanes + lane], ny = spx[4 * kLanes + lane],
              nz = spx[5 * kLanes + lane];
  const float dx = spx[6 * kLanes + lane], dy = spx[7 * kLanes + lane],
              dz = spx[8 * kLanes + lane];
  const float tr = spx[9 * kLanes + lane], tg = spx[10 * kLanes + lane],
              tb = spx[11 * kLanes + lane];
  const float kr = spx[12 * kLanes + lane], kg = spx[13 * kLanes + lane],
              kb = spx[14 * kLanes + lane];
  const float shin = spx[15 * kLanes + lane];
  const bool okf = spx[16 * kLanes + lane] > 0.0f;
  const bool shin_int = shin == floorf(shin);
  const bool shin_odd = fmodf(fabsf(shin), 2.0f) == 1.0f;

  const float ecx = scal[0], ecy = scal[1], ecz = scal[2], erad = scal[3];
  const float ir = scal[4], ig = scal[5], ib = scal[6], off = scal[7];
  const float twx = ecx - hx, twy = ecy - hy, twz = ecz - hz;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  const int n_samples = okf ? min(lc, n_valid) : 0;
  const float* up = u + p0 + lane;
  for (int s = slice; s < n_samples; s += S) {
    const float u0 = up[static_cast<size_t>(s) * sP];
    const float u1 = up[static_cast<size_t>(lc + s) * sP];

    // sphere light point (object.c:293-304), shading._sphere_light_point_from_u
    const float inc = u0 * kPi2;
    const float azi = u1 * kPi2;
    const float si = sinf(inc), ci = cosf(inc);
    const float sa = sinf(azi), ca = cosf(azi);
    float l0x = erad * ca * si;
    float l0y = erad * sa * si;
    float l0z = erad * ci;
    if (twx * l0x + twy * l0y + twz * l0z != 0.0f) {
      l0x = -l0x;
      l0y = -l0y;
      l0z = -l0z;
    }
    const float lvx = (l0x + ecx) - hx;
    const float lvy = (l0y + ecy) - hy;
    const float lvz = (l0z + ecz) - hz;
    const float ldist = safe_mag(lvx * lvx + lvy * lvy + lvz * lvz);
    const float inv = where_nonzero_inv(ldist);
    const float lx = lvx * inv, ly = lvy * inv, lz = lvz * inv;

    // occlusion: every sphere but the emitter, then every plane
    bool blocked = false;
    for (int i = 0; i < ns && !blocked; ++i) {
      if (i == egid) continue;
      const float* sp = scal + kEmitF + 5 * i;
      const float rx = hx - sp[0], ry = hy - sp[1], rz = hz - sp[2];
      const float b = -(lx * rx + ly * ry + lz * rz);
      const float cc = (rx * rx + ry * ry + rz * rz) - sp[3] * sp[3];
      const float det = b * b - cc;
      const float sq = det > 0.0f ? sqrtf(det) : 0.0f;
      const float t_near = b - sq;
      const float t = t_near > sp[4] ? t_near : b + sq;
      blocked = det >= 0.0f && t > sp[4] && t < ldist;
    }
    for (int i = 0; i < npl && !blocked; ++i) {
      const float* pl = scal + kEmitF + 5 * ns + 5 * i;
      const float a = lx * pl[0] + ly * pl[1] + lz * pl[2];
      const bool parallel = fabsf(a) < pl[4];
      const float t =
          (pl[3] - (hx * pl[0] + hy * pl[1] + hz * pl[2])) / (parallel ? 1.0f : a);
      blocked = !parallel && t > pl[4] && t < ldist;
    }
    if (blocked) continue;

    // attenuation (render.c:191-200)
    float att = 1.0f;
    if (kAtten == 1) {
      att = 1.0f / (off + ldist);
    } else if (kAtten == 2) {
      att = 1.0f / (off + ldist * ldist);
    }
    const float in_r = ir * att, in_g = ig * att, in_b = ib * att;

    const float a = lx * nx + ly * ny + lz * nz;
    const float cos_d = a > 0.0f ? a : 0.0f;
    float spec_mul;
    if (kPhong) {
      const float rfx = nx * (2.0f * a) - lx;
      const float rfy = ny * (2.0f * a) - ly;
      const float rfz = nz * (2.0f * a) - lz;
      spec_mul = -(rfx * dx + rfy * dy + rfz * dz);
    } else {  // Blinn half vector (render.c:215-220)
      const float hvx = dx - lx, hvy = dy - ly, hvz = dz - lz;
      const float ih =
          where_nonzero_inv(safe_mag(hvx * hvx + hvy * hvy + hvz * hvz));
      spec_mul = -(nx * (hvx * ih) + ny * (hvy * ih) + nz * (hvz * ih));
    }
    const float spec_p = fmax0_powf(spec_mul, shin, shin_int, shin_odd);

    acc_r += tr * in_r * cos_d + kr * in_r * spec_p;
    acc_g += tg * in_g * cos_d + kg * in_g * spec_p;
    acc_b += tb * in_b * cos_d + kb * in_b * spec_p;
  }

  part[(0 * S + slice) * kLanes + lane] = acc_r;
  part[(1 * S + slice) * kLanes + lane] = acc_g;
  part[(2 * S + slice) * kLanes + lane] = acc_b;
  __syncthreads();
  if (slice == 0 && p0 + lane < P) {
    float r = 0.0f, g = 0.0f, b = 0.0f;
    for (int j = 0; j < S; ++j) {
      r += part[(0 * S + j) * kLanes + lane];
      g += part[(1 * S + j) * kLanes + lane];
      b += part[(2 * S + j) * kLanes + lane];
    }
    out[0 * sP + p0 + lane] = r;
    out[1 * sP + p0 + lane] = g;
    out[2 * sP + p0 + lane] = b;
  }
}

template <bool kPhong, int kAtten>
cudaError_t launch(const float* u, const float* px, const float* scal_f,
                   float* out, int P, int lc, int n_valid, int ns, int npl,
                   int egid, int n_scal, cudaStream_t stream) {
  auto* kernel = fused_shadow_kernel<kPhong, kAtten>;
  const size_t smem = smem_bytes(n_scal);
  if (smem > 48 * 1024) {  // a scene of many spheres and planes
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(P + kLanes - 1) / kLanes, dim3(kLanes, kSlices), smem, stream>>>(
      u, px, scal_f, out, P, lc, n_valid, ns, npl, egid, n_scal);
  return cudaGetLastError();
}

}  // namespace

// (u, px, scal_f, out, P, lc, n_valid, ns, npl, egid, phong, atten_kind,
//  n_scal, stream)
extern "C" int crt_fused_shadow_chunk(void* u, void* px, void* scal_f,
                                      void* out, int P, int lc, int n_valid,
                                      int ns, int npl, int egid, int phong,
                                      int atten_kind, int n_scal,
                                      void* stream) {
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  if (atten_kind < 0 || atten_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* fu = static_cast<const float*>(u);
  const auto* fp = static_cast<const float*>(px);
  const auto* fs = static_cast<const float*>(scal_f);
  auto* fo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  using Fn = cudaError_t (*)(const float*, const float*, const float*, float*,
                             int, int, int, int, int, int, int,
                             cudaStream_t);
  static constexpr Fn kLaunch[2][3] = {
      {launch<false, 0>, launch<false, 1>, launch<false, 2>},
      {launch<true, 0>, launch<true, 1>, launch<true, 2>}};
  return static_cast<int>(kLaunch[phong ? 1 : 0][atten_kind](
      fu, fp, fs, fo, P, lc, n_valid, ns, npl, egid, n_scal, s));
}
