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
// Bound on the H100: the ALU.  Per sample a thread does 4 sin/cos, 2 sqrt,
// 2 divisions, one powf (log + exp) and a handful of occluder tests, against
// 8 bytes of u read; the pixel's 17 inputs and its 3 running sums stay in
// registers for the whole chunk, so nothing between the uniform draw and the
// (3, P) sums touches device memory.  The design: one thread per pixel, a loop
// over the lc samples (a thread owns its sums, so no atomics and no second
// pass), the scene scalars staged once per block in shared memory where every
// thread reads the same word (a broadcast), and u read as
// u[s * P + p] so a warp's loads are 128 contiguous bytes.  ns, npl, egid,
// phong, atten_kind and n_valid are runtime ints; each block masks its own
// ragged edge, so P need not be a multiple of the block.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmitF = 8;
constexpr float kPi2 = 2.0f * 3.1415927f;  // 2·PI in float32 (type.h:32)

__device__ __forceinline__ float where_nonzero_inv(float x) {
  return 1.0f / (x == 0.0f ? 1.0f : x);
}

__device__ __forceinline__ float safe_mag(float m2) {
  return m2 > 0.0f ? sqrtf(m2) : 0.0f;
}

// fmaxf(0, powf(base, e)) with C99 powf semantics (core/cmath.py c_powf,
// fmaxf_zero): 0^0 = 1, 0^pos = 0, 0^neg = inf; negative bases give a
// signed power for integral e and NaN otherwise; NaN clamps to 0.
__device__ __forceinline__ float fmax0_powf(float b, float e) {
  const bool is_zero = b == 0.0f;
  const float safe = is_zero ? 1.0f : fabsf(b);
  float mag = powf(safe, e);
  if (is_zero) mag = e > 0.0f ? 0.0f : (e == 0.0f ? 1.0f : INFINITY);
  const bool is_int = e == floorf(e);
  const bool is_odd = fmodf(fabsf(e), 2.0f) == 1.0f;
  const float signed_mag = is_odd ? -mag : mag;
  const float neg = is_int ? signed_mag : NAN;
  const float pw = b < 0.0f ? neg : mag;
  return pw > 0.0f ? pw : 0.0f;
}

__global__ void fused_shadow_kernel(
    const float* __restrict__ u, const float* __restrict__ px,
    const float* __restrict__ scal_g, float* __restrict__ out, int P, int lc,
    int n_valid, int ns, int npl, int egid, int phong, int atten_kind,
    int n_scal) {
  extern __shared__ float scal[];
  for (int i = threadIdx.x; i < n_scal; i += blockDim.x) scal[i] = scal_g[i];
  __syncthreads();

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t sP = static_cast<size_t>(P);

  const float hx = px[0 * sP + p], hy = px[1 * sP + p], hz = px[2 * sP + p];
  const float nx = px[3 * sP + p], ny = px[4 * sP + p], nz = px[5 * sP + p];
  const float dx = px[6 * sP + p], dy = px[7 * sP + p], dz = px[8 * sP + p];
  const float tr = px[9 * sP + p], tg = px[10 * sP + p], tb = px[11 * sP + p];
  const float kr = px[12 * sP + p], kg = px[13 * sP + p], kb = px[14 * sP + p];
  const float shin = px[15 * sP + p];
  const bool okf = px[16 * sP + p] > 0.0f;

  const float ecx = scal[0], ecy = scal[1], ecz = scal[2], erad = scal[3];
  const float ir = scal[4], ig = scal[5], ib = scal[6], off = scal[7];
  const float twx = ecx - hx, twy = ecy - hy, twz = ecz - hz;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  const int n_lanes = okf ? min(lc, n_valid) : 0;
  for (int s = 0; s < n_lanes; ++s) {
    const float u0 = u[static_cast<size_t>(s) * sP + p];
    const float u1 = u[static_cast<size_t>(lc + s) * sP + p];

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
    if (atten_kind == 1) {
      att = 1.0f / (off + ldist);
    } else if (atten_kind == 2) {
      att = 1.0f / (off + ldist * ldist);
    }
    const float in_r = ir * att, in_g = ig * att, in_b = ib * att;

    const float a = lx * nx + ly * ny + lz * nz;
    const float cos_d = a > 0.0f ? a : 0.0f;
    float spec_mul;
    if (phong) {
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
    const float spec_p = fmax0_powf(spec_mul, shin);

    acc_r += tr * in_r * cos_d + kr * in_r * spec_p;
    acc_g += tg * in_g * cos_d + kg * in_g * spec_p;
    acc_b += tb * in_b * cos_d + kb * in_b * spec_p;
  }
  out[0 * sP + p] = acc_r;
  out[1 * sP + p] = acc_g;
  out[2 * sP + p] = acc_b;
}

}  // namespace

extern "C" int crt_fused_shadow_chunk(void* u, void* px, void* scal_f,
                                      void* out, int P, int lc, int n_valid,
                                      int ns, int npl, int egid, int phong,
                                      int atten_kind, int n_scal,
                                      void* stream) {
  if (P > 0) {
    const int threads = 128;
    const int grid = (P + threads - 1) / threads;
    fused_shadow_kernel<<<grid, threads, n_scal * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(px),
        static_cast<const float*>(scal_f), static_cast<float*>(out), P, lc,
        n_valid, ns, npl, egid, phong, atten_kind, n_scal);
  }
  return static_cast<int>(cudaGetLastError());
}
