// Union shadow sweep for Hopper (sm_90a): the visit loop of a shared-origin
// soft-shadow query, every visit of every pixel in one launch.
//
// Replaces no TPU kernel.  The JAX package runs this loop as XLA ops
// (c_raytracer_tpu/accel/traverse.py any_hit_tint_shared); on the card its
// eager form, accel/union_sweep.py union_visits_reference, issued ~89
// small launches per visit step (~59% of a 32x32 glass frame's launches),
// and the card sat idle between them.  This kernel computes the same loop:
// for each pixel p and each visit slot v < n_steps with ok[p, v], the
// cluster cids[p, v] of the packed table blk (K, F, C) is tested against
// every light sample s of the pixel (Moller-Trumbore from the shared origin
// o[p] along d[p, s]), as traverse._mt_block_multi does:
//   s = o - v0;  q = s x e1;  tnum = e2 . q           (once a triangle)
//   h = d x e2;  a = e1 . h;  parallel = a < eps && a > -eps
//   f = 1 / (parallel ? 1 : a);  u = f (s . h);  w = f (d . q);  t = f tnum
//   hit = !parallel && u >= 0 && u <= 1 && w >= 0 && u + w <= 1 && t > eps
// and a lane is in range when hit && t < md[p, s] && gid != ex[p, s], gid
// = gid0 + cid * C + lane.  The fold is traverse._fold_blockers': an opaque
// lane (an opaque pack, F = 13, or transparency row 16 <= 0) sets the
// sample's blocked, a transparent lane adds one to the count of its slot
// (slot[cid * C + lane], when in [0, n_slots)).  Outputs: blocked_out =
// blocked_in | blocked, counts_out = counts_in + counts, narrowed to int16
// once (modulo 2^16, as the plain loop's int16 sums wrap).  Every float
// operation rounds once in the plain version's order (the library is built
// with --fmad=false and IEEE division), so blocked and counts are bit-equal
// to the plain loop.  No sample stops early: the counts go on after a
// sample is blocked, as in the plain loop.
//
// Bound on the H100: float operations.  A visit costs a pixel C * S tests
// of ~40 float operations and one IEEE division each, against F * C * 4
// bytes of cluster rows that every sample shares (17 * 64 * 4 = 4,352 B on
// the glass stand-in: ~0.7 operations a byte per sample).  The design keeps
// everything a test needs on chip.  A block of 256 threads takes one pixel;
// its threads cover NS samples (the power of two >= S, 32..256, in passes
// of 256 above that) times G = 256 / NS triangle groups, so every thread
// has work at small S.  Thread (g, s) tests triangles g, g + G, ... of
// each visited cluster against sample s.  The cluster's rows are staged in
// shared memory by cp.async, two buffers deep: the next live slot's rows
// load while this one's are tested.  The S-independent terms (s, q, tnum)
// are computed once per (pixel, triangle) into a 16-float row per
// triangle, which the warps read as shared-memory broadcasts (every lane
// of a warp reads the same triangle).  blocked and the per-slot counts
// live in registers across every visit (kSlots, the compiled slot count,
// is a template parameter: 0 for an opaque pack, else 1, 2, 4, 8 or 16);
// the groups' partial results meet in shared memory once at the end and
// each output is written once.
//
// Layouts (all contiguous): origin (P, 3), d (P, S, 3), md (P, S) float32;
// cids (P, V) int64, ok (P, V) bool; ex (P, S) int64; blk (K, F, C) float32;
// slot (K * C) int64 or NULL for an opaque pack; blocked (P, S) bool;
// counts (P, S, n_slots) int16 or NULL when n_slots is 0.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// the launch's cudaError_t (0 means launched), or cudaErrorInvalidValue for
// F other than 13 or 17, C < 1, or n_slots outside 0..kMaxSlots.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a block: one pixel
constexpr int kMaxSlots = 16;   // transparent slots of the largest build
constexpr int kDer = 16;        // floats of a triangle's derived row
// packed field rows of ClusterSet.blk (accel/traverse.py)
constexpr int kV0 = 0, kE1 = 3, kE2 = 6, kEps = 12, kTransp = 16;
constexpr int kOpaqueF = 13, kTranspF = 17;
// a derived row's lane kind: an opaque lane blocks; a transparent lane
// counts in its slot (>= 0), or nowhere when its slot is not listed
constexpr int kOpaque = -1, kNoSlot = -2;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The block's shared memory: two staging buffers of F * C floats and of C
// slots, the C derived rows, the groups' partial sums.
struct Layout {
  size_t stage, slots, der, red, total;
  __host__ __device__ Layout(int F, int C, int k_slots) {
    stage = align16(sizeof(float) * F * C);
    slots = align16(sizeof(int64_t) * C);
    der = sizeof(float) * kDer * C;
    red = sizeof(int) * kThreads * (1 + k_slots);
    total = 2 * stage + 2 * slots + der + red;
  }
};

// The first slot from v on with ok set; n when none is left.
__device__ __forceinline__ int next_live(const bool* ok_row, int v, int n) {
  while (v < n && !ok_row[v]) ++v;
  return v;
}

// Start copying cluster cid's rows (and its lanes' slots) into a buffer.
__device__ __forceinline__ void stage(float* dst, int64_t* dst_slot,
                                      const float* blk, const int64_t* slot,
                                      int64_t cid, int F, int C, bool vec16) {
  const float* src = blk + cid * F * C;
  const int n = F * C;
  if (vec16) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      __pipeline_memcpy_async(dst + i, src + i, 4);
    }
  }
  if (slot != nullptr) {
    for (int i = threadIdx.x; i < C; i += kThreads) {
      __pipeline_memcpy_async(dst_slot + i, slot + cid * C + i, 8);
    }
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads) union_sweep_kernel(
    const float* __restrict__ origin, const int64_t* __restrict__ cids,
    const bool* __restrict__ ok, const float* __restrict__ d,
    const float* __restrict__ md, const int64_t* __restrict__ ex,
    const float* __restrict__ blk, const int64_t* __restrict__ slot,
    const bool* __restrict__ blocked_in,
    const int16_t* __restrict__ counts_in, bool* __restrict__ blocked_out,
    int16_t* __restrict__ counts_out, int V, int n_steps, int S, int F,
    int C, int gid0, int n_slots, bool vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(F, C, kSlots);
  // buffer b of the rows and of the slots: b * stage and b * slots on
  auto rows = [&](int b) {
    return reinterpret_cast<float*>(smem + b * lay.stage);
  };
  auto slots = [&](int b) {
    return reinterpret_cast<int64_t*>(smem + 2 * lay.stage + b * lay.slots);
  };
  float4* der = reinterpret_cast<float4*>(smem + 2 * lay.stage
                                          + 2 * lay.slots);
  int* red = reinterpret_cast<int*>(smem + 2 * lay.stage + 2 * lay.slots
                                    + lay.der);

  const int64_t p = blockIdx.x;
  const int tid = threadIdx.x;
  int NS = 32;
  while (NS < S && NS < kThreads) NS *= 2;
  const int G = kThreads / NS;          // triangle groups
  const int grp = tid / NS;
  const int lane_s = tid % NS;
  const float ox = origin[3 * p], oy = origin[3 * p + 1],
              oz = origin[3 * p + 2];
  const bool* ok_row = ok + p * V;
  const int64_t* cid_row = cids + p * V;
  const bool transp_pack = F == kTranspF;
  const int64_t* lane_slot = transp_pack ? slot : nullptr;

  for (int s0 = 0; s0 < S; s0 += NS) {
    const int s = s0 + lane_s;
    const bool mine = s < S;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f, mdist = 0.0f;
    int64_t exg = 0;
    if (mine) {
      const int64_t ps = p * S + s;
      dx = d[3 * ps];
      dy = d[3 * ps + 1];
      dz = d[3 * ps + 2];
      mdist = md[ps];
      exg = ex[ps];
    }
    bool blocked = false;
    int cnt[kSlots > 0 ? kSlots : 1];
#pragma unroll
    for (int m = 0; m < (kSlots > 0 ? kSlots : 1); ++m) cnt[m] = 0;

    int v = next_live(ok_row, 0, n_steps);
    if (v < n_steps) {
      stage(rows(0), slots(0), blk, lane_slot, cid_row[v], F, C, vec16);
    }
    __pipeline_commit();
    int b = 0;
    while (v < n_steps) {
      const int64_t cid = cid_row[v];
      const int nv = next_live(ok_row, v + 1, n_steps);
      if (nv < n_steps) {
        stage(rows(b ^ 1), slots(b ^ 1), blk, lane_slot, cid_row[nv], F, C,
              vec16);
      }
      __pipeline_commit();
      __pipeline_wait_prior(1);   // this slot's rows have landed
      __syncthreads();
      // the S-independent terms, once per triangle
      for (int c = tid; c < C; c += kThreads) {
        const float* r = rows(b);
        const float v0x = r[(kV0 + 0) * C + c], v0y = r[(kV0 + 1) * C + c],
                    v0z = r[(kV0 + 2) * C + c];
        const float e1x = r[(kE1 + 0) * C + c], e1y = r[(kE1 + 1) * C + c],
                    e1z = r[(kE1 + 2) * C + c];
        const float e2x = r[(kE2 + 0) * C + c], e2y = r[(kE2 + 1) * C + c],
                    e2z = r[(kE2 + 2) * C + c];
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float tnum = e2x * qx + e2y * qy + e2z * qz;
        int kind = kOpaque;
        if (transp_pack && r[kTransp * C + c] > 0.0f) {
          const int64_t m = slots(b)[c];
          kind = (m >= 0 && m < n_slots) ? static_cast<int>(m) : kNoSlot;
        }
        der[4 * c + 0] = make_float4(e1x, e1y, e1z, e2x);
        der[4 * c + 1] = make_float4(e2y, e2z, r[kEps * C + c], tnum);
        der[4 * c + 2] = make_float4(sx, sy, sz, qx);
        der[4 * c + 3] = make_float4(qy, qz, __int_as_float(kind), 0.0f);
      }
      __syncthreads();
      if (mine) {
        // the sample's excluded lane in this cluster, -1 for none
        const int64_t rel = exg - (gid0 + cid * C);
        const int ex_lane = (rel >= 0 && rel < C) ? static_cast<int>(rel)
                                                  : -1;
        for (int c = grp; c < C; c += G) {
          const float4 r0 = der[4 * c + 0], r1 = der[4 * c + 1],
                       r2 = der[4 * c + 2], r3 = der[4 * c + 3];
          const float e1x = r0.x, e1y = r0.y, e1z = r0.z, e2x = r0.w;
          const float e2y = r1.x, e2z = r1.y, eps = r1.z, tnum = r1.w;
          const float sx = r2.x, sy = r2.y, sz = r2.z, qx = r2.w;
          const float qy = r3.x, qz = r3.y;
          const float hx = dy * e2z - dz * e2y;
          const float hy = dz * e2x - dx * e2z;
          const float hz = dx * e2y - dy * e2x;
          const float a = e1x * hx + e1y * hy + e1z * hz;
          const bool parallel = (a < eps) && (a > -eps);
          const float f = 1.0f / (parallel ? 1.0f : a);
          const float u = f * (sx * hx + sy * hy + sz * hz);
          const float w = f * (dx * qx + dy * qy + dz * qz);
          const float t = f * tnum;
          const bool hit = !parallel && u >= 0.0f && u <= 1.0f
                           && w >= 0.0f && u + w <= 1.0f && t > eps;
          if (hit && t < mdist && c != ex_lane) {
            const int kind = __float_as_int(r3.z);
            if (kind == kOpaque) {
              blocked = true;
            } else {
#pragma unroll
              for (int m = 0; m < kSlots; ++m) cnt[m] += kind == m;
            }
          }
        }
      }
      b ^= 1;
      v = nv;
    }

    // the groups' partial results, summed by group 0
    if (G > 1) {
      if (grp > 0) {
        red[tid] = blocked;
#pragma unroll
        for (int m = 0; m < kSlots; ++m) red[(1 + m) * kThreads + tid] =
            cnt[m];
      }
      __syncthreads();
      if (grp == 0) {
        for (int g = 1; g < G; ++g) {
          const int i = g * NS + lane_s;
          blocked = blocked || red[i] != 0;
#pragma unroll
          for (int m = 0; m < kSlots; ++m) cnt[m] += red[(1 + m) * kThreads
                                                         + i];
        }
      }
      __syncthreads();   // red is free for the next pass
    }
    if (grp == 0 && mine) {
      const int64_t ps = p * S + s;
      blocked_out[ps] = blocked_in[ps] || blocked;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (m < n_slots) {
          const int64_t i = ps * n_slots + m;
          counts_out[i] = static_cast<int16_t>(
              static_cast<int>(counts_in[i]) + cnt[m]);
        }
      }
    }
  }
}

template <int kSlots>
cudaError_t launch(const float* origin, const int64_t* cids, const bool* ok,
                   const float* d, const float* md, const int64_t* ex,
                   const float* blk, const int64_t* slot,
                   const bool* blocked_in, const int16_t* counts_in,
                   bool* blocked_out, int16_t* counts_out, int P, int V,
                   int n_steps, int S, int F, int C, int gid0, int n_slots,
                   cudaStream_t stream) {
  auto* kernel = union_sweep_kernel<kSlots>;
  const size_t smem = Layout(F, C, kSlots).total;
  if (smem > 48 * 1024) {  // clusters of more than ~128 triangles
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec16 = (F * C) % 4 == 0
                     && reinterpret_cast<uintptr_t>(blk) % 16 == 0;
  kernel<<<P, kThreads, smem, stream>>>(
      origin, cids, ok, d, md, ex, blk, slot, blocked_in, counts_in,
      blocked_out, counts_out, V, n_steps, S, F, C, gid0, n_slots, vec16);
  return cudaGetLastError();
}

}  // namespace

// (origin, cids, ok, d, md, ex, blk, slot or NULL, blocked_in,
//  counts_in or NULL, blocked_out, counts_out or NULL, P, V, n_steps, S, F,
//  C, gid0, n_slots, stream)
extern "C" int crt_union_sweep(void* origin, void* cids, void* ok, void* d,
                               void* md, void* ex, void* blk, void* slot,
                               void* blocked_in, void* counts_in,
                               void* blocked_out, void* counts_out, int P,
                               int V, int n_steps, int S, int F, int C,
                               int gid0, int n_slots, void* stream) {
  if (P <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if ((F != kOpaqueF && F != kTranspF) || C < 1 || n_slots < 0
      || n_slots > kMaxSlots || (F == kOpaqueF && n_slots != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Fn = cudaError_t (*)(const float*, const int64_t*, const bool*,
                             const float*, const float*, const int64_t*,
                             const float*, const int64_t*, const bool*,
                             const int16_t*, bool*, int16_t*, int, int, int,
                             int, int, int, int, int, cudaStream_t);
  // the build of the fewest compiled slots that holds n_slots
  static constexpr Fn kLaunch[] = {launch<0>, launch<1>, launch<2>,
                                   launch<4>, launch<8>, launch<16>};
  int k = 0;
  while ((k == 0 ? 0 : 1 << (k - 1)) < n_slots) ++k;
  return static_cast<int>(kLaunch[k](
      static_cast<const float*>(origin), static_cast<const int64_t*>(cids),
      static_cast<const bool*>(ok), static_cast<const float*>(d),
      static_cast<const float*>(md), static_cast<const int64_t*>(ex),
      static_cast<const float*>(blk), static_cast<const int64_t*>(slot),
      static_cast<const bool*>(blocked_in),
      static_cast<const int16_t*>(counts_in),
      static_cast<bool*>(blocked_out), static_cast<int16_t*>(counts_out), P,
      V, n_steps, S, F, C, gid0, n_slots, static_cast<cudaStream_t>(stream)));
}
