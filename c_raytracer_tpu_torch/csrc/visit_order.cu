// Cluster visit order for Hopper (sm_90a): slab test of every ray against
// every cluster AABB, and each ray's V nearest overlapped clusters.
//
// Replaces the Pallas kernel of c_raytracer_tpu/accel/pallas_visit.py
// (_kernel, visit_order_fused), and computes exactly the XLA body of
// c_raytracer_tpu/accel/traverse.py _visit_order:
//   dd = |d| < 1e-30 ? 1e-30 : d;  inv = 1 / dd   (per axis)
//   t1 = (lo - o) * inv;  t2 = (hi - o) * inv
//   tmin = max over axes of min(t1, t2);  tmax = min over axes of max(t1, t2)
//   entry = max(tmin, 0);  overlap = tmax >= entry
// then the V smallest entries of the overlapping boxes, ascending, ties to
// the lowest cluster id, and spill = max(#overlap - V, 0), where with
// count_max_dist only overlaps with entry < count_max_dist are counted.
// Empty list slots get entry FLT_MAX (ok = entry < FLT_MAX) and cid 0.
// Boxes are finite or infinite, never NaN (cluster packs refit them from
// the vertices).
// Every operation rounds once, as in the plain torch version (the library
// is built with --fmad=false), so the two agree bit for bit.
//
// Bound on the H100: the ALU.  A ray does ~25 operations per box against
// K boxes (8,556 on the mesh stand-in) and reads nothing per box but the
// box itself, which a block stages in shared memory and all its threads
// read as a broadcast; the (R, K) keys of the plain version never exist.
// One thread per ray keeps its sorted list of VM (the compiled list size,
// >= V) keys and ids in registers: a box enters only with a key strictly
// below the list's last, after any equal keys, and boxes arrive in
// ascending id, so ties go to the lowest id.  The first V of the exact
// VM-list are the exact V-list.  Blocks are one warp, so a 2048-ray tile
// spreads over 64 SMs with one warp each, which cannot hide the latency
// of its dependent per-box chain: 0.45 ms per call at R=2048, K=8,556,
// V=16 on an H100 80GB HBM3 at 700 W, against 3.1 ms for the plain
// version.  Splitting K across the warps of a block is the next step.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// cudaGetLastError() after the launch (0 means launched), or
// cudaErrorInvalidValue for a V above the largest compiled list.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // rays per block
constexpr int kTile = 1024;    // boxes per shared-memory tile (24 KB)

template <int VM>
__global__ void __launch_bounds__(kThreads)
visit_order_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const float* __restrict__ count_max_dist,
                   int32_t* __restrict__ cids, float* __restrict__ entry,
                   int32_t* __restrict__ spill, int R, int K, int V) {
  __shared__ float box[6][kTile];   // lo x y z, hi x y z
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float org[3] = {0.f, 0.f, 0.f};
  float inv[3] = {1.f, 1.f, 1.f};
  float max_dist = FLT_MAX;
  // a NaN in o or d makes every t NaN, and the plain version's NaN-
  // propagating min/max then reject every box: such a ray overlaps nothing
  bool finite = true;
  if (r < R) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      org[c] = o[3 * r + c];
      float dc = d[3 * r + c];
      finite = finite && !isnan(org[c]) && !isnan(dc);
      dc = fabsf(dc) < 1e-30f ? 1e-30f : dc;
      inv[c] = 1.0f / dc;
    }
    if (count_max_dist != nullptr) max_dist = count_max_dist[r];
  }
  const bool live = r < R && finite;
  const bool cap = count_max_dist != nullptr;

  float key[VM];
  int id[VM];
#pragma unroll
  for (int j = 0; j < VM; ++j) {
    key[j] = FLT_MAX;
    id[j] = 0;
  }
  int counted = 0;

  for (int base = 0; base < K; base += kTile) {
    const int n = min(kTile, K - base);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
      box[i % 3][i / 3] = lo[3 * base + i];
      box[3 + i % 3][i / 3] = hi[3 * base + i];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int b = 0; b < n; ++b) {
      float t1 = (box[0][b] - org[0]) * inv[0];
      float t2 = (box[3][b] - org[0]) * inv[0];
      float tmin = fminf(t1, t2);
      float tmax = fmaxf(t1, t2);
      t1 = (box[1][b] - org[1]) * inv[1];
      t2 = (box[4][b] - org[1]) * inv[1];
      tmin = fmaxf(tmin, fminf(t1, t2));
      tmax = fminf(tmax, fmaxf(t1, t2));
      t1 = (box[2][b] - org[2]) * inv[2];
      t2 = (box[5][b] - org[2]) * inv[2];
      tmin = fmaxf(tmin, fminf(t1, t2));
      tmax = fminf(tmax, fmaxf(t1, t2));
      const float e = fmaxf(tmin, 0.0f);
      if (tmax >= e) {
        counted += (!cap || e < max_dist) ? 1 : 0;
        if (e < key[VM - 1]) {
          key[VM - 1] = e;
          id[VM - 1] = base + b;
          // one bubble pass from the back: the new key moves forward past
          // every strictly larger key and stops behind equal ones
#pragma unroll
          for (int j = VM - 1; j > 0; --j) {
            if (key[j] < key[j - 1]) {
              const float tk = key[j];
              key[j] = key[j - 1];
              key[j - 1] = tk;
              const int ti = id[j];
              id[j] = id[j - 1];
              id[j - 1] = ti;
            }
          }
        }
      }
    }
  }
  if (r >= R) return;
#pragma unroll
  for (int j = 0; j < VM; ++j) {
    if (j < V) {
      cids[static_cast<int64_t>(r) * V + j] = id[j];
      entry[static_cast<int64_t>(r) * V + j] = key[j];
    }
  }
  spill[r] = counted > V ? counted - V : 0;
}

template <int VM>
void launch(const float* o, const float* d, const float* lo, const float* hi,
            const float* cmd, int32_t* cids, float* entry, int32_t* spill,
            int R, int K, int V, cudaStream_t stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  visit_order_kernel<VM><<<grid, kThreads, 0, stream>>>(
      o, d, lo, hi, cmd, cids, entry, spill, R, K, V);
}

}  // namespace

// Largest V served: the transparent-scene visit budget.
extern "C" int crt_visit_order_max_visits() { return 64; }

extern "C" int crt_visit_order(const void* o, const void* d, const void* lo,
                               const void* hi, const void* count_max_dist,
                               void* cids, void* entry, void* spill, int R,
                               int K, int V, void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  const auto* o_ = static_cast<const float*>(o);
  const auto* d_ = static_cast<const float*>(d);
  const auto* lo_ = static_cast<const float*>(lo);
  const auto* hi_ = static_cast<const float*>(hi);
  const auto* cmd = static_cast<const float*>(count_max_dist);
  auto* cids_ = static_cast<int32_t*>(cids);
  auto* entry_ = static_cast<float*>(entry);
  auto* spill_ = static_cast<int32_t*>(spill);
  auto s = static_cast<cudaStream_t>(stream);
  if (V < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (V <= 8) {
    launch<8>(o_, d_, lo_, hi_, cmd, cids_, entry_, spill_, R, K, V, s);
  } else if (V <= 16) {
    launch<16>(o_, d_, lo_, hi_, cmd, cids_, entry_, spill_, R, K, V, s);
  } else if (V <= 32) {
    launch<32>(o_, d_, lo_, hi_, cmd, cids_, entry_, spill_, R, K, V, s);
  } else if (V <= 64) {
    launch<64>(o_, d_, lo_, hi_, cmd, cids_, entry_, spill_, R, K, V, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
