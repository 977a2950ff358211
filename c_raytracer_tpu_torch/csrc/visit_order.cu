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
// Rays with a NaN in o or d overlap nothing.  Boxes are finite or
// infinite, never NaN (cluster packs refit them from the vertices).
// Every operation rounds once, as in the plain torch version (the library
// is built with --fmad=false), so the two agree bit for bit.
//
// Bound on the H100: the ALU.  A ray does ~25 float operations per box
// against K boxes (8,556 on the mesh stand-in) and reads nothing per box
// but the box itself, which all lanes of a warp read from shared memory as
// a broadcast; the (R, K) keys of the plain version never exist.  At
// R = 2048 the work is 17.5 M box tests, ~6.5 us of float32 issue.
//
// The design splits K so that a 2048-ray tile fills the card.  A block
// holds 32 rays, one per lane, and W warps; a thread-block cluster holds C
// blocks with the same 32 rays.  Each of the W*C warps scans one
// contiguous, id-ascending slice of the boxes (the split is computed by
// the Python wrapper, pallas_visit.visit_split: R = 2048 runs 64 clusters
// of 4 blocks of 8 warps).  A warp streams its slice through its own ring
// of shared-memory tiles filled by cp.async.bulk copies that complete on
// an mbarrier, so no block-wide barrier sits in the scan, and keeps each
// ray's sorted VM-list (VM >= V, the compiled list size): a box enters
// only with a key strictly below the list's last, after any equal keys,
// and boxes arrive in ascending id, so each warp's list is the first VM of
// its slice's stable sort.  The lists then merge by (key, id): each
// entry's place is its index plus the number of smaller entries in the
// other lists (a binary search in each), first among the warps of a block
// through shared memory, then among the blocks of the cluster through
// distributed shared memory.  The slices are id-contiguous, so (key, id)
// order is the stable-sort order, ties included; each ray's counts add up
// to the spill.  The first V of the merged lists are exact: an entry among
// a ray's V smallest is among the VM smallest of its slice.
//
// Up to VM = 64 the lists live in registers, kept sorted by one bubble
// pass per insertion.  VM = 128 and 256 (the transparent scenes' larger
// budgets, e.g. 104 and 128) would take 512 and 1,024 registers a thread;
// their lists live in shared memory instead, laid out as the merge reads
// them (entry j of lane l at j * 32 + l, so the lanes never share a
// bank), with the list's length in a register: an insertion finds its
// place by binary search after the equal keys and shifts the tail by one.
//
// The ring's tile (64 boxes) and depth (4 stages) are compile-time
// constants, and the block's shared-memory layout (smem_bytes) lives here
// only; a static_assert holds the largest block of every list size to the
// 227 KB an H100 block may take.
//
// A V above the largest compiled list (256) runs in passes of up to 256
// slots, one launch each (the Python wrapper, pallas_visit.visit_passes):
// a pass writes slots [col0, col0 + its V) of the (R, V) outputs and
// admits to its lists only boxes after the previous pass's last slot in
// (key, id) order, read from the outputs that the previous launch on the
// same stream wrote.  (key, id) is a total order of a ray's boxes, so the
// passes together give the first V of the stable sort, ties included; a
// pass whose bound is an empty slot (FLT_MAX) admits nothing.  Every pass
// counts all overlaps and writes the same spill, counted against the
// whole V.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 10;
// PERF.md): 0.054 ms at R = 2048, K = 8,556, V = 16, against 0.44 ms for
// the earlier design of one warp per block scanning all K boxes.  VM = 64
// needs 255 registers and spills a few hundred bytes a thread; it runs 4
// warps a block, VM = 128 4 and VM = 256 2.
//
// C ABI (bound with ctypes in c_raytracer_tpu_torch/_native.py): returns
// the launch's cudaError_t (0 means launched), or cudaErrorInvalidValue for
// a pass above the largest compiled list (256) or outside the V slots, or
// a split the kernel does not take.

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;      // rays per block
constexpr int kTile = 64;       // boxes per ring stage, a multiple of 4
constexpr int kStages = 4;      // ring stages per warp
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

struct Params {
  const float* o;
  const float* d;
  const float* lo;
  const float* hi;
  const float* count_max_dist;  // or nullptr
  int32_t* cids;
  float* entry;
  int32_t* spill;
  int R, K;
  int V;        // this pass's slots
  int V_total;  // the outputs' slots a ray, the spill's budget
  int col0;     // this pass's first slot; from 1 on, the previous slot
                // bounds the boxes a pass admits
  int slice;    // boxes per warp slice, a multiple of 4
};

// Whether a list of size VM lives in shared memory (else in registers).
__host__ __device__ constexpr bool smem_list(int vm) { return vm > 64; }

// Most warps a block of list size VM may have: register lists must fit
// the SM's 65,536 registers, shared-memory lists its 227 KB.
__host__ __device__ constexpr int max_warps(int vm) {
  return vm <= 16 ? 16 : (vm == 32 ? 8 : (vm <= 128 ? 4 : 2));
}

__host__ __device__ constexpr int align16(int n) {
  return (n + 15) / 16 * 16;
}

// A block's dynamic shared memory, in three parts: the ring mbarriers
// (bars_bytes); the ring and the warps' lists and counts (ring_bytes),
// which for register lists reuse the ring after the scan and for
// shared-memory lists follow it (lists_offset); the block's merged list
// and counts.
__host__ __device__ constexpr int bars_bytes(int warps) {
  return align16(8 * warps * kStages);
}
__host__ __device__ constexpr int lists_offset(int vm, int warps) {
  return smem_list(vm) ? 24 * kTile * kStages * warps : 0;
}
__host__ __device__ constexpr int ring_bytes(int vm, int warps) {
  const int ring = 24 * kTile * kStages * warps;
  const int lists = 4 * warps * kLanes * (2 * vm + 2);
  return align16(smem_list(vm) ? ring + lists
                               : (ring > lists ? ring : lists));
}
__host__ __device__ constexpr int smem_bytes(int vm, int warps) {
  return bars_bytes(warps) + ring_bytes(vm, warps) + 4 * kLanes * (2 * vm + 2);
}
static_assert(smem_bytes(8, max_warps(8)) <= kSmemMax &&
                  smem_bytes(16, max_warps(16)) <= kSmemMax &&
                  smem_bytes(32, max_warps(32)) <= kSmemMax &&
                  smem_bytes(64, max_warps(64)) <= kSmemMax &&
                  smem_bytes(128, max_warps(128)) <= kSmemMax &&
                  smem_bytes(256, max_warps(256)) <= kSmemMax,
              "the largest block of each list size must fit shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Ring stage t % kStages of one warp <- boxes [b0, b0 + nb) of lo and hi.
// Lane 0 starts the bulk copies of the whole 16-byte words; a ragged tail
// (< 4 floats per array, only where the slice ends at K) is copied by
// lanes with plain loads.  Slices and tiles start at multiples of 4 boxes,
// so every copy starts 16-byte aligned (the wrapper checks the bases).
__device__ __forceinline__ void issue(const Params& p, float* slo,
                                      uint64_t* bar, int b0, int nb,
                                      int lane) {
  float* shi = slo + 3 * kTile;
  const float* glo = p.lo + 3 * static_cast<int64_t>(b0);
  const float* ghi = p.hi + 3 * static_cast<int64_t>(b0);
  const int nf = 3 * nb;
  const int bulk = nf & ~3;
  if (lane == 0) {
    // the warp's earlier reads of this stage (ordered by __syncwarp) come
    // before the async proxy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(8 * bulk) : "memory");
    if (bulk > 0) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(slo)), "l"(glo), "r"(4 * bulk),
             "r"(smem_addr(bar)) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_addr(shi)), "l"(ghi), "r"(4 * bulk),
             "r"(smem_addr(bar)) : "memory");
    }
  }
  if (lane < nf - bulk) {
    slo[bulk + lane] = glo[bulk + lane];
    shi[bulk + lane] = ghi[bulk + lane];
  }
}

// A ray's sorted list of the VM nearest boxes so far, in registers.
template <int VM, bool kSmem = smem_list(VM)>
struct List {
  float key[VM];
  int id[VM];

  __device__ __forceinline__ void init(float*, int*) {
#pragma unroll
    for (int j = 0; j < VM; ++j) {
      key[j] = FLT_MAX;
      id[j] = 0;
    }
  }
  // box b with key e < the last key: one bubble pass from the back moves
  // it forward past every strictly larger key, behind the equal ones
  __device__ __forceinline__ void insert(float e, int b) {
    if (!(e < key[VM - 1])) return;
    key[VM - 1] = e;
    id[VM - 1] = b;
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
  // the list into its warp's merge arrays (stride kLanes); its length
  __device__ __forceinline__ int store(float* wk, int* wi) {
    int n = 0;
#pragma unroll
    for (int j = 0; j < VM; ++j) {
      n += key[j] < FLT_MAX ? 1 : 0;
      wk[j * kLanes] = key[j];
      wi[j * kLanes] = id[j];
    }
    return n;
  }
};

// The same list in shared memory, where the merge reads it: entry j at
// k[j * kLanes], i[j * kLanes]; its length n in a register.
template <int VM>
struct List<VM, true> {
  float* k;
  int* i;
  int n;

  __device__ __forceinline__ void init(float* wk, int* wi) {
    k = wk;
    i = wi;
    n = 0;
  }
  __device__ __forceinline__ void insert(float e, int b) {
    if (!(e < FLT_MAX) || (n == VM && !(e < k[(VM - 1) * kLanes]))) return;
    // the first entry with a key above e: boxes arrive in ascending id, so
    // e goes after the entries of equal key
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (k[mid * kLanes] <= e) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    for (int j = n < VM ? n : VM - 1; j > lo; --j) {
      k[j * kLanes] = k[(j - 1) * kLanes];
      i[j * kLanes] = i[(j - 1) * kLanes];
    }
    k[lo * kLanes] = e;
    i[lo * kLanes] = b;
    n += n < VM ? 1 : 0;
  }
  __device__ __forceinline__ int store(float*, int*) { return n; }
};

// The slab test of box b and, on overlap, the count and the insertion.
template <int VM>
__device__ __forceinline__ void visit(float lx, float ly, float lz, float hx,
                                      float hy, float hz, int b,
                                      const float (&org)[3],
                                      const float (&inv)[3], bool live,
                                      bool cap, float max_dist,
                                      bool bounded, float after_key,
                                      int after_id, List<VM>& list,
                                      int& counted) {
  float t1 = (lx - org[0]) * inv[0];
  float t2 = (hx - org[0]) * inv[0];
  float tmin = fminf(t1, t2);
  float tmax = fmaxf(t1, t2);
  t1 = (ly - org[1]) * inv[1];
  t2 = (hy - org[1]) * inv[1];
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  t1 = (lz - org[2]) * inv[2];
  t2 = (hz - org[2]) * inv[2];
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
  const float e = fmaxf(tmin, 0.0f);
  if (live && tmax >= e) {
    counted += (!cap || e < max_dist) ? 1 : 0;
    if (!bounded || e > after_key || (e == after_key && b > after_id)) {
      list.insert(e, b);
    }
  }
}

// Entries of a sorted list (stride kLanes) below (k, i) in (key, id) order.
__device__ __forceinline__ int count_below(const float* keys, const int* ids,
                                           int n, float k, int i) {
  int lo = 0;
  while (lo < n) {
    const int mid = (lo + n) >> 1;
    const float km = keys[mid * kLanes];
    if (km < k || (km == k && ids[mid * kLanes] < i)) {
      lo = mid + 1;
    } else {
      n = mid;
    }
  }
  return lo;
}

template <int VM>
__global__ void __launch_bounds__(kLanes * max_warps(VM))
visit_order_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = (blockIdx.x / C) * kLanes + lane;
  constexpr int S = kStages;
  constexpr int T = kTile;

  const int ring0 = bars_bytes(W);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * S;
  float* ring = reinterpret_cast<float*>(smem + ring0) + warp * S * 6 * T;
  float* wkey = reinterpret_cast<float*>(               // [W][VM][32]
      smem + ring0 + lists_offset(VM, W));
  int* wid = reinterpret_cast<int*>(wkey + W * VM * kLanes);  // [W][VM][32]
  int* wn = wid + W * VM * kLanes;                            // [W][32]
  int* wcnt = wn + W * kLanes;                                // [W][32]
  float* bkey =
      reinterpret_cast<float*>(smem + ring0 + ring_bytes(VM, W));  // [VM][32]
  int* bid = reinterpret_cast<int*>(bkey + VM * kLanes);            // [VM][32]
  int* bn = bid + VM * kLanes;                                      // [32]
  int* bcnt = bn + kLanes;                                          // [32]

  float org[3] = {0.f, 0.f, 0.f};
  float inv[3] = {1.f, 1.f, 1.f};
  float max_dist = FLT_MAX;
  // a NaN in o or d makes every t NaN, and the plain version's NaN-
  // propagating min/max then reject every box: such a ray overlaps nothing
  bool finite = true;
  if (r < p.R) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      org[c] = p.o[3 * r + c];
      float dc = p.d[3 * r + c];
      finite = finite && !isnan(org[c]) && !isnan(dc);
      dc = fabsf(dc) < 1e-30f ? 1e-30f : dc;
      inv[c] = 1.0f / dc;
    }
    if (p.count_max_dist != nullptr) max_dist = p.count_max_dist[r];
  }
  // a later pass: the previous pass's last slot, an exclusive lower bound
  const bool bounded = p.col0 > 0;
  float after_key = 0.0f;
  int after_id = 0;
  if (bounded && r < p.R) {
    const int64_t last = static_cast<int64_t>(r) * p.V_total + p.col0 - 1;
    after_key = p.entry[last];
    after_id = p.cids[last];
  }
  const bool live = r < p.R && finite;
  const bool cap = p.count_max_dist != nullptr;
  // the same for every warp of the cluster: they hold the same 32 rays
  const bool any_live = __any_sync(0xffffffffu, live);

  // -- the scan of this warp's slice, through its ring --------------------
  const int start = min((rank * W + warp) * p.slice, p.K);
  const int end = min(start + p.slice, p.K);
  const int n_tiles = any_live ? (end - start + T - 1) / T : 0;
  if (lane == 0) {
    for (int st = 0; st < S; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(bars + st)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int t = 0; t < S && t < n_tiles; ++t) {
    const int b0 = start + t * T;
    issue(p, ring + t * 6 * T, bars + t, b0, min(T, end - b0), lane);
  }

  List<VM> list;
  list.init(wkey + warp * VM * kLanes + lane, wid + warp * VM * kLanes + lane);
  int counted = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S;
    bar_wait(bars + st, (t / S) & 1);
    __syncwarp();  // the lanes' plain tail stores, too
    const int b0 = start + t * T;
    const int nb = min(T, end - b0);
    const float* slo = ring + st * 6 * T;
    const float* shi = slo + 3 * T;
    int b = 0;
    for (; b + 4 <= nb; b += 4) {  // four boxes: three 16-byte words each
      const float4 l0 = reinterpret_cast<const float4*>(slo + 3 * b)[0];
      const float4 l1 = reinterpret_cast<const float4*>(slo + 3 * b)[1];
      const float4 l2 = reinterpret_cast<const float4*>(slo + 3 * b)[2];
      const float4 h0 = reinterpret_cast<const float4*>(shi + 3 * b)[0];
      const float4 h1 = reinterpret_cast<const float4*>(shi + 3 * b)[1];
      const float4 h2 = reinterpret_cast<const float4*>(shi + 3 * b)[2];
      visit<VM>(l0.x, l0.y, l0.z, h0.x, h0.y, h0.z, b0 + b, org, inv, live,
                cap, max_dist, bounded, after_key, after_id, list,
                counted);
      visit<VM>(l0.w, l1.x, l1.y, h0.w, h1.x, h1.y, b0 + b + 1, org, inv,
                live, cap, max_dist, bounded, after_key, after_id, list,
                counted);
      visit<VM>(l1.z, l1.w, l2.x, h1.z, h1.w, h2.x, b0 + b + 2, org, inv,
                live, cap, max_dist, bounded, after_key, after_id, list,
                counted);
      visit<VM>(l2.y, l2.z, l2.w, h2.y, h2.z, h2.w, b0 + b + 3, org, inv,
                live, cap, max_dist, bounded, after_key, after_id, list,
                counted);
    }
    for (; b < nb; ++b) {
      visit<VM>(slo[3 * b], slo[3 * b + 1], slo[3 * b + 2], shi[3 * b],
                shi[3 * b + 1], shi[3 * b + 2], b0 + b, org, inv, live, cap,
                max_dist, bounded, after_key, after_id, list, counted);
    }
    __syncwarp();  // every lane is done with the stage before its refill
    if (t + S < n_tiles) {
      const int b1 = b0 + S * T;
      issue(p, ring + st * 6 * T, bars + st, b1, min(T, end - b1), lane);
    }
  }

  // -- merge 1: the W lists of the block, through shared memory ----------
  __syncthreads();  // every warp is done with the ring: register lists
                    // reuse it
  const int n_mine = list.store(wkey + warp * VM * kLanes + lane,
                                wid + warp * VM * kLanes + lane);
  wn[warp * kLanes + lane] = n_mine;
  wcnt[warp * kLanes + lane] = counted;
  __syncthreads();
  for (int j = 0; j < n_mine; ++j) {
    const float k = wkey[(warp * VM + j) * kLanes + lane];
    const int i = wid[(warp * VM + j) * kLanes + lane];
    int pos = j;
    for (int w = 0; w < W && pos < VM; ++w) {
      if (w != warp) {
        pos += count_below(wkey + w * VM * kLanes + lane,
                           wid + w * VM * kLanes + lane, wn[w * kLanes + lane],
                           k, i);
      }
    }
    if (pos < VM) {
      bkey[pos * kLanes + lane] = k;
      bid[pos * kLanes + lane] = i;
    }
  }
  if (warp == 0) {
    int n = 0, c = 0;
    for (int w = 0; w < W; ++w) {
      n += wn[w * kLanes + lane];
      c += wcnt[w * kLanes + lane];
    }
    bn[lane] = min(n, VM);
    bcnt[lane] = c;
  }

  // -- merge 2: the C block lists, through distributed shared memory -----
  cluster.sync();  // every block's list is complete and visible
  const int n_blk = bn[lane];
  for (int j = warp; j < n_blk; j += W) {
    const float k = bkey[j * kLanes + lane];
    const int i = bid[j * kLanes + lane];
    int pos = j;
    for (int c = 0; c < C && pos < p.V; ++c) {
      if (c != rank) {
        pos += count_below(cluster.map_shared_rank(bkey, c) + lane,
                           cluster.map_shared_rank(bid, c) + lane,
                           cluster.map_shared_rank(bn, c)[lane], k, i);
      }
    }
    if (pos < p.V && r < p.R) {
      p.cids[static_cast<int64_t>(r) * p.V_total + p.col0 + pos] = i;
      p.entry[static_cast<int64_t>(r) * p.V_total + p.col0 + pos] = k;
    }
  }
  if (rank == 0 && r < p.R) {
    int n = 0, c = 0;
    for (int q = 0; q < C; ++q) {
      n += cluster.map_shared_rank(bn, q)[lane];
      c += cluster.map_shared_rank(bcnt, q)[lane];
    }
    for (int j = min(n, p.V) + warp; j < p.V; j += W) {
      p.cids[static_cast<int64_t>(r) * p.V_total + p.col0 + j] = 0;
      p.entry[static_cast<int64_t>(r) * p.V_total + p.col0 + j] = FLT_MAX;
    }
    if (warp == 0) p.spill[r] = c > p.V_total ? c - p.V_total : 0;
  }
  cluster.sync();  // no block leaves while another reads its lists
}

template <int VM>
cudaError_t launch(const Params& p, int groups, int C, int W,
                   cudaStream_t stream) {
  if (W > max_warps(VM)) return cudaErrorInvalidValue;
  const int smem = smem_bytes(VM, W);
  auto* kernel = visit_order_kernel<VM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * C);
  cfg.blockDim = dim3(kLanes * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace

// (o, d, lo, hi, count_max_dist or NULL, cids, entry, spill, R, K,
//  V_total, col0, V, cluster, warps, slice, stream): one pass, slots
//  [col0, col0 + V) of the (R, V_total) outputs
extern "C" int crt_visit_order(const void* o, const void* d, const void* lo,
                               const void* hi, const void* count_max_dist,
                               void* cids, void* entry, void* spill, int R,
                               int K, int V_total, int col0, int V,
                               int cluster, int warps, int slice,
                               void* stream) {
  if (R <= 0) return static_cast<int>(cudaGetLastError());
  if (V < 1 || col0 < 0 || col0 + V > V_total || K < 1 || cluster < 1 ||
      cluster > 8 || warps < 1 ||
      slice < 4 || slice % 4 != 0 ||
      static_cast<int64_t>(slice) * warps * cluster < K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.o = static_cast<const float*>(o);
  p.d = static_cast<const float*>(d);
  p.lo = static_cast<const float*>(lo);
  p.hi = static_cast<const float*>(hi);
  p.count_max_dist = static_cast<const float*>(count_max_dist);
  p.cids = static_cast<int32_t*>(cids);
  p.entry = static_cast<float*>(entry);
  p.spill = static_cast<int32_t*>(spill);
  p.R = R;
  p.K = K;
  p.V = V;
  p.V_total = V_total;
  p.col0 = col0;
  p.slice = slice;
  const int groups = (R + kLanes - 1) / kLanes;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (V <= 8) {
    err = launch<8>(p, groups, cluster, warps, s);
  } else if (V <= 16) {
    err = launch<16>(p, groups, cluster, warps, s);
  } else if (V <= 32) {
    err = launch<32>(p, groups, cluster, warps, s);
  } else if (V <= 64) {
    err = launch<64>(p, groups, cluster, warps, s);
  } else if (V <= 128) {
    err = launch<128>(p, groups, cluster, warps, s);
  } else if (V <= 256) {
    err = launch<256>(p, groups, cluster, warps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
