// k-NN median depth for Hopper (sm_90a).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_knn.py
// (knn_median_depth_pallas -> _knn_kernel, which the fleet path runs under
// vmap): for each rig and each of its box centers (cx, cy)
// the k nearest projected cloud points (u, v, depth) under the reference's
// 3D metric quirk d2 = (cx-u)^2 + (cy-v)^2 + depth^2, then the upper median
// (index n // 2) of their depths, or -1 when no point is found.
//
// Tie rule: that of grid_vision_tpu/ops/association.knn_median_depth, not
// of the Pallas kernel. Equal d2 resolves to the LOWEST point index, so the
// selection key is (d2, index) packed into one 64-bit integer: d2 >= 0
// orders like its IEEE bits, the index breaks ties. The k smallest keys of
// a set do not depend on how the set is cut up or scanned, so the points
// and centers may be partitioned freely; what must not change is the key
// and the rounding of d2, op by op (__fsub_rn / __fmul_rn / __fadd_rn, no
// FMA), which keep the selected set equal to the plain torch twin's. An
// invalid point gets d2 = +inf, as in the twin: it sorts behind every
// finite distance and, like any point at d2 = +inf, counts as not found.
//
// Bound on this card: instruction rate; neither bytes nor FP32 operations.
// A fleet of 64 rigs (8192 points, 16 or 64 centers each) is 59 or 235
// MFLOP over ~7 MB, a few microseconds of either, and a launch costs about
// two. A kernel that gives one block to one center reads the cloud once per
// center through a serial chain of dependent scalar loads. One that shares
// the loads but keeps a sorted top-k per thread still pays a divergent
// 64-bit insertion at almost every point: a thread sees too few points for
// its own list's worst entry to reject any, and a warp runs the insertion
// when one lane of 32 needs it (measured on an H100: 26 / 83 us of device
// time at 16 / 64 centers a rig, against 29 / 86 for a block per center;
// 25 / 51 with a bound the block's threads share). Design, one launch:
//   1. scan. A block (128 threads) serves a group of 8 centers of one rig
//      (4 when k > 4) over one slice of the rig's points: a point is loaded
//      once and meets the whole group, so the cloud is read once per group.
//      The points come in chunks of 1024 through a double buffer in shared
//      memory, ahead of their use: 16-byte cp.async pieces when the cloud
//      is 16-byte aligned (P a multiple of 16), plain coalesced loads
//      otherwise. No thread keeps a list. A center has, in shared memory,
//      its k smallest (d2, index) keys so far, the k-th of them published
//      as the bar, and two slots a thread for candidates. A thread takes a
//      batch of two points: their loads and the six roundings of each d2
//      first, then per center one compare of the d2 bits with the bar's
//      high word (a register) and a branch that is rarely taken: a key
//      below the bar goes to a free slot of the thread's (no atomic). When
//      the points seen reach a power of two, and at the end, one warp per
//      center selects the k smallest of the kept keys and all slots (each
//      lane folds its share, then k rounds of a warp-wide minimum, two
//      redux.sync each), keeps them and publishes the k-th; the threads
//      empty their slots. The bar rises as 1 / (points seen by the block),
//      whatever the ties, because the whole key is compared. A thread that
//      finds no free slot (distances that fall point after point) says so
//      at the batch's barrier: the block selects at once, and the thread
//      then places what it held back: emptied, its two slots take a
//      batch's two keys whatever they are, so nothing is scanned twice.
//   2. merge. Where the points are in one slice, the selecting warp takes
//      the upper median of the selected points' depths at once. Else it
//      writes its k keys, kEmpty for "none", to a scratch, and the block
//      counts itself on a counter of its (rig, group): the last of the
//      slices' blocks to arrive (__threadfence before the count) selects,
//      one warp per center, the k smallest of all slices' candidates the
//      same way, takes the median, and sets the counter back to 0 for the
//      next call.
// The host picks the number of slices from (rigs, points, centers, k) so
// that the scan's blocks fill the card once (ops/cuda_knn.knn_split): one
// wave of at most 4 blocks an SM at every shape the ticks use. What is left
// is the loop itself: about ten instructions a (point, center), six of them
// the roundings the twin's equality needs, at half the SM's rate.

#include "gv_mma.cuh"

namespace {

using u64 = unsigned long long;

constexpr u64 kEmpty = 0xFFFFFFFFFFFFFFFFull;
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;                  // points staged at a time
constexpr int kBatch = 2;                     // points a thread takes at a time
constexpr int kKeep = 8;                      // selected keys a center keeps (>= k)
// A center's keys in shared memory: the selected ones in front, then
// kBatch slots of every thread for the candidates it finds between two
// selections (thread t's slot s at kKeep + s * kThreads + t).
constexpr int kCenterKeys = kKeep + kBatch * kThreads;

// The smallest key of a warp: the smallest high word, then the smallest low
// word among the lanes that hold it.
__device__ __forceinline__ u64 warp_min(u64 v) {
  const uint32_t hi = (uint32_t)(v >> 32);
  const uint32_t min_hi = __reduce_min_sync(kFull, hi);
  const uint32_t lo = hi == min_hi ? (uint32_t)v : 0xFFFFFFFFu;
  return ((u64)min_hi << 32) | __reduce_min_sync(kFull, lo);
}

// key into a sorted list whose last (largest) entry it beats.
template <int K>
__device__ __forceinline__ void insert(u64 (&best)[K], u64 key) {
  best[K - 1] = key;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (best[j] < best[j - 1]) {
      const u64 t = best[j];
      best[j] = best[j - 1];
      best[j - 1] = t;
    }
  }
}

// The K smallest of the n keys at src, ascending, in every lane of the warp
// (keys are unique but for kEmpty, which stands for "none"). kRemote: other
// SMs wrote the keys to device memory, so they are read past this SM's L1.
template <int K, bool kRemote = false>
__device__ __forceinline__ void warp_select(const u64* src, int n,
                                            u64 (&sel)[K]) {
  u64 mine[K];
#pragma unroll
  for (int j = 0; j < K; ++j) mine[j] = kEmpty;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const u64 key = kRemote ? __ldcg(src + i) : src[i];
    if (key < mine[K - 1]) insert(mine, key);
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const u64 m = warp_min(mine[0]);
    sel[r] = m;
    if (mine[0] == m && m != kEmpty) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) mine[j] = mine[j + 1];
      mine[K - 1] = kEmpty;
    }
  }
}

// The d2 bits (as a signed int) that a point must not exceed to have a
// chance against the k-th key: its high word, or everything while there is
// no k-th key yet (kEmpty; a NaN's bits order above every distance).
__device__ __forceinline__ int pass_limit(u64 kth) {
  const uint32_t hi = (uint32_t)(kth >> 32);
  return hi >= 0x80000000u ? 0x7FFFFFFF : (int)hi;
}

// The upper median (index n_found / 2) of the depths of the found keys among
// sel (ascending: the found ones, d2 < +inf, come first), -1 when none.
template <int K>
__device__ __forceinline__ float median_depth(const u64 (&sel)[K],
                                              const float* __restrict__ uvd) {
  float d[K];
  int n_found = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool found = (uint32_t)(sel[j] >> 32) < kInfBits;
    d[j] = found ? uvd[3 * (int64_t)(uint32_t)sel[j] + 2] : 0.0f;
    n_found += found;
  }
#pragma unroll
  for (int a = 1; a < K; ++a) {               // sort the first n_found
#pragma unroll
    for (int b = a; b > 0; --b) {
      if (b < n_found && d[b] < d[b - 1]) {
        const float t = d[b];
        d[b] = d[b - 1];
        d[b - 1] = t;
      }
    }
  }
  float med = -1.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (n_found > 0 && j == n_found / 2) med = d[j];
  }
  return med;
}

// Per rig (blockIdx.y): uvd (p, 3), valid (p,), centers (n_centers, 2).
// blockIdx.x = group * n_slices + slice; the block scans points
// [slice * slice_len, (slice + 1) * slice_len) for centers
// [group * G, (group + 1) * G) and writes cand[rig][center][slice][K]; the
// last of a (rig, group)'s n_slices blocks to get there (arrived[rig][group]
// counts them, from 0, and is set back to 0) merges them into out[rig].
template <int K, int G>
__global__ void __launch_bounds__(kThreads, 4)
gv_knn_scan_kernel(const float* __restrict__ uvd,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ centers, int p, int n_centers,
                   int n_slices, int slice_len, int wide, u64* cand,
                   int* __restrict__ arrived, float* __restrict__ out) {
  static_assert(K <= kKeep && 2 * G <= 32, "kept keys; slot counts in a word");
  __shared__ __align__(16) float pts[2 * kChunk * 3];
  __shared__ __align__(16) uint8_t vld[2 * kChunk];
  __shared__ u64 keys[G][kCenterKeys];
  __shared__ u64 kth[G];          // a center's k-th smallest key so far
  __shared__ int last_block;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rig = blockIdx.y;
  const int group = blockIdx.x / n_slices;
  const int slice = blockIdx.x - group * n_slices;
  uvd += (int64_t)rig * p * 3;
  valid += (int64_t)rig * p;
  const int lo = (int)min((int64_t)p, (int64_t)slice * slice_len);
  const int hi = (int)min((int64_t)p, (int64_t)lo + slice_len);

  float cx[G], cy[G];
  int limit[G];                   // pass_limit(kth[c])
  unsigned used = 0;              // slots taken, two bits a center
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const int ci = min(group * G + c, n_centers - 1);      // spare: a copy
    cx[c] = centers[2 * ((int64_t)rig * n_centers + ci)];
    cy[c] = centers[2 * ((int64_t)rig * n_centers + ci) + 1];
    limit[c] = 0x7FFFFFFF;
    for (int i = tid; i < kCenterKeys; i += kThreads) keys[c][i] = kEmpty;
  }
  if (tid < G) kth[tid] = kEmpty;

  // One warp per center: the k smallest of its kept keys and candidates to
  // the front, the k-th published. Barriers around it are the caller's.
  auto select_all = [&](u64 (&sel)[K], auto&& use) {
    for (int c = warp; c < G; c += kWarps) {
      warp_select(keys[c], kCenterKeys, sel);
      __syncwarp();                           // every lane has read the keys
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < K; ++r) keys[c][r] = sel[r];
        kth[c] = sel[K - 1];
      }
      use(c);
    }
  };
  // ... then every thread empties its slots and takes the new limits
  auto after_select = [&]() {
#pragma unroll
    for (int c = 0; c < G; ++c) {
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        keys[c][kKeep + s * kThreads + tid] = kEmpty;
      }
      limit[c] = pass_limit(kth[c]);
    }
    used = 0;
  };
  // key to a free slot of the thread's for center c; false if it has none
  auto append = [&](int c, u64 key) {
    const unsigned u = used >> (2 * c) & 3u;
    if (u >= (unsigned)kBatch) return false;
    keys[c][kKeep + u * kThreads + tid] = key;
    used += 1u << (2 * c);
    return true;
  };

  // (u, v, z, valid) of point j of a staged chunk -> the d2 bits to every
  // center; an invalid point is at d2 = +inf, as in the twin
  auto distances = [&](const float* sp, const uint8_t* sv, int j,
                       int (&d2_bits)[G]) {
    const float u = sp[3 * j];
    const float v = sp[3 * j + 1];
    const float z = sp[3 * j + 2];
    const float zz = sv[j] ? __fmul_rn(z, z) : __int_as_float(kInfBits);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float du = __fsub_rn(cx[c], u);
      const float dv = __fsub_rn(cy[c], v);
      d2_bits[c] = __float_as_int(
          __fadd_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)), zz));
    }
  };

  const int n_chunks = (hi - lo + kChunk - 1) / kChunk;
  auto load_chunk = [&](int chunk) {
    const int base = lo + chunk * kChunk;
    const int n = min(kChunk, hi - base);
    float* dp = pts + (chunk & 1) * kChunk * 3;
    uint8_t* dv = vld + (chunk & 1) * kChunk;
    if (wide) {                               // n is a multiple of 16
      for (int i = tid; i < n * 3 / 4; i += kThreads) {
        gv::cp_async16(dp + 4 * i, uvd + (int64_t)base * 3 + 4 * i, true);
      }
      for (int i = tid; i < n / 16; i += kThreads) {
        gv::cp_async16(reinterpret_cast<float*>(dv + 16 * i),
                       reinterpret_cast<const float*>(valid + base + 16 * i),
                       true);
      }
    } else {
      for (int i = tid; i < n * 3; i += kThreads) {
        dp[i] = __ldg(uvd + (int64_t)base * 3 + i);
      }
      for (int i = tid; i < n; i += kThreads) dv[i] = __ldg(valid + base + i);
    }
    gv::cp_async_commit();
  };
  if (n_chunks > 0) load_chunk(0);
  u64 sel[K];
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + 1 < n_chunks) {
      load_chunk(chunk + 1);
      gv::cp_async_wait<1>();
    } else {
      gv::cp_async_wait<0>();
    }
    __syncthreads();
    const int base = lo + chunk * kChunk;
    const int n = min(kChunk, hi - base);
    const float* sp = pts + (chunk & 1) * kChunk * 3;
    const uint8_t* sv = vld + (chunk & 1) * kChunk;
    // a batch: kBatch points a thread. Their loads and distances first (the
    // appends write shared memory, and the compiler moves no load of a
    // later point above them), then one branch per center.
    for (int s0 = 0; s0 < n; s0 += kBatch * kThreads) {
      int d2_bits[kBatch][G];
      bool ok[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = s0 + b * kThreads + tid;
        ok[b] = j < n && sv[min(j, n - 1)];
        distances(sp, sv, min(j, n - 1), d2_bits[b]);
      }
      unsigned waiting = 0;                   // (b, c) that found no slot
#pragma unroll
      for (int c = 0; c < G; ++c) {
        bool any = false;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) any |= d2_bits[b][c] <= limit[c];
        if (!any) continue;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const u64 key = ((u64)(uint32_t)d2_bits[b][c] << 32) |
                          (uint32_t)(base + s0 + b * kThreads + tid);
          if (ok[b] && key < kth[c] && !append(c, key)) {
            waiting |= 1u << (b * G + c);
          }
        }
      }
      // select when the points seen are a power of two (a higher bar for
      // the points to come; the end of the slice has its own) or a thread
      // is out of slots: emptied, they hold a batch's keys whatever comes
      const int seen = chunk * kChunk + s0 + kBatch * kThreads;
      const bool due = (seen & (seen - 1)) == 0 &&
                       base + s0 + kBatch * kThreads < hi;
      if (__syncthreads_or(waiting != 0) || due) {
        select_all(sel, [](int) {});
        __syncthreads();
        after_select();
#pragma unroll
        for (int c = 0; c < G; ++c) {
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (waiting >> (b * G + c) & 1u) {
              const u64 key = ((u64)(uint32_t)d2_bits[b][c] << 32) |
                              (uint32_t)(base + s0 + b * kThreads + tid);
              if (key < kth[c]) append(c, key);
            }
          }
        }
      }
    }
  }

  // the slice's k smallest per center: the median at once where the slice
  // is the whole cloud, else to the scratch for the last block to merge
  __syncthreads();
  select_all(sel, [&](int c) {
    const int ci = group * G + c;
    if (lane == 0 && ci < n_centers) {
      if (n_slices == 1) {
        out[(int64_t)rig * n_centers + ci] = median_depth(sel, uvd);
      } else {
        u64* dst =
            cand + (((int64_t)rig * n_centers + ci) * n_slices + slice) * K;
#pragma unroll
        for (int r = 0; r < K; ++r) dst[r] = sel[r];
        __threadfence();                      // before the block is counted
      }
    }
  });
  if (n_slices == 1) return;

  // merge: the block that finds the other n_slices - 1 counted is the last;
  // every slice's candidates are then written and visible
  __syncthreads();
  if (tid == 0) {
    int* counter = arrived + rig * (gridDim.x / n_slices) + group;
    last_block = atomicAdd(counter, 1) == n_slices - 1;
    if (last_block) *counter = 0;             // for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int c = warp; c < G; c += kWarps) {
    const int ci = group * G + c;
    if (ci >= n_centers) break;
    warp_select<K, true>(
        cand + ((int64_t)rig * n_centers + ci) * n_slices * K, n_slices * K,
        sel);
    if (lane == 0) out[(int64_t)rig * n_centers + ci] = median_depth(sel, uvd);
  }
}

template <int K>
cudaError_t launch(const float* uvd, const uint8_t* valid,
                   const float* centers, int n_rigs, int p, int d,
                   int n_slices, int slice_len, u64* cand, int* arrived,
                   float* out, cudaStream_t stream) {
  constexpr int G = K <= 4 ? 8 : 4;
  const int wide = p % 16 == 0 && slice_len % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(uvd) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(valid) % 16 == 0;
  const int64_t blocks = (int64_t)((d + G - 1) / G) * n_slices;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  gv_knn_scan_kernel<K, G><<<dim3((unsigned)blocks, n_rigs), kThreads, 0,
                             stream>>>(uvd, valid, centers, p, d, n_slices,
                                       slice_len, wide, cand, arrived, out);
  return cudaGetLastError();
}

}  // namespace

// uvd: (n_rigs, p, 3); valid: (n_rigs, p) bytes; centers: (n_rigs, d, 2);
// out: (n_rigs, d). A rig's points are scanned in n_slices slices of
// slice_len points (n_slices * slice_len >= p). Where n_slices > 1, cand:
// (n_rigs, d, n_slices, k) 64-bit scratch, and arrived: one int per rig and
// center group (8 centers, 4 when k > 4), 0 before the call and after it;
// calls that share them must follow each other on one stream.
extern "C" int gv_knn_median_depth(const float* uvd, const uint8_t* valid,
                                   const float* centers, int n_rigs, int p,
                                   int d, int k, int n_slices, int slice_len,
                                   unsigned long long* cand, int* arrived,
                                   float* out, cudaStream_t stream) {
  if (n_rigs > 65535 || n_slices < 1 || slice_len < 1 ||
      (int64_t)n_slices * slice_len < p ||
      (int64_t)n_rigs * d > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  if (d <= 0 || n_rigs <= 0) return 0;
  switch (k) {
#define GV_KNN_CASE(K)                                                     \
  case K:                                                                  \
    return (int)launch<K>(uvd, valid, centers, n_rigs, p, d, n_slices,     \
                          slice_len, cand, arrived, out, stream);
    GV_KNN_CASE(1)
    GV_KNN_CASE(2)
    GV_KNN_CASE(3)
    GV_KNN_CASE(4)
    GV_KNN_CASE(5)
    GV_KNN_CASE(6)
    GV_KNN_CASE(7)
    GV_KNN_CASE(8)
#undef GV_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
