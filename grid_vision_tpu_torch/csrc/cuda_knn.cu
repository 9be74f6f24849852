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
// merge key is (d2, index) packed into one 64-bit integer: d2 >= 0 orders
// like its IEEE bits, the index breaks ties.
//
// Bound on this card: launch. At the single-rig path's shapes (16384
// points, 64 centers) the call reads ~213 KB once and does ~7 FLOP per
// (center, point) pair, ~7.3 MFLOP in all: well under a microsecond of
// either HBM or FP32 time; a fleet of 64 rigs (8192 points, 16 centers
// each) is ~59 MFLOP and ~7 MB, still a few microseconds. Design: one
// launch per fleet tick, one block per (center, rig) with the rig on
// blockIdx.y; each thread keeps
// a sorted running top-k over a strided slice of the points in registers
// (the points stay in L2 across the 64 blocks); the block then merges the
// per-thread lists in k rounds of a warp-shuffle min over their heads.
// The distance is rounded op by op (__fmul_rn / __fadd_rn, no FMA) so the
// selected set equals the plain torch twin's on the same inputs.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned long long kEmpty = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <int K>
__global__ void gv_knn_kernel(const float* __restrict__ uvd,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ centers, int p,
                              int n_centers, float* __restrict__ out) {
  // Per rig (blockIdx.y): uvd (p, 3), valid (p,), centers (n_centers, 2),
  // out (n_centers,).
  const int rig = blockIdx.y;
  uvd += (int64_t)rig * p * 3;
  valid += (int64_t)rig * p;
  const int box = blockIdx.x;
  const int64_t slot = (int64_t)rig * n_centers + box;
  const float cx = centers[2 * slot];
  const float cy = centers[2 * slot + 1];

  unsigned long long best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kEmpty;

  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    if (!valid[i]) continue;                  // d2 = inf: never selected
    const float du = __fsub_rn(cx, uvd[3 * i]);
    const float dv = __fsub_rn(cy, uvd[3 * i + 1]);
    const float z = uvd[3 * i + 2];
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)),
                               __fmul_rn(z, z));
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)i;
    if (key < best[K - 1]) {
      best[K - 1] = key;
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (best[j] < best[j - 1]) {
          const unsigned long long t = best[j];
          best[j] = best[j - 1];
          best[j - 1] = t;
        }
      }
    }
  }

  __shared__ unsigned long long warp_best[32];
  __shared__ unsigned long long winner;
  __shared__ float depth_sel[K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  int n_found = 0;
  for (int r = 0; r < K; ++r) {
    const unsigned long long m = warp_min(best[0]);
    if (lane == 0) warp_best[warp] = m;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < n_warps ? warp_best[lane] : kEmpty;
      v = warp_min(v);
      if (lane == 0) winner = v;
    }
    __syncthreads();
    const unsigned long long win = winner;
    // d2 = +inf (bits 0x7f800000) would not be "found" either.
    if (win == kEmpty || (unsigned)(win >> 32) >= 0x7f800000u) break;
    if (best[0] == win) {                     // keys are unique
#pragma unroll
      for (int j = 0; j < K - 1; ++j) best[j] = best[j + 1];
      best[K - 1] = kEmpty;
      depth_sel[r] = uvd[3 * (unsigned)(win & 0xFFFFFFFFu) + 2];
    }
    ++n_found;
    __syncthreads();                          // warp_best / winner reuse
  }
  if (threadIdx.x == 0) {
    float d[K];
#pragma unroll
    for (int j = 0; j < K; ++j) d[j] = j < n_found ? depth_sel[j] : 0.0f;
    for (int a = 1; a < n_found; ++a) {       // insertion sort, n <= K
      const float v = d[a];
      int b = a - 1;
      while (b >= 0 && d[b] > v) {
        d[b + 1] = d[b];
        --b;
      }
      d[b + 1] = v;
    }
    float med = -1.0f;
    for (int j = 0; j < K; ++j) {
      if (n_found > 0 && j == n_found / 2) med = d[j];
    }
    out[slot] = med;
  }
}

}  // namespace

extern "C" int gv_knn_median_depth(const float* uvd, const uint8_t* valid,
                                   const float* centers, int n_rigs, int p,
                                   int d, int k, float* out,
                                   cudaStream_t stream) {
  if (n_rigs > 65535) return (int)cudaErrorInvalidValue;
  if (d <= 0 || n_rigs <= 0) return 0;
  const int threads = 256;
  const dim3 grid(d, n_rigs);
  switch (k) {
#define GV_KNN_CASE(K)                                                   \
  case K:                                                                \
    gv_knn_kernel<K><<<grid, threads, 0, stream>>>(uvd, valid, centers,  \
                                                   p, d, out);           \
    break;
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
  return (int)cudaGetLastError();
}
