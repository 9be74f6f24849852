// Device code shared by the two grid-update kernels for Hopper (sm_90a):
// csrc/cuda_grid.cu (decay + footprint hits) and csrc/cuda_raycast.cu (the
// same with the raycast carve in front).
//
// Layout. Grids are (R, H, W) f32, indexed flat per rig: the rig is a
// block's y index, and a block owns GV_GRID_CELLS_PER_BLOCK consecutive
// cells of it. The cells move in items of N: N = 4 is one 16-byte vector
// (float4 / int4 loads and stores), taken when H * W % 4 == 0 and every
// pointer is 16-byte aligned; N = 1 is the scalar path for any other grid.
// An item may straddle a row, so each cell computes its own row and column.
// Thread t of a block owns items t, t + T, t + 2T, ... (T threads), so a
// warp's loads are consecutive; it issues the loads of all its items before
// its first store, and before the barrier that ends the staging: 32 bytes of
// log-odds a thread in flight (the carve adds 64 of maps), 40 KB an SM at
// five blocks (the carve 96 KB at four). 8 cells a thread: for the grid
// kernel on an H100, 16 and 32 were 1.3 and 2.8 us slower at 64 rigs and
// 1.7 and 4.7 us slower for one rig (fewer blocks, fewer SMs);
// cache-streaming loads and stores gained nothing.
//
// Box ranges. A rig's <= 64 inclusive [row_lo, row_hi, col_lo, col_hi]
// ranges are staged once a block, compacted to those that are non-empty and
// meet the block's rows. A left-out range adds only 0.0f terms to every cell
// of the block, and the count is a sum of 1.0f and 0.0f (an exact small
// integer, here summed as an int), so the compaction is exact. Leaving out
// the ranges that miss the block's rows saved 0.9 us (grid) and 2.4 us
// (carve) at 64 rigs with 8 ranges a rig on an H100.
//
// Epilogue. The run gate (quirk Q1: a rig with neither image nor cloud is
// not updated, not even decayed) and the nav_msgs int8 export are fused in:
// for a gated-off rig the block copies its log-odds and its previous
// occupancy (the only case that reads it) and exports the latter; the branch
// is uniform per block. The export is (int8) rint(min(max(occ, 0), 1) * 100)
// with round-half-to-even (rintf in the default rounding mode), as
// torch.round and jnp.round do.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define GV_GRID_MAX_BOXES 64
#define GV_GRID_THREADS 256
#define GV_GRID_CELLS_PER_THREAD 8      // CELLS_PER_THREAD, ops/cuda_grid.py
#define GV_GRID_CELLS_PER_BLOCK (GV_GRID_THREADS * GV_GRID_CELLS_PER_THREAD)

namespace gv_grid {

template <int N>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load(const int32_t* __restrict__ p,
                                     int (&x)[N]) {
  if constexpr (N == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// nav_msgs/OccupancyGrid export of one probability: int8 in [0, 100].
__device__ __forceinline__ uint32_t export_i8(float occ) {
  return (uint32_t)(int)rintf(
             __fmul_rn(fminf(fmaxf(occ, 0.0f), 1.0f), 100.0f)) & 0xffu;
}

template <int N>
__device__ __forceinline__ void store_i8(int8_t* __restrict__ p,
                                         const float (&occ)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) =
        export_i8(occ[0]) | (export_i8(occ[1]) << 8) |
        (export_i8(occ[2]) << 16) | (export_i8(occ[3]) << 24);
  } else {
    *p = (int8_t)export_i8(occ[0]);
  }
}

// The clamp, then 1 / (1 + expf(-x)) in IEEE precision (the library is
// built without --use_fast_math).
__device__ __forceinline__ float clamp(float x, float lo_min, float lo_max) {
  return fminf(fmaxf(x, lo_min), lo_max);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Stage the rig's non-empty ranges that meet rows [row_lo, row_hi] into r
// (in their order: warp 0 compacts with a ballot) and return their number.
// Ends with the block's barrier: every thread must call it.
__device__ __forceinline__ int stage_ranges(const int32_t* __restrict__ ranges,
                                            int n_boxes, int row_lo,
                                            int row_hi, int4* r, int* n_live) {
  if (threadIdx.x < 32) {
    const unsigned lane = threadIdx.x;
    int base = 0;
    for (int k = 0; k < n_boxes; k += 32) {     // n_boxes: uniform
      const int d = k + (int)lane;
      int4 b = make_int4(1, 0, 1, 0);
      if (d < n_boxes) {
        b = make_int4(ranges[4 * d], ranges[4 * d + 1], ranges[4 * d + 2],
                      ranges[4 * d + 3]);
      }
      const bool live = d < n_boxes && b.x <= b.y && b.z <= b.w &&
                        b.x <= row_hi && b.y >= row_lo;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) r[base + __popc(m & ((1u << lane) - 1u))] = b;
      base += __popc(m);
    }
    if (lane == 0) *n_live = base;
  }
  __syncthreads();
  return *n_live;
}

// Row and column of N consecutive cells starting at flat index c (a rig's
// cells fit an int: the host entry points check it).
template <int N>
__device__ __forceinline__ void rows_cols(int c, int w, int (&row)[N],
                                          int (&col)[N]) {
  row[0] = c / w;
  col[0] = c - row[0] * w;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const bool wrap = col[j - 1] + 1 == w;
    row[j] = row[j - 1] + (wrap ? 1 : 0);
    col[j] = wrap ? 0 : col[j - 1] + 1;
  }
}

// Number of staged ranges covering each of N cells, as f32.
template <int N>
__device__ __forceinline__ void counts(const int4* r, int n,
                                       const int (&row)[N],
                                       const int (&col)[N], float (&cnt)[N]) {
  int c[N];
#pragma unroll
  for (int j = 0; j < N; ++j) c[j] = 0;
  for (int d = 0; d < n; ++d) {
    const int4 b = r[d];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c[j] += (row[j] >= b.x) & (row[j] <= b.y) & (col[j] >= b.z) &
              (col[j] <= b.w);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) cnt[j] = (float)c[j];
}

// The gated-off rig: log-odds and occupancy kept, the occupancy exported.
// lo holds the items' log-odds already loaded; items at or past n_items are
// masked.
template <int N, int ITEMS>
__device__ __forceinline__ void keep(const float (&lo)[ITEMS][N],
                                     const float* __restrict__ occ_prev,
                                     float* __restrict__ lo_out,
                                     float* __restrict__ occ_out,
                                     int8_t* __restrict__ i8_out, int first,
                                     int n_items) {
  float p[ITEMS][N];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + i * GV_GRID_THREADS;
    if (it < n_items) load<N>(occ_prev + it * N, p[i]);
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + i * GV_GRID_THREADS;
    if (it < n_items) {
      store<N>(lo_out + it * N, lo[i]);
      store<N>(occ_out + it * N, p[i]);
      if (i8_out != nullptr) store_i8<N>(i8_out + it * N, p[i]);
    }
  }
}

// The writes of an updated item: log-odds, occupancy, and the export when
// asked for.
template <int N>
__device__ __forceinline__ void finish(float (&x)[N], float lo_min,
                                       float lo_max,
                                       float* __restrict__ lo_out,
                                       float* __restrict__ occ_out,
                                       int8_t* __restrict__ i8_out) {
  float occ[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = clamp(x[j], lo_min, lo_max);
    occ[j] = sigmoid(x[j]);
  }
  store<N>(lo_out, x);
  store<N>(occ_out, occ);
  if (i8_out != nullptr) store_i8<N>(i8_out, occ);
}

// 16-byte alignment of a pointer (null counts as aligned).
inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

}  // namespace gv_grid
