// Fused occupancy-grid update for Hopper (sm_90a).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_grid.py
// (lshape_update_pallas -> _grid_kernel, which the fleet path runs under
// vmap): one pass over the log-odds grids of R rigs that decays, adds
// log_odds_hit times the number of the rig's pose footprints covering the
// cell, clamps, and writes log-odds and occupancy; with the epilogue on, it
// also applies the run gate and writes the int8 export (csrc/gv_grid.cuh).
//
// Bound on this card: bytes. Per cell the pass reads 4 bytes and writes 9
// (log-odds, occupancy, int8); a fleet of 64 rigs on (500, 200) grids moves
// 83 MB (~25 us at 3.35 TB/s); the box ranges are nothing. A single rig is
// well under a microsecond of HBM time, so the launch bounds it. The first
// design moved one 4-byte cell a thread, ~8 KB in flight an SM, about half
// the rate the card needs to hold; this one moves 16-byte vectors, two a
// thread with all loads issued before the first store (gv_grid.cuh), and
// takes into the same pass the run gate and the export that eager torch ran
// as six more elementwise launches over the grids. One launch per tick, the
// rig on blockIdx.y; the Pallas (128, W) blocks existed only for VMEM.
//
// Bit-equality with the plain torch twin (grid_vision_tpu_torch/ops/
// cuda_grid.py) and with the JAX package, whose XLA build contracts the
// hit add into a fused multiply-add: the count is summed over boxes first,
// then fma(hit, count, lo + decay) with one rounding (__fadd_rn keeps the
// decay add on its own), then the clamp, then 1 / (1 + expf(-x)) in IEEE
// precision. The library is built without --use_fast_math.

#include "gv_grid.cuh"

template <int N>
__global__ void __launch_bounds__(GV_GRID_THREADS)
    gv_grid_update_kernel(const float* __restrict__ lo_in,
                          float* __restrict__ lo_out,
                          float* __restrict__ occ_out,
                          int8_t* __restrict__ i8_out,
                          const uint8_t* __restrict__ gate,
                          const float* __restrict__ occ_prev,
                          const int32_t* __restrict__ ranges, int n_boxes,
                          int h, int w, float decay, float hit, float lo_min,
                          float lo_max) {
  // ranges: (R, n_boxes, 4); grids (R, h, w); gate (R,) or null (all on);
  // occ_prev read only for gated-off rigs; i8_out null: no export.
  constexpr int ITEMS = GV_GRID_CELLS_PER_THREAD / N;
  __shared__ int4 r[GV_GRID_MAX_BOXES];
  __shared__ int n_live;
  const int rig = blockIdx.y;
  const int cells = h * w;
  const int n_items = cells / N;
  const int64_t off = (int64_t)rig * cells;
  const int block_first = blockIdx.x * GV_GRID_THREADS * ITEMS;
  const int first = block_first + threadIdx.x;
  lo_in += off;
  lo_out += off;
  occ_out += off;
  if (i8_out != nullptr) i8_out += off;
  float lo[ITEMS][N];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + i * GV_GRID_THREADS;
    if (it < n_items) gv_grid::load<N>(lo_in + it * N, lo[i]);
  }
  if (gate != nullptr && gate[rig] == 0) {
    gv_grid::keep<N, ITEMS>(lo, occ_prev + off, lo_out, occ_out, i8_out,
                            first, n_items);
    return;
  }
  const int block_last =
      min(block_first + GV_GRID_THREADS * ITEMS, n_items) * N - 1;
  const int n = gv_grid::stage_ranges(
      ranges + (int64_t)rig * 4 * n_boxes, n_boxes,
      block_first * N / w, block_last / w, r, &n_live);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + i * GV_GRID_THREADS;
    if (it < n_items) {
      int row[N], col[N];
      float cnt[N], x[N];
      gv_grid::rows_cols<N>(it * N, w, row, col);
      gv_grid::counts<N>(r, n, row, col, cnt);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        x[j] = __fmaf_rn(hit, cnt[j], __fadd_rn(lo[i][j], decay));
      }
      gv_grid::finish<N>(x, lo_min, lo_max, lo_out + it * N,
                         occ_out + it * N,
                         i8_out == nullptr ? nullptr : i8_out + it * N);
    }
  }
}

extern "C" int gv_grid_update(const float* lo_in, float* lo_out,
                              float* occ_out, int8_t* i8_out,
                              const uint8_t* gate, const float* occ_prev,
                              const int32_t* ranges, int n_rigs, int n_boxes,
                              int h, int w, float decay, float hit,
                              float lo_min, float lo_max,
                              cudaStream_t stream) {
  if (n_boxes < 0 || n_boxes > GV_GRID_MAX_BOXES || n_rigs > 65535 ||
      h <= 0 || w <= 0 || (int64_t)h * w > INT32_MAX ||
      (gate != nullptr && occ_prev == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rigs <= 0) return 0;
  const int cells = h * w;
  const dim3 blocks(
      (unsigned)((cells + GV_GRID_CELLS_PER_BLOCK - 1) /
                 GV_GRID_CELLS_PER_BLOCK),
      n_rigs);
  const bool vec = cells % 4 == 0 && gv_grid::aligned16(lo_in) &&
                   gv_grid::aligned16(lo_out) && gv_grid::aligned16(occ_out) &&
                   gv_grid::aligned16(occ_prev) &&
                   ((uintptr_t)i8_out & 3u) == 0;
  if (vec) {
    gv_grid_update_kernel<4><<<blocks, GV_GRID_THREADS, 0, stream>>>(
        lo_in, lo_out, occ_out, i8_out, gate, occ_prev, ranges, n_boxes, h,
        w, decay, hit, lo_min, lo_max);
  } else {
    gv_grid_update_kernel<1><<<blocks, GV_GRID_THREADS, 0, stream>>>(
        lo_in, lo_out, occ_out, i8_out, gate, occ_prev, ranges, n_boxes, h,
        w, decay, hit, lo_min, lo_max);
  }
  return (int)cudaGetLastError();
}

// What the card gives the kernel (for the build report): blocks an SM of
// the vector and of the scalar path.
extern "C" int gv_grid_blocks_per_sm(int* blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], gv_grid_update_kernel<4>, GV_GRID_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[1], gv_grid_update_kernel<1>, GV_GRID_THREADS, 0);
}
