// Fused raycast carve + occupancy-grid update for Hopper (sm_90a).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_raycast.py
// (fused_carve_update / lshape_update_with_carving_pallas ->
// _carve_grid_kernel): one pass over the log-odds grids of R rigs that
// looks up each cell's measured beam range in the rig's polar range
// profile, carves free space where the cell lies strictly inside the beam,
// decays, adds log_odds_hit times the number of the rig's pose footprints
// covering the cell, clamps, and writes log-odds and occupancy; with the
// epilogue on, it also applies the run gate and writes the int8 export. It
// is csrc/cuda_grid.cu with the carve in front, and shares its layout, its
// box-range staging, its epilogue and its rounding (csrc/gv_grid.cuh).
//
// Bound on this card: bytes. Per cell the pass reads 4 bytes of log-odds
// and writes 9 (log-odds, occupancy, int8); the two per-cell maps (angle
// bin, centre range; 800 KB at (500, 200)) are shared by all rigs and count
// once per launch, the 4096-bin profile 16 KB a rig. A fleet of 64 rigs
// moves ~85 MB (~25 us at 3.35 TB/s); one rig ~2 MB, so the launch bounds
// it. Design: one launch per tick, the rig on blockIdx.y, 16-byte vectors
// (float4 log-odds and ranges, int4 bins), 8 cells a thread. A thread
// issues the loads of all its cells (log-odds and maps) before it stages
// the box ranges and before its first store; the ragged edge is masked,
// never returned from. The lookup is one indexed load of the rig's profile
// through L1 (__ldg): neighbouring cells read neighbouring bins, and a
// block touches only the bins its cells fall in. Staging the whole 16 KB
// profile in shared memory once a block instead (with the cell loads issued
// before the barrier that ends the staging) was 4.6 us slower at 64 rigs on
// an H100: 25 blocks a rig each copied the table. The Pallas kernel's
// factored one-hot matmul (and its n_bins == 64 * 64 rule), its (16, W)
// tiles and its padding to (512, 256) were the TPU's and are gone. Any
// n_bins up to GV_CARVE_MAX_BINS works. A bin index outside [0, n_bins)
// reads as range 0: never carved, never out of bounds.
//
// Bit-equality with the plain torch twin (grid_vision_tpu_torch/ops/
// cuda_raycast.py) and, given the same maps, with the JAX package's jitted
// carve_update_from_maps: the threshold is one f32 subtraction
// (cell_range - margin, __fsub_rn) compared strictly; lo + free * carve
// has an exact product, so one rounding (fma); then + decay on its own
// (__fadd_rn); then fma(hit, count, .) with one rounding; then the clamp;
// then 1 / (1 + expf(-x)) in IEEE precision. The library is built without
// --use_fast_math. The maps and the profile are inputs (torch computes
// them): atan2f / sqrtf here would not be bit-equal to torch's, and one
// ulp moves a cell across a bin edge.

#include "gv_grid.cuh"

#define GV_CARVE_MAX_BINS 8192            // MAX_BINS in ops/cuda_raycast.py

template <int N>
__global__ void __launch_bounds__(GV_GRID_THREADS)
    gv_carve_update_kernel(const float* __restrict__ lo_in,
                           float* __restrict__ lo_out,
                           float* __restrict__ occ_out,
                           int8_t* __restrict__ i8_out,
                           const uint8_t* __restrict__ gate,
                           const float* __restrict__ occ_prev,
                           const int32_t* __restrict__ box_ranges,
                           const float* __restrict__ profile,
                           const int32_t* __restrict__ cbin,
                           const float* __restrict__ cr, int n_boxes,
                           int n_bins, int h, int w, float decay, float hit,
                           float free_lo, float margin, float lo_min,
                           float lo_max) {
  // box_ranges: (R, n_boxes, 4); profile: (R, n_bins); cbin, cr: (h, w),
  // shared by the rigs; grids (R, h, w); gate (R,) or null (all on);
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
  int bin[ITEMS][N];
  float range[ITEMS][N];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int it = first + i * GV_GRID_THREADS;
    if (it < n_items) {
      gv_grid::load<N>(cbin + it * N, bin[i]);
      gv_grid::load<N>(cr + it * N, range[i]);
    }
  }
  const float* __restrict__ rig_profile = profile + (int64_t)rig * n_bins;
  const int block_last =
      min(block_first + GV_GRID_THREADS * ITEMS, n_items) * N - 1;
  const int n = gv_grid::stage_ranges(
      box_ranges + (int64_t)rig * 4 * n_boxes, n_boxes,
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
        const int b = bin[i][j];
        const bool in_table = b >= 0 && b < n_bins;
        const float cell_range = in_table ? __ldg(rig_profile + b) : 0.0f;
        const bool carve =
            range[i][j] < __fsub_rn(cell_range, margin) && cell_range > 0.0f;
        x[j] = __fmaf_rn(free_lo, carve ? 1.0f : 0.0f, lo[i][j]);
        x[j] = __fmaf_rn(hit, cnt[j], __fadd_rn(x[j], decay));
      }
      gv_grid::finish<N>(x, lo_min, lo_max, lo_out + it * N,
                         occ_out + it * N,
                         i8_out == nullptr ? nullptr : i8_out + it * N);
    }
  }
}

extern "C" int gv_carve_update(const float* lo_in, float* lo_out,
                               float* occ_out, int8_t* i8_out,
                               const uint8_t* gate, const float* occ_prev,
                               const int32_t* box_ranges,
                               const float* profile, const int32_t* cbin,
                               const float* cr, int n_rigs, int n_boxes,
                               int n_bins, int h, int w, float decay,
                               float hit, float free_lo, float margin,
                               float lo_min, float lo_max,
                               cudaStream_t stream) {
  if (n_boxes < 0 || n_boxes > GV_GRID_MAX_BOXES || n_rigs > 65535 ||
      n_bins <= 0 || n_bins > GV_CARVE_MAX_BINS || h <= 0 || w <= 0 ||
      (int64_t)h * w > INT32_MAX ||
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
                   gv_grid::aligned16(occ_prev) && gv_grid::aligned16(cbin) &&
                   gv_grid::aligned16(cr) && ((uintptr_t)i8_out & 3u) == 0;
  if (vec) {
    gv_carve_update_kernel<4><<<blocks, GV_GRID_THREADS, 0, stream>>>(
        lo_in, lo_out, occ_out, i8_out, gate, occ_prev, box_ranges, profile,
        cbin, cr, n_boxes, n_bins, h, w, decay, hit, free_lo, margin, lo_min,
        lo_max);
  } else {
    gv_carve_update_kernel<1><<<blocks, GV_GRID_THREADS, 0, stream>>>(
        lo_in, lo_out, occ_out, i8_out, gate, occ_prev, box_ranges, profile,
        cbin, cr, n_boxes, n_bins, h, w, decay, hit, free_lo, margin, lo_min,
        lo_max);
  }
  return (int)cudaGetLastError();
}
