// Fused raycast carve + occupancy-grid update for Hopper (sm_90a).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_raycast.py
// (fused_carve_update / lshape_update_with_carving_pallas ->
// _carve_grid_kernel): one pass over the log-odds grids of R rigs that
// looks up each cell's measured beam range in the rig's polar range
// profile, carves free space where the cell lies strictly inside the beam,
// decays, adds log_odds_hit times the number of the rig's pose footprints
// covering the cell, clamps, and writes both log-odds and occupancy. It is
// csrc/cuda_grid.cu with the carve in front, and shares its box-range
// staging and its rounding discipline.
//
// Bound on this card: bytes. Per rig the (500, 200) grid is 400 KB read
// and 800 KB written, the 4096-bin profile 16 KB; the two per-cell maps
// (angle bin, centre range; 800 KB) are shared by all rigs and count once
// per launch. One rig is about 2 MB, well under a microsecond of HBM time,
// so the launch bounds it; a fleet of 64 rigs moves ~79 MB (~23 us).
// Design: one launch per tick, the rig on blockIdx.y. A block stages its
// rig's profile (n_bins floats) and <= 64 box ranges in shared memory
// once, then walks GV_CARVE_CELLS_PER_THREAD strides of blockDim.x cells,
// so the 16 KB table costs 8 bytes a cell of L2 traffic instead of 64; the
// cell loads and stores are coalesced along the row. The lookup is one
// indexed shared-memory load: the Pallas kernel's factored one-hot matmul
// (and its n_bins == 64 * 64 rule), its (16, W) tiles and its padding to
// (512, 256) were the TPU's and are gone; the ragged edge is masked by the
// cell count. Any n_bins that fits the shared memory asked for at launch
// works (the wrapper bounds it). A bin index outside [0, n_bins) reads as
// range 0: never carved, never out of bounds.
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

#include <cuda_runtime.h>
#include <cstdint>

#define GV_CARVE_MAX_BOXES 64
#define GV_CARVE_THREADS 256
#define GV_CARVE_CELLS_PER_THREAD 8

__global__ void gv_carve_update_kernel(
    const float* __restrict__ lo_in, float* __restrict__ lo_out,
    float* __restrict__ occ_out, const int32_t* __restrict__ box_ranges,
    const float* __restrict__ profile, const int32_t* __restrict__ cbin,
    const float* __restrict__ cr, int n_boxes, int n_bins, int h, int w,
    float decay, float hit, float free_lo, float margin, float lo_min,
    float lo_max) {
  // box_ranges: (R, n_boxes, 4) inclusive [row_lo, row_hi, col_lo, col_hi],
  // skipped boxes carry an empty range (lo > hi). profile: (R, n_bins).
  // cbin, cr: (h, w), shared by the rigs. Grids: (R, h, w).
  extern __shared__ float table[];                    // n_bins floats
  __shared__ int32_t r[4 * GV_CARVE_MAX_BOXES];
  const int rig = blockIdx.y;
  const float* rig_profile = profile + (int64_t)rig * n_bins;
  for (int t = threadIdx.x; t < n_bins; t += blockDim.x) {
    table[t] = rig_profile[t];
  }
  const int32_t* rig_ranges = box_ranges + (int64_t)rig * 4 * n_boxes;
  for (int t = threadIdx.x; t < 4 * n_boxes; t += blockDim.x) {
    r[t] = rig_ranges[t];
  }
  __syncthreads();
  const int64_t cells = (int64_t)h * w;
  const int64_t base =
      (int64_t)blockIdx.x * blockDim.x * GV_CARVE_CELLS_PER_THREAD;
  for (int i = 0; i < GV_CARVE_CELLS_PER_THREAD; ++i) {
    const int64_t cell = base + (int64_t)i * blockDim.x + threadIdx.x;
    if (cell >= cells) return;
    const int row = (int)(cell / w);
    const int col = (int)(cell - (int64_t)row * w);
    const int64_t idx = (int64_t)rig * cells + cell;
    const int32_t b = cbin[cell];
    const float cell_range = (b >= 0 && b < n_bins) ? table[b] : 0.0f;
    const bool carve =
        cr[cell] < __fsub_rn(cell_range, margin) && cell_range > 0.0f;
    float x = __fmaf_rn(free_lo, carve ? 1.0f : 0.0f, lo_in[idx]);
    x = __fadd_rn(x, decay);
    float cnt = 0.0f;
    for (int d = 0; d < n_boxes; ++d) {
      const bool in_box = row >= r[4 * d] && row <= r[4 * d + 1] &&
                          col >= r[4 * d + 2] && col <= r[4 * d + 3];
      cnt = __fadd_rn(cnt, in_box ? 1.0f : 0.0f);
    }
    x = __fmaf_rn(hit, cnt, x);
    x = fminf(fmaxf(x, lo_min), lo_max);
    lo_out[idx] = x;
    occ_out[idx] = 1.0f / (1.0f + expf(-x));
  }
}

extern "C" int gv_carve_update(const float* lo_in, float* lo_out,
                               float* occ_out, const int32_t* box_ranges,
                               const float* profile, const int32_t* cbin,
                               const float* cr, int n_rigs, int n_boxes,
                               int n_bins, int h, int w, float decay,
                               float hit, float free_lo, float margin,
                               float lo_min, float lo_max,
                               cudaStream_t stream) {
  const size_t smem = (size_t)n_bins * sizeof(float);
  if (n_boxes < 0 || n_boxes > GV_CARVE_MAX_BOXES || n_rigs > 65535 ||
      n_bins <= 0 || smem > 32 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rigs <= 0) return 0;
  const int64_t cells = (int64_t)h * w;
  const int64_t per_block =
      (int64_t)GV_CARVE_THREADS * GV_CARVE_CELLS_PER_THREAD;
  const dim3 blocks((unsigned)((cells + per_block - 1) / per_block), n_rigs);
  gv_carve_update_kernel<<<blocks, GV_CARVE_THREADS, smem, stream>>>(
      lo_in, lo_out, occ_out, box_ranges, profile, cbin, cr, n_boxes, n_bins,
      h, w, decay, hit, free_lo, margin, lo_min, lo_max);
  return (int)cudaGetLastError();
}
