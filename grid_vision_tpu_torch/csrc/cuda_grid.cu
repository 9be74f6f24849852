// Fused occupancy-grid update for Hopper (sm_90a).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_grid.py
// (lshape_update_pallas -> _grid_kernel, which the fleet path runs under
// vmap): one pass over the log-odds grids of R rigs that decays, adds
// log_odds_hit times the number of the rig's pose footprints covering the
// cell, clamps, and writes both log-odds and occupancy.
//
// Bound on this card: bytes. Per rig the (500, 200) grid is 400 KB read
// and 800 KB written; eight boxes of index ranges are nothing. A single
// rig is well under a microsecond of HBM time, so the launch bounds it; a
// fleet of 64 rigs moves ~77 MB (~23 us). Design: one launch per fleet
// tick, the rig on blockIdx.y; one thread per cell, coalesced along the
// row, the rig's <= 64 box ranges staged once per block in shared memory.
// No tiling is needed; the Pallas (128, W) blocks existed only for VMEM.
//
// Bit-equality with the plain torch twin (grid_vision_tpu_torch/ops/
// cuda_grid.py) and with the JAX package, whose XLA build contracts the
// hit add into a fused multiply-add: the count is summed over boxes first,
// then fma(hit, count, lo + decay) with one rounding (__fadd_rn keeps the
// decay add on its own), then the clamp, then 1 / (1 + expf(-x)) in IEEE
// precision. The library is built without --use_fast_math.

#include <cuda_runtime.h>
#include <cstdint>

#define GV_GRID_MAX_BOXES 64

__global__ void gv_grid_update_kernel(const float* __restrict__ lo_in,
                                      float* __restrict__ lo_out,
                                      float* __restrict__ occ_out,
                                      const int32_t* __restrict__ ranges,
                                      int n_boxes, int h, int w,
                                      float decay, float hit,
                                      float lo_min, float lo_max) {
  // ranges: (R, n_boxes, 4) inclusive [row_lo, row_hi, col_lo, col_hi];
  // skipped boxes carry an empty range (lo > hi). Grids: (R, h, w).
  __shared__ int32_t r[4 * GV_GRID_MAX_BOXES];
  const int rig = blockIdx.y;
  const int32_t* rig_ranges = ranges + (int64_t)rig * 4 * n_boxes;
  for (int t = threadIdx.x; t < 4 * n_boxes; t += blockDim.x) {
    r[t] = rig_ranges[t];
  }
  __syncthreads();
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= (int64_t)h * w) return;
  const int row = (int)(cell / w);
  const int col = (int)(cell - (int64_t)row * w);
  const int64_t idx = (int64_t)rig * h * w + cell;
  float cnt = 0.0f;
  for (int d = 0; d < n_boxes; ++d) {
    const bool in_box = row >= r[4 * d] && row <= r[4 * d + 1] &&
                        col >= r[4 * d + 2] && col <= r[4 * d + 3];
    cnt = __fadd_rn(cnt, in_box ? 1.0f : 0.0f);
  }
  float x = __fmaf_rn(hit, cnt, __fadd_rn(lo_in[idx], decay));
  x = fminf(fmaxf(x, lo_min), lo_max);
  lo_out[idx] = x;
  occ_out[idx] = 1.0f / (1.0f + expf(-x));
}

extern "C" int gv_grid_update(const float* lo_in, float* lo_out,
                              float* occ_out, const int32_t* ranges,
                              int n_rigs, int n_boxes, int h, int w,
                              float decay, float hit, float lo_min,
                              float lo_max, cudaStream_t stream) {
  if (n_boxes < 0 || n_boxes > GV_GRID_MAX_BOXES || n_rigs > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rigs <= 0) return 0;
  const int threads = 256;
  const int64_t cells = (int64_t)h * w;
  const dim3 blocks((unsigned)((cells + threads - 1) / threads), n_rigs);
  gv_grid_update_kernel<<<blocks, threads, 0, stream>>>(
      lo_in, lo_out, occ_out, ranges, n_boxes, h, w, decay, hit, lo_min,
      lo_max);
  return (int)cudaGetLastError();
}
