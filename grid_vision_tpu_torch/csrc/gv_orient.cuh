// The crop geometry of the orientation front's kernels (cuda_orient.cu,
// the f32 form; cuda_orient_bf16.cu, the bf16 form): a box's sample
// positions along each axis, computed with the plain twin's f32 operations
// in the twin's order (preprocess.box_axis_samples), and the bilinear
// weights of a sample's two taps.

#pragma once

#include <cuda_runtime.h>

namespace gv {

__device__ __forceinline__ float lerp_weight_pair(float frac, bool same,
                                                  float* w_hi) {
  // (1 - frac) at lo and frac at hi, merged onto one tap when lo == hi
  // (the plain twin's interpolation-weight matrices sum both there).
  const float w_lo = 1.0f - frac;
  if (same) {
    *w_hi = 0.0f;
    return w_lo + frac;
  }
  *w_hi = frac;
  return w_lo;
}

// preprocess._bilinear_sample_axis for output index i: the half-pixel
// position start + (i + 0.5) * (extent / n_out) - 0.5 clamped to the crop,
// every operation rounded on its own as torch's elementwise ops are (the
// compiler would contract the multiply-add and move a position by an ulp
// across a pixel edge).
__device__ __forceinline__ void axis_sample(int length, float start,
                                            float extent, int n_out, int i,
                                            int* lo, int* hi, float* frac) {
  const float step = __fdiv_rn(extent, (float)n_out);
  float pos = __fsub_rn(
      __fadd_rn(start, __fmul_rn(__fadd_rn((float)i, 0.5f), step)), 0.5f);
  pos = fminf(fmaxf(pos, start), __fsub_rn(__fadd_rn(start, extent), 1.0f));
  const float fl = floorf(pos);
  *frac = __fsub_rn(pos, fl);
  const int l = min(max((int)fl, 0), length - 1);
  *lo = l;
  *hi = min(l + 1, length - 1);
}

// preprocess.box_axis_samples for one box: corners truncated toward zero
// and clamped to the image, the max column excluded, extents >= 1.
struct BoxAxes {
  float x_start, x_extent, y_start, y_extent;
};

__device__ __forceinline__ BoxAxes box_axes(const float* __restrict__ box,
                                            int h, int w) {
  const int xmin = max(__float2int_rz(box[0]), 0);
  const int ymin = max(__float2int_rz(box[1]), 0);
  const int xmax = min(__float2int_rz(box[2]), w - 1);
  const int ymax = min(__float2int_rz(box[3]), h - 1);
  BoxAxes a;
  a.x_start = (float)xmin;
  a.y_start = (float)ymin;
  a.x_extent = (float)max(xmax - xmin, 1);
  a.y_extent = (float)max(ymax - ymin, 1);
  return a;
}

// The (lo, hi, frac) tables of one box, `size` entries an axis, into
// ylo | yhi | xlo | xhi (int) and yfr | xfr (float).
__device__ __forceinline__ void fill_tables(const float* __restrict__ box,
                                            int h, int w, int size, int* ylo,
                                            int* yhi, float* yfr, int* xlo,
                                            int* xhi, float* xfr) {
  const BoxAxes a = box_axes(box, h, w);
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    axis_sample(h, a.y_start, a.y_extent, size, i, ylo + i, yhi + i,
                yfr + i);
    axis_sample(w, a.x_start, a.x_extent, size, i, xlo + i, xhi + i,
                xfr + i);
  }
}

}  // namespace gv
