// The orientation net's front end for Hopper (sm_90a): for each crop of
// the fleet-compacted batch, its rig's frame -> bilinear crop-resize to
// S x S -> per-crop per-channel standardization (quirk Q10) -> the folded
// s2d stem conv (12x12, stride 8, 3 -> F) + BN + relu, giving the
// (N, S/8, S/8, F) NHWC activation OrientationNetS2D takes with
// stem_external=True.
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_orient.py
// (orient_front_pallas -> _orient_kernel). Its phase-permuted sample
// vectors, iota-mask weight matrices and padded im2col planes work around
// Mosaic (no strided slices, no safe minor-dim reshapes); none of that is
// carried over: the crop is sampled directly, the conv reads it directly.
//
// Bound on this card: FP32 operations. At S = 224, F = 128 the conv is
// ~87 MFLOP a crop (28 x 28 outputs x 128 channels x 432 taps x 2), ~28
// GFLOP for 320 crops (~0.4 ms); the frames the crops read are at most
// ~240 MB once (~0.07 ms of HBM time), the crops themselves ~0.6 MB each.
// Design, two launches:
//   1. one block per crop: reads the crop's rig index, samples the S x S
//      crop straight from that rig's frame with the per-axis (lo, hi,
//      frac) triplets the host computed (preprocess.box_axis_samples, the
//      same positions as the plain twin), writes it to a scratch the
//      wrapper allocates (L2-resident), and reduces the per-channel mean
//      and then the variance around it (two passes, as the twin);
//   2. the conv: one thread per output pixel and 16 output channels, the
//      432 x 16 weight slice in shared memory (float4 broadcasts). Each
//      input is standardized on load, (x - mean) * inv: center first, then
//      scale, because the other order cancels catastrophically on flat
//      crops (pallas_orient.py:35-40). Taps in the SAME padding, which on
//      the 4-pixel block grid is (0, 4) pixels at S = 224, read zero.
// An invalid crop is an all-zero standardized input: it gets exactly
// relu(t), and launch 1 skips it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kGroup = 16;                    // output channels per thread
constexpr int kTaps = 12 * 12 * 3;            // 12x12 kernel, 3 channels
constexpr int kStride = 8;

// Block-wide sum of three values (blockDim.x a multiple of 32, <= 1024);
// every thread gets the totals.
__device__ __forceinline__ void block_sum3(float v[3]) {
  __shared__ float part[32][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      v[c] += __shfl_xor_sync(0xFFFFFFFFu, v[c], off);
    }
  }
  if (lane == 0) {
    part[warp][0] = v[0];
    part[warp][1] = v[1];
    part[warp][2] = v[2];
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float t = 0.0f;
    for (int i = 0; i < n_warps; ++i) t += part[i][c];
    v[c] = t;
  }
  __syncthreads();                            // part is reused by a caller
}

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

__global__ void gv_orient_crop_kernel(
    const float* __restrict__ images, int h, int w,
    const int32_t* __restrict__ rig, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ ylo, const int32_t* __restrict__ yhi,
    const float* __restrict__ yfr, const int32_t* __restrict__ xlo,
    const int32_t* __restrict__ xhi, const float* __restrict__ xfr, int size,
    float* __restrict__ crops, float* __restrict__ stats) {
  const int n = blockIdx.x;
  if (!valid[n]) return;                      // uniform over the block
  const float* frame = images + (int64_t)rig[n] * h * w * 3;
  float* crop = crops + (int64_t)n * size * size * 3;
  const int64_t row0 = (int64_t)n * size;
  const int npix = size * size;

  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / size;
    const int j = p - i * size;
    const int y0 = ylo[row0 + i], y1 = yhi[row0 + i];
    const int x0 = xlo[row0 + j], x1 = xhi[row0 + j];
    float wy1, wx1;
    const float wy0 = lerp_weight_pair(yfr[row0 + i], y0 == y1, &wy1);
    const float wx0 = lerp_weight_pair(xfr[row0 + j], x0 == x1, &wx1);
    const float* r0 = frame + (int64_t)y0 * w * 3;
    const float* r1 = frame + (int64_t)y1 * w * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // along x first, then y: the order of the twin's einsums
      const float t0 = wx0 * r0[x0 * 3 + c] + wx1 * r0[x1 * 3 + c];
      const float t1 = wx0 * r1[x0 * 3 + c] + wx1 * r1[x1 * 3 + c];
      const float v = wy0 * t0 + wy1 * t1;
      crop[p * 3 + c] = v;
      sum[c] += v;
    }
  }
  block_sum3(sum);
  const float mean[3] = {sum[0] / npix, sum[1] / npix, sum[2] / npix};
  float sq[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = crop[p * 3 + c] - mean[c];  // this thread's writes
      sq[c] += d * d;
    }
  }
  block_sum3(sq);
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    stats[n * 6 + c] = mean[c];
    stats[n * 6 + 3 + c] = 1.0f / fmaxf(sqrtf(sq[c] / npix), 1e-6f);
  }
}

__global__ void gv_orient_conv_kernel(
    const float* __restrict__ crops, const float* __restrict__ stats,
    const uint8_t* __restrict__ valid, int size, int q, int pad,
    const float* __restrict__ wmat, int f, const float* __restrict__ scale,
    const float* __restrict__ shift, float* __restrict__ out) {
  __shared__ __align__(16) float sw[kTaps * kGroup];
  __shared__ float ss[kGroup], sb[kGroup];
  const int n = blockIdx.z;
  const int g0 = blockIdx.y * kGroup;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  float4* dst = reinterpret_cast<float4*>(
      out + (((int64_t)n * q * q) + pix) * f + g0);
  if (!valid[n]) {                            // uniform over the block
    if (pix < q * q) {
#pragma unroll
      for (int c4 = 0; c4 < kGroup / 4; ++c4) {
        const float* t = shift + g0 + 4 * c4;
        dst[c4] = make_float4(fmaxf(t[0], 0.0f), fmaxf(t[1], 0.0f),
                              fmaxf(t[2], 0.0f), fmaxf(t[3], 0.0f));
      }
    }
    return;
  }
  for (int t = threadIdx.x; t < kTaps * kGroup; t += blockDim.x) {
    sw[t] = wmat[(t / kGroup) * f + g0 + t % kGroup];
  }
  if (threadIdx.x < kGroup) {
    ss[threadIdx.x] = scale[g0 + threadIdx.x];
    sb[threadIdx.x] = shift[g0 + threadIdx.x];
  }
  __syncthreads();
  if (pix >= q * q) return;
  const int oy = pix / q;
  const int ox = pix - oy * q;
  const float* crop = crops + (int64_t)n * size * size * 3;
  const float mean[3] = {stats[n * 6], stats[n * 6 + 1], stats[n * 6 + 2]};
  const float inv[3] = {stats[n * 6 + 3], stats[n * 6 + 4],
                        stats[n * 6 + 5]};

  float acc[kGroup];
#pragma unroll
  for (int co = 0; co < kGroup; ++co) acc[co] = 0.0f;
  for (int uy = 0; uy < 12; ++uy) {
    const int r = oy * kStride + uy - pad;
    if (r < 0 || r >= size) continue;         // SAME zero pad
    for (int ux = 0; ux < 12; ++ux) {
      const int s = ox * kStride + ux - pad;
      if (s < 0 || s >= size) continue;
      const float* px = crop + ((int64_t)r * size + s) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = (__ldg(px + c) - mean[c]) * inv[c];
        const float4* wr = reinterpret_cast<const float4*>(
            sw + ((uy * 12 + ux) * 3 + c) * kGroup);
#pragma unroll
        for (int c4 = 0; c4 < kGroup / 4; ++c4) {
          const float4 wv = wr[c4];
          acc[4 * c4] += wv.x * x;
          acc[4 * c4 + 1] += wv.y * x;
          acc[4 * c4 + 2] += wv.z * x;
          acc[4 * c4 + 3] += wv.w * x;
        }
      }
    }
  }
#pragma unroll
  for (int c4 = 0; c4 < kGroup / 4; ++c4) {
    dst[c4] = make_float4(
        fmaxf(acc[4 * c4] * ss[4 * c4] + sb[4 * c4], 0.0f),
        fmaxf(acc[4 * c4 + 1] * ss[4 * c4 + 1] + sb[4 * c4 + 1], 0.0f),
        fmaxf(acc[4 * c4 + 2] * ss[4 * c4 + 2] + sb[4 * c4 + 2], 0.0f),
        fmaxf(acc[4 * c4 + 3] * ss[4 * c4 + 3] + sb[4 * c4 + 3], 0.0f));
  }
}

}  // namespace

// images: (R, h, w, 3); rig / valid: (n,); ylo, yhi, yfr, xlo, xhi, xfr:
// (n, size); crops: (n, size, size, 3) and stats: (n, 6) scratch; wmat:
// (432, f) in ((uy * 12 + ux) * 3 + c) row order; scale / shift: (f,);
// out: (n, q, q, f).
extern "C" int gv_orient_front(
    const float* images, int h, int w, const int32_t* rig,
    const uint8_t* valid, const int32_t* ylo, const int32_t* yhi,
    const float* yfr, const int32_t* xlo, const int32_t* xhi,
    const float* xfr, int n, int size, int q, int pad, const float* wmat,
    int f, const float* scale, const float* shift, float* crops,
    float* stats, float* out, cudaStream_t stream) {
  if (f % kGroup != 0 || n > 65535) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  gv_orient_crop_kernel<<<n, 256, 0, stream>>>(images, h, w, rig, valid, ylo,
                                               yhi, yfr, xlo, xhi, xfr, size,
                                               crops, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const dim3 grid((q * q + threads - 1) / threads, f / kGroup, n);
  gv_orient_conv_kernel<<<grid, threads, 0, stream>>>(
      crops, stats, valid, size, q, pad, wmat, f, scale, shift, out);
  return (int)cudaGetLastError();
}
