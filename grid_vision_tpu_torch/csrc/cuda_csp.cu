// The detector's first CSP stage for Hopper (sm_90a): ConvBN_2 (3x3,
// 64->64) + CSPBlock_0 (3x3 32->32 on channels [32:64), 3x3 32->32,
// 1x1 64->64 on concat[x2, x1], concat[x, x3]) + 2x2/s2 max pool, with
// folded BN and leaky 0.1: (B, H, W, 64) -> (B, H/2, W/2, 128), NHWC f32.
//
// Replaces both TPU kernels of grid_vision_tpu/ops/pallas_csp.py:
// detector_csp_pallas -> _csp_kernel ("pallas2") and detector_csp_flat ->
// _csp_flat_kernel ("pallas3"), two Mosaic layouts of one function. Their
// phase decomposition on the pool's stride-2 grid and block-diagonal
// packing exist for a 128-wide MXU; none of it is carried over.
//
// Bound on this card: FP32 operations. Per 104x104 frame the stage is
// ~1.28 GFLOP (ConvBN_2 0.80, the two 32->32 convs 0.40, the 1x1 0.09)
// against ~4.2 MB of compulsory traffic (2.8 MB in, 1.4 MB out): ~19 us of
// FP32 time against ~1.3 us of HBM time. Design, four launches per call,
// each one thread per output pixel with a group of 16 output channels in
// registers and that group's weight slice in shared memory (read as
// float4 broadcasts); the inputs come in as float4 loads of 32 or 64
// channels and stay in L1/L2 for the neighbouring taps:
//   1. ConvBN_2 -> y (B, H, W, 64) scratch;
//   2. CSP conv a on y[..., 32:64] -> x1, written to channels [32:64) of
//      an (B, H, W, 64) scratch;
//   3. CSP conv b on x1 -> x2, written to channels [0:32) of the same
//      scratch, which then holds concat[x2, x1] with no copy;
//   4. the 1x1 conv on that scratch, fused with both concats and the pool:
//      each thread evaluates x3 at the four pixels of its 2x2 window and
//      writes max(y) to channels [0:64) and max(x3) to [64:128).
// SAME padding of a 3x3 stride-1 conv is (1, 1). No tensor cores yet.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kGroup = 16;                    // output channels per thread

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

// acc[0:kGroup) += sum_c x[c] * wt[c * kGroup + co], x read as CIN / 4
// float4 loads, wt from shared memory.
template <int CIN>
__device__ __forceinline__ void accumulate(const float* __restrict__ x,
                                           const float* wt, float* acc) {
  const float4* px = reinterpret_cast<const float4*>(x);
#pragma unroll 4
  for (int q = 0; q < CIN / 4; ++q) {
    const float4 x4 = __ldg(px + q);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4* wr =
          reinterpret_cast<const float4*>(wt + (4 * q + e) * kGroup);
#pragma unroll
      for (int c4 = 0; c4 < kGroup / 4; ++c4) {
        const float4 wv = wr[c4];
        acc[4 * c4] += wv.x * xs[e];
        acc[4 * c4 + 1] += wv.y * xs[e];
        acc[4 * c4 + 2] += wv.z * xs[e];
        acc[4 * c4 + 3] += wv.w * xs[e];
      }
    }
  }
}

// 3x3 stride-1 SAME conv + BN + leaky. in: (B, h, w, in_stride), CIN
// channels from in_off; wts: (9 * CIN, cout) in (ty, tx, c) order; out:
// (B, h, w, out_stride), output channel co goes to out_off + co.
template <int CIN>
__global__ void gv_csp_conv3x3_kernel(const float* __restrict__ in,
                                      int in_stride, int in_off, int h, int w,
                                      const float* __restrict__ wts, int cout,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift,
                                      float* __restrict__ out, int out_stride,
                                      int out_off) {
  __shared__ __align__(16) float sw[9 * CIN * kGroup];
  __shared__ float ss[kGroup], sb[kGroup];
  const int g0 = blockIdx.y * kGroup;
  for (int t = threadIdx.x; t < 9 * CIN * kGroup; t += blockDim.x) {
    sw[t] = wts[(t / kGroup) * cout + g0 + t % kGroup];
  }
  if (threadIdx.x < kGroup) {
    ss[threadIdx.x] = scale[g0 + threadIdx.x];
    sb[threadIdx.x] = shift[g0 + threadIdx.x];
  }
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h * w) return;
  const int oy = pix / w;
  const int ox = pix - oy * w;
  const float* src = in + (int64_t)blockIdx.z * h * w * in_stride + in_off;

  float acc[kGroup];
#pragma unroll
  for (int co = 0; co < kGroup; ++co) acc[co] = 0.0f;
  for (int ty = 0; ty < 3; ++ty) {
    const int r = oy + ty - 1;
    if (r < 0 || r >= h) continue;            // SAME zero pad
    for (int tx = 0; tx < 3; ++tx) {
      const int s = ox + tx - 1;
      if (s < 0 || s >= w) continue;
      accumulate<CIN>(src + ((int64_t)r * w + s) * in_stride,
                      sw + (ty * 3 + tx) * CIN * kGroup, acc);
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      out + ((int64_t)blockIdx.z * h * w + pix) * out_stride + out_off + g0);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) {
    dst[q] = make_float4(leaky(acc[4 * q] * ss[4 * q] + sb[4 * q]),
                         leaky(acc[4 * q + 1] * ss[4 * q + 1] + sb[4 * q + 1]),
                         leaky(acc[4 * q + 2] * ss[4 * q + 2] + sb[4 * q + 2]),
                         leaky(acc[4 * q + 3] * ss[4 * q + 3] + sb[4 * q + 3]));
  }
}

// 1x1 conv (64 -> 64) on xcat = concat[x2, x1] + BN + leaky = x3, then the
// 2x2/s2 max pool of concat[y, x3]. One thread per pooled pixel; group
// blockIdx.y owns channels [g0, g0 + 16) of both y and x3.
__global__ void gv_csp_pool_kernel(const float* __restrict__ y,
                                   const float* __restrict__ xcat, int h,
                                   int w, const float* __restrict__ wc,
                                   const float* __restrict__ sc,
                                   const float* __restrict__ bc,
                                   float* __restrict__ out) {
  __shared__ __align__(16) float sw[64 * kGroup];
  __shared__ float ss[kGroup], sb[kGroup];
  const int g0 = blockIdx.y * kGroup;
  for (int t = threadIdx.x; t < 64 * kGroup; t += blockDim.x) {
    sw[t] = wc[(t / kGroup) * 64 + g0 + t % kGroup];
  }
  if (threadIdx.x < kGroup) {
    ss[threadIdx.x] = sc[g0 + threadIdx.x];
    sb[threadIdx.x] = bc[g0 + threadIdx.x];
  }
  __syncthreads();
  const int ho = h / 2;
  const int wo = w / 2;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= ho * wo) return;
  const int oy = pix / wo;
  const int ox = pix - oy * wo;
  const int64_t frame = (int64_t)blockIdx.z * h * w;

  float ymax[kGroup], xmax[kGroup];
#pragma unroll
  for (int co = 0; co < kGroup; ++co) {
    ymax[co] = xmax[co] = __int_as_float(0xff800000);      // -inf
  }
  for (int dy = 0; dy < 2; ++dy) {
    for (int dx = 0; dx < 2; ++dx) {
      const int64_t p = frame + (int64_t)(2 * oy + dy) * w + 2 * ox + dx;
      const float4* yv = reinterpret_cast<const float4*>(y + p * 64 + g0);
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q) {
        const float4 v = __ldg(yv + q);
        ymax[4 * q] = fmaxf(ymax[4 * q], v.x);
        ymax[4 * q + 1] = fmaxf(ymax[4 * q + 1], v.y);
        ymax[4 * q + 2] = fmaxf(ymax[4 * q + 2], v.z);
        ymax[4 * q + 3] = fmaxf(ymax[4 * q + 3], v.w);
      }
      float acc[kGroup];
#pragma unroll
      for (int co = 0; co < kGroup; ++co) acc[co] = 0.0f;
      accumulate<64>(xcat + p * 64, sw, acc);
#pragma unroll
      for (int co = 0; co < kGroup; ++co) {
        xmax[co] = fmaxf(xmax[co], leaky(acc[co] * ss[co] + sb[co]));
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      out + ((int64_t)blockIdx.z * ho * wo + pix) * 128 + g0);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) {
    dst[q] = make_float4(ymax[4 * q], ymax[4 * q + 1], ymax[4 * q + 2],
                         ymax[4 * q + 3]);
    dst[q + 64 / 4] = make_float4(xmax[4 * q], xmax[4 * q + 1],
                                  xmax[4 * q + 2], xmax[4 * q + 3]);
  }
}

}  // namespace

// x: (B, h, w, 64); y, xcat: (B, h, w, 64) scratch; out: (B, h/2, w/2, 128).
// w2: (576, 64), wa / wb: (288, 32), wc: (64, 64) as (in, out); s*/b*: the
// folded BN scale / shift of each conv.
extern "C" int gv_detector_csp(const float* x, int batch, int h, int w,
                               const float* w2, const float* s2,
                               const float* b2, const float* wa,
                               const float* sa, const float* ba,
                               const float* wb, const float* sb,
                               const float* bb, const float* wc,
                               const float* sc, const float* bc, float* y,
                               float* xcat, float* out, cudaStream_t stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((h * w + threads - 1) / threads);
  gv_csp_conv3x3_kernel<64><<<dim3(blocks, 64 / kGroup, batch), threads, 0,
                              stream>>>(x, 64, 0, h, w, w2, 64, s2, b2, y, 64,
                                        0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gv_csp_conv3x3_kernel<32><<<dim3(blocks, 32 / kGroup, batch), threads, 0,
                              stream>>>(y, 64, 32, h, w, wa, 32, sa, ba, xcat,
                                        64, 32);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gv_csp_conv3x3_kernel<32><<<dim3(blocks, 32 / kGroup, batch), threads, 0,
                              stream>>>(xcat, 64, 32, h, w, wb, 32, sb, bb,
                                        xcat, 64, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pooled = (h / 2) * (w / 2);
  if (pooled == 0) return 0;
  gv_csp_pool_kernel<<<dim3((pooled + threads - 1) / threads, 64 / kGroup,
                            batch),
                       threads, 0, stream>>>(y, xcat, h, w, wc, sc, bc, out);
  return (int)cudaGetLastError();
}
