// Fused detector front end for Hopper (sm_90a): antialiased resize + /255
// + ConvBN_0 (3x3/s2, 3->32, folded BN, leaky 0.1) + ConvBN_1 (3x3/s2,
// 32->64, folded BN, leaky 0.1), (B, H, W, 3) frames -> (B, S1, S1, 64).
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_stem.py
// (detector_stem_pallas -> _stem_kernel). The Pallas kernel's stride-4
// phase planes and block-diagonal packing exist only because Mosaic has no
// strided vector slices and a 128-wide MXU; none of that is carried over.
//
// Bound on this card: FP32 operations. At the main path's shapes (480x640
// -> 416 -> 208 -> 104) conv0 is 74.8 MFLOP and conv1 398.7 MFLOP, against
// ~6.5 MB of compulsory traffic (frame in, activation out): several
// microseconds of FP32 instruction time against ~2 us of HBM time.
// Design, two launches:
//   1. resize + conv0: one thread per conv0 output pixel and all 32 output
//      channels in registers. It resamples the 3x3 patch of the resized
//      image it needs straight from the frame through the separable
//      triangle taps (<= 4 per axis at 640->416; the host passes each
//      output row's tap window and weights), so the resized image never
//      exists in memory. Weights and folded BN sit in shared memory.
//   2. conv1: one thread per conv1 output pixel and 16 output channels
//      (blockIdx.y picks the group, four groups), the 288x16 weight slice
//      in shared memory and read as float4 broadcasts; the 32-channel input
//      rows come in as float4 loads from the L2-resident conv0 output.
// Everything accumulates in f32. SAME padding is passed from the host: for
// a 3x3/s2 conv on an even input it is (0, 1), so pad_lo is 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

// Resample one resized pixel (row r, col s, 3 channels) from the frame:
// first along x for each tapped frame row, then along y (the order of the
// plain version's einsums). wx already carries the 1/255.
__device__ __forceinline__ void resize_pixel(
    const float* __restrict__ img, int w, int r, int s,
    const int32_t* __restrict__ ry0, const float* __restrict__ ryw, int ty_n,
    const int32_t* __restrict__ rx0, const float* __restrict__ rxw, int tx_n,
    float out[3]) {
  out[0] = out[1] = out[2] = 0.0f;
  const int y0 = ry0[r];
  const int x0 = rx0[s];
  for (int a = 0; a < ty_n; ++a) {
    const float wy = ryw[r * ty_n + a];
    const float* row = img + (int64_t)(y0 + a) * w * 3;
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int b = 0; b < tx_n; ++b) {
      const float wx = rxw[s * tx_n + b];
      const float* px = row + (x0 + b) * 3;
      t0 += wx * px[0];
      t1 += wx * px[1];
      t2 += wx * px[2];
    }
    out[0] += wy * t0;
    out[1] += wy * t1;
    out[2] += wy * t2;
  }
}

__global__ void gv_stem_conv0_kernel(
    const float* __restrict__ img, int h, int w,
    const int32_t* __restrict__ ry0, const float* __restrict__ ryw, int ty_n,
    const int32_t* __restrict__ rx0, const float* __restrict__ rxw, int tx_n,
    int size, const float* __restrict__ w0, const float* __restrict__ s0,
    const float* __restrict__ b0, int pad0, int s0_size,
    float* __restrict__ mid) {
  __shared__ float sw[27 * 32];
  __shared__ float ss[32], sb[32];
  for (int t = threadIdx.x; t < 27 * 32; t += blockDim.x) sw[t] = w0[t];
  if (threadIdx.x < 32) {
    ss[threadIdx.x] = s0[threadIdx.x];
    sb[threadIdx.x] = b0[threadIdx.x];
  }
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= s0_size * s0_size) return;
  const int oy = pix / s0_size;
  const int ox = pix - oy * s0_size;
  const float* frame = img + (int64_t)blockIdx.z * h * w * 3;

  float acc[32];
#pragma unroll
  for (int co = 0; co < 32; ++co) acc[co] = 0.0f;
  for (int ty = 0; ty < 3; ++ty) {
    const int r = 2 * oy + ty - pad0;
    if (r < 0 || r >= size) continue;         // SAME zero pad
    for (int tx = 0; tx < 3; ++tx) {
      const int s = 2 * ox + tx - pad0;
      if (s < 0 || s >= size) continue;
      float v[3];
      resize_pixel(frame, w, r, s, ry0, ryw, ty_n, rx0, rxw, tx_n, v);
      const float* wt = sw + (ty * 3 + tx) * 3 * 32;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int co = 0; co < 32; ++co) acc[co] += wt[c * 32 + co] * v[c];
      }
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      mid + (((int64_t)blockIdx.z * s0_size + oy) * s0_size + ox) * 32);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    dst[q] = make_float4(leaky(acc[4 * q] * ss[4 * q] + sb[4 * q]),
                         leaky(acc[4 * q + 1] * ss[4 * q + 1] + sb[4 * q + 1]),
                         leaky(acc[4 * q + 2] * ss[4 * q + 2] + sb[4 * q + 2]),
                         leaky(acc[4 * q + 3] * ss[4 * q + 3] + sb[4 * q + 3]));
  }
}

constexpr int kGroup = 16;                    // conv1 output channels/thread

__global__ void gv_stem_conv1_kernel(const float* __restrict__ mid,
                                     int s0_size,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ s1,
                                     const float* __restrict__ b1, int pad1,
                                     int s1_size, float* __restrict__ out) {
  __shared__ __align__(16) float sw[288 * kGroup];
  __shared__ float ss[kGroup], sb[kGroup];
  const int g0 = blockIdx.y * kGroup;
  for (int t = threadIdx.x; t < 288 * kGroup; t += blockDim.x) {
    sw[t] = w1[(t / kGroup) * 64 + g0 + t % kGroup];
  }
  if (threadIdx.x < kGroup) {
    ss[threadIdx.x] = s1[g0 + threadIdx.x];
    sb[threadIdx.x] = b1[g0 + threadIdx.x];
  }
  __syncthreads();
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= s1_size * s1_size) return;
  const int oy = pix / s1_size;
  const int ox = pix - oy * s1_size;
  const float* src = mid + (int64_t)blockIdx.z * s0_size * s0_size * 32;

  float acc[kGroup];
#pragma unroll
  for (int co = 0; co < kGroup; ++co) acc[co] = 0.0f;
  for (int ty = 0; ty < 3; ++ty) {
    const int r = 2 * oy + ty - pad1;
    if (r < 0 || r >= s0_size) continue;
    for (int tx = 0; tx < 3; ++tx) {
      const int s = 2 * ox + tx - pad1;
      if (s < 0 || s >= s0_size) continue;
      const float4* px = reinterpret_cast<const float4*>(
          src + ((int64_t)r * s0_size + s) * 32);
      const float* wt = sw + (ty * 3 + tx) * 32 * kGroup;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
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
  }
  float4* dst = reinterpret_cast<float4*>(
      out + (((int64_t)blockIdx.z * s1_size + oy) * s1_size + ox) * 64 + g0);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) {
    dst[q] = make_float4(leaky(acc[4 * q] * ss[4 * q] + sb[4 * q]),
                         leaky(acc[4 * q + 1] * ss[4 * q + 1] + sb[4 * q + 1]),
                         leaky(acc[4 * q + 2] * ss[4 * q + 2] + sb[4 * q + 2]),
                         leaky(acc[4 * q + 3] * ss[4 * q + 3] + sb[4 * q + 3]));
  }
}

}  // namespace

extern "C" int gv_detector_stem(
    const float* img, int batch, int h, int w, const int32_t* ry0,
    const float* ryw, int ty_n, const int32_t* rx0, const float* rxw,
    int tx_n, int size, const float* w0, const float* s0, const float* b0,
    int pad0, int s0_size, float* mid, const float* w1, const float* s1,
    const float* b1, int pad1, int s1_size, float* out,
    cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int threads = 128;
  const dim3 grid0((s0_size * s0_size + threads - 1) / threads, 1, batch);
  gv_stem_conv0_kernel<<<grid0, threads, 0, stream>>>(
      img, h, w, ry0, ryw, ty_n, rx0, rxw, tx_n, size, w0, s0, b0, pad0,
      s0_size, mid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((s1_size * s1_size + threads - 1) / threads, 64 / kGroup,
                   batch);
  gv_stem_conv1_kernel<<<grid1, threads, 0, stream>>>(
      mid, s0_size, w1, s1, b1, pad1, s1_size, out);
  return (int)cudaGetLastError();
}
