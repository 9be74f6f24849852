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
// Bound on this card: operations. At S = 224, F = 128 the conv is ~87
// MFLOP a crop (28 x 28 outputs x 128 channels x 432 taps x 2), ~28 GFLOP
// for 320 crops; the frames the crops read are at most ~240 MB once, the
// output 0.4 MB a crop. The contract is f32 (1e-3 against the twin), so the
// conv is a matrix product on the tensor cores in 3xTF32 (gv_mma.cuh): the
// weights are split into hi and lo once on the host with the BN scale
// folded in, the activations in registers. Design, two launches:
//   1. one block per crop: computes the crop's sample positions from its
//      box with the plain twin's f32 operations in the twin's order, each
//      rounded on its own (preprocess.box_axis_samples: corners truncated
//      and clamped, extents >= 1, half-pixel positions clamped to the crop),
//      samples the S x S crop straight from its rig's frame, writes it to a
//      scratch the wrapper allocates (L2-resident), and reduces the
//      per-channel mean and then the variance around it (two passes, as the
//      twin);
//   2. the conv: a block (896 threads) owns a band of 4 output rows x 28
//      columns of one crop and all F <= 128 channels. It stages the band's
//      36 input rows in shared memory with coalesced 16-byte loads,
//      standardizing on the way in, (x - mean) * inv: center first, then
//      scale, because the other order cancels catastrophically on flat
//      crops (pallas_orient.py:35-40); rows and columns in the SAME padding,
//      which on the 4-pixel block grid is (0, 4) pixels at S = 224, are
//      zero. An A-fragment row is then the 36 contiguous floats (12 pixels
//      x 3 channels) of one input row per uy; the run is padded to 40 (a
//      multiple of the mma's k = 8) with zero weights, so K = 12 x 40. The
//      packed weights stream through a double buffer, one uy (40 KB at
//      F = 128) a chunk. The 112 pixels are 7 m16 tiles; warp w of 28 owns
//      channels [32 (w % 4), +32) and m-tile w / 4. At 181 KB of shared
//      memory there is one block an SM, so its own 28 warps hide the
//      latency of the loads and of the cvt and mma chains (on an H100, 289
//      valid crops: 1.03 ms with 8 warps, 0.65-0.70 ms with 16 or 28).
//      Pixels 8 apart in x are 24 floats apart, so the 8-byte A loads of a
//      half-warp fall in 32 different banks.
// An invalid crop is an all-zero standardized input: it gets exactly
// relu(t) and costs no product, and launch 1 skips it.
//
// The bf16 form (compute_dtype="bfloat16") is cuda_orient_bf16.cu. The
// crop geometry both forms share is gv_orient.cuh.

#include "gv_mma.cuh"
#include "gv_orient.cuh"

namespace {

using gv::fill_tables;
using gv::lerp_weight_pair;

constexpr int kStridePx = 8;                  // conv stride in pixels
constexpr int kTapRows = 12;                  // 12 x 12 kernel
constexpr int kRunF32 = 40;                   // 12 px x 3 ch, padded to 8s
constexpr int kBandRows = 4;                  // output rows a block
constexpr int kBandCols = 28;                 // output columns a block
constexpr int kMTiles = kBandRows * kBandCols / 16;
constexpr int kInRows = (kBandRows - 1) * kStridePx + kTapRows;
constexpr int kConvThreads = 896;             // 28 warps: 7 x 4
constexpr int kWarpMTiles = 1;                // m-tiles a warp
constexpr int kCropThreads = 672;              // one block a crop, 3 an SM
constexpr int kMaxF = 128;
static_assert(kBandRows * kBandCols % 16 == 0, "whole m16 tiles");
static_assert((kConvThreads / 32 / 4) * kWarpMTiles >= kMTiles,
              "every m-tile has a warp");

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

// The twin's crop and two-pass statistics.
__global__ void __launch_bounds__(kCropThreads) gv_orient_crop_kernel(
    const float* __restrict__ images, int h, int w,
    const void* __restrict__ rig, int rig_is_i64,
    const uint8_t* __restrict__ valid, const float* __restrict__ xyxy,
    int size, float* __restrict__ crops, float* __restrict__ stats) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  if (!valid[n]) return;                      // uniform over the block
  int* ylo = reinterpret_cast<int*>(smem);
  int* yhi = ylo + size;
  int* xlo = yhi + size;
  int* xhi = xlo + size;
  float* yfr = smem + 4 * size;
  float* xfr = yfr + size;
  fill_tables(xyxy + 4 * n, h, w, size, ylo, yhi, yfr, xlo, xhi, xfr);
  __syncthreads();
  const int64_t r = rig_is_i64 ? static_cast<const int64_t*>(rig)[n]
                               : static_cast<const int32_t*>(rig)[n];
  const float* frame = images + r * h * w * 3;
  float* crop = crops + (int64_t)n * size * size * 3;
  const int npix = size * size;

  float sum[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / size;
    const int j = p - i * size;
    const int y0 = ylo[i], y1 = yhi[i];
    const int x0 = xlo[j], x1 = xhi[j];
    float wy1, wx1;
    const float wy0 = lerp_weight_pair(yfr[i], y0 == y1, &wy1);
    const float wx0 = lerp_weight_pair(xfr[j], x0 == x1, &wx1);
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
  float var[3];
  float sq[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = crop[p * 3 + c] - mean[c];  // this thread's writes
      sq[c] += d * d;
    }
  }
  block_sum3(sq);
#pragma unroll
  for (int c = 0; c < 3; ++c) var[c] = sq[c] / npix;
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    stats[n * 6 + c] = mean[c];
    stats[n * 6 + 3 + c] = 1.0f / fmaxf(sqrtf(var[c]), 1e-6f);
  }
}

// The sample tables of every box, as the crop kernel computes them.
__global__ void gv_orient_samples_kernel(const float* __restrict__ xyxy,
                                         int h, int w, int size, int* ylo,
                                         int* yhi, float* yfr, int* xlo,
                                         int* xhi, float* xfr) {
  const int64_t o = (int64_t)blockIdx.x * size;
  fill_tables(xyxy + 4 * blockIdx.x, h, w, size, ylo + o, yhi + o, yfr + o,
              xlo + o, xhi + o, xfr + o);
}

// The conv's layout: an input row run of 12 px x 3 ch padded to 40 (5 mma
// k steps of 8); the band's rows are staged standardized, 4 values a piece.
struct OrientCfg {
  static constexpr int kRun = kRunF32;
  static constexpr int kSteps = kRun / gv::Op<float>::kK;
  static constexpr int kRowElems = (kBandCols - 1) * kStridePx * 3 + kRun;
  static constexpr int kBandElems = kInRows * kRowElems;
  static_assert(kRowElems % 4 == 0, "4-value staging pieces");
};

int conv_smem_bytes(int f) {
  using C = OrientCfg;
  const int chunk = C::kSteps * (f / 8) * 32 * 4;
  return (C::kBandElems + 2 * chunk + kMaxF + 8) * (int)sizeof(float);
}

// crops: (n, size, size, 3) raw; stats: (n, 6) mean | 1 / std; wfrag: the
// (12 * kRun, f) matrix (rows uy * kRun + ux * 3 + c, rows 36.. of a run
// zero; BN scale folded in, packed by tf32x3.pack_b_fragments); out: (n,
// q, q, f).
__global__ void __launch_bounds__(kConvThreads)
gv_orient_conv_kernel(const float* __restrict__ crops,
                      const float* __restrict__ stats,
                      const uint8_t* __restrict__ valid, int size, int q,
                      int pad, const float* __restrict__ wfrag, int f,
                      const float* __restrict__ shift,
                      float* __restrict__ out) {
  using C = OrientCfg;
  using O = gv::Op<float>;
  using Frag = O::Frag;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk_elems = C::kSteps * (f / 8) * 32 * 4;
  float* band = reinterpret_cast<float*>(smem_raw);
  float* wbuf = band + C::kBandElems;
  float* sshift = wbuf + 2 * chunk_elems;
  float* sstat = sshift + kMaxF;
  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const int oy0 = blockIdx.y * kBandRows;
  const int ox0 = blockIdx.z * kBandCols;

  if (!valid[n]) {                            // uniform over the block
    const int vecs = f / 4;
    for (int i = tid; i < kBandRows * kBandCols * vecs; i += kConvThreads) {
      const int p = i / vecs;
      const int v = i - p * vecs;
      const int oy = oy0 + p / kBandCols;
      const int ox = ox0 + p % kBandCols;
      if (oy < q && ox < q) {
        const float* t = shift + 4 * v;
        gv::store4(out + (((int64_t)n * q + oy) * q + ox) * f + 4 * v,
                   fmaxf(t[0], 0.0f), fmaxf(t[1], 0.0f), fmaxf(t[2], 0.0f),
                   fmaxf(t[3], 0.0f));
      }
    }
    return;
  }

  constexpr int kPer = 4;                     // elements a 16-byte piece
  auto load_chunk = [&](int chunk) {
    const float* s = wfrag + (int64_t)chunk * chunk_elems;
    float* d = wbuf + (chunk & 1) * chunk_elems;
    for (int i = tid; i < chunk_elems / kPer; i += kConvThreads) {
      gv::cp_async16(d + kPer * i, s + kPer * i, true);
    }
    gv::cp_async_commit();
  };
  load_chunk(0);
  if (tid < f) sshift[tid] = shift[tid];
  if (tid < 6) sstat[tid] = stats[n * 6 + tid];
  __syncthreads();

  // stage the band's input rows, standardized; zero outside the crop
  {
    const float* crop = crops + (int64_t)n * size * size * 3;
    const int row_len = size * 3;
    const int r0 = oy0 * kStridePx - pad;
    const int col0 = (ox0 * kStridePx - pad) * 3;  // a multiple of 12
    constexpr int kVecs = C::kRowElems / 4;
    for (int i = tid; i < kInRows * kVecs; i += kConvThreads) {
      const int rr = i / kVecs;
      const int v = i - rr * kVecs;
      const int r = r0 + rr;
      const int cs = col0 + 4 * v;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r >= 0 && r < size && cs >= 0 && cs < row_len) {
        const float4 raw = __ldg(reinterpret_cast<const float4*>(
            crop + (int64_t)r * row_len + cs));
        x[0] = raw.x;
        x[1] = raw.y;
        x[2] = raw.z;
        x[3] = raw.w;
        int c = v % 3;                        // channel of x[0]: cs % 3
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = (x[e] - sstat[c]) * sstat[3 + c];
          c = c == 2 ? 0 : c + 1;
        }
      }
      gv::store4(band + rr * C::kRowElems + 4 * v, x[0], x[1], x[2], x[3]);
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = warp & 3;                    // channels [32 wq, 32 wq + 32)
  const int mt0 = (warp >> 2) * kWarpMTiles;  // its first m-tile
  const int n_tiles = f / 8;

  int a_off[kWarpMTiles][2];                  // band offset of rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < kWarpMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = min((mt0 + mt) * 16 + g + 8 * half,
                        kBandRows * kBandCols - 1);
      a_off[mt][half] = (p / kBandCols) * kStridePx * C::kRowElems +
                        (p % kBandCols) * kStridePx * 3 + O::kThreadK * t;
    }
  }
  float acc[kWarpMTiles][4][4];
#pragma unroll
  for (int mt = 0; mt < kWarpMTiles; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }

  for (int uy = 0; uy < kTapRows; ++uy) {
    if (uy + 1 < kTapRows) {
      load_chunk(uy + 1);
      gv::cp_async_wait<1>();
    } else {
      gv::cp_async_wait<0>();
    }
    __syncthreads();                          // chunk uy (and the band) landed
    const Frag* wb =
        reinterpret_cast<const Frag*>(wbuf + (uy & 1) * chunk_elems);
    const float* arow = band + uy * C::kRowElems;
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      Frag b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int tile = min(4 * wq + nt, n_tiles - 1);
        b[nt] = wb[(ks * n_tiles + tile) * 32 + lane];
      }
#pragma unroll
      for (int mt = 0; mt < kWarpMTiles; ++mt) {
        if (mt0 + mt < kMTiles) {             // uniform over the warp
          const float* a = arow + ks * O::kK;
          float d[4][4];                      // a chain of one k step
          O::step(d, true, a + a_off[mt][0], a + a_off[mt][1], b);
          gv::add_chain(acc[mt], d);
        }
      }
    }
    __syncthreads();                          // the buffer is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < kWarpMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = (mt0 + mt) * 16 + g + 8 * half;
      const int oy = oy0 + p / kBandCols;
      const int ox = ox0 + p % kBandCols;
      if (mt0 + mt < kMTiles && oy < q && ox < q) {
        float* dst = out + (((int64_t)n * q + oy) * q + ox) * f;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int ch = 32 * wq + 16 * pp + 4 * t;
          if (ch < f) {
            const float* sh = sshift + ch;
            gv::store4(dst + ch,
                       fmaxf(acc[mt][2 * pp][2 * half] + sh[0], 0.0f),
                       fmaxf(acc[mt][2 * pp][2 * half + 1] + sh[1], 0.0f),
                       fmaxf(acc[mt][2 * pp + 1][2 * half] + sh[2], 0.0f),
                       fmaxf(acc[mt][2 * pp + 1][2 * half + 1] + sh[3],
                             0.0f));
          }
        }
      }
    }
  }
}

}  // namespace

// images: (R, h, w, 3); rig: (n,) int32 or int64; valid: (n,) bytes; xyxy:
// (n, 4); crops: (n, size, size, 3) and stats: (n, 6) scratch; wfrag: the
// packed (480, f) weights; shift: (f,); out: (n, q, q, f). size % 8 == 0,
// f % 16 == 0, f <= 128.
extern "C" int gv_orient_front(const float* images, int h, int w,
                               const void* rig, int rig_is_i64,
                               const uint8_t* valid, const float* xyxy, int n,
                               int size, int q, int pad, const float* wfrag,
                               int f, const float* shift, float* crops,
                               float* stats, float* out,
                               cudaStream_t stream) {
  if (f <= 0 || f % 16 != 0 || f > kMaxF || size <= 0 || size % 8 != 0 ||
      pad % 4 != 0 || q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  const int band_rows = (q + kBandRows - 1) / kBandRows;
  const int band_cols = (q + kBandCols - 1) / kBandCols;
  if (band_rows > 65535 || band_cols > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int crop_smem = 6 * size * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gv_orient_crop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      crop_smem);
  if (err != cudaSuccess) return (int)err;
  gv_orient_crop_kernel<<<n, kCropThreads, crop_smem, stream>>>(
      images, h, w, rig, rig_is_i64, valid, xyxy, size, crops, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int conv_smem = conv_smem_bytes(f);
  err = cudaFuncSetAttribute(gv_orient_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             conv_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, band_rows, band_cols);
  gv_orient_conv_kernel<<<grid, kConvThreads, conv_smem, stream>>>(
      crops, stats, valid, size, q, pad, wfrag, f, shift, out);
  return (int)cudaGetLastError();
}

// The (n, size) sample tables the crop kernel computes from the boxes
// (the check against preprocess.box_axis_samples).
extern "C" int gv_orient_samples(const float* xyxy, int n, int h, int w,
                                 int size, int* ylo, int* yhi, float* yfr,
                                 int* xlo, int* xhi, float* xfr,
                                 cudaStream_t stream) {
  if (n <= 0 || size <= 0) return 0;
  gv_orient_samples_kernel<<<n, 128, 0, stream>>>(xyxy, h, w, size, ylo, yhi,
                                                  yfr, xlo, xhi, xfr);
  return (int)cudaGetLastError();
}
