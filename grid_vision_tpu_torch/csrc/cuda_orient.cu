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
// The bf16 form (compute_dtype="bfloat16", both kernels templated on the
// type T of frames, crops and output) rounds where pallas_orient.py's
// kernel rounds in bf16: the interpolation weights and each resampling
// pass's sum are rounded to bf16 (the crop is stored bf16), the statistics
// are single-pass f32 moments of that crop (var = max(E[x^2] - E[x]^2, 0)),
// the standardized values (x - mean) * inv are rounded to bf16 as they are
// staged (4 at a time: a bf16 row run starts at any multiple of 4 values),
// a run of 36 is padded to 48 (three k steps of 16) with zero weights, the
// product is bf16 mma.sync.m16n8k16 with the whole K on the tensor core, and
// relu(acc * s + t) (no FMA) is rounded once at the store.

#include <type_traits>

#include "gv_mma.cuh"

namespace {

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

// f32: the twin's crop and two-pass statistics. bf16 (the Pallas kernel's
// bf16 arithmetic): the frame and the four interpolation weights rounded to
// bf16, each resampling pass's sum rounded to bf16 (the bf16 crop), and
// single-pass f32 moments of the bf16 crop: var = max(E[x^2] - E[x]^2, 0).
template <typename T>
__global__ void __launch_bounds__(kCropThreads) gv_orient_crop_kernel(
    const T* __restrict__ images, int h, int w,
    const void* __restrict__ rig, int rig_is_i64,
    const uint8_t* __restrict__ valid, const float* __restrict__ xyxy,
    int size, T* __restrict__ crops, float* __restrict__ stats) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
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
  const T* frame = images + r * h * w * 3;
  T* crop = crops + (int64_t)n * size * size * 3;
  const int npix = size * size;
  auto rnd = [](float v) { return kBf16 ? gv::round_bf16(v) : v; };
  auto px = [](const T* p) {
    if constexpr (kBf16) {
      return __bfloat162float(*p);
    } else {
      return *p;
    }
  };

  float sum[3] = {0.0f, 0.0f, 0.0f};
  float sum2[3] = {0.0f, 0.0f, 0.0f};
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int i = p / size;
    const int j = p - i * size;
    const int y0 = ylo[i], y1 = yhi[i];
    const int x0 = xlo[j], x1 = xhi[j];
    float wy1, wx1;
    const float wy0 = rnd(lerp_weight_pair(yfr[i], y0 == y1, &wy1));
    const float wx0 = rnd(lerp_weight_pair(xfr[j], x0 == x1, &wx1));
    wy1 = rnd(wy1);
    wx1 = rnd(wx1);
    const T* r0 = frame + (int64_t)y0 * w * 3;
    const T* r1 = frame + (int64_t)y1 * w * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // along x first, then y: the order of the twin's einsums
      const float t0 =
          rnd(wx0 * px(r0 + x0 * 3 + c) + wx1 * px(r0 + x1 * 3 + c));
      const float t1 =
          rnd(wx0 * px(r1 + x0 * 3 + c) + wx1 * px(r1 + x1 * 3 + c));
      const float v = rnd(wy0 * t0 + wy1 * t1);
      if constexpr (kBf16) {
        crop[p * 3 + c] = __float2bfloat16_rn(v);
        sum2[c] += v * v;
      } else {
        crop[p * 3 + c] = v;
      }
      sum[c] += v;
    }
  }
  block_sum3(sum);
  const float mean[3] = {sum[0] / npix, sum[1] / npix, sum[2] / npix};
  float var[3];
  if constexpr (kBf16) {
    block_sum3(sum2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      var[c] = fmaxf(__fsub_rn(sum2[c] / npix, __fmul_rn(mean[c], mean[c])),
                     0.0f);
    }
  } else {
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
  }
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

// The conv's layout in operand type T. f32: an input row run of 12 px x 3
// ch padded to 40 (5 mma k steps of 8); bf16: padded to 48 (3 k steps of
// 16); the band's rows are staged standardized, 4 values a piece.
template <typename T>
struct OrientCfg {
  static constexpr int kRun = std::is_same<T, float>::value ? kRunF32 : 48;
  static constexpr int kSteps = kRun / gv::Op<T>::kK;
  static constexpr int kRowElems = (kBandCols - 1) * kStridePx * 3 + kRun;
  static constexpr int kBandElems = kInRows * kRowElems;
  static_assert(kRowElems % 4 == 0, "4-value staging pieces");
};

template <typename T>
int conv_smem_bytes(int f) {
  using C = OrientCfg<T>;
  const int chunk = C::kSteps * (f / 8) * 32 * 4;
  return (C::kBandElems + 2 * chunk) * (int)sizeof(T) + (2 * kMaxF + 8) * 4;
}

// crops: (n, size, size, 3) raw; stats: (n, 6) mean | 1 / std; wfrag: the
// (12 * kRun, f) matrix (rows uy * kRun + ux * 3 + c, rows 36.. of a run
// zero; f32: BN scale folded in, packed by tf32x3.pack_b_fragments; bf16:
// packed by bf16mma.pack_b_fragments, scale the BN scale); out: (n, q, q,
// f). bf16: the standardized values are rounded to bf16 on the way in, and
// relu(acc * scale + shift) is computed in f32 (no FMA) and rounded once.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
gv_orient_conv_kernel(const T* __restrict__ crops,
                      const float* __restrict__ stats,
                      const uint8_t* __restrict__ valid, int size, int q,
                      int pad, const T* __restrict__ wfrag, int f,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out) {
  using C = OrientCfg<T>;
  using O = gv::Op<T>;
  using Frag = typename O::Frag;
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk_elems = C::kSteps * (f / 8) * 32 * 4;
  T* band = reinterpret_cast<T*>(smem_raw);
  T* wbuf = band + C::kBandElems;
  float* sscale = reinterpret_cast<float*>(wbuf + 2 * chunk_elems);
  float* sshift = sscale + kMaxF;
  float* sstat = sshift + kMaxF;
  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const int oy0 = blockIdx.y * kBandRows;
  const int ox0 = blockIdx.z * kBandCols;
  auto bn_relu = [](float a, float s, float t) {
    return kBf16 ? fmaxf(__fadd_rn(__fmul_rn(a, s), t), 0.0f)
                 : fmaxf(a + t, 0.0f);
  };

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

  constexpr int kPer = 16 / (int)sizeof(T);   // elements a 16-byte piece
  auto load_chunk = [&](int chunk) {
    const T* s = wfrag + (int64_t)chunk * chunk_elems;
    T* d = wbuf + (chunk & 1) * chunk_elems;
    for (int i = tid; i < chunk_elems / kPer; i += kConvThreads) {
      gv::cp_async16(d + kPer * i, s + kPer * i, true);
    }
    gv::cp_async_commit();
  };
  load_chunk(0);
  if (tid < f) {
    sshift[tid] = shift[tid];
    sscale[tid] = kBf16 ? scale[tid] : 1.0f;
  }
  if (tid < 6) sstat[tid] = stats[n * 6 + tid];
  __syncthreads();

  // stage the band's input rows, standardized; zero outside the crop
  {
    const T* crop = crops + (int64_t)n * size * size * 3;
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
        const T* src = crop + (int64_t)r * row_len + cs;
        if constexpr (kBf16) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
          const __nv_bfloat162 lo =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          x[0] = __low2float(lo);
          x[1] = __high2float(lo);
          x[2] = __low2float(hi);
          x[3] = __high2float(hi);
        } else {
          const float4 raw = __ldg(reinterpret_cast<const float4*>(src));
          x[0] = raw.x;
          x[1] = raw.y;
          x[2] = raw.z;
          x[3] = raw.w;
        }
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
    const T* arow = band + uy * C::kRowElems;
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
          const T* a = arow + ks * O::kK;
          if constexpr (O::kSplitChains) {
            float d[4][4];                    // a chain of one k step
            O::step(d, true, a + a_off[mt][0], a + a_off[mt][1], b);
            gv::add_chain(acc[mt], d);
          } else {
            O::step(acc[mt], false, a + a_off[mt][0], a + a_off[mt][1], b);
          }
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
        T* dst = out + (((int64_t)n * q + oy) * q + ox) * f;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int ch = 32 * wq + 16 * pp + 4 * t;
          if (ch < f) {
            const float* ss = sscale + ch;
            const float* sh = sshift + ch;
            gv::store4(dst + ch,
                       bn_relu(acc[mt][2 * pp][2 * half], ss[0], sh[0]),
                       bn_relu(acc[mt][2 * pp][2 * half + 1], ss[1], sh[1]),
                       bn_relu(acc[mt][2 * pp + 1][2 * half], ss[2], sh[2]),
                       bn_relu(acc[mt][2 * pp + 1][2 * half + 1], ss[3],
                               sh[3]));
          }
        }
      }
    }
  }
}

template <typename T>
int orient_front(const T* images, int h, int w, const void* rig,
                 int rig_is_i64, const uint8_t* valid, const float* xyxy,
                 int n, int size, int q, int pad, const T* wfrag, int f,
                 const float* scale, const float* shift, T* crops,
                 float* stats, T* out, cudaStream_t stream) {
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
      gv_orient_crop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      crop_smem);
  if (err != cudaSuccess) return (int)err;
  gv_orient_crop_kernel<T><<<n, kCropThreads, crop_smem, stream>>>(
      images, h, w, rig, rig_is_i64, valid, xyxy, size, crops, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int conv_smem = conv_smem_bytes<T>(f);
  err = cudaFuncSetAttribute(gv_orient_conv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             conv_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n, band_rows, band_cols);
  gv_orient_conv_kernel<T><<<grid, kConvThreads, conv_smem, stream>>>(
      crops, stats, valid, size, q, pad, wfrag, f, scale, shift, out);
  return (int)cudaGetLastError();
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
  return orient_front<float>(images, h, w, rig, rig_is_i64, valid, xyxy, n,
                             size, q, pad, wfrag, f, nullptr, shift, crops,
                             stats, out, stream);
}

// The bf16 form: images, crops, wfrag and out bf16; wfrag: the packed
// (576, f) weights without the BN scale (runs padded to 48); scale / shift:
// the BN's (f32).
extern "C" int gv_orient_front_bf16(const void* images, int h, int w,
                                    const void* rig, int rig_is_i64,
                                    const uint8_t* valid, const float* xyxy,
                                    int n, int size, int q, int pad,
                                    const void* wfrag, int f,
                                    const float* scale, const float* shift,
                                    void* crops, float* stats, void* out,
                                    cudaStream_t stream) {
  using B = gv::bf16;
  return orient_front<B>(static_cast<const B*>(images), h, w, rig,
                         rig_is_i64, valid, xyxy, n, size, q, pad,
                         static_cast<const B*>(wfrag), f, scale, shift,
                         static_cast<B*>(crops), stats, static_cast<B*>(out),
                         stream);
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
