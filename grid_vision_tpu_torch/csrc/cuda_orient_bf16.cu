// The orientation net's front end, bf16 form, for Hopper (sm_90a), in one
// launch: for each crop of the fleet-compacted batch, its rig's bf16 frame
// -> bilinear crop-resize to S x S -> per-crop per-channel standardization
// (quirk Q10) -> the folded s2d stem conv (12x12, stride 8, 3 -> F) + BN +
// relu -> the (N, S/8, S/8, F) bf16 NHWC activation OrientationNetS2D
// takes with stem_external=True.
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_orient.py
// (orient_front_pallas -> _orient_kernel, compute_dtype="bfloat16"), which
// keeps the crop in VMEM for the whole pass. The f32 form stays in
// cuda_orient.cu; the crop geometry both share is gv_orient.cuh.
//
// Arithmetic, rounded where the Pallas kernel rounds in bf16: the four
// interpolation weights and each resampling pass's sum (x first, then y)
// rounded to bf16 (the bf16 crop); single-pass f32 moments of that crop,
// var = max(E[x^2] - E[x]^2, 0), inv = 1 / max(sqrt(var), 1e-6); the
// standardized (x - mean) * inv, each step rounded on its own, rounded to
// bf16; the conv's f32 sums of exact bf16 products; relu(acc * s + t)
// (a multiply, then an add) rounded once. An invalid crop gets relu(t).
//
// Bound on this card: operations, about level with bytes. At 64 frames of
// 480x640 and 320 crops (~290 valid) the conv is ~25 GFLOP on the bf16
// tensor cores (0.026 ms); the frame pixels that the valid crops tap, each
// once, are ~19 MB and the output 64 MB (0.025 ms at 3.35 TB/s). The
// earlier bf16 form (two launches of the f32 design) wrote every crop to
// device memory and read it back (~200 MB, more than the whole bound),
// gathered the crop a pixel at a time, streamed the weights from L2 for
// every band of 4 output rows and fed mma.sync one B fragment a product.
// Here, one launch:
//   - A cluster of C blocks takes a crop (C = 4 at S = 224, Plan below):
//     block b owns output rows [R b, R b + R) and resamples the 8 R + 4
//     crop rows they read into its own shared memory (the 4 halo rows also
//     resampled by block b + 1, with the same arithmetic, so bit-equal).
//     The crop never leaves the chip.
//   - The resample: the tap tables (frame offsets and bf16 weights of each
//     crop column and of the block's crop rows) once into shared memory; a
//     thread keeps one pair of crop columns and their taps in registers.
//     Chunk by chunk of crop rows (a prefix of the rows left, counted in
//     one barrier), the x pass runs once per frame row the chunk taps
//     (two 4-byte loads a tap, four rows' loads in flight) into a buffer of
//     up to 16 rows, then the y pass from it into the crop rows. No
//     division and no 2-byte global load a pixel.
//   - Each block adds the moments of the crop rows it owns (disjoint over
//     the cluster); the blocks read each other's six partial sums through
//     distributed shared memory and add them in rank order, so all of them
//     standardize with bit-identical mean and inv, in place, to bf16.
//   - The conv on wgmma (m64n128k16 at F = 128, m64n64k16 at F <= 64; one
//     m64 tile of output pixels a warpgroup), K = 432 unpadded (27 steps of
//     16: a thread's four neighbouring k never straddle a tap row, runs of
//     36 being multiples of 4). B, the (432, F) weights in wgmma's layout
//     (ops/bf16mma.pack_wgmma_b_halves), arrives once a block by
//     cp.async.bulk on an mbarrier while the crop is resampled. A comes
//     from the standardized rows through registers, 8-byte loads: the
//     fragment's row g is output pixel 2g of the warp's 16 and row g + 8
//     pixel 2g + 1, so a half-warp's loads fall in distinct banks.
//   - The epilogue: s * acc + t, the relu in the rounding conversion,
//     16-byte stores.
// Shared memory (227 KB at S = 224, F = 128): one block an SM, 30 clusters
// of 4 resident on an H100. What bounds it, measured (PERF.md; a
// -DGV_ORIENT_CLOCKS build counts cycles by phase, gv_orient_bf16_clocks,
// tools/torch_kernel_times.py orient_bf16 --variant
// cuda_orient_bf16:GV_ORIENT_CLOCKS): SIMT instruction issue in the
// resample and standardize (about half a block's cycles), then the tensor
// cores (a fourth m64 tile holds 4 of the 196 pixels a block at S = 224).

#include <type_traits>

#include "gv_hopper.cuh"
#include "gv_orient.cuh"

namespace {

using gv::acc_channel;
using gv::axis_sample;
using gv::b_desc;
using gv::bf16;
using gv::box_axes;
using gv::BoxAxes;
using gv::bulk_copy;
using gv::fence_acc;
using gv::lerp_weight_pair;
using gv::mbar_expect_tx;
using gv::mbar_init;
using gv::mbar_wait;
using gv::round_bf16;
using gv::smem_u32;
using gv::store8;
using gv::wgmma_commit;
using gv::wgmma_fence;
using gv::wgmma_m64n128k16;
using gv::wgmma_m64n64k16;
using gv::wgmma_wait0;

constexpr int kThreads = 512;                 // four warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 432;                    // 12 x 12 taps x 3 channels
constexpr int kSteps = kTaps / 16;            // wgmma k steps
constexpr int kStepBytes = 64 * 16 * 2;       // B of one step, 64 channels
constexpr int kHalfBytes = kSteps * kStepBytes;   // 64 channels of B
constexpr int kGroup = 3;                     // k steps a commit group
constexpr int kXBatch = 4;                    // x-pass rows loaded at once
constexpr int kMaxTiles = kThreads / 128;     // m64 tiles a block
constexpr int kMaxF = 128;
constexpr int kMaxShared = 232448;
constexpr int kMaxBufRows = 16;
constexpr int kMinBufRows = 4;
// the BN constants (2 x kMaxF floats), then the mbarrier, the block's six
// partial sums, the cluster's six sums and the warps' partial sums
constexpr int kConstBytes = 2 * kMaxF * 4;
constexpr int kMiscBytes = 512;
static_assert(kSteps % kGroup == 0, "whole commit groups");
static_assert(16 + 32 + 32 + kWarps * 6 * 4 <= kMiscBytes, "misc fits");

// What a crop size gets: the cluster's blocks, the output rows a block,
// the crop rows it holds (8 rows + 4 of halo), a crop row's elements in
// shared memory (S + 4 pixels of 3 channels: the right SAME padding is 4
// zero pixels), the x pass's rows, the dynamic shared memory. cluster ==
// 0: refused. ops/cuda_orient.orient_bf16_plan mirrors it.
struct Plan {
  int cluster, rows, crop_rows, stride, buf_rows, smem;
};

__host__ __device__ inline Plan make_plan(int size, int f) {
  Plan p{0, 0, 0, 0, 0, 0};
  if (size <= 0 || size % 8 != 0 || f <= 0 || f % 16 != 0 || f > kMaxF) {
    return p;
  }
  const int q = size / 8;
  const int halves = (f + 63) / 64;
  for (int c = 1; c <= 8; c *= 2) {
    const int rows = (q + c - 1) / c;
    if ((rows * q + 63) / 64 > kMaxTiles) continue;
    const int crop_rows = 8 * rows + 4;
    const int stride = 3 * size + 12;
    const int fixed = halves * kHalfBytes + kConstBytes + kMiscBytes +
                      16 * (size + crop_rows) + 2 * crop_rows * stride;
    const int room = (kMaxShared - fixed) / (8 * size);
    const int buf = room < kMaxBufRows ? room : kMaxBufRows;
    if (buf < kMinBufRows) continue;
    return Plan{c, rows, crop_rows, stride, buf, fixed + 8 * size * buf};
  }
  return p;
}

// A crop column's taps: the element offsets (3 x) of its two frame
// columns in a frame row and their bf16 weights; a crop row's: its two
// frame rows and weights.
struct ColTap {
  int e_lo, e_hi;
  float w_lo, w_hi;
};

struct RowTap {
  int lo, hi;
  float w_lo, w_hi;
};

struct Args {
  const bf16* images;
  int frames, h, w;
  const void* rig;
  int rig_is_i64;
  const uint8_t* valid;
  const float* xyxy;
  int size, q, f, halves;
  const bf16* wwg;
  const float* scale;
  const float* shift;
  bf16* out;
  Plan plan;
};

__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// The three channels of a pixel from the two 4-byte words at and after its
// first element; odd: that element is the upper half of the first word.
__device__ __forceinline__ void px_channels(uint2 w, int odd,
                                            float (&v)[3]) {
  const uint32_t sh = (uint32_t)odd << 4;
  const uint32_t lo = __funnelshift_r(w.x, w.y, sh);
  v[0] = lo_bf16(lo);
  v[1] = hi_bf16(lo);
  v[2] = lo_bf16(w.y >> sh);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// relu(a), relu(b) rounded to bf16 in one conversion (a in the low half):
// rounding is monotone and keeps 0, so it is the rounded relu.
__device__ __forceinline__ uint32_t pack_relu_bf16(float a, float b) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
  return d;
}

// A (rows, width) walk over units u = tid, tid + kThreads, ... without a
// division a unit: the row and column of u, advanced by kThreads.
struct Walk {
  int r, c, dr, dc, width;
  __device__ __forceinline__ Walk(int width_) : width(width_) {
    r = (int)threadIdx.x / width;
    c = (int)threadIdx.x - r * width;
    dr = kThreads / width;
    dc = kThreads - dr * width;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
};

// d = A (a warpgroup's 64 rows) x B for `steps` k steps (a multiple of
// G), one m64n128k16 a step at H = 2 halves of 64 channels, one m64n64k16
// at 1: B in shared memory at wb, H x 2048 bytes a step
// (pack_wgmma_b_halves); load(s, a) gives the warp's A fragment of step s
// (pack_wgmma_b's k order). G steps a commit group, with no branch
// between a group's loads and products (one would make the compiler fence
// each product).
template <int H, int G, class LoadA>
__device__ __forceinline__ void product(float (&d)[32 * H], int steps,
                                        uint32_t wb, LoadA load) {
#pragma unroll
  for (int i = 0; i < 32 * H; ++i) d[i] = 0.0f;
  for (int s0 = 0; s0 < steps; s0 += G) {
    uint32_t a[G][4];
#pragma unroll
    for (int i = 0; i < G; ++i) load(s0 + i, a[i]);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int s = s0 + i;
      const uint64_t desc = b_desc(wb + s * H * kStepBytes);
      if constexpr (H == 2) {
        wgmma_m64n128k16(d, a[i], desc, s > 0);
      } else {
        wgmma_m64n64k16(d, a[i], desc, s > 0);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(d);
  }
}

#ifdef GV_ORIENT_CLOCKS
// Cycles by phase summed over the valid crops' blocks (thread 0's view,
// barrier to barrier): tap tables, x passes, y passes, moments and the
// cluster's exchange, standardize, the wait for the weights, the conv, its
// epilogue (warpgroup 0's), the last cluster wait; [9] the blocks.
__device__ unsigned long long gv_orient_clocks[10];
#define GV_CLK(i)                                 \
  if (threadIdx.x == 0) {                         \
    const long long c_now = clock64();            \
    clk[i] += c_now - c_prev;                     \
    c_prev = c_now;                               \
  }
#else
#define GV_CLK(i)
#endif

// images: (R, h, w, 3) bf16; the rest as gv_orient_front_bf16 takes them.
// Block rank b of cluster n (blockIdx.x = C n + b) takes crop n's output
// rows [R b, R b + R).
__global__ void __launch_bounds__(kThreads, 1)
gv_orient_bf16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan P = a.plan;
  const int tid = threadIdx.x;
  const int n = blockIdx.x / P.cluster;
  const int rank = blockIdx.x - n * P.cluster;
  const int size = a.size, q = a.q, f = a.f;
  const int oy0 = rank * P.rows;
  const int out_rows = max(min(P.rows, q - oy0), 0);
  bf16* out = a.out + ((int64_t)n * q + oy0) * q * f;
  // the crop's rig and box, read with its validity (one wait, not three)
  const int64_t r = a.rig_is_i64 ? static_cast<const int64_t*>(a.rig)[n]
                                 : static_cast<const int32_t*>(a.rig)[n];
  const BoxAxes ax = box_axes(a.xyxy + 4 * n, a.h, a.w);

  if (!a.valid[n]) {       // uniform over the cluster: before any barrier
    const int groups = f / 8;
    for (int i = tid; i < out_rows * q * groups; i += kThreads) {
      const int p = i / groups;
      const int v = i - p * groups;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fmaxf(a.shift[8 * v + e], 0.0f);
      store8(out + p * f + 8 * v, o);
    }
    return;
  }

#ifdef GV_ORIENT_CLOCKS
  long long clk[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long c_prev = clock64();
#endif
  const int row0 = 8 * oy0;                    // the block's first crop row
  const int nreal = max(min(P.crop_rows, size - row0), 0);
  const int owned = min(8 * P.rows, nreal);    // rows whose moments it adds
  const int64_t frame = r * a.h * a.w * 3;     // element of the rig's frame
  // the frame rows whose taps may read the whole word after a pixel's
  // first: all but the last of the last frame (the tensor's last word may
  // end past it)
  const int whole_rows = r == a.frames - 1 ? a.h - 1 : a.h;
  unsigned char* sp = smem + a.halves * kHalfBytes;
  float* s_scale = reinterpret_cast<float*>(sp);
  float* s_shift = s_scale + kMaxF;
  sp += kConstBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sp);
  float* part = reinterpret_cast<float*>(sp + 16);    // this block's sums
  float* total = part + 8;                             // the cluster's
  float* wpart = total + 8;                            // the warps'
  sp += kMiscBytes;
  ColTap* ctab = reinterpret_cast<ColTap*>(sp);
  sp += 16 * size;
  RowTap* rtab = reinterpret_cast<RowTap*>(sp);
  sp += 16 * P.crop_rows;
  bf16* xbuf = reinterpret_cast<bf16*>(sp);           // 4 values a column
  sp += 8 * size * P.buf_rows;
  bf16* crop = reinterpret_cast<bf16*>(sp);
  const uint32_t wbar = smem_u32(bar);

  // the weights and BN constants, by the copy engine while the crop is cut
  if (tid == 0) mbar_init(wbar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(wbar, a.halves * kHalfBytes + 8 * f);
    bulk_copy(smem_u32(smem), a.wwg, a.halves * kHalfBytes, wbar);
    bulk_copy(smem_u32(s_scale), a.scale, 4 * f, wbar);
    bulk_copy(smem_u32(s_shift), a.shift, 4 * f, wbar);
  }

  // the tap tables; zero what no pass writes (the right padding, the rows
  // past the crop)
  for (int i = tid; i < size + nreal; i += kThreads) {
    const bool col = i < size;
    const int k = col ? i : i - size;
    int lo, hi;
    float fr, w1;
    if (col) {
      axis_sample(a.w, ax.x_start, ax.x_extent, size, k, &lo, &hi, &fr);
    } else {
      axis_sample(a.h, ax.y_start, ax.y_extent, size, row0 + k, &lo, &hi,
                  &fr);
    }
    const float w0 = round_bf16(lerp_weight_pair(fr, lo == hi, &w1));
    w1 = round_bf16(w1);
    if (col) {
      ctab[k] = ColTap{3 * lo, 3 * hi, w0, w1};
    } else {
      rtab[k] = RowTap{lo, hi, w0, w1};
    }
  }
  const int vecs = P.stride / 4;               // 8-byte pieces a crop row
  uint2* c2 = reinterpret_cast<uint2*>(crop);
  for (int i = tid; i < 3 * nreal; i += kThreads) {
    const int row = i / 3;
    c2[row * vecs + 3 * size / 4 + (i - 3 * row)] = make_uint2(0, 0);
  }
  for (int i = nreal * vecs + tid; i < P.crop_rows * vecs; i += kThreads) {
    c2[i] = make_uint2(0, 0);
  }
  __syncthreads();
  GV_CLK(0)

  // the resample. A thread keeps one pair of crop columns, pc, for every
  // row it takes (pr, pr + prows, ...; threads past prows x npair idle),
  // its columns' taps in registers: frame offsets (3 x) and bf16 weights.
  const int npair = size / 2;
  const int prows = kThreads / npair;
  int pr = tid / npair;
  const int pc = tid - pr * npair;
  int ex[4] = {0, 0, 0, 0};
  float wx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (pr < prows) {
    const ColTap c0 = ctab[2 * pc], c1 = ctab[2 * pc + 1];
    ex[0] = c0.e_lo;
    ex[1] = c0.e_hi;
    ex[2] = c1.e_lo;
    ex[3] = c1.e_hi;
    wx[0] = c0.w_lo;
    wx[1] = c0.w_hi;
    wx[2] = c1.w_lo;
    wx[3] = c1.w_hi;
  } else {
    pr = prows + kThreads;                     // past every row
  }
  // the rig's frame as 4-byte words from the one holding its first element
  const uint32_t* fwords =
      reinterpret_cast<const uint32_t*>(a.images) + (frame >> 1);
  const int fpar = (int)(frame & 1);
  const int w3 = a.w * 3;
  uint4* xbuf4 = reinterpret_cast<uint4*>(xbuf);   // a column pair a uint4

  // Chunk by chunk of crop rows: the x pass of the frame rows [fr0, fr0 +
  // nfr) that rows [i0, i1) tap, then their y pass. A chunk is the rows
  // left that keep nfr <= buf_rows, a prefix (the frame rows a row taps
  // grow with it) counted in one barrier: chunk_end(from) is its end, at
  // least one row past `from`.
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // sums, squares
  auto chunk_end = [&](int from) {
    const int fr0 = rtab[min(from, max(nreal - 1, 0))].lo;
    const bool in =
        tid < nreal - from && rtab[from + tid].hi - fr0 < P.buf_rows;
    return from + max(__syncthreads_count(in), 1);
  };
  int i0 = 0;
  int i1 = chunk_end(0);
  while (i0 < nreal) {
    const int fr0 = rtab[i0].lo;
    const int nfr = rtab[i1 - 1].hi - fr0 + 1;
    // the x pass, kXBatch rows' loads in flight before the first is used.
    // Tail: the chunk taps the tensor's last frame row, where a pixel at
    // an even element takes only the lower 2 bytes of its second word
    // (all 4 may end past the tensor).
    auto x_pass = [&](auto tail) {
      for (int r0 = pr; r0 < nfr; r0 += kXBatch * prows) {
        uint2 wv[kXBatch][4];
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) {
          const int row = r0 + b * prows;
          if (row < nfr) {
            const int el = fpar + (fr0 + row) * w3;
            const bool whole =
                !decltype(tail)::value || fr0 + row < whole_rows;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t* p = fwords + ((el + ex[k]) >> 1);
              wv[b][k].x = __ldg(p);
              wv[b][k].y =
                  whole || ((el + ex[k]) & 1)
                      ? __ldg(p + 1)
                      : (uint32_t)__ldg(
                            reinterpret_cast<const unsigned short*>(p + 1));
            }
          }
        }
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) {
          const int row = r0 + b * prows;
          if (row >= nfr) continue;
          const int el = fpar + (fr0 + row) * w3;
          float px[4][3];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            px_channels(wv[b][k], (el + ex[k]) & 1, px[k]);
          }
          float v[6];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[c] = wx[0] * px[0][c] + wx[1] * px[1][c];
            v[3 + c] = wx[2] * px[2][c] + wx[3] * px[3][c];
          }
          xbuf4[row * npair + pc] =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], 0.0f),
                         pack_bf16(v[3], v[4]), pack_bf16(v[5], 0.0f));
        }
      }
    };
    if (fr0 + nfr <= whole_rows) {     // uniform over the block
      x_pass(std::false_type());
    } else {
      x_pass(std::true_type());
    }
    __syncthreads();
    GV_CLK(1)
    // the y pass
    for (int rr = pr; rr < i1 - i0; rr += prows) {
      const int i = i0 + rr;
      const RowTap rt = rtab[i];
      const uint4 t0 = xbuf4[(rt.lo - fr0) * npair + pc];
      const uint4 t1 = xbuf4[(rt.hi - fr0) * npair + pc];
      const float x0[6] = {lo_bf16(t0.x), hi_bf16(t0.x), lo_bf16(t0.y),
                           lo_bf16(t0.z), hi_bf16(t0.z), lo_bf16(t0.w)};
      const float x1[6] = {lo_bf16(t1.x), hi_bf16(t1.x), lo_bf16(t1.y),
                           lo_bf16(t1.z), hi_bf16(t1.z), lo_bf16(t1.w)};
      uint32_t yv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        yv[k] = pack_bf16(rt.w_lo * x0[2 * k] + rt.w_hi * x1[2 * k],
                          rt.w_lo * x0[2 * k + 1] + rt.w_hi * x1[2 * k + 1]);
      }
      uint32_t* dst =
          reinterpret_cast<uint32_t*>(crop + i * P.stride + 6 * pc);
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[k] = yv[k];
      if (i < owned) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float v = (k & 1) ? hi_bf16(yv[k / 2]) : lo_bf16(yv[k / 2]);
          acc[k % 3] += v;
          acc[3 + k % 3] += v * v;
        }
      }
    }
    const int next = chunk_end(i1);             // xbuf is refilled next
    GV_CLK(2)
    i0 = i1;
    i1 = next;
  }

  // the moments: the block's, then the cluster's in rank order
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc[k] += __shfl_xor_sync(0xFFFFFFFFu, acc[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) wpart[6 * warp + k] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
    float v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = lane < kWarps ? wpart[6 * lane + k] : 0.0f;
#pragma unroll
      for (int o = kWarps / 2; o > 0; o >>= 1) {
        v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) part[k] = v[k];
    }
  }
  gv::cluster_arrive();                        // every block's part is in
  gv::cluster_wait();
  if (tid < 6) {
    float s = 0.0f;
    for (int k = 0; k < P.cluster; ++k) s += gv::ld_cluster(part + tid, k);
    total[tid] = s;
  }
  __syncthreads();
  GV_CLK(3)
  gv::cluster_arrive();      // read; the wait before the exit keeps part
  float mean[3], inv[3];
  {
    const float npix = (float)(size * size);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mean[c] = __fdiv_rn(total[c], npix);
      const float ex2 = __fdiv_rn(total[3 + c], npix);
      const float var =
          fmaxf(__fsub_rn(ex2, __fmul_rn(mean[c], mean[c])), 0.0f);
      inv[c] = __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(var), 1e-6f));
    }
  }

  // standardize the block's crop rows in place, 4 pixels (12 values) a unit
  for (Walk u(size / 4); u.r < nreal; u.next()) {
    uint2* p = reinterpret_cast<uint2*>(crop + u.r * P.stride + 12 * u.c);
    uint32_t w[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint2 v = p[k];
      w[2 * k] = v.x;
      w[2 * k + 1] = v.y;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int c0 = (2 * k) % 3, c1 = (2 * k + 1) % 3;
      w[k] = pack_bf16(
          __fmul_rn(__fsub_rn(lo_bf16(w[k]), mean[c0]), inv[c0]),
          __fmul_rn(__fsub_rn(hi_bf16(w[k]), mean[c1]), inv[c1]));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = make_uint2(w[2 * k], w[2 * k + 1]);
  }
  __syncthreads();
  GV_CLK(4)
  mbar_wait(wbar, 0);                          // the weights and constants
  GV_CLK(5)

  // the conv: warpgroup wg takes pixels [64 wg, 64 wg + 64) of the block's
  // out_rows x q; the thread's fragment rows g, g + 8 are pixels 2g, 2g + 1
  // of its warp's 16
  const int wg = tid >> 7;
  const int npx = out_rows * q;
  if (64 * wg < npx) {                         // uniform over the warpgroup
    const int g = lane >> 2;
    const int t = lane & 3;
    const int p0 = 64 * wg + 16 * (warp & 3) + 2 * g;
    int base[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = p0 + hr < npx ? p0 + hr : 0;
      const int oy = p / q;
      base[hr] = 8 * oy * P.stride + 24 * (p - oy * q) + 4 * t;
    }
    const int stride = P.stride;
    auto load = [&](int s, uint32_t (&fr)[4]) {
      const int k = 16 * s + 4 * t;            // the thread's first k
      const int uy = k / 36;
      const int off = uy * stride + 16 * s - 36 * uy;
      const uint2 lo = *reinterpret_cast<const uint2*>(crop + base[0] + off);
      const uint2 hi = *reinterpret_cast<const uint2*>(crop + base[1] + off);
      fr[0] = lo.x;
      fr[1] = hi.x;
      fr[2] = lo.y;
      fr[3] = hi.y;
    };
    // H halves of 64 channels: the accumulators' size is compile-time
    auto conv = [&](auto halves) {
      constexpr int H = decltype(halves)::value;
      float d[32 * H];
      product<H, kGroup>(d, kSteps, smem_u32(smem), load);
      GV_CLK(6)
#pragma unroll
      for (int h = 0; h < 2 * H; ++h) {      // 32 channels at a time
        const int ch = 32 * h + 8 * t;
        if (ch >= f) continue;
        const float4* sp4 = reinterpret_cast<const float4*>(s_scale + ch);
        const float4* tp4 = reinterpret_cast<const float4*>(s_shift + ch);
        const float4 sa = sp4[0], sb = sp4[1], ta = tp4[0], tb = tp4[1];
        const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
        const float sf[8] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (p0 + hr >= npx) continue;
          float v[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // channel acc_channel(4h + jj, t, e)
              const float y = d[4 * (4 * h + jj) + 2 * hr + e];
              v[2 * jj + e] =
                  __fadd_rn(__fmul_rn(y, sc[2 * jj + e]), sf[2 * jj + e]);
            }
          }
          *reinterpret_cast<uint4*>(out + (p0 + hr) * f + ch) = make_uint4(
              pack_relu_bf16(v[0], v[1]), pack_relu_bf16(v[2], v[3]),
              pack_relu_bf16(v[4], v[5]), pack_relu_bf16(v[6], v[7]));
        }
      }
    };
    if (a.halves > 1) {
      conv(std::integral_constant<int, 2>());
    } else {
      conv(std::integral_constant<int, 1>());
    }
  }
  GV_CLK(7)
  gv::cluster_wait();        // no block leaves while one may read its part
  GV_CLK(8)
#ifdef GV_ORIENT_CLOCKS
  if (threadIdx.x == 0) {
    for (int i = 0; i < 9; ++i) {
      atomicAdd(gv_orient_clocks + i, (unsigned long long)clk[i]);
    }
    atomicAdd(gv_orient_clocks + 9, 1ull);
  }
#endif
}

// ---- a bare wgmma product, for the card tests ----------------------------

// out (M, N) f32 = a (M, K) bf16 row-major @ the (K, N) matrix packed into
// b: N = 64 halves by pack_wgmma_b_halves (at one half pack_wgmma_b's
// layout), or N = 32 or 96 by pack_wgmma_b; one warpgroup a 64-row block,
// B by cp.async.bulk into shared memory, A fragments from global memory in
// pack_wgmma_b's k order, the product on this kernel's path (at N = 32 or
// 96, one m64n32k16 / m64n96k16 a step). The check of the B layout and A
// k order that the bf16 kernels give gv_hopper.cuh's wgmma (the stem's
// conv1 at one half, this kernel's conv at one or two, the CSP stage's
// convs at N = 64 and 96).
__global__ void __launch_bounds__(128)
gv_wgmma_product_kernel(const bf16* __restrict__ a, int k,
                               const bf16* __restrict__ b, int n,
                               float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int steps = k / 16;
  const int b_bytes = steps * n * 32;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + b_bytes);
  const uint32_t wb = smem_u32(smem);
  const uint32_t mbar = smem_u32(bar);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  if (threadIdx.x == 0) mbar_init(mbar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(mbar, b_bytes);
    bulk_copy(wb, b, b_bytes, mbar);
  }
  mbar_wait(mbar, 0);
  const int row = blockIdx.x * 64 + 16 * warp + g;
  const bf16* a0 = a + (int64_t)row * k + 4 * t;
  const bf16* a1 = a0 + (int64_t)8 * k;
  auto load = [&](int s, uint32_t (&fr)[4]) {
    const uint2 lo = *reinterpret_cast<const uint2*>(a0 + 16 * s);
    const uint2 hi = *reinterpret_cast<const uint2*>(a1 + 16 * s);
    fr[0] = lo.x;
    fr[1] = hi.x;
    fr[2] = lo.y;
    fr[3] = hi.y;
  };
  auto store = [&](const auto& d) {
    constexpr int nd = sizeof(d) / sizeof(float);
#pragma unroll
    for (int j = 0; j < nd / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[(int64_t)(row + 8 * (e >> 1)) * n + acc_channel(j, t, e & 1)] =
            d[4 * j + e];
      }
    }
  };
  auto run = [&](auto hc) {
    constexpr int H = decltype(hc)::value;
    float d[32 * H];
    product<H, 1>(d, steps, wb, load);
    store(d);
  };
  // pack_wgmma_b's layout on one instruction of width N (32 or 96)
  auto narrow = [&](auto& d, auto mma) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(d) / sizeof(float)); ++i) d[i] = 0.0f;
    for (int s = 0; s < steps; ++s) {
      uint32_t fr[4];
      load(s, fr);
      fence_acc(d);
      wgmma_fence();
      mma(d, fr, b_desc(wb + s * n * 32), s > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(d);
    }
    store(d);
  };
  if (n == 32) {
    float d[16];
    narrow(d, [](float(&dd)[16], const uint32_t(&fr)[4], uint64_t desc,
                 int sc) { gv::wgmma_m64n32k16(dd, fr, desc, sc); });
  } else if (n == 96) {
    float d[48];
    narrow(d, [](float(&dd)[48], const uint32_t(&fr)[4], uint64_t desc,
                 int sc) { gv::wgmma_m64n96k16(dd, fr, desc, sc); });
  } else if (n == 128) {
    run(std::integral_constant<int, 2>());
  } else {
    run(std::integral_constant<int, 1>());
  }
}

int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaLaunchConfig_t cluster_config(const Plan& p, int n,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * p.cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// images: (frames, h, w, 3) bf16, 4-byte aligned; rig: (n,) int32 or int64;
// valid: (n,) bytes; xyxy: (n, 4) f32; wwg: the (432, f) weights without
// the BN scale, packed by bf16mma.pack_wgmma_b_halves ((f + 63) / 64
// halves); scale / shift: the BN's (f,) f32, 16-byte aligned; out: (n,
// size / 8, size / 8, f) bf16. size % 8 == 0, f % 16 == 0, f <= 128.
// Nonzero: a CUDA error (cudaErrorInvalidValue for a size or width the
// plan cannot take).
extern "C" int gv_orient_front_bf16(const void* images, int frames, int h,
                                    int w, const void* rig, int rig_is_i64,
                                    const uint8_t* valid, const float* xyxy,
                                    int n, int size, const void* wwg, int f,
                                    const float* scale, const float* shift,
                                    void* out, cudaStream_t stream) {
  const Plan p = make_plan(size, f);
  if (p.cluster == 0 || frames <= 0 || h <= 0 || w <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return 0;
  if ((int64_t)n * p.cluster > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int err = set_smem((const void*)gv_orient_bf16_kernel, p.smem);
  if (err) return err;
  Args args{static_cast<const bf16*>(images), frames, h, w, rig, rig_is_i64,
            valid, xyxy, size, size / 8, f, (f + 63) / 64,
            static_cast<const bf16*>(wwg), scale, shift,
            static_cast<bf16*>(out), p};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, n, &attr, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gv_orient_bf16_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel's plan for a crop size and width: {cluster, output rows a
// block, crop rows a block, a crop row's elements, the x pass's rows,
// dynamic shared memory, clusters resident on the card at once (0 where
// the plan is refused)}.
extern "C" int gv_orient_bf16_plan(int size, int f, int* plan) {
  const Plan p = make_plan(size, f);
  plan[0] = p.cluster;
  plan[1] = p.rows;
  plan[2] = p.crop_rows;
  plan[3] = p.stride;
  plan[4] = p.buf_rows;
  plan[5] = p.smem;
  plan[6] = 0;
  if (p.cluster == 0) return 0;
  const int err = set_smem((const void*)gv_orient_bf16_kernel, p.smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, 1, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(
      &plan[6], (const void*)gv_orient_bf16_kernel, &cfg);
}

// out (m, n) f32 = a (m, k) bf16 @ b, the (k, n) matrix packed by
// pack_wgmma_b_halves (n = 64 or 128) or pack_wgmma_b (n = 32 or 96); m %
// 64 == 0, k % 16 == 0, k <= 576.
extern "C" int gv_wgmma_product_bf16(const void* a, int m, int k,
                                     const void* b, int n, float* out,
                                     cudaStream_t stream) {
  if (m <= 0 || m % 64 || k <= 0 || k % 16 || k > 576 ||
      (n != 32 && n != 64 && n != 96 && n != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (k / 16) * n * 32 + 16;
  const int err = set_smem((const void*)gv_wgmma_product_kernel, smem);
  if (err) return err;
  gv_wgmma_product_kernel<<<m / 64, 128, smem, stream>>>(
      static_cast<const bf16*>(a), k, static_cast<const bf16*>(b), n, out);
  return (int)cudaGetLastError();
}

#ifdef GV_ORIENT_CLOCKS
// Reads and clears the phase cycles (a measurement build only).
extern "C" int gv_orient_bf16_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, gv_orient_clocks, 10 * 8);
  if (err) return err;
  const unsigned long long zero[10] = {};
  return (int)cudaMemcpyToSymbol(gv_orient_clocks, zero, 10 * 8);
}
#endif
