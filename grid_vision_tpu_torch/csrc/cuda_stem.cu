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
// -> 416 -> 208 -> 104) a frame is 0.40 GFLOP in ConvBN_1, 0.075 in
// ConvBN_0 and 0.013 in the resize, against ~6.5 MB of compulsory traffic
// (frame in, activation out): 15:1 over the bytes at the FP32 rate. What a
// straightforward kernel loses is not arithmetic but operand traffic: every
// product fed by its own shared- or global-memory load, the resize redone
// for every conv tap that touches a pixel. Design, two launches:
//   1. resize + ConvBN_0, a block (4 warps) per 8 x 32 tile of conv0
//      outputs, four blocks an SM. The block stages the frame rows and
//      columns under its tile (the extent comes from the tap windows the
//      host passes: a window is clamped at the frame's edge, so no scale
//      factor gives it) with cp.async, 16 bytes a piece where the frame's
//      rows are aligned, resamples separably through shared memory, along x
//      and then along y as the plain version's einsums do, so each resized
//      pixel is computed once a block, and runs the conv from that resized
//      tile in FFMA register tiles: a thread owns two pixels x all 32
//      channels, a weight comes in as a 16-byte shared-memory broadcast and
//      meets eight products. The resized tile is split by column parity, so
//      that a warp's stride-2 taps read consecutive pixels: no bank
//      conflict. A warp's 32 pixels x 32 channels are 4 KB in a row of the
//      output: they go out through a swizzled shared-memory transpose, 512
//      bytes an instruction (a thread storing its own 128 bytes cost twice
//      the store's share of the time).
//   2. ConvBN_1 as the product (pixels) x (K = 9 taps x 32) by 288 x 64 on
//      the tensor cores in 3xTF32 (gv_mma.cuh; the f32 contract, 1e-4
//      against the twin, does not survive plain TF32). A block (4 warps)
//      owns 8 x 16 output pixels and all 64 channels, so a conv0 activation
//      is read from device memory once: the 17 x 33 pixel input tile with
//      its halo is staged with cp.async, zero where the SAME padding is. A
//      staged pixel is 36 floats: the rows of an A fragment are output
//      pixels, two staged pixels apart, and 72 floats = 8 banks put a
//      half-warp's 8-byte loads in 32 different banks (32 + 8 would put
//      them 80 apart: a four-way conflict). The packed weights (BN scale
//      folded in, split into hi and lo on the host) stream tap by tap
//      through a double buffer; a tap's 12 mma are one chain on the tensor
//      core, the taps are added in f32 outside it. The epilogue adds the BN
//      shift, applies the leaky slope and stores 16 bytes a thread.
// The conv0 activation goes through device memory between the two (at 64
// frames it does not fit the L2). Keeping it on the SM, the TPU kernel's
// way, was built and measured on an H100: one launch, a block resampling,
// running ConvBN_0 on its 17 x 33 tile with the halo recomputed and then
// ConvBN_1, all in the second kernel's 114 KB. It took 1.00 ms against the
// two launches' 0.92 at 64 frames: at two blocks of four warps an SM the
// resize and ConvBN_0 phases, which wait on memory and on each other, have
// too few warps to hide it, and the tensor-core phase's 212 registers a
// thread leave room for no more. The two launches give each phase the
// occupancy it wants.

#include <type_traits>

#include "gv_mma.cuh"

namespace {

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

// ---- launch 1: resize + ConvBN_0 ----------------------------------------

constexpr int kC0Threads = 128;
constexpr int kC0Warps = kC0Threads / 32;
constexpr int kT0H = 8;                       // conv0 outputs a tile: rows
constexpr int kT0W = 32;                      // and columns (one a lane)
constexpr int kR0H = 2 * kT0H + 1;            // resized rows under the tile
constexpr int kR0W = 2 * kT0W + 1;            // resized columns
constexpr int kR0Plane = (kT0W + 1) * 3;      // floats of one column parity
constexpr int kR0Row = 2 * kR0Plane;          // floats a resized row
constexpr int kR0Floats = (kR0H * kR0Row + 3) / 4 * 4;   // 16-byte multiple
constexpr int kXresRow = kR0W * 3;            // floats a row resampled in x
constexpr int kC0ConstFloats = 27 * 32 + 64;  // w0, BN scale, BN shift

// Shared memory of the conv0 kernel, in floats: the constants, the frame
// patch (the resized tile takes its place once the x pass has read it) and
// all of the patch's rows resampled along x. fh / fw: the most frame rows /
// columns a tile's tap windows span; band: the frame rows staged at a time.
// A staged frame row starts at a 16-byte boundary of the frame where the
// copies are 16 bytes wide, up to 3 floats before its first tapped one, and
// is a multiple of 4 floats long.
__host__ __device__ constexpr int c0_patch_row(int fw) {
  return (fw * 3 + 3 + 3) / 4 * 4;
}

__host__ __device__ constexpr int c0_patch_floats(int band, int fw) {
  return band * c0_patch_row(fw) > kR0Floats ? band * c0_patch_row(fw)
                                             : kR0Floats;
}

// ... and the rows resampled along x, or the warps' 32 x 32 float corners
// that stage the output.
__host__ __device__ constexpr int c0_xres_floats(int fh) {
  return fh * kXresRow > kC0Warps * 1024 ? fh * kXresRow : kC0Warps * 1024;
}

__host__ __device__ constexpr int c0_smem_bytes(int fh, int fw, int band) {
  return (kC0ConstFloats + c0_patch_floats(band, fw) + c0_xres_floats(fh)) *
         4;
}

static_assert(kC0Warps == kT0H / 2, "a warp owns rows w and w + kT0H / 2");

// 4 bytes global -> shared, asynchronously (gv::cp_async16's narrow twin).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// Up to four taps of a resampling row from index b0: their weights (0 past
// the last tap) and their offsets at `step` floats a tap (past the last tap:
// the first one's, so that nothing outside the window is read).
__device__ __forceinline__ void load_taps(const float* __restrict__ wt,
                                          int b0, int n, int step,
                                          float (&w4)[4], int (&o4)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = b0 + q < n;
    w4[q] = in ? __ldg(wt + b0 + q) : 0.0f;
    o4[q] = (in ? b0 + q : b0) * step;
  }
}

// The resized rows [r_lo, r_lo + kR0H) x columns [s_lo, s_lo + kR0W) of one
// frame into `rt`, by all warps of the block: rows and columns outside the
// image are zero (SAME padding); column cc lies in parity plane cc & 1 at
// cc >> 1, 3 floats a pixel. The frame rows and columns under the tile (from
// the tap windows) are staged in `patch`, `band` rows a pass (16-byte copies
// from the boundary before the first tapped float where the frame's rows
// allow it, else 4 bytes each), and resampled along x as they come into
// xres[row][(s - s_lo) * 3 + c] (rxw carries the 1/255), then along y. rt
// may lie over patch. Ends with the block in step.
template <typename T>
__device__ __forceinline__ void resized_tile(
    const T* __restrict__ frame, int w, const int32_t* __restrict__ ry0,
    const float* __restrict__ ryw, int ty_n, const int32_t* __restrict__ rx0,
    const float* __restrict__ rxw, int tx_n, int size, int r_lo, int s_lo,
    int band, int wide, float* patch, float* xres, float* rt) {
  // bf16: the frame comes in as bf16 (staged as f32, exact), and each
  // resampling pass's sums are rounded to bf16 (the Pallas kernel's bf16
  // products with f32 sums, cast between the two)
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the rows and columns inside the image: [ra, rb] x [sa, sb]
  const int ra = max(r_lo, 0), rb = min(r_lo + kR0H - 1, size - 1);
  const int sa = max(s_lo, 0), sb = min(s_lo + kR0W - 1, size - 1);
  const int fy0 = ry0[ra];
  const int fh = ry0[rb] + ty_n - fy0;
  const int fx0 = rx0[sa];
  const int fwf = (rx0[sb] + tx_n - fx0) * 3;
  const int p0 = wide ? (fx0 * 3) & ~3 : fx0 * 3;
  const int pn = (fx0 * 3 + fwf - p0 + 3) & ~3;            // floats a row
  const int ns3 = (sb - sa + 1) * 3;
  for (int band0 = 0; band0 < fh; band0 += band) {
    const int rows = min(band, fh - band0);
    for (int row = warp; row < rows; row += kC0Warps) {
      const T* src = frame + (int64_t)(fy0 + band0 + row) * w * 3 + p0;
      float* dst = patch + row * pn;
      if constexpr (kBf16) {
        for (int col = lane; col < fwf; col += 32) {
          dst[col] = __bfloat162float(src[col]);
        }
      } else if (wide) {
        for (int col = 4 * lane; col < pn; col += 128) {
          gv::cp_async16(dst + col, src + col, true);
        }
      } else {
        for (int col = lane; col < fwf; col += 32) {
          cp_async4(dst + col, src + col);
        }
      }
    }
    gv::cp_async_commit();
    gv::cp_async_wait<0>();
    __syncthreads();
    for (int j = lane; j < ns3; j += 32) {
      const int sj = j / 3;
      const int s = sa + sj;
      const int off = rx0[s] * 3 - p0 + (j - 3 * sj);
      for (int b0 = 0; b0 < tx_n; b0 += 4) {
        float w4[4];
        int o4[4];
        load_taps(rxw + s * tx_n, b0, tx_n, 3, w4, o4);
        const bool last = b0 + 4 >= tx_n;
#pragma unroll 5
        for (int row = warp; row < rows; row += kC0Warps) {
          const float* px = patch + row * pn + off;
          float acc = w4[0] * px[o4[0]];
          acc += w4[1] * px[o4[1]];
          acc += w4[2] * px[o4[2]];
          acc += w4[3] * px[o4[3]];
          float* dst = xres + (band0 + row) * kXresRow + (sa - s_lo) * 3 + j;
          const float v = b0 == 0 ? acc : *dst + acc;
          *dst = kBf16 && last ? gv::round_bf16(v) : v;
        }
      }
    }
    __syncthreads();
  }
  for (int rr = warp; rr < kR0H; rr += kC0Warps) {
    const int r = r_lo + rr;
    const bool row_ok = r >= ra && r <= rb;
    const float* src = xres + (row_ok ? ry0[r] - fy0 : 0) * kXresRow;
    float* dst = rt + rr * kR0Row;
    const int n_a = row_ok ? ty_n : 1;
    for (int a0 = 0; a0 < n_a; a0 += 4) {
      float w4[4];
      int o4[4];
      load_taps(ryw + (row_ok ? r : 0) * ty_n, a0, ty_n, kXresRow, w4, o4);
      const bool last = a0 + 4 >= n_a;
#pragma unroll
      for (int j = lane; j < kXresRow; j += 32) {
        const int cc = j / 3;
        const int s = s_lo + cc;
        float acc = 0.0f;
        if (row_ok && s >= sa && s <= sb) {
          acc = w4[0] * src[o4[0] + j];
          acc += w4[1] * src[o4[1] + j];
          acc += w4[2] * src[o4[2] + j];
          acc += w4[3] * src[o4[3] + j];
        }
        float* d = dst + (cc & 1) * kR0Plane + (cc >> 1) * 3 + (j - 3 * cc);
        const float v = a0 == 0 ? acc : *d + acc;
        *d = kBf16 && last ? gv::round_bf16(v) : v;
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kC0Threads)
gv_stem_conv0_kernel(const T* __restrict__ img, int h, int w,
                     const int32_t* __restrict__ ry0,
                     const float* __restrict__ ryw, int ty_n,
                     const int32_t* __restrict__ rx0,
                     const float* __restrict__ rxw, int tx_n, int size,
                     int fw_max, int band, int wide,
                     const float* __restrict__ w0,
                     const float* __restrict__ s0,
                     const float* __restrict__ b0, int pad0, int s0_size,
                     T* __restrict__ mid) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                           // (27, 32) + scale + shift
  float* patch = smem + kC0ConstFloats;       // frame rows, then the tile
  float* xres = patch + c0_patch_floats(band, fw_max);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cx0 = blockIdx.x * kT0W;
  const int cy0 = blockIdx.y * kT0H;
  for (int i = threadIdx.x; i < kC0ConstFloats; i += kC0Threads) {
    sw[i] = i < 27 * 32 ? w0[i]
                        : (i < 27 * 32 + 32 ? s0[i - 27 * 32]
                                            : b0[i - 27 * 32 - 32]);
  }
  resized_tile(
      img + (int64_t)blockIdx.z * h * w * 3, w, ry0, ryw, ty_n, rx0, rxw, tx_n,
      size, 2 * cy0 - pad0, 2 * cx0 - pad0, band, wide, patch, xres, patch);

  // the conv: lane = column, a thread's two pixels are kT0H / 2 rows apart
  const int row0 = warp;                      // kC0Warps == kT0H / 2
  float acc[2][32];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int co = 0; co < 32; ++co) acc[p][co] = 0.0f;
  }
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      const float* px = patch + (2 * row0 + ty) * kR0Row +
                        (tx & 1) * kR0Plane + (lane + (tx >> 1)) * 3;
      const float4* wt =
          reinterpret_cast<const float4*>(sw + (ty * 3 + tx) * 96);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v0 = px[c];
        const float v1 = px[kT0H * kR0Row + c];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 wv = wt[c * 8 + q];
          acc[0][4 * q] += wv.x * v0;
          acc[0][4 * q + 1] += wv.y * v0;
          acc[0][4 * q + 2] += wv.z * v0;
          acc[0][4 * q + 3] += wv.w * v0;
          acc[1][4 * q] += wv.x * v1;
          acc[1][4 * q + 1] += wv.y * v1;
          acc[1][4 * q + 2] += wv.z * v1;
          acc[1][4 * q + 3] += wv.w * v1;
        }
      }
    }
  }
  // BN, leaky, and out through the warp's 32 x 32 float corner of the xres
  // rows (free since the y pass): a row of the tile is 32 pixels x 32
  // channels = 4 KB in a row of `mid` (2 KB in bf16), which the warp then
  // writes 512 (256) bytes an instruction. 16-byte slot q of pixel x sits at
  // q ^ (x & 7): neither the writes (a pixel a lane) nor the reads (a slot a
  // lane) conflict. bf16: BN as a multiply, then an add (no FMA), as the
  // Pallas kernel and the twin compute it.
  const float* ss = sw + 27 * 32;
  const float* sh = ss + 32;
  float4* stage = reinterpret_cast<float4*>(xres) + warp * (32 * 8);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int oy = cy0 + row0 + p * (kT0H / 2);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        v[e] = kBf16 ? leaky(__fadd_rn(__fmul_rn(acc[p][c], ss[c]), sh[c]))
                     : leaky(acc[p][c] * ss[c] + sh[c]);
      }
      stage[lane * 8 + (q ^ (lane & 7))] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();
    if (oy < s0_size) {
      T* dst =
          mid + (((int64_t)blockIdx.z * s0_size + oy) * s0_size + cx0) * 32;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int x = 4 * i + (lane >> 3);    // slot (lane & 7) of pixel x
        if (cx0 + x < s0_size) {
          const float4 v = stage[x * 8 + ((lane & 7) ^ (x & 7))];
          gv::store4(dst + 4 * (32 * i + lane), v.x, v.y, v.z, v.w);
        }
      }
    }
    __syncwarp();
  }
}

// ---- launch 2: ConvBN_1 on the tensor cores ------------------------------

constexpr int kC1Threads = 128;               // 4 warps
constexpr int kMT = 2;                        // m16 tiles (rows) a warp
constexpr int kT1H = 4 * kMT;                 // output rows a tile
constexpr int kT1W = 16;                      // one m16 tile per tile row
constexpr int kMidH = 2 * kT1H + 1;
constexpr int kMidW = 2 * kT1W + 1;
constexpr int kNT = 8;                        // n-tiles: 64 channels

// f32: a staged pixel is 36 floats (rows two pixels apart: 72 floats = 8
// banks); bf16: 40 bf16 (80 bytes, 16-byte pieces; two pixels = 40 words,
// 8 banks).
template <typename T>
struct Conv1Cfg {
  using O = gv::Op<T>;
  static constexpr int kStride = std::is_same<T, float>::value ? 36 : 40;
  static constexpr int kMidElems = kMidH * kMidW * kStride;
  static constexpr int kSteps = 32 / O::kK;   // mma k steps a tap
  static constexpr int kTapElems = kSteps * kNT * 32 * 4;
  static constexpr int kSmemBytes =
      (kMidElems + 2 * kTapElems) * (int)sizeof(T) + 2 * 64 * 4;
};

// mid: (B, s0, s0, 32); wfrag: the (288, 64) matrix in (ty, tx, c) row
// order (f32: BN scale folded in, packed by tf32x3.pack_b_fragments; bf16:
// packed by bf16mma.pack_b_fragments, scale the BN scale); out: (B, s1, s1,
// 64).
template <typename T>
__global__ void __launch_bounds__(kC1Threads)
gv_stem_conv1_kernel(const T* __restrict__ mid, int s0_size,
                     const T* __restrict__ wfrag,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, int pad1, int s1_size,
                     T* __restrict__ out) {
  using C = Conv1Cfg<T>;
  using O = gv::Op<T>;
  using Frag = typename O::Frag;
  constexpr int kPer = 16 / (int)sizeof(T);   // elements a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + C::kMidElems;
  float* sscale = reinterpret_cast<float*>(wbuf + 2 * C::kTapElems);
  float* sshift = sscale + 64;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kT1W;
  const int y0 = blockIdx.y * kT1H;
  const T* src = mid + (int64_t)blockIdx.z * s0_size * s0_size * 32;

  // the 17 x 33 input tile: output (y, x) taps (2y - pad1 + ty, 2x - pad1 +
  // tx); zero outside the conv0 image
  for (int i = tid; i < kMidH * kMidW * (32 / kPer); i += kC1Threads) {
    const int pix = i / (32 / kPer);
    const int v = i - pix * (32 / kPer);
    const int ry = pix / kMidW;
    const int rx = pix - ry * kMidW;
    const int y = 2 * y0 - pad1 + ry;
    const int x = 2 * x0 - pad1 + rx;
    const bool ok = y >= 0 && y < s0_size && x >= 0 && x < s0_size;
    const T* p = ok ? src + ((int64_t)y * s0_size + x) * 32 + kPer * v : src;
    gv::cp_async16(tile + pix * C::kStride + kPer * v, p, ok);
  }
  auto load_tap = [&](int tap) {
    const T* s = wfrag + (int64_t)tap * C::kTapElems;
    T* d = wbuf + (tap & 1) * C::kTapElems;
    for (int i = tid; i < C::kTapElems / kPer; i += kC1Threads) {
      gv::cp_async16(d + kPer * i, s + kPer * i, true);
    }
    gv::cp_async_commit();
  };
  load_tap(0);                                // one group with the tile
  if (tid < 64) {
    sshift[tid] = shift[tid];
    sscale[tid] = std::is_same<T, float>::value ? 1.0f : scale[tid];
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {
      load_tap(tap + 1);
      gv::cp_async_wait<1>();
    } else {
      gv::cp_async_wait<0>();
    }
    __syncthreads();
    const int ty = tap / 3;
    const int tx = tap - 3 * ty;
    const Frag* wb =
        reinterpret_cast<const Frag*>(wbuf + (tap & 1) * C::kTapElems);
    // row g of the A fragment: output pixel (warp * kMT + mt, g), whose tap
    // is the staged pixel (2 * row + ty, 2 * g + tx); row g + 8: 16 further
    const T* a0 = tile +
                  ((2 * warp * kMT + ty) * kMidW + 2 * g + tx) * C::kStride +
                  O::kThreadK * t;
    float d[kMT][kNT][4];                     // 3xTF32: the tap's chain
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      Frag b[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) b[nt] = wb[(ks * kNT + nt) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const T* a = a0 + mt * 2 * kMidW * C::kStride + ks * O::kK;
        if constexpr (O::kSplitChains) {
          O::step(d[mt], ks == 0, a, a + 16 * C::kStride, b);
        } else {
          O::step(acc[mt], false, a, a + 16 * C::kStride, b);
        }
      }
    }
    if constexpr (O::kSplitChains) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) gv::add_chain(acc[mt], d[mt]);
    }
    __syncthreads();                          // the buffer is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int y = y0 + warp * kMT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + g + 8 * half;
      if (y < s1_size && x < s1_size) {
        T* dst = out +
                 (((int64_t)blockIdx.z * s1_size + y) * s1_size + x) * 64 +
                 4 * t;
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          const float* ss = sscale + 16 * p + 4 * t;
          const float* sh = sshift + 16 * p + 4 * t;
          const float a[4] = {acc[mt][2 * p][2 * half],
                              acc[mt][2 * p][2 * half + 1],
                              acc[mt][2 * p + 1][2 * half],
                              acc[mt][2 * p + 1][2 * half + 1]};
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = std::is_same<T, float>::value
                       ? leaky(a[e] + sh[e])
                       : leaky(__fadd_rn(__fmul_rn(a[e], ss[e]), sh[e]));
          }
          gv::store4(dst + 16 * p, v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

template <typename T>
int detector_stem(const T* img, int batch, int h, int w, const int32_t* ry0,
                  const float* ryw, int ty_n, const int32_t* rx0,
                  const float* rxw, int tx_n, int size, int fh_max,
                  int fw_max, int band, int wide, const float* w0,
                  const float* s0, const float* b0, int pad0, int s0_size,
                  T* mid, const T* w1frag, const float* s1, const float* b1,
                  int pad1, int s1_size, T* out, cudaStream_t stream) {
  if (batch > 65535 || band <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const int smem0 = c0_smem_bytes(fh_max, fw_max, band);
  cudaError_t err = cudaFuncSetAttribute(
      gv_stem_conv0_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem0);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid0((s0_size + kT0W - 1) / kT0W, (s0_size + kT0H - 1) / kT0H,
                   batch);
  gv_stem_conv0_kernel<T><<<grid0, kC0Threads, smem0, stream>>>(
      img, h, w, ry0, ryw, ty_n, rx0, rxw, tx_n, size, fw_max, band, wide, w0,
      s0, b0, pad0, s0_size, mid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gv_stem_conv1_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Conv1Cfg<T>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((s1_size + kT1W - 1) / kT1W, (s1_size + kT1H - 1) / kT1H,
                   batch);
  gv_stem_conv1_kernel<T><<<grid1, kC1Threads, Conv1Cfg<T>::kSmemBytes,
                            stream>>>(mid, s0_size, w1frag, s1, b1, pad1,
                                      s1_size, out);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (B, h, w, 3) in [0, 255]; ry0 / ryw, rx0 / rxw: each resized row's /
// column's tap window start and its ty_n / tx_n weights (rxw times 1/255);
// fh_max / fw_max: the most frame rows / columns that the windows of 2 *
// 8 + 1 resized rows / 2 * 32 + 1 columns span, band: how many of those
// rows a block stages at a time, wide: the frame's rows are 16-byte aligned
// (w * 3 a multiple of 4, img aligned); w0: (27, 32) in (ty, tx, c)
// row order, s0 / b0: ConvBN_0's BN scale and shift; mid: (B, s0, s0, 32)
// scratch; w1frag: ConvBN_1 packed (see the conv1 kernel), b1 its BN shift;
// out: (B, s1, s1, 64).
extern "C" int gv_detector_stem(
    const float* img, int batch, int h, int w, const int32_t* ry0,
    const float* ryw, int ty_n, const int32_t* rx0, const float* rxw,
    int tx_n, int size, int fh_max, int fw_max, int band, int wide,
    const float* w0, const float* s0, const float* b0, int pad0, int s0_size,
    float* mid, const float* w1frag, const float* b1, int pad1, int s1_size, float* out,
    cudaStream_t stream) {
  return detector_stem<float>(img, batch, h, w, ry0, ryw, ty_n, rx0, rxw,
                              tx_n, size, fh_max, fw_max, band, wide, w0, s0,
                              b0, pad0, s0_size, mid, w1frag, nullptr, b1,
                              pad1, s1_size, out, stream);
}

// What the launch above gets (tests/test_torch_cuda.py holds it to the
// wrapper's conv0_shared_bytes): {conv0's blocks that fit one SM, conv1's,
// conv0's dynamic shared memory in bytes, conv1's}.
extern "C" int gv_stem_blocks_per_sm(int fh_max, int fw_max, int band,
                                     int* blocks) {
  const int smem0 = c0_smem_bytes(fh_max, fw_max, band);
  blocks[2] = smem0;
  cudaError_t err = cudaFuncSetAttribute(
      gv_stem_conv0_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem0);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], gv_stem_conv0_kernel<float>, kC0Threads, smem0);
  if (err != cudaSuccess) return (int)err;
  const int smem1 = Conv1Cfg<float>::kSmemBytes;
  blocks[3] = smem1;
  err = cudaFuncSetAttribute(gv_stem_conv1_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[1], gv_stem_conv1_kernel<float>, kC1Threads, smem1);
}
