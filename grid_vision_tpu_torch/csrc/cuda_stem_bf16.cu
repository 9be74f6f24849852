// The detector front end's bf16 form for Hopper (sm_90a), in one launch:
// antialiased resize + /255 -> ConvBN_0 (3x3/s2, 3->32, BN, leaky 0.1) ->
// ConvBN_1 (3x3/s2, 32->64, BN, leaky 0.1), (B, H, W, 3) bf16 frames ->
// (B, S1, S1, 64) bf16.
//
// Replaces the TPU kernel grid_vision_tpu/ops/pallas_stem.py
// (detector_stem_pallas -> _stem_kernel, compute_dtype="bfloat16"), which
// keeps the conv0 activation on chip (its scrm_ref) and runs conv0 as one
// matmul. The f32 form stays in cuda_stem.cu.
//
// Bound on this card: bytes. At 64 frames of 480x640 -> 416 -> 208 -> 104
// the frames in and the activation out are 207 MB (0.062 ms at 3.35 TB/s);
// ConvBN_1 is 25.5 GFLOP and ConvBN_0 4.8 on the bf16 tensor cores (0.031
// ms). The earlier bf16 form was two launches of the f32 design: the conv0
// activation (177 MB at 64 frames) went out to device memory and back,
// conv0 and the resize ran in FFMA from a frame staged by 2-byte loads,
// and conv1 streamed its 36 KB of weights from L2 for every tile. Here, in
// one persistent launch (two blocks of two warpgroups an SM, each block
// walking (frame, tile) pairs):
//   - A block's conv1 tile is 8 x 16 outputs x 64 channels. It computes
//     the tile's 17 x 33 conv0 pixels (halo included: 10 % recomputed) into
//     shared memory as bf16, rounded where the stored activation was
//     rounded, and never writes them out.
//   - The frame rows under the tile arrive by one TMA tensor copy (a tensor
//     map over the frames as rows of 4-byte pairs, from the 16-byte
//     boundary at or before the first tapped element; a bulk copy a row
//     where a frame row is no multiple of 16 bytes), with the tap tables'
//     rows under the tile, on an mbarrier. Warp 0 asks for the next tile's
//     as soon as conv0 has read the resized pixels (their buffer), so the
//     copy runs under conv1; the other block of the SM hides the rest.
//   - Both resize passes run on the tensor cores (mma.sync m16n8k16), a
//     channel at a time, as products with band matrices of the tile's
//     resampling weights built in shared memory: x, M = resized columns, N
//     = frame rows, K = frame columns, each m16 tile over its band's k
//     steps only; y, M = resized rows, N = resized columns, K = frame rows.
//     bf16 weights times bf16 values are exact and the sums f32; each
//     pass's result is rounded to bf16 as the Pallas kernel rounds it.
//   - ConvBN_0 is an im2col product on the tensor cores (mma.sync m16n8k16,
//     K = 27 taps x channels padded with zero weights to 32, N = 32, f32
//     sums); BN (a multiply, then an add) and leaky in f32, rounded once.
//   - ConvBN_1 runs on wgmma m64n64k16, one warpgroup a 64-pixel half of
//     the tile, K = 288 in 18 steps, the sums in registers. B, the whole
//     288 x 64 weight matrix in wgmma's layout (ops/bf16mma.
//     pack_wgmma_b), stays in shared memory: with conv0's weights and the
//     BN constants it arrives once a block by cp.async.bulk on an
//     mbarrier. A comes from the conv0 tile through registers. The
//     epilogue, leaky(s * acc + t) rounded once, stores 16 bytes a thread.
// Shared memory (~113 KB at the ticks' shapes, two blocks an SM): the
// weights and constants, and regions used in turns: P holds the frame
// rows, then the resized planes; Q the rows resampled along x and the
// band matrices, then the conv0 tile; T the tap tables' rows.
// What bounds it, measured (PERF.md): instruction issue in the SIMT parts
// (conv0's ~17 900 f32 BN values a tile, the passes' gathers and stores),
// not the bytes or the tensor cores. A build with -DGV_STEM_CLOCKS counts
// cycles by phase (gv_stem_bf16_clocks; tools/torch_kernel_times.py
// stem_bf16 --variant cuda_stem_bf16:GV_STEM_CLOCKS).

#include <cuda.h>

#include <cstring>

#include "gv_hopper.cuh"

namespace {

using gv::b_desc;
using gv::bf16;
using gv::bulk_copy;
using gv::fence_acc;
using gv::fence_proxy_async;
using gv::mbar_expect_tx;
using gv::mbar_init;
using gv::mbar_wait;
using gv::smem_u32;
using gv::store8;
using gv::wgmma_commit;
using gv::wgmma_fence;
using gv::wgmma_m64n64k16;
using gv::wgmma_wait0;

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kT1H = 8;                       // conv1 outputs a tile: rows
constexpr int kT1W = 16;                      // and columns
constexpr int kMidH = 2 * kT1H + 1;           // conv0 pixels under a tile
constexpr int kMidW = 2 * kT1W + 1;
constexpr int kMidPix = kMidH * kMidW;        // 561
// bf16 a staged conv0 pixel: the rows of an A fragment are pixels two
// apart, 40 words = 8 banks, so a half-warp's 8-byte loads do not conflict
constexpr int kMidStride = 40;
constexpr int kRH = 2 * kMidH + 1;            // resized pixels under a tile
constexpr int kRW = 2 * kMidW + 1;
// The resized tile, one plane a channel: 48 rows (the y pass's 3 m16
// tiles; 35 used) of 72 columns (its 9 n8 tiles; 67 used), the planes 16
// elements (8 banks) further apart than 48 x 72, so that conv0's gathers
// from the three channels fall in different banks.
constexpr int kRCols = 72;
constexpr int kRPlane = 48 * kRCols + 16;
// The rows resampled along x, transposed, one plane a channel: xr[c][s][row]
// for the tile's 72 resized columns s (67 used) and the frame rows (K of
// the y pass, contiguous).
constexpr int kXS = 72;
constexpr int kXM = 80;                       // x pass: 5 m16 tiles of columns
constexpr int kYM = 48;                       // y pass: 3 m16 tiles of rows
constexpr int kSteps1 = 18;                   // conv1's k steps of 16
constexpr int kStepBytes = 64 * 16 * 2;       // B of one step
constexpr int kWBytes = kSteps1 * kStepBytes; // 36864
constexpr int kW0Bytes = 2 * 4 * 32 * 8;      // conv0's B fragments
constexpr int kBnFloats = 32 + 32 + 64 + 64;  // s0, b0, s1, b1
// + 2 mbarriers and the next tile's geometry (struct Tile, 13 ints), up to
// a 128-byte boundary for the frame rows' tensor copy
constexpr int kHeadBytes =
    (kWBytes + kW0Bytes + kBnFloats * 4 + 32 + 64 + 127) / 128 * 128;

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ constexpr int max2(int a, int b) { return a > b ? a : b; }

// A staged frame row: 8-element (16-byte) pieces from the boundary at or
// before its first tapped element, up to 7 elements earlier.
__host__ __device__ constexpr int patch_row(int fw) {
  return (fw * 3 + 7 + 7) / 8 * 8;
}

// Region P: the frame rows (and 40 elements that the x pass's last k step
// may read past them, at zero weight), then the resized tile's planes.
__host__ __device__ constexpr int region_p(int fh, int fw) {
  return round16(max2((fh * patch_row(fw) + 40) * 2, 3 * kRPlane * 2));
}

// Row lengths (bf16) of the y pass's K (the frame rows, round16(fh), plus
// 8: ldmatrix rows in different banks) and of an x band (kb k steps of 16
// a m16 tile of columns, plus 8).
__host__ __device__ constexpr int y_row(int fh) { return round16(fh) + 8; }
__host__ __device__ constexpr int x_row(int kb) { return 16 * kb + 8; }

// Region Q: the rows resampled along x (3 planes of 72 x y_row) and the two
// passes' band matrices (x: 80 columns x x_row, y: 48 rows x y_row), then
// the conv0 tile.
__host__ __device__ constexpr int region_q(int fh, int kb) {
  return round16(max2(kMidPix * kMidStride * 2,
                      (3 * kXS * y_row(fh) + kXM * x_row(kb) +
                       kYM * y_row(fh)) * 2));
}

// Region T: the tap tables' rows under a tile (67 columns of xs floats, 35
// rows of ys), brought in with the frame rows.
__host__ __device__ constexpr int region_t(int xs, int ys) {
  return round16((kRW * xs + kRH * ys) * 4);
}

__host__ __device__ constexpr int smem_bytes(int fh, int fw, int xs, int ys,
                                             int kb) {
  return kHeadBytes + region_p(fh, fw) + region_q(fh, kb) +
         region_t(xs, ys);
}

// Two bf16 of shared memory as one mma operand register (lo in the low
// half).
__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo) |
         ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

// The four 8 x 8 matrices of an m16k16 A fragment from a row-major bf16
// matrix in shared memory: lane l gives row l % 16, columns 8 (l / 16) on.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ---- the tile's geometry ------------------------------------------------

// ytab / xtab: a resized row's / column's tap table, ys / xs floats a row:
// the first frame row / column of its window (an integer, as a float),
// then its ty_n / tx_n weights (bf16 values; xtab's times 1/255).
struct Geo {
  const bf16* img;
  int h, w;
  const float* ytab;
  int ys, ty_n;
  const float* xtab;
  int xs, tx_n;
  int size, fh_max, fw_max, pad0, s0_size, pad1, s1_size, tiles_x, tiles_y;
  int kb;   // the most k steps of 16 frame columns under 16 resized columns
  int tma;  // the frame rows come by one tensor copy (else a copy a row)
};

struct Tile {
  int b, y0, x0;        // frame, first conv1 output row and column
  int r_lo, s_lo;       // first resized row and column under the tile
  int ra, rb, sa, sb;   // the resized rows / columns inside the image
  int fy0, fh, fx0, fwf;  // frame rows [fy0, fy0 + fh); first column, and
                          // the elements a row spans (3 a column)
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int t) {
  Tile T;
  const int per = g.tiles_x * g.tiles_y;
  T.b = t / per;
  const int r = t - T.b * per;
  const int ty = r / g.tiles_x;
  T.y0 = ty * kT1H;
  T.x0 = (r - ty * g.tiles_x) * kT1W;
  T.r_lo = 2 * (2 * T.y0 - g.pad1) - g.pad0;
  T.s_lo = 2 * (2 * T.x0 - g.pad1) - g.pad0;
  T.ra = max(T.r_lo, 0);
  T.rb = min(T.r_lo + kRH - 1, g.size - 1);
  T.sa = max(T.s_lo, 0);
  T.sb = min(T.s_lo + kRW - 1, g.size - 1);
  T.fy0 = (int)__ldg(g.ytab + T.ra * g.ys);
  T.fh = (int)__ldg(g.ytab + T.rb * g.ys) + g.ty_n - T.fy0;
  T.fx0 = (int)__ldg(g.xtab + T.sa * g.xs);
  T.fwf = ((int)__ldg(g.xtab + T.sb * g.xs) + g.tx_n - T.fx0) * 3;
  return T;
}

// Element offset of frame row `row` of the tile's first tapped element
// (the frame is 16-byte aligned).
__device__ __forceinline__ int64_t row_start(const Geo& g, const Tile& T,
                                             int row) {
  return (((int64_t)T.b * g.h + T.fy0 + row) * g.w + T.fx0) * 3;
}

// The tile's frame rows into `patch` by the copy engine, a bulk copy a row
// from the 16-byte boundary at or before its first tapped element, and the
// tap tables' rows under the tile into xt (column sa first) and yt (row
// r_lo first), all completing on `bar`: by warp 0.
// Where the frame's rows are a multiple of 16 bytes long, one tensor copy
// (fmap: the frames as rows of 4-byte pairs, its box fh_max rows of
// patch_row / 2 pairs, zero past the frames) brings all of them.
__device__ __forceinline__ void stage(const Geo& g, const Tile& T,
                                      const CUtensorMap* fmap, bf16* patch,
                                      float* xt, float* yt, uint32_t bar) {
  const int lane = threadIdx.x & 31;
  const int prow = patch_row(g.fw_max);
  const int xbytes = (T.sb - T.sa + 1) * g.xs * 4;
  const int ybytes = (T.rb - T.ra + 1) * g.ys * 4;
  if (g.tma) {
    if (lane == 0) {
      mbar_expect_tx(bar, xbytes + ybytes + g.fh_max * prow * 2);
      bulk_copy(smem_u32(xt), g.xtab + T.sa * g.xs, xbytes, bar);
      bulk_copy(smem_u32(yt + (T.ra - T.r_lo) * g.ys),
                g.ytab + T.ra * g.ys, ybytes, bar);
      const int x = ((T.fx0 * 3) & ~7) / 2;
      const int y = T.b * g.h + T.fy0;
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
              smem_u32(patch)),
          "l"(fmap), "r"(x), "r"(y), "r"(bar)
          : "memory");
    }
    return;
  }
  int total = lane == 0 ? xbytes + ybytes : 0;
  for (int row = lane; row < T.fh; row += 32) {
    const int sh = (int)(row_start(g, T, row) & 7);
    total += (sh + T.fwf + 7) / 8 * 16;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  if (lane == 0) {
    mbar_expect_tx(bar, total);
    bulk_copy(smem_u32(xt), g.xtab + T.sa * g.xs, xbytes, bar);
    bulk_copy(smem_u32(yt + (T.ra - T.r_lo) * g.ys), g.ytab + T.ra * g.ys,
              ybytes, bar);
  }
  __syncwarp();
  for (int row = lane; row < T.fh; row += 32) {
    const int64_t e = row_start(g, T, row);
    const int64_t p = e & ~(int64_t)7;
    bulk_copy(smem_u32(patch + row * prow), g.img + p,
              ((int)(e - p) + T.fwf + 7) / 8 * 16, bar);
  }
}

// Two bf16 weights of a resampling row as one mma operand register: the
// row's taps (wt, shared memory) start at column `lo` of the band and are
// `n` long.
__device__ __forceinline__ uint32_t band_pair(const float* wt, int lo, int n,
                                              int x) {
  const int a = x - lo, b = a + 1;
  const float wa = a >= 0 && a < n ? wt[a] : 0.0f;
  const float wb = b >= 0 && b < n ? wt[b] : 0.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(wa, wb);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The first k step of m16 tile mt's band (16 resized columns from sa +
// 16 mt) among the frame columns from fx0.
__device__ __forceinline__ int band_k0(const Geo& g, const Tile& T,
                                       const float* xt, int mt) {
  return ((int)xt[16 * mt * g.xs] - T.fx0) / 16;
}

// The two passes' band matrices of the tile, bf16 (the weights are bf16
// values already). wx: m16 tile mt of the resized columns (sa + 16 mt + r,
// r < 16) against the kb k steps of frame columns from its band's first,
// wx[16 mt + r][x] the weight of frame column fx0 + 16 band_k0(mt) + x (xt
// carries the 1/255), zero past the tile's columns; wy[rr][row]: that of
// frame row fy0 + row in resized row r_lo + rr, 48 rows, zero outside the
// image. 16 bytes a thread at a time.
__device__ __forceinline__ void build_bands(const Geo& g, const Tile& T,
                                            const float* xt, const float* yt,
                                            int yrow, bf16* wx, bf16* wy) {
  const int ns = T.sb - T.sa + 1;
  const int xrow = x_row(g.kb);
  const int xper = xrow / 8, yper = yrow / 8;
  const int nx = kXM * xper;
  for (int i = threadIdx.x; i < nx + kYM * yper; i += kThreads) {
    const bool is_x = i < nx;
    const int j = is_x ? i : i - nx;
    const int per = is_x ? xper : yper;
    const int m = j / per;
    const int x0 = 8 * (j - m * per);
    bool ok;
    int lo = 0, n;
    const float* wt;
    if (is_x) {
      ok = m < ns;
      wt = xt + (ok ? m : 0) * g.xs;
      n = g.tx_n;
      lo = ok ? (int)wt[0] - T.fx0 - 16 * band_k0(g, T, xt, m >> 4) : 0;
    } else {
      const int r = T.r_lo + m;
      ok = m < kRH && r >= T.ra && r <= T.rb;
      wt = yt + (ok ? m : 0) * g.ys;
      n = g.ty_n;
      lo = ok ? (int)wt[0] - T.fy0 : 0;
    }
    uint4 v = make_uint4(0, 0, 0, 0);
    if (ok && x0 < lo + n && x0 + 8 > lo) {
      v.x = band_pair(wt + 1, lo, n, x0);
      v.y = band_pair(wt + 1, lo, n, x0 + 2);
      v.z = band_pair(wt + 1, lo, n, x0 + 4);
      v.w = band_pair(wt + 1, lo, n, x0 + 6);
    }
    *reinterpret_cast<uint4*>((is_x ? wx + m * xrow : wy + m * yrow) + x0) =
        v;
  }
}

// The x pass on the tensor cores, a channel at a time: xr[c][s - s_lo][row]
// = sum over x of wx[s - sa][x] * frame(fy0 + row, fx0 + x, c), rounded to
// bf16. M = the tile's resized columns s (5 m16 tiles), N = the frame rows
// (n8 tiles), K = the frame columns. A warp takes a (channel, m16 tile)
// pair, all of its n8 tiles, over the k steps of that m16 tile's band
// only. A (wx) by ldmatrix, B gathered from the staged rows (three
// elements a column). The products of bf16 weights and bf16 frame values
// are exact and the sums f32: the plain version's f32 resampling product,
// rounded as it rounds.
__device__ __forceinline__ void x_gemm(const Geo& g, const Tile& T,
                                       const bf16* patch, const float* xt,
                                       const bf16* wx, int yrow, bf16* xr) {
  constexpr int kMT = kXM / 16;
  constexpr int kNT = 6;                      // n8 tiles (48 rows) at a time
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int prow = patch_row(g.fw_max);
  const int xrow = x_row(g.kb);
  const int ns = T.sb - T.sa + 1;
  const int n_mt = min((ns + 15) / 16, kMT);
  const int n_grp = (T.fh + 8 * kNT - 1) / (8 * kNT);
  const int sh0 = (int)(row_start(g, T, 0) & 7);
  const int st7 = (g.w * 3) & 7;
  const int off = T.sa - T.s_lo;              // xr's columns count from s_lo
  for (int u = warp; u < 3 * n_mt * n_grp; u += kWarps) {
    const int c = u / (n_mt * n_grp);
    const int v = u - c * n_mt * n_grp;
    const int mt = v / n_grp;
    const int r0 = 8 * kNT * (v - mt * n_grp);     // the group's first row
    const int n_nt = min((T.fh - r0 + 7) / 8, kNT);
    const int k0 = band_k0(g, T, xt, mt);
    const int k1 = ((int)xt[min(16 * mt + 15, ns - 1) * g.xs] + g.tx_n -
                    T.fx0 + 15) / 16;
    const bf16* bcol[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int row = min(r0 + 8 * j + gq, T.fh - 1);
      bcol[j] = patch + row * prow + ((sh0 + row * st7) & 7) + c + 6 * t;
    }
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    }
    const bf16* arow = wx + (16 * mt + (lane & 15)) * xrow + (lane >> 4) * 8;
    for (int ks = k0; ks < k1; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, arow + 16 * (ks - k0));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < n_nt) {
          const bf16* b = bcol[j] + 48 * ks;
          gv::mma_bf16(acc[j], a,
                       make_uint2(pack2(b, b + 3), pack2(b + 24, b + 27)));
        }
      }
    }
    bf16* dst = xr + c * kXS * yrow + r0 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sc = off + 16 * mt + gq + 8 * h;
      if (sc < kXS) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j < n_nt) {
            *reinterpret_cast<__nv_bfloat162*>(dst + sc * yrow + 8 * j) =
                __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
          }
        }
      }
    }
  }
}

// The y pass on the tensor cores, a channel at a time: rt[c][rr][s] = sum
// over rows of wy[rr][row] * xr[c][s][row], rounded to bf16, zero outside
// the image. M = the tile's resized rows (3 m16 tiles), N = its columns (9
// n8 tiles), K = the frame rows. A (wy) and B (xr, k contiguous) by
// ldmatrix.
__device__ __forceinline__ void y_gemm(const Geo& g, const Tile& T,
                                       const bf16* xr, const bf16* wy,
                                       int yrow, bf16* rt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const bf16* arow = wy + (lane & 15) * yrow + (lane >> 4) * 8;
  for (int u = warp; u < 3 * (kXS / 8); u += kWarps) {
    const int c = u / (kXS / 8);
    const int nt = u - c * (kXS / 8);
    const bf16* brow = xr + c * kXS * yrow + (8 * nt + (lane & 7)) * yrow +
                       ((lane >> 3) & 1) * 8;
    float acc[kYM / 16][4];
#pragma unroll
    for (int mt = 0; mt < kYM / 16; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
    }
    for (int ks = 0; ks < yrow / 16; ++ks) {
      uint2 bb;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                   : "=r"(bb.x), "=r"(bb.y)
                   : "r"(smem_u32(brow + 16 * ks)));
#pragma unroll
      for (int mt = 0; mt < kYM / 16; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, arow + 16 * mt * yrow + 16 * ks);
        gv::mma_bf16(acc[mt], a, bb);
      }
    }
    const int sc = 8 * nt + 2 * t;
    const bool ok0 = T.s_lo + sc >= T.sa && T.s_lo + sc <= T.sb;
    const bool ok1 = T.s_lo + sc + 1 >= T.sa && T.s_lo + sc + 1 <= T.sb;
    bf16* dst = rt + c * kRPlane + sc;
#pragma unroll
    for (int mt = 0; mt < kYM / 16; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(
            dst + (16 * mt + gq + 8 * h) * kRCols) =
            __floats2bfloat162_rn(ok0 ? acc[mt][2 * h] : 0.0f,
                                  ok1 ? acc[mt][2 * h + 1] : 0.0f);
      }
    }
  }
}

// ConvBN_0 on the tensor cores: the tile's 561 conv0 pixels (rows of
// m16 tiles) x K = 32 (tap (ty, tx), channel c at k = (3 ty + tx) 3 + c;
// 27..31 meet zero weights) x 32 channels, A gathered from the resized
// tile in the k order of bf16mma.pack_b_fragments (a thread's k: 4t ..
// 4t + 3 of each step of 16), B (w0) held in registers. BN (x * s + b) and
// leaky in f32, rounded once to bf16 into mid; zero outside the conv0
// image. A warp takes two m16 tiles at a time (mt, mt + kWarps), for two
// independent chains.
__device__ __forceinline__ void conv0(const Geo& g, const Tile& T,
                                      const bf16* rt, const uint2* w0s,
                                      const float* s0, const float* b0,
                                      bf16* mid) {
  constexpr int kMTiles = (kMidPix + 15) / 16;      // 36
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int my0 = 2 * T.y0 - g.pad1;
  const int mx0 = 2 * T.x0 - g.pad1;
  // the thread's B fragments and A offsets (k = 16 ks + 4t + j: tap 3 ty +
  // tx, channel c at k = 3 (3 ty + tx) + c)
  uint2 bw[2][4];
  int koff[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) bw[ks][nt] = w0s[(ks * 4 + nt) * 32 + lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * ks + 4 * t + j;
      koff[ks][j] = k < 27 ? k % 3 * kRPlane + k / 9 * kRCols + k / 3 % 3
                           : 0;
    }
  }
  for (int m0 = warp; m0 < kMTiles; m0 += 2 * kWarps) {
    const int nu = m0 + kWarps < kMTiles ? 2 : 1;   // m16 tiles this time
    int base[2][2];
    bool inside[2][2];
    int q[2][2];
    float acc[2][4][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        q[u][hr] = (m0 + u * kWarps) * 16 + gq + 8 * hr;
        const int qc = min(q[u][hr], kMidPix - 1);
        const int r = qc / kMidW;
        const int c = qc - r * kMidW;
        base[u][hr] = 2 * r * kRCols + 2 * c;
        const int my = my0 + r, mx = mx0 + c;
        inside[u][hr] =
            my >= 0 && my < g.s0_size && mx >= 0 && mx < g.s0_size;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u >= nu) break;
        uint32_t a[4];
        const bf16* p0 = rt + base[u][0];
        const bf16* p1 = rt + base[u][1];
        a[0] = pack2(p0 + koff[ks][0], p0 + koff[ks][1]);
        a[1] = pack2(p1 + koff[ks][0], p1 + koff[ks][1]);
        a[2] = pack2(p0 + koff[ks][2], p0 + koff[ks][3]);
        a[3] = pack2(p1 + koff[ks][2], p1 + koff[ks][3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          gv::mma_bf16(acc[u][nt], a, bw[ks][nt]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ch = 16 * p + 4 * t;
      const float4 sv = *reinterpret_cast<const float4*>(s0 + ch);
      const float4 bv = *reinterpret_cast<const float4*>(b0 + ch);
      const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
      const float sf[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (q[u][hr] >= kMidPix) continue;
          const float v[4] = {acc[u][2 * p][2 * hr], acc[u][2 * p][2 * hr + 1],
                              acc[u][2 * p + 1][2 * hr],
                              acc[u][2 * p + 1][2 * hr + 1]};
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = __fadd_rn(__fmul_rn(v[e], sc[e]), sf[e]);
            o[e] = inside[u][hr] ? fmaxf(y, 0.1f * y) : 0.0f;   // leaky
          }
          gv::store4(mid + q[u][hr] * kMidStride + ch, o[0], o[1], o[2],
                     o[3]);
        }
      }
    }
  }
}

// ConvBN_1 on wgmma: warpgroup wg owns output rows 4 wg .. 4 wg + 3 of the
// tile, its warp wq row 4 wg + wq, a thread's A rows g and g + 8 the
// columns g and g + 8. K step (tap, half) reads the tap's conv0 pixel,
// channels 16 half + 4t .. + 3 (the k order of pack_wgmma_b). The taps of
// one kernel row (6 steps) go in one commit group.
__device__ __forceinline__ void conv1(const Geo& g, const Tile& T,
                                      const bf16* mid, uint32_t wb,
                                      const float* s1, const float* b1,
                                      bf16* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int oy = (warp >> 2) * 4 + (warp & 3);
  const bf16* arow = mid + (2 * oy * kMidW + 2 * gq) * kMidStride + 4 * t;
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    uint32_t a[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int tx = i >> 1;
      const bf16* p = arow + (ty * kMidW + tx) * kMidStride + 16 * (i & 1);
      const uint2 lo = *reinterpret_cast<const uint2*>(p);
      const uint2 hi = *reinterpret_cast<const uint2*>(p + 16 * kMidStride);
      a[i][0] = lo.x;
      a[i][1] = hi.x;
      a[i][2] = lo.y;
      a[i][3] = hi.y;
    }
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      wgmma_m64n64k16(d, a[i], b_desc(wb + (ty * 6 + i) * kStepBytes),
                      ty + i > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(d);
  }
  const int y = T.y0 + oy;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int x = T.x0 + gq + 8 * hr;
    if (y >= g.s1_size || x >= g.s1_size) continue;
    bf16* dst = out + (((int64_t)T.b * g.s1_size + y) * g.s1_size + x) * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // channels acc_channel(4h + jj, t, e) = 32h + 8t + 2jj + e
      const float4* sp = reinterpret_cast<const float4*>(s1 + 32 * h + 8 * t);
      const float4* bp = reinterpret_cast<const float4*>(b1 + 32 * h + 8 * t);
      const float4 sa = sp[0], sb = sp[1], ba = bp[0], bb = bp[1];
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float sf[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      float v[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[2 * jj + e] = leaky(__fadd_rn(
              __fmul_rn(d[4 * (4 * h + jj) + 2 * hr + e], sc[2 * jj + e]),
              sf[2 * jj + e]));
        }
      }
      store8(dst + 32 * h + 8 * t, v);
    }
  }
}

#ifdef GV_STEM_CLOCKS
// Cycles by phase summed over blocks (thread 0's view): the bands and the
// wait for the frame rows, the x pass, the y pass, conv0, issuing the next
// rows, conv1.
__device__ unsigned long long gv_stem_clocks[12];
#endif

// w0frag: ConvBN_0's (27, 32) matrix padded to (32, 32), bf16, packed by
// bf16mma.pack_b_fragments ((2, 4, 32, 4): a lane's uint2 of step ks and
// n-tile nt); w1wg: ConvBN_1's (288, 64) by bf16mma.pack_wgmma_b; s0 / b0,
// s1 / b1: the BN scales and shifts (f32, 16-byte aligned). Block b walks
// the tiles b, b + gridDim.x, ... (conv1 column tiles fastest, then rows,
// then frames).
__global__ void __launch_bounds__(kThreads, 2)
gv_stem_bf16_kernel(Geo g, const __grid_constant__ CUtensorMap fmap,
                    const uint2* __restrict__ w0frag,
                    const bf16* __restrict__ w1wg,
                    const float* __restrict__ s0,
                    const float* __restrict__ b0,
                    const float* __restrict__ s1,
                    const float* __restrict__ b1, int n_tiles,
                    bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint2* w0s = reinterpret_cast<const uint2*>(smem + kWBytes);
  float* bn = reinterpret_cast<float*>(smem + kWBytes + kW0Bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWBytes + kW0Bytes +
                                               kBnFloats * 4);
  Tile* next = reinterpret_cast<Tile*>(bars + 4);
  const int yrow = y_row(g.fh_max);
  const int p_bytes = region_p(g.fh_max, g.fw_max);
  const int q_bytes = region_q(g.fh_max, g.kb);
  bf16* rp = reinterpret_cast<bf16*>(smem + kHeadBytes);     // P
  bf16* rq = reinterpret_cast<bf16*>(smem + kHeadBytes + p_bytes);   // Q
  bf16* wx = rq + 3 * kXS * yrow;             // the bands, after xr
  bf16* wy = wx + kXM * x_row(g.kb);
  float* xt = reinterpret_cast<float*>(smem + kHeadBytes + p_bytes +
                                       q_bytes);                     // T
  float* yt = xt + kRW * g.xs;
  const uint32_t wb = smem_u32(smem);
  const uint32_t wbar = smem_u32(bars);       // weights and BN constants
  const uint32_t pbar = smem_u32(bars + 1);   // the frame rows of a tile

  // P and Q start zero: what the products read at zero weight beyond the
  // tile's data (past the last frame row, the filler columns) is finite
  for (int i = threadIdx.x; i < (p_bytes + q_bytes) / 16; i += kThreads) {
    reinterpret_cast<uint4*>(rp)[i] = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    mbar_init(pbar, 1);
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(wbar, kWBytes + kW0Bytes + kBnFloats * 4);
    bulk_copy(wb, w1wg, kWBytes, wbar);
    bulk_copy(smem_u32(w0s), w0frag, kW0Bytes, wbar);
    bulk_copy(smem_u32(bn), s0, 32 * 4, wbar);
    bulk_copy(smem_u32(bn + 32), b0, 32 * 4, wbar);
    bulk_copy(smem_u32(bn + 64), s1, 64 * 4, wbar);
    bulk_copy(smem_u32(bn + 128), b1, 64 * 4, wbar);
  }
  if ((int)blockIdx.x < n_tiles && threadIdx.x < 32) {
    const Tile T0 = tile_at(g, blockIdx.x);
    if (threadIdx.x == 0) *next = T0;
    stage(g, T0, &fmap, rp, xt, yt, pbar);
  }
#ifdef GV_STEM_CLOCKS
  // thread 0's phases (barrier to barrier) and every warp's own time in
  // each phase (from the barrier before it to its arrival at the next)
  long long clk[6] = {0, 0, 0, 0, 0, 0};
  long long wclk[6] = {0, 0, 0, 0, 0, 0};
  long long c_prev = clock64(), c_warp = c_prev;
#define GV_CLK(i)                       \
  {                                     \
    const long long c_now = clock64();  \
    clk[i] += c_now - c_prev;           \
    c_prev = c_now;                     \
    c_warp = c_now;                     \
  }
#define GV_WCLK(i) wclk[i] += clock64() - c_warp;
#else
#define GV_CLK(i)
#define GV_WCLK(i)
#endif
  int parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    __syncthreads();                  // Q is free (the last conv1 is done)
    const Tile T = *next;
    mbar_wait(pbar, parity);          // the frame rows and tables are in
    parity ^= 1;
    build_bands(g, T, xt, yt, yrow, wx, wy);
    GV_WCLK(0)
    __syncthreads();
    GV_CLK(0)
    x_gemm(g, T, rp, xt, wx, yrow, rq);   // P: frame rows -> Q: xr
    GV_WCLK(1)
    __syncthreads();
    GV_CLK(1)
    y_gemm(g, T, rq, wy, yrow, rp);   // Q: xr -> P: resized
    mbar_wait(wbar, 0);               // the weights and BN constants
    GV_WCLK(2)
    __syncthreads();
    GV_CLK(2)
    conv0(g, T, rp, w0s, bn, bn + 32, rq);   // P -> Q: mid
    fence_proxy_async();              // P was read; the copy engine is next
    GV_WCLK(3)
    __syncthreads();
    GV_CLK(3)
    if (tile + (int)gridDim.x < n_tiles && threadIdx.x < 32) {
      const Tile Tn = tile_at(g, tile + gridDim.x);
      if (threadIdx.x == 0) *next = Tn;
      stage(g, Tn, &fmap, rp, xt, yt, pbar);
    }
    GV_WCLK(4)
    GV_CLK(4)
    conv1(g, T, rq, wb, bn + 64, bn + 128, out);
    GV_WCLK(5)
    GV_CLK(5)
  }
#ifdef GV_STEM_CLOCKS
  for (int i = 0; i < 6; ++i) {
    if (threadIdx.x == 0) {
      atomicAdd(gv_stem_clocks + i, (unsigned long long)clk[i]);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(gv_stem_clocks + 6 + i, (unsigned long long)wclk[i]);
    }
  }
#endif
}

int set_smem(const void* fn, int bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The frames (B * h rows of w * 3 / 2 four-byte pairs) as a tensor map for
// the frame rows' copy: a box of fh_max rows of prow / 2 pairs, zero past
// the frames.
int stem_frame_map(CUtensorMap* map, const void* img, int batch, int h,
                   int w, int prow, int fh_max) {
  const cuuint64_t dims[2] = {(cuuint64_t)w * 3 / 2,
                              (cuuint64_t)batch * h};
  const cuuint64_t strides[1] = {(cuuint64_t)w * 3 * 2};
  const cuuint32_t box[2] = {(cuuint32_t)prow / 2, (cuuint32_t)fh_max};
  return gv::frame_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, img, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace

// img: (B, h, w, 3) bf16 in [0, 255], 16-byte aligned; ytab / xtab: the
// tap tables (see Geo; ys, xs multiples of 4, 16-byte aligned); fh_max /
// fw_max: the most frame rows / columns that the windows of the 35 resized
// rows / 67 columns under one tile span; w0frag, w1wg, s0, b0, s1, b1: see
// the kernel; out: (B, s1, s1, 64) bf16. Nonzero: a CUDA error
// (cudaErrorInvalidValue for a plan that does not fit a block).
extern "C" int gv_detector_stem_bf16(
    const void* img, int batch, int h, int w, const float* ytab, int ys,
    int ty_n, const float* xtab, int xs, int tx_n, int size, int fh_max,
    int fw_max, int kb, const void* w0frag,
    const void* w1wg, const float* s0, const float* b0, const float* s1,
    const float* b1, int pad0, int s0_size, int pad1, int s1_size, void* out,
    cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int smem = smem_bytes(fh_max, fw_max, xs, ys, kb);
  if (smem > 232448 || xs % 4 || ys % 4 || xs <= tx_n || ys <= ty_n) {
    return (int)cudaErrorInvalidValue;
  }
  int err = set_smem((const void*)gv_stem_bf16_kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev))) {
    return err;
  }
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gv_stem_bf16_kernel, kThreads, smem))) {
    return err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const int prow = patch_row(fw_max);
  const int tma = w * 3 % 8 == 0 && prow / 2 <= 256 && fh_max <= 256;
  Geo g{static_cast<const bf16*>(img), h, w, ytab, ys, ty_n, xtab, xs, tx_n,
        size, fh_max, fw_max, pad0, s0_size, pad1, s1_size,
        (s1_size + kT1W - 1) / kT1W, (s1_size + kT1H - 1) / kT1H, kb, tma};
  const int64_t tiles = (int64_t)batch * g.tiles_x * g.tiles_y;
  if (tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  CUtensorMap fmap;
  std::memset(&fmap, 0, sizeof(fmap));
  if (tma &&
      (err = stem_frame_map(&fmap, img, batch, h, w, prow, fh_max))) {
    return err;
  }
  const int64_t slots = (int64_t)sms * per_sm;
  const int grid = (int)(tiles < slots ? tiles : slots);
  gv_stem_bf16_kernel<<<grid, kThreads, smem, stream>>>(
      g, fmap, static_cast<const uint2*>(w0frag),
      static_cast<const bf16*>(w1wg),
      s0, b0, s1, b1, (int)tiles, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// What the launch gets at fh_max x fw_max frame patches (tests/
// test_torch_cuda.py holds it to the wrapper's stem_bf16_shared_bytes):
// {dynamic shared memory in bytes, blocks that fit one SM}.
extern "C" int gv_stem_bf16_plan(int fh_max, int fw_max, int xs, int ys,
                                 int kb, int* plan) {
  plan[0] = smem_bytes(fh_max, fw_max, xs, ys, kb);
  plan[1] = 0;
  if (plan[0] > 232448) return 0;
  const int err = set_smem((const void*)gv_stem_bf16_kernel, plan[0]);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan[1], gv_stem_bf16_kernel, kThreads, plan[0]);
}

#ifdef GV_STEM_CLOCKS
// Reads and clears the phase cycles (a measurement build only).
extern "C" int gv_stem_bf16_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, gv_stem_clocks, 12 * 8);
  if (err) return err;
  const unsigned long long zero[12] = {};
  return (int)cudaMemcpyToSymbol(gv_stem_clocks, zero, 12 * 8);
}
#endif
