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
// Bound on this card: operations. Per 104x104 frame the stage is ~1.28
// GFLOP (ConvBN_2 0.80, the two 32->32 convs 0.40, the 1x1 0.09) against
// ~4.2 MB of compulsory traffic: 15:1 over the bytes at the FP32 rate.
// The contract is f32 (1e-4 against the twin), which plain TF32 would
// break, so each conv is a matrix product (pixels x taps*C_in by
// taps*C_in x C_out) on the tensor cores in 3xTF32 (gv_mma.cuh): three
// mma.sync per tile, the weights split into hi and lo once on the host
// with the BN scale folded in, the activations split in registers, a weight
// chunk's products chained on the tensor core and the chunks added in f32.
// Design, four launches per call:
//   1. ConvBN_2 -> y (B, H, W, 64) scratch;
//   2. CSP conv a on y[..., 32:64] -> x1, written to channels [32:64) of
//      an (B, H, W, 64) scratch;
//   3. CSP conv b on x1 -> x2, written to channels [0:32) of the same
//      scratch (it reads only [32:64), so no block reads what another
//      writes), which then holds concat[x2, x1] with no copy;
//   4. the 1x1 conv on that scratch, fused with both concats and the pool:
//      max(y) to channels [0:64), max(x3) to [64:128).
// A 3x3 block (128 threads) owns a tile of 4*MT rows x 16 output pixels
// and all output channels, so an activation is read from global memory
// once per conv: the input tile with its one-pixel halo is staged in shared
// memory with cp.async (zero-filled outside the frame: SAME padding of a
// 3x3 stride-1 conv is (1, 1)), the pixel stride padded to C_in + 8 floats
// so that the 8-byte A loads of a half-warp fall in 32 different banks.
// The packed weights stream through a double buffer in chunks of one tap x
// 32 input channels (16 KB at 64 outputs). A warp owns MT rows of 16 pixels
// (one m16 tile each) and every n-tile: its A fragments are split once and
// meet every weight. ConvBN_2 runs MT = 2 (8 x 16 pixels, 85 KB: two blocks
// an SM), the 32 -> 32 convs MT = 4 (16 x 16 pixels, 68 KB: three). The
// epilogue adds the BN shift, applies the leaky slope and writes 16 bytes a
// thread and channel pair.
// The pool block owns 8 x 16 pixels: a warp's two rows pool in registers
// (vertical) and with one shuffle (horizontal).

#include "gv_mma.cuh"

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kTileW = 16;                    // one m16 tile per tile row
constexpr int kChunkK = 32;                   // input channels a weight chunk

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

template <int CIN, int COUT, int MT>
struct ConvCfg {
  static constexpr int kTileH = 4 * MT;       // 4 warps x MT rows
  static constexpr int kStride = CIN + 8;     // floats a staged pixel
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kTileFloats = (kTileH + 2) * kHaloW * kStride;
  static constexpr int kNT = COUT / 8;
  static constexpr int kChunkFloats = (kChunkK / 8) * kNT * 32 * 4;
  static constexpr int kChunksPerTap = CIN / kChunkK;
  static constexpr int kChunks = 9 * kChunksPerTap;
  static constexpr int kSmemBytes =
      (kTileFloats + 2 * kChunkFloats + COUT) * 4;
};

// 3x3 stride-1 SAME conv + BN shift + leaky. in: (B, h, w, in_stride), CIN
// channels from in_off; wfrag: the (9 * CIN, COUT) matrix in (ty, tx, c) row
// order, BN scale folded in, packed by tf32x3.pack_b_fragments; out:
// (B, h, w, out_stride), output channel co goes to out_off + co. in and out
// may be one buffer with disjoint channel ranges.
template <int CIN, int COUT, int MT>
__global__ void __launch_bounds__(kThreads)
gv_csp_conv3x3_kernel(const float* in, int in_stride, int in_off, int h,
                      int w, const float* __restrict__ wfrag,
                      const float* __restrict__ shift, float* out,
                      int out_stride, int out_off) {
  using C = ConvCfg<CIN, COUT, MT>;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* wbuf = smem + C::kTileFloats;
  float* sshift = wbuf + 2 * C::kChunkFloats;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * C::kTileH;
  const float* src = in + (int64_t)blockIdx.z * h * w * in_stride + in_off;

  constexpr int kVecs = CIN / 4;              // 16-byte pieces a pixel
  for (int i = tid; i < (C::kTileH + 2) * C::kHaloW * kVecs; i += kThreads) {
    const int pix = i / kVecs;
    const int v = i - pix * kVecs;
    const int ry = pix / C::kHaloW;
    const int rx = pix - ry * C::kHaloW;
    const int y = y0 + ry - 1;
    const int x = x0 + rx - 1;
    const bool ok = y >= 0 && y < h && x >= 0 && x < w;
    const float* p =
        ok ? src + ((int64_t)y * w + x) * in_stride + 4 * v : src;
    gv::cp_async16(tile + pix * C::kStride + 4 * v, p, ok);
  }
  auto load_chunk = [&](int chunk) {
    const float* s = wfrag + (int64_t)chunk * C::kChunkFloats;
    float* d = wbuf + (chunk & 1) * C::kChunkFloats;
    for (int i = tid; i < C::kChunkFloats / 4; i += kThreads) {
      gv::cp_async16(d + 4 * i, s + 4 * i, true);
    }
    gv::cp_async_commit();
  };
  load_chunk(0);                              // one group with the tile
  if (tid < COUT) sshift[tid] = shift[tid];

  float acc[MT][C::kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < C::kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }

  for (int chunk = 0; chunk < C::kChunks; ++chunk) {
    if (chunk + 1 < C::kChunks) {
      load_chunk(chunk + 1);
      gv::cp_async_wait<1>();
    } else {
      gv::cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = chunk / C::kChunksPerTap;
    const int c0 = (chunk - tap * C::kChunksPerTap) * kChunkK;
    const int ty = tap / 3;
    const int tx = tap - 3 * ty;
    const float4* wb = reinterpret_cast<const float4*>(
        wbuf + (chunk & 1) * C::kChunkFloats);
    const float* a0 =
        tile + ((warp * MT + ty) * C::kHaloW + tx + g) * C::kStride + c0 +
        2 * t;
    float d[MT][C::kNT][4];                   // the chunk's sums: one chain
#pragma unroll
    for (int ks = 0; ks < kChunkK / 8; ++ks) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = a0 + mt * C::kHaloW * C::kStride + ks * 8;
        gv::load_a(a, a + 8 * C::kStride, ah[mt], al[mt]);
      }
      float4 b[C::kNT];
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        b[nt] = wb[(ks * C::kNT + nt) * 32 + lane];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        gv::mma_3xtf32_chain(d[mt], ks == 0, ah[mt], al[mt], b);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) gv::add_chain(acc[mt], d[mt]);
    __syncthreads();                          // the buffer is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = y0 + warp * MT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + g + 8 * half;
      if (y < h && x < w) {
        float* dst = out +
                     (((int64_t)blockIdx.z * h + y) * w + x) * out_stride +
                     out_off + 4 * t;
#pragma unroll
        for (int p = 0; p < C::kNT / 2; ++p) {
          const float* sh = sshift + 16 * p + 4 * t;
          *reinterpret_cast<float4*>(dst + 16 * p) = make_float4(
              leaky(acc[mt][2 * p][2 * half] + sh[0]),
              leaky(acc[mt][2 * p][2 * half + 1] + sh[1]),
              leaky(acc[mt][2 * p + 1][2 * half] + sh[2]),
              leaky(acc[mt][2 * p + 1][2 * half + 1] + sh[3]));
        }
      }
    }
  }
}

constexpr int kPoolTileH = 8;
constexpr int kPoolStride = 64 + 8;
constexpr int kPoolTileFloats = kPoolTileH * kTileW * kPoolStride;
constexpr int kPoolWFloats = 8 * 8 * 32 * 4;  // 64 x 64, hi and lo
constexpr int kPoolSmemBytes = (kPoolTileFloats + kPoolWFloats + 64) * 4;

// 1x1 conv (64 -> 64) on xcat = concat[x2, x1] + BN shift + leaky = x3,
// then the 2x2/s2 max pool of concat[y, x3]. A block owns 8 x 16 pixels,
// a warp two rows of them: one row of 8 pooled pixels.
__global__ void __launch_bounds__(kThreads)
gv_csp_pool_kernel(const float* __restrict__ y,
                   const float* __restrict__ xcat, int h, int w,
                   const float* __restrict__ wfrag,
                   const float* __restrict__ shift, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* wbuf = smem + kPoolTileFloats;
  float* sshift = wbuf + kPoolWFloats;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kPoolTileH;
  const int64_t frame = (int64_t)blockIdx.z * h * w;

  for (int i = tid; i < kPoolTileH * kTileW * 16; i += kThreads) {
    const int pix = i >> 4;
    const int v = i & 15;
    const int yy = y0 + pix / kTileW;
    const int xx = x0 + pix % kTileW;
    const bool ok = yy < h && xx < w;
    const float* p =
        ok ? xcat + (frame + (int64_t)yy * w + xx) * 64 + 4 * v : xcat;
    gv::cp_async16(tile + pix * kPoolStride + 4 * v, p, ok);
  }
  for (int i = tid; i < kPoolWFloats / 4; i += kThreads) {
    gv::cp_async16(wbuf + 4 * i, wfrag + 4 * i, true);
  }
  gv::cp_async_commit();
  if (tid < 64) sshift[tid] = shift[tid];

  // while the copies fly: max pool of y into channels [0:64)
  const int ho = h / 2;
  const int wo = w / 2;
  for (int i = tid; i < (kPoolTileH / 2) * (kTileW / 2) * 16;
       i += kThreads) {
    const int pp = i >> 4;
    const int v = i & 15;
    const int py = y0 / 2 + pp / (kTileW / 2);
    const int px = x0 / 2 + pp % (kTileW / 2);
    if (py < ho && px < wo) {
      const float* s = y + (frame + (int64_t)(2 * py) * w + 2 * px) * 64 +
                       4 * v;
      const float4 a = __ldg(reinterpret_cast<const float4*>(s));
      const float4 b = __ldg(reinterpret_cast<const float4*>(s + 64));
      const float4 c =
          __ldg(reinterpret_cast<const float4*>(s + (int64_t)w * 64));
      const float4 d =
          __ldg(reinterpret_cast<const float4*>(s + (int64_t)w * 64 + 64));
      *reinterpret_cast<float4*>(
          out + (((int64_t)blockIdx.z * ho + py) * wo + px) * 128 + 4 * v) =
          make_float4(fmaxf(fmaxf(a.x, b.x), fmaxf(c.x, d.x)),
                      fmaxf(fmaxf(a.y, b.y), fmaxf(c.y, d.y)),
                      fmaxf(fmaxf(a.z, b.z), fmaxf(c.z, d.z)),
                      fmaxf(fmaxf(a.w, b.w), fmaxf(c.w, d.w)));
    }
  }
  gv::cp_async_wait<0>();
  __syncthreads();

  float acc[2][2][4][4];                      // [row][n-tile / 4][n-tile % 4]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt >> 2][nt & 3][e] = 0.0f;
    }
  }
  const float4* wb = reinterpret_cast<const float4*>(wbuf);
  const float* a0 = tile + (warp * 2 * kTileW + g) * kPoolStride + 2 * t;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* a = a0 + mt * kTileW * kPoolStride + ks * 8;
      gv::load_a(a, a + 8 * kPoolStride, ah[mt], al[mt]);
    }
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {          // 4 n-tiles at a time: registers
      float4 b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt] = wb[(ks * 8 + 4 * nh + nt) * 32 + lane];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        gv::mma_3xtf32(acc[mt][nh], ah[mt], al[mt], b);
      }
    }
  }

  // x3 = leaky(acc + shift); pool the warp's two rows (registers), then
  // neighbouring pixels g, g ^ 1 (lanes 4 apart); even g stores
  const int py = y0 / 2 + warp;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* sh = sshift + 16 * p + 4 * t;
    float m[2][4];                            // [pixel half][channel]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nt = 2 * p + (e >> 1);
        const int c = 2 * half + (e & 1);
        const float v = fmaxf(leaky(acc[0][nt >> 2][nt & 3][c] + sh[e]),
                              leaky(acc[1][nt >> 2][nt & 3][c] + sh[e]));
        m[half][e] = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 4));
      }
    }
    if (!(g & 1) && py < ho) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = x0 / 2 + g / 2 + 4 * half;
        if (px < wo) {
          *reinterpret_cast<float4*>(
              out + (((int64_t)blockIdx.z * ho + py) * wo + px) * 128 + 64 +
              16 * p + 4 * t) =
              make_float4(m[half][0], m[half][1], m[half][2], m[half][3]);
        }
      }
    }
  }
}

// One warp per 16 x 8 tile of c = a @ b in 3xTF32 (the check of gv_mma.cuh's
// fragment layout against a library product). a: (m, k) row-major; bfrag:
// (k, n) packed by tf32x3.pack_b_fragments; c: (m, n) row-major.
__global__ void gv_mma_product_kernel(const float* __restrict__ a,
                                      const float* __restrict__ bfrag,
                                      float* __restrict__ c, int n, int k) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt = blockIdx.x;
  const int m0 = blockIdx.y * 16;
  const float4* wb = reinterpret_cast<const float4*>(bfrag);
  float acc[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
  for (int ks = 0; ks < k / 8; ++ks) {
    uint32_t ah[4], al[4];
    const float* row = a + (int64_t)(m0 + g) * k + ks * 8 + 2 * t;
    gv::load_a(row, row + (int64_t)8 * k, ah, al);
    const float4 b[1] = {wb[((int64_t)ks * (n / 8) + nt) * 32 + lane]};
    gv::mma_3xtf32(acc, ah, al, b);
  }
  const int ch = 16 * (nt / 2) + 4 * t + 2 * (nt % 2);
  float* dst = c + (int64_t)(m0 + g) * n + ch;
  dst[0] = acc[0][0];
  dst[1] = acc[0][1];
  dst[(int64_t)8 * n] = acc[0][2];
  dst[(int64_t)8 * n + 1] = acc[0][3];
}

template <int CIN, int COUT, int MT>
cudaError_t launch_conv(const float* in, int in_off, int batch, int h, int w,
                        const float* wfrag, const float* shift, float* out,
                        int out_off, cudaStream_t stream) {
  using C = ConvCfg<CIN, COUT, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      gv_csp_conv3x3_kernel<CIN, COUT, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + C::kTileH - 1) / C::kTileH, batch);
  gv_csp_conv3x3_kernel<CIN, COUT, MT>
      <<<grid, kThreads, C::kSmemBytes, stream>>>(in, 64, in_off, h, w, wfrag,
                                                  shift, out, 64, out_off);
  return cudaGetLastError();
}

}  // namespace

// x: (B, h, w, 64); y, xcat: (B, h, w, 64) scratch; out: (B, h/2, w/2, 128).
// w2: (576, 64), wa / wb: (288, 32), wc: (64, 64) as (in, out) with the BN
// scale folded in, packed by tf32x3.pack_b_fragments; b*: each conv's BN
// shift.
extern "C" int gv_detector_csp(const float* x, int batch, int h, int w,
                               const float* w2, const float* b2,
                               const float* wa, const float* ba,
                               const float* wb, const float* bb,
                               const float* wc, const float* bc, float* y,
                               float* xcat, float* out, cudaStream_t stream) {
  if (batch > 65535 || h > 65535 * 8) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err =
      launch_conv<64, 64, 2>(x, 0, batch, h, w, w2, b2, y, 0, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<32, 32, 4>(y, 32, batch, h, w, wa, ba, xcat, 32, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<32, 32, 4>(xcat, 32, batch, h, w, wb, bb, xcat, 0,
                               stream);
  if (err != cudaSuccess) return (int)err;
  if (h / 2 == 0 || w / 2 == 0) return 0;
  err = cudaFuncSetAttribute(gv_csp_pool_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPoolSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + kPoolTileH - 1) / kPoolTileH, batch);
  gv_csp_pool_kernel<<<grid, kThreads, kPoolSmemBytes, stream>>>(
      y, xcat, h, w, wc, bc, out);
  return (int)cudaGetLastError();
}

// c (m, n) = a (m, k) @ b in 3xTF32, b packed; m % 16 == n % 16 == k % 8 == 0.
extern "C" int gv_mma_product(const float* a, const float* bfrag, float* c,
                              int m, int n, int k, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % 16 || n % 16 || k % 8 ||
      m / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  gv_mma_product_kernel<<<dim3(n / 8, m / 16), 32, 0, stream>>>(a, bfrag, c,
                                                                 n, k);
  return (int)cudaGetLastError();
}
