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
//
// The bf16 form (compute_dtype="bfloat16") is cuda_csp_bf16.cu. The kernels
// stay templated on the operand type (gv::Op<T>, instantiated for f32
// only), as the stem's f32 form is.

#include <type_traits>

#include "gv_mma.cuh"

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kTileW = 16;                    // one m16 tile per tile row
constexpr int kChunkK = 32;                   // input channels a weight chunk

__device__ __forceinline__ float leaky(float v) {
  return v > 0.0f ? v : 0.1f * v;
}

template <typename T, int CIN, int COUT, int MT>
struct ConvCfg {
  using O = gv::Op<T>;
  static constexpr int kTileH = 4 * MT;       // 4 warps x MT rows
  static constexpr int kStride = CIN + O::kPad;   // elements a staged pixel
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kTileElems = (kTileH + 2) * kHaloW * kStride;
  static constexpr int kNT = COUT / 8;
  static constexpr int kSteps = kChunkK / O::kK;  // mma k steps a chunk
  static constexpr int kChunkElems = kSteps * kNT * 32 * 4;
  static constexpr int kChunksPerTap = CIN / kChunkK;
  static constexpr int kChunks = 9 * kChunksPerTap;
  static constexpr int kSmemBytes =
      (kTileElems + 2 * kChunkElems) * (int)sizeof(T) + 2 * COUT * 4;
  // blocks an SM the compiler is to plan registers for: f32, as many as
  // the SM's 228 KB of shared memory take anyway (2 at 64 -> 64, 3 at 32 ->
  // 32; 3 at 64 -> 64 spills); bf16, one (left free, ptxas keeps the
  // 32 -> 32 instance at 96 registers and spills 8 bytes)
  static constexpr int kMinBlocks =
      std::is_same<T, float>::value ? 233472 / (kSmemBytes + 1024) : 1;
};

// BN and leaky of four neighbouring outputs, stored. f32: the scale is
// folded into the weights, acc + shift. bf16: acc * scale + shift in f32,
// rounded once at the store (the Pallas kernel's order, no FMA).
template <typename T>
__device__ __forceinline__ float bn_leaky(float v, float s, float b) {
  return std::is_same<T, float>::value ? leaky(v + b)
                                       : leaky(__fadd_rn(__fmul_rn(v, s), b));
}

// 3x3 stride-1 SAME conv + BN + leaky in operand type T (f32: 3xTF32;
// bf16: bf16 operands, f32 sums on the tensor core). in: (B, h, w,
// in_stride), CIN channels from in_off; wfrag: the (9 * CIN, COUT) matrix
// in (ty, tx, c) row order (f32: BN scale folded in, packed by
// tf32x3.pack_b_fragments; bf16: packed by bf16mma.pack_b_fragments);
// scale (bf16 only) and shift: the BN's; out: (B, h, w, out_stride), output
// channel co goes to out_off + co. in and out may be one buffer with
// disjoint channel ranges.
template <typename T, int CIN, int COUT, int MT>
__global__ void __launch_bounds__(kThreads,
                                  (ConvCfg<T, CIN, COUT, MT>::kMinBlocks))
gv_csp_conv3x3_kernel(const T* in, int in_stride, int in_off, int h, int w,
                      const T* __restrict__ wfrag,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* out,
                      int out_stride, int out_off) {
  using C = ConvCfg<T, CIN, COUT, MT>;
  using O = gv::Op<T>;
  using Frag = typename O::Frag;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + C::kTileElems;
  float* sscale = reinterpret_cast<float*>(wbuf + 2 * C::kChunkElems);
  float* sshift = sscale + COUT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * C::kTileH;
  const T* src = in + (int64_t)blockIdx.z * h * w * in_stride + in_off;

  constexpr int kPer = 16 / (int)sizeof(T);   // elements a 16-byte piece
  constexpr int kVecs = CIN / kPer;           // pieces a pixel
  for (int i = tid; i < (C::kTileH + 2) * C::kHaloW * kVecs; i += kThreads) {
    const int pix = i / kVecs;
    const int v = i - pix * kVecs;
    const int ry = pix / C::kHaloW;
    const int rx = pix - ry * C::kHaloW;
    const int y = y0 + ry - 1;
    const int x = x0 + rx - 1;
    const bool ok = y >= 0 && y < h && x >= 0 && x < w;
    const T* p = ok ? src + ((int64_t)y * w + x) * in_stride + kPer * v : src;
    gv::cp_async16(tile + pix * C::kStride + kPer * v, p, ok);
  }
  auto load_chunk = [&](int chunk) {
    const T* s = wfrag + (int64_t)chunk * C::kChunkElems;
    T* d = wbuf + (chunk & 1) * C::kChunkElems;
    for (int i = tid; i < C::kChunkElems / kPer; i += kThreads) {
      gv::cp_async16(d + kPer * i, s + kPer * i, true);
    }
    gv::cp_async_commit();
  };
  load_chunk(0);                              // one group with the tile
  if (tid < COUT) {
    sshift[tid] = shift[tid];
    sscale[tid] = std::is_same<T, float>::value ? 1.0f : scale[tid];
  }

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
    const Frag* wb =
        reinterpret_cast<const Frag*>(wbuf + (chunk & 1) * C::kChunkElems);
    const T* a0 = tile + ((warp * MT + ty) * C::kHaloW + tx + g) * C::kStride +
                  c0 + O::kThreadK * t;
    float d[MT][C::kNT][4];                   // 3xTF32: the chunk's chain
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
      Frag b[C::kNT];
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        b[nt] = wb[(ks * C::kNT + nt) * 32 + lane];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* a = a0 + mt * C::kHaloW * C::kStride + ks * O::kK;
        if constexpr (O::kSplitChains) {
          O::step(d[mt], ks == 0, a, a + 8 * C::kStride, b);
        } else {
          O::step(acc[mt], false, a, a + 8 * C::kStride, b);
        }
      }
    }
    if constexpr (O::kSplitChains) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) gv::add_chain(acc[mt], d[mt]);
    }
    __syncthreads();                          // the buffer is refilled next
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = y0 + warp * MT + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int x = x0 + g + 8 * half;
      if (y < h && x < w) {
        T* dst = out + (((int64_t)blockIdx.z * h + y) * w + x) * out_stride +
                 out_off + 4 * t;
#pragma unroll
        for (int p = 0; p < C::kNT / 2; ++p) {
          const float* ss = sscale + 16 * p + 4 * t;
          const float* sh = sshift + 16 * p + 4 * t;
          gv::store4(dst + 16 * p,
                     bn_leaky<T>(acc[mt][2 * p][2 * half], ss[0], sh[0]),
                     bn_leaky<T>(acc[mt][2 * p][2 * half + 1], ss[1], sh[1]),
                     bn_leaky<T>(acc[mt][2 * p + 1][2 * half], ss[2], sh[2]),
                     bn_leaky<T>(acc[mt][2 * p + 1][2 * half + 1], ss[3],
                                 sh[3]));
        }
      }
    }
  }
}

constexpr int kPoolTileH = 8;

template <typename T>
struct PoolCfg {
  using O = gv::Op<T>;
  static constexpr int kStride = 64 + O::kPad;    // elements a staged pixel
  static constexpr int kTileElems = kPoolTileH * kTileW * kStride;
  static constexpr int kSteps = 64 / O::kK;
  static constexpr int kWElems = kSteps * 8 * 32 * 4;   // 64 x 64 packed
  static constexpr int kSmemBytes =
      (kTileElems + kWElems) * (int)sizeof(T) + 2 * 64 * 4;
};

// The elementwise max of four 16-byte pieces.
__device__ __forceinline__ float4 max4(float4 a, float4 b, float4 c,
                                       float4 d) {
  return make_float4(fmaxf(fmaxf(a.x, b.x), fmaxf(c.x, d.x)),
                     fmaxf(fmaxf(a.y, b.y), fmaxf(c.y, d.y)),
                     fmaxf(fmaxf(a.z, b.z), fmaxf(c.z, d.z)),
                     fmaxf(fmaxf(a.w, b.w), fmaxf(c.w, d.w)));
}

// 1x1 conv (64 -> 64) on xcat = concat[x2, x1] + BN + leaky = x3, then the
// 2x2/s2 max pool of concat[y, x3], in operand type T. A block owns 8 x 16
// pixels, a warp two rows of them: one row of 8 pooled pixels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gv_csp_pool_kernel(const T* __restrict__ y, const T* __restrict__ xcat,
                   int h, int w, const T* __restrict__ wfrag,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ out) {
  using C = PoolCfg<T>;
  using O = gv::Op<T>;
  using Frag = typename O::Frag;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* wbuf = tile + C::kTileElems;
  float* sscale = reinterpret_cast<float*>(wbuf + C::kWElems);
  float* sshift = sscale + 64;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kPoolTileH;
  const int64_t frame = (int64_t)blockIdx.z * h * w;
  constexpr int kPer = 16 / (int)sizeof(T);   // elements a 16-byte piece
  constexpr int kVecs = 64 / kPer;            // pieces a pixel

  for (int i = tid; i < kPoolTileH * kTileW * kVecs; i += kThreads) {
    const int pix = i / kVecs;
    const int v = i - pix * kVecs;
    const int yy = y0 + pix / kTileW;
    const int xx = x0 + pix % kTileW;
    const bool ok = yy < h && xx < w;
    const T* p =
        ok ? xcat + (frame + (int64_t)yy * w + xx) * 64 + kPer * v : xcat;
    gv::cp_async16(tile + pix * C::kStride + kPer * v, p, ok);
  }
  for (int i = tid; i < C::kWElems / kPer; i += kThreads) {
    gv::cp_async16(wbuf + kPer * i, wfrag + kPer * i, true);
  }
  gv::cp_async_commit();
  if (tid < 64) {
    sshift[tid] = shift[tid];
    sscale[tid] = std::is_same<T, float>::value ? 1.0f : scale[tid];
  }

  // while the copies fly: max pool of y into channels [0:64)
  const int ho = h / 2;
  const int wo = w / 2;
  for (int i = tid; i < (kPoolTileH / 2) * (kTileW / 2) * kVecs;
       i += kThreads) {
    const int pp = i / kVecs;
    const int v = i - pp * kVecs;
    const int py = y0 / 2 + pp / (kTileW / 2);
    const int px = x0 / 2 + pp % (kTileW / 2);
    if (py < ho && px < wo) {
      const T* s = y + (frame + (int64_t)(2 * py) * w + 2 * px) * 64 +
                   kPer * v;
      T* d = out + (((int64_t)blockIdx.z * ho + py) * wo + px) * 128 +
             kPer * v;
      *reinterpret_cast<float4*>(d) = max4(
          __ldg(reinterpret_cast<const float4*>(s)),
          __ldg(reinterpret_cast<const float4*>(s + 64)),
          __ldg(reinterpret_cast<const float4*>(s + (int64_t)w * 64)),
          __ldg(reinterpret_cast<const float4*>(s + (int64_t)w * 64 + 64)));
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
  const Frag* wb = reinterpret_cast<const Frag*>(wbuf);
  const T* a0 = tile + (warp * 2 * kTileW + g) * C::kStride + O::kThreadK * t;
#pragma unroll
  for (int ks = 0; ks < C::kSteps; ++ks) {
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {          // 4 n-tiles at a time: registers
      Frag b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt] = wb[(ks * 8 + 4 * nh + nt) * 32 + lane];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* a = a0 + mt * kTileW * C::kStride + ks * O::kK;
        if constexpr (O::kSplitChains) {
          float d[4][4];                      // a chain of one k step
          O::step(d, true, a, a + 8 * C::kStride, b);
          gv::add_chain(acc[mt][nh], d);
        } else {
          O::step(acc[mt][nh], false, a, a + 8 * C::kStride, b);
        }
      }
    }
  }

  // x3 = leaky(BN(acc)) (rounded to T); pool the warp's two rows
  // (registers), then neighbouring pixels g, g ^ 1 (lanes 4 apart); even g
  // stores
  const int py = y0 / 2 + warp;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* ss = sscale + 16 * p + 4 * t;
    const float* sh = sshift + 16 * p + 4 * t;
    float m[2][4];                            // [pixel half][channel]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nt = 2 * p + (e >> 1);
        const int c = 2 * half + (e & 1);
        float r[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float a = acc[mt][nt >> 2][nt & 3][c];
          r[mt] = bn_leaky<T>(a, ss[e], sh[e]);
        }
        const float v = fmaxf(r[0], r[1]);
        m[half][e] = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 4));
      }
    }
    if (!(g & 1) && py < ho) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = x0 / 2 + g / 2 + 4 * half;
        if (px < wo) {
          gv::store4(out + (((int64_t)blockIdx.z * ho + py) * wo + px) * 128 +
                         64 + 16 * p + 4 * t,
                     m[half][0], m[half][1], m[half][2], m[half][3]);
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

template <typename T, int CIN, int COUT, int MT>
cudaError_t launch_conv(const T* in, int in_off, int batch, int h, int w,
                        const T* wfrag, const float* scale,
                        const float* shift, T* out, int out_off,
                        cudaStream_t stream) {
  using C = ConvCfg<T, CIN, COUT, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      gv_csp_conv3x3_kernel<T, CIN, COUT, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + C::kTileH - 1) / C::kTileH, batch);
  gv_csp_conv3x3_kernel<T, CIN, COUT, MT>
      <<<grid, kThreads, C::kSmemBytes, stream>>>(
          in, 64, in_off, h, w, wfrag, scale, shift, out, 64, out_off);
  return cudaGetLastError();
}

// The four launches of one call in operand type T (scale: the BN scales,
// bf16 only; s* may be null in f32).
template <typename T>
int detector_csp(const T* x, int batch, int h, int w, const T* w2,
                 const float* s2, const float* b2, const T* wa,
                 const float* sa, const float* ba, const T* wb,
                 const float* sb, const float* bb, const T* wc,
                 const float* sc, const float* bc, T* y, T* xcat, T* out,
                 cudaStream_t stream) {
  if (batch > 65535 || h > 65535 * 8) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = launch_conv<T, 64, 64, 2>(x, 0, batch, h, w, w2, s2, b2,
                                              y, 0, stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<T, 32, 32, 4>(y, 32, batch, h, w, wa, sa, ba, xcat, 32,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<T, 32, 32, 4>(xcat, 32, batch, h, w, wb, sb, bb, xcat, 0,
                                  stream);
  if (err != cudaSuccess) return (int)err;
  if (h / 2 == 0 || w / 2 == 0) return 0;
  err = cudaFuncSetAttribute(gv_csp_pool_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PoolCfg<T>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTileW - 1) / kTileW,
                  (h + kPoolTileH - 1) / kPoolTileH, batch);
  gv_csp_pool_kernel<T><<<grid, kThreads, PoolCfg<T>::kSmemBytes, stream>>>(
      y, xcat, h, w, wc, sc, bc, out);
  return (int)cudaGetLastError();
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
  return detector_csp<float>(x, batch, h, w, w2, nullptr, b2, wa, nullptr,
                             ba, wb, nullptr, bb, wc, nullptr, bc, y, xcat,
                             out, stream);
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
