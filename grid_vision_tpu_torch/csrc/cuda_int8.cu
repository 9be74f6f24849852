// The int8 detector's conv for Hopper (sm_90a): an s8 implicit-GEMM
// convolution with the detector's requant fused into its epilogue, and the
// same tiling as a plain GEMM in s8 and in bf16.
//
// Replaces the TPU kernels of tools/bench_int8_mxu.py, build_matmul (:32):
// the whole-K kernel (:42, pallas_call :46) and the K-blocked kernel (:58,
// pallas_call :67). Both compute an (M, K) x (K, N) product, s8 x s8 ->
// s32 or bf16 x bf16 -> f32, on detector-shaped GEMMs: an im2col'd conv
// with M the output positions, K = k * k * Cin and N = Cout. The tool
// gated a fused int8 detector that keeps its activations int8 on chip and
// requantizes in the GEMM's epilogue. This kernel is that conv, on the
// port's int8 detector path (models/yolov4_int8.py, one launch a conv, 19
// a forward); its 1 x 1, stride-1 form over a (1, M, 1, K) view is the
// tool's GEMM (ops/cuda_int8.int8_matmul, bf16_matmul).
//
// What it computes. x (B, H, W, C) NHWC, w (N, Kp) with k in (ty, tx, c)
// order and zero columns from K = k * k * C up to Kp; a k x k conv of
// stride s with flax SAME padding (pad_y rows above, pad_x columns to the
// left; zero outside the frame):
//   acc[b, oy, ox, n] = sum_k x[b, oy s + ty - pad_y, ox s + tx - pad_x, c]
//                             * w[n, (ty k + tx) C + c]
// Mode 0 writes acc: int32 in s8, exact (|acc| <= 127^2 * 4608 < 2^27).
// Mode 1 (s8 only) writes one f32 per accumulator, yolov4_int8.requant's
// arithmetic bit for bit, each rounding an explicit intrinsic so that nvcc
// contracts nothing:
//   s = sx[b] * sw[n]                 f32, round to nearest
//   a = f32(acc)                      rounds once |acc| passes 2^24
//   y = f32(fma(f64 a, f64 s, f64 bias[n]))   the f64 product is exact
//   y > 0 ? y : y * 0.1f              torch's leaky_relu form
// bf16 (mode 0): f32 sums. The tensor core truncates its accumulator at
// every mma (gv_mma.cuh), a bias that grows with the length of the chain,
// so each k-16 step runs from a zero accumulator and is added to the
// running sums in f32, round to nearest, outside the tensor core.
//
// Design, a simple kernel first. A block (128 threads, 2 x 2 warps) owns a
// 128 x BN output tile, BN 128 (s8), 64 or 32 (the wrapper's tile_n: the
// widest N fills, 128 only for K >= 2048, where it measured faster than
// 64, narrowed while the tiles would not give every SM a block, so that
// the 13 x 13 layers at one frame still spread). A warp computes 64 x BN / 2 with mma.sync: m16n8k32 s8 or
// m16n8k16 bf16, whose fragments hold the same bytes (a register: four
// neighbouring bytes of K of one row), so one tiling serves both. K walks
// in stages of 64 bytes (two mma steps), three stages in flight through
// cp.async. The taps are gathered into shared memory as a stage is staged
// (implicit GEMM: no (M, K) tap matrix in device memory). A row's 16-byte
// piece lies in one tap when C * sizeof(T) is a multiple of 16 (every layer
// but ConvBN_0): one cp.async, zero-filled outside the frame and past K.
// Otherwise (ConvBN_0: C = 3, K = 27 in one stage; a GEMM with K not a
// multiple of 16) a thread gathers its row's bytes one by one. Staged rows
// are 80 bytes apart, so the eight 16-byte rows an ldmatrix phase reads
// fall in eight distinct bank groups. Consecutive blocks take the N tiles
// of one M tile: the rows they gather are read from L2 once.
//
// Bound on this card: at the detector's shapes, bytes. At 64 frames the 19
// convs are 434.5 G operations (0.22 ms at the int8 peak of 1979 TOPS)
// against 1.56 GB of f32 output and 0.39 GB of int8 activations in (0.58
// ms at 3.35 TB/s). The requant in the epilogue writes each output once;
// the activation scales stay a reduction between convs. This form reaches
// ~30 % of that bound (PERF.md §6): mma.sync runs well below wgmma's
// rate, and the requant's f32 <-> f64 conversions add ~15 % to the int32
// form's time; wgmma s8 with TMA is the next step (ROADMAP B).

#include <climits>
#include <cstdint>

#include "gv_mma.cuh"

namespace {

constexpr int kThreads = 128;       // 4 warps, 2 x 2 over the tile
constexpr int kBM = 128;            // output rows (positions) a block
constexpr int kBK = 64;             // bytes of K a stage
constexpr int kPitch = kBK + 16;    // bytes between staged rows
constexpr int kStages = 3;

static_assert(kBM == kThreads, "the scalar gather stages a row a thread");

struct Conv {
  const char* x;                    // (B, H, W, C), T
  const char* w;                    // (N, Kp), T
  int h, w_in, c, ho, wo, ksize, stride, pad_y, pad_x;
  int m;                            // B * Ho * Wo
  int n;
  int k;                            // k * k * C elements
  int kp_bytes;                     // a weight row, a multiple of 16
  int n_tiles;                      // ceil(N / BN)
  bool vec;                         // 16-byte pieces (C * sizeof(T) % 16 == 0)
  const float* sx;                  // (B,) mode 1
  const float* sw;                  // (N,) mode 1
  const float* bias;                // (N,) mode 1
  void* out;                        // (M, N): int32 (s8) or f32
};

// 16 bytes global -> shared, zero-filled when !ok (src is then not read
// but must be a valid address). Cached in L1: a 3x3 conv's neighbouring
// rows gather overlapping pixels.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Four 8 x 16-byte matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8, and receives word l % 4 of row l / 4 of
// each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const unsigned char* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

template <typename T>
struct Elem;

// s8: m16n8k32 into the int32 accumulators (exact).
template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr int kSize = 1;
  __device__ __forceinline__ static void step(int (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// bf16: m16n8k16 from zero, added in f32 round to nearest.
template <>
struct Elem<gv::bf16> {
  using Acc = float;
  static constexpr int kSize = 2;
  __device__ __forceinline__ static void step(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    float d[4];
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], d[e]);
  }
};

// yolov4_int8.requant of one accumulator (bn: the f32 bias, widened).
__device__ __forceinline__ float requant(int acc, float sxb, float swn,
                                         double bn) {
  const float s = __fmul_rn(sxb, swn);
  const float a = __int2float_rn(acc);
  const float y = __double2float_rn(__fma_rn((double)a, (double)s, bn));
  return y > 0.0f ? y : __fmul_rn(y, 0.1f);
}

// The input window of output position m: its frame, top row and left
// column (rows past M get a row that no tap reaches).
struct Row {
  int b, y0, x0;
};

__device__ __forceinline__ Row row_of(const Conv& p, int m) {
  Row r{0, INT_MIN / 2, 0};
  if (m < p.m) {
    const int hw = p.ho * p.wo;
    r.b = m / hw;
    const int rem = m - r.b * hw;
    const int oy = rem / p.wo;
    r.y0 = oy * p.stride - p.pad_y;
    r.x0 = (rem - oy * p.wo) * p.stride - p.pad_x;
  }
  return r;
}

// Stages K bytes [64 kt, 64 kt + 64) of the block's A rows (the gathered
// taps) and B rows (the weights) into stage `stage`. Vector path: this
// thread copies piece tid % 4 of A rows tid / 4 + 32 i (row_* from
// row_of) and of B rows tid / 4 + 32 j.
template <typename T, int BN>
__device__ __forceinline__ void load_stage(
    const Conv& p, unsigned char* da, unsigned char* db, int kt, int tid,
    int m0, int n0, const int (&row_off)[4], const int (&row_y)[4],
    const int (&row_x)[4]) {
  constexpr int kSize = Elem<T>::kSize;
  const int piece = tid & 3;
  const int kb = kt * kBK + piece * 16;                // this piece's byte
  if (p.vec) {
    const int ke = kb / kSize;
    const bool in_k = ke < p.k;
    int tap_off = 0, ty = 0, tx = 0;
    if (in_k) {
      const int tap = ke / p.c;
      ty = tap / p.ksize;
      tx = tap - ty * p.ksize;
      tap_off = (ty * p.w_in + tx) * p.c + (ke - tap * p.c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = row_y[i] + ty, ix = row_x[i] + tx;
      const bool ok = in_k && (unsigned)iy < (unsigned)p.h &&
                      (unsigned)ix < (unsigned)p.w_in;
      const char* src =
          ok ? p.x + (size_t)(row_off[i] + tap_off) * kSize : p.x;
      cp_async16(da + ((tid >> 2) + 32 * i) * kPitch + piece * 16, src, ok);
    }
  } else if constexpr (kSize == 1) {
    // Scalar gather: thread tid stages all 64 bytes of row tid, walking
    // (ty, tx, c) on from the stage's first k.
    const Row r = row_of(p, m0 + tid);
    const int k0 = kt * kBK;
    const int end = p.k - k0 < kBK ? p.k - k0 : kBK;   // bytes of K here
    int tap = k0 / p.c, cc = k0 - tap * p.c;
    int ty = tap / p.ksize, tx = tap - ty * p.ksize;
    uint32_t* dst = reinterpret_cast<uint32_t*>(da + tid * kPitch);
    uint32_t word = 0;
    for (int e = 0; e < kBK; ++e) {
      if (e < end) {
        const int iy = r.y0 + ty, ix = r.x0 + tx;
        if ((unsigned)iy < (unsigned)p.h && (unsigned)ix < (unsigned)p.w_in) {
          const size_t at =
              ((size_t)(r.b * p.h + iy) * p.w_in + ix) * p.c + cc;
          word |= (uint32_t)(uint8_t)p.x[at] << (8 * (e & 3));
        }
        if (++cc == p.c) {
          cc = 0;
          if (++tx == p.ksize) {
            tx = 0;
            ++ty;
          }
        }
      }
      if ((e & 3) == 3) {
        dst[e >> 2] = word;
        word = 0;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    const int r = (tid >> 2) + 32 * j;
    const int n = n0 + r;
    const bool ok = n < p.n && kb < p.kp_bytes;
    const char* src = ok ? p.w + (size_t)n * p.kp_bytes + kb : p.w;
    cp_async16(db + r * kPitch + piece * 16, src, ok);
  }
}

__device__ __forceinline__ void store2(int* o, int a, int b) {
  *reinterpret_cast<int2*>(o) = make_int2(a, b);
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

template <typename T, int BN, int kMode>
__global__ void __launch_bounds__(kThreads)
    gv_int8_conv_kernel(const Conv p) {
  using Acc = typename Elem<T>::Acc;
  constexpr int kMT = 4;                 // m16 tiles a warp (64 rows)
  constexpr int kNT = BN / 16;           // n8 tiles a warp (BN / 2 columns)
  static_assert(kMode == 0 || Elem<T>::kSize == 1, "requant is s8 only");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sa = smem;                           // [kStages][kBM][kPitch]
  unsigned char* sb = smem + kStages * kBM * kPitch;  // [kStages][BN][kPitch]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = (int)(blockIdx.x / p.n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % p.n_tiles) * BN;

  // The windows of the A rows this thread stages (vector path).
  int row_off[4], row_y[4], row_x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Row r = row_of(p, m0 + (tid >> 2) + 32 * i);
    row_y[i] = r.y0;
    row_x[i] = r.x0;
    row_off[i] = r.y0 == INT_MIN / 2
                     ? 0
                     : ((r.b * p.h + r.y0) * p.w_in + r.x0) * p.c;
  }
  auto stage_a = [&](int stage) { return sa + stage * kBM * kPitch; };
  auto stage_b = [&](int stage) { return sb + stage * BN * kPitch; };

  Acc acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int kt_n = (p.kp_bytes + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) {
      load_stage<T, BN>(p, stage_a(s), stage_b(s), s, tid, m0, n0, row_off,
                        row_y, row_x);
    }
    gv::cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    gv::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_n) {
      load_stage<T, BN>(p, stage_a(next % kStages), stage_b(next % kStages),
                        next, tid, m0, n0, row_off, row_y, row_x);
    }
    gv::cp_async_commit();
    const unsigned char* da = stage_a(kt % kStages);
    const unsigned char* db = stage_b(kt % kStages);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        ldmatrix_x4(af[mt], da + (wm * 64 + mt * 16 + (lane & 15)) * kPitch +
                                ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int pr = 0; pr < kNT / 2; ++pr) {
        // n8 tiles 2 pr and 2 pr + 1: matrices (rows 0-7, bytes 0-15),
        // (0-7, 16-31), (8-15, 0-15), (8-15, 16-31) = b0, b1 of each.
        uint32_t bf[4];
        ldmatrix_x4(bf, db + (wn * (BN / 2) + pr * 16 + ((lane >> 4) << 3) +
                              (lane & 7)) * kPitch +
                            ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          Elem<T>::step(acc[mt][2 * pr], af[mt], bf[0], bf[1]);
          Elem<T>::step(acc[mt][2 * pr + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // Epilogue: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8.
  // Requant: a row's frame scale read once, a column's scale and bias once
  // (the f32 -> f64 conversions of the bias hoisted out of the rows).
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.n & 1) == 0;       // 8-byte stores stay aligned
  float sxr[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
      sxr[mt][half] = 0.0f;
      if constexpr (kMode == 1) {
        if (m < p.m) sxr[mt][half] = p.sx[m / (p.ho * p.wo)];
      }
    }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + wn * (BN / 2) + nt * 8 + 2 * t;
    if (n >= p.n) continue;
    const bool has1 = n + 1 < p.n;
    float sw0 = 0.0f, sw1 = 0.0f;
    double b0 = 0.0, b1 = 0.0;
    if constexpr (kMode == 1) {
      sw0 = p.sw[n];
      b0 = p.bias[n];
      if (has1) {
        sw1 = p.sw[n + 1];
        b1 = p.bias[n + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (m >= p.m) continue;
        const Acc v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if constexpr (kMode == 1) {
          float* o = static_cast<float*>(p.out) + (size_t)m * p.n + n;
          const float y0 = requant(v0, sxr[mt][half], sw0, b0);
          const float y1 = requant(v1, sxr[mt][half], sw1, b1);
          if (pairs) {
            store2(o, y0, y1);
          } else {
            o[0] = y0;
            if (has1) o[1] = y1;
          }
        } else {
          Acc* o = static_cast<Acc*>(p.out) + (size_t)m * p.n + n;
          if (pairs) {
            store2(o, v0, v1);
          } else {
            o[0] = v0;
            if (has1) o[1] = v1;
          }
        }
      }
    }
  }
}

template <typename T, int BN, int kMode>
cudaError_t launch(const Conv& p, long long blocks, cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kPitch;
  cudaError_t err = cudaFuncSetAttribute(
      gv_int8_conv_kernel<T, BN, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gv_int8_conv_kernel<T, BN, kMode>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch_bn(const Conv& p, int bn, long long blocks,
                      cudaStream_t stream) {
  switch (bn) {
    case 128:     // s8 only: bf16's split sums need more registers
      if constexpr (Elem<T>::kSize == 1) {
        return launch<T, 128, kMode>(p, blocks, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    case 64:
      return launch<T, 64, kMode>(p, blocks, stream);
    case 32:
      return launch<T, 32, kMode>(p, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (batch, h, w, c) and w (n, kp), both s8 (bf16 == 0) or both bf16; the
// conv's output (batch, ho, wo, n) into out: int32 accumulators (mode 0;
// f32 in bf16) or the requantized f32 (mode 1, s8: sx (batch,), sw and
// bias (n,)). bn: the tile's N (32, 64, or in s8 128). Returns a
// cudaError_t.
extern "C" int gv_int8_conv(const void* x, const void* w, int bf16, int mode,
                            int batch, int h, int w_in, int c, int ho, int wo,
                            int ksize, int stride, int pad_y, int pad_x,
                            int n, int kp, int bn, const float* sx,
                            const float* sw, const float* bias, void* out,
                            cudaStream_t stream) {
  const int size = bf16 ? 2 : 1;
  const long long m = (long long)batch * ho * wo;
  const long long k = (long long)ksize * ksize * c;
  if (batch < 0 || h < 1 || w_in < 1 || c < 1 || ksize < 1 || stride < 1 ||
      n < 0 || k > kp || (long long)kp * size % 16 != 0 ||
      ((uintptr_t)w & 15) != 0 || m > INT_MAX ||
      (long long)batch * h * w_in * c > INT_MAX ||
      (mode != 0 && (bf16 || !sx || !sw || !bias)) || mode < 0 || mode > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || n == 0) return 0;
  Conv p;
  p.x = static_cast<const char*>(x);
  p.w = static_cast<const char*>(w);
  p.h = h;
  p.w_in = w_in;
  p.c = c;
  p.ho = ho;
  p.wo = wo;
  p.ksize = ksize;
  p.stride = stride;
  p.pad_y = pad_y;
  p.pad_x = pad_x;
  p.m = (int)m;
  p.n = n;
  p.k = (int)k;
  p.kp_bytes = kp * size;
  p.n_tiles = (n + bn - 1) / bn;
  p.vec = c * size % 16 == 0 && ((uintptr_t)x & 15) == 0;
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.out = out;
  if (bf16 && !p.vec) return (int)cudaErrorInvalidValue;
  const long long blocks = ((m + kBM - 1) / kBM) * p.n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (bf16) return (int)launch_bn<gv::bf16, 0>(p, bn, blocks, stream);
  if (mode == 1) return (int)launch_bn<int8_t, 1>(p, bn, blocks, stream);
  return (int)launch_bn<int8_t, 0>(p, bn, blocks, stream);
}
