// The int8 detector's conv for Hopper (sm_90a): an s8 implicit-GEMM
// convolution with the detector's requant fused into its epilogue, and the
// same kernel as a plain GEMM in s8 and in bf16.
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
// Mode 0 writes acc: int32 in s8, exact (|acc| <= 127^2 * 4608 < 2^27) in
// any order of the sums, so any tiling gives the same bits. Mode 1 (s8
// only) writes one f32 per accumulator, yolov4_int8.requant's arithmetic
// bit for bit, each rounding an explicit intrinsic so that nvcc contracts
// nothing:
//   s = sx[b] * sw[n]                 f32, round to nearest
//   a = f32(acc)                      rounds once |acc| passes 2^24
//   y = f32(fma(f64 a, f64 s, f64 bias[n]))   the f64 product is exact
//   y > 0 ? y : y * 0.1f              torch's leaky_relu form
// bf16 (mode 0): f32 sums. The tensor core truncates its accumulator at
// every instruction (gv_mma.cuh), a bias that grows with the chain, so a
// stage's four k-16 steps chain from zero and their sum is added to the
// running sums in f32, round to nearest, outside the tensor core (all of
// K chained also passed the bars, 4.6e-5 at K = 384 against 1.5e-5 so:
// PERF.md §6 PR 19).
//
// What bounds it on this card. At 64 frames the 19 convs are 433.6 G
// operations (0.219 ms at the int8 peak of 1979 TOPS) against 1.56 GB of
// f32 output and 0.39 GB of int8 activations in (0.585 ms at 3.35 TB/s):
// bytes, as a sum. Per layer two classes: the early layers (208 and 104
// rows, N 32 / 64, K <= 576) are bound by their f32 writes; the big-K
// layers (ConvBN_3, 4, 5, 7, 9: 255 of the 434 G operations) by the
// tensor cores, which Hopper runs at full rate only through wgmma.
//
// Design (ops/cuda_int8.int8_plan chooses the tile and the route):
// - A block of 384 threads, one an SM, persistent: it walks output tiles
//   of 128 rows x BN (32, 64, 128, 256; bf16 up to 128) blockIdx.x,
//   + gridDim.x, ..., the N tiles of one row tile next to each other so
//   that the rows gathered for them are read from L2 once.
// - Warpgroup 0 produces (setmaxnreg down to 88 registers), warpgroups 1
//   and 2 consume (up to 208), 64 rows each. Between them a ring of S >= 4
//   stages, each 128 bytes of K of the tile's A rows and B rows, with
//   full / empty mbarriers; the ring runs on across tiles, so that the
//   producer loads the next tile while the consumers store this one.
// - Consumers: wgmma.mma_async m64nBNk32 s8 (bf16: m64nBNk16), both
//   operands from shared memory by descriptor, four k steps a stage, a
//   partial last stage too (every route leaves zeros past K, or bytes
//   that multiply B's zeros: branches around the products made ptxas
//   fence between them); a stage's buffer is released when the products
//   that read it are done.
// - Producer routes for A (B, the weights, always comes by a TMA tiled
//   copy of wt in the 128-byte swizzle, zero past Kp and N):
//     tiled  (1 x 1, stride 1: CSP*/2, ConvBN_6, 8 and the tool's GEMM) A
//            is a plain (M, C) matrix: one TMA tiled copy a stage;
//     im2col (every other 3x3 layer) TMA im2col copies of 128 output
//            pixels, the tap as the copy's offsets, the stride as the
//            map's element strides, flax SAME's asymmetric padding as the
//            bounding box's corners: C of 128 bytes or more a copy a
//            stage (128 bytes of one tap's channels, the 128-byte
//            swizzle); s8 C of 32 or 64 (ConvBN_1, 2, CSP0/0, 1, CSP1/0,
//            1) a copy a tap, each into a sub-tile of 128 rows x C bytes
//            in the 32- or 64-byte swizzle, so four or two taps a stage;
//     gather (any other C a multiple of 16 bytes) 16-byte cp.async
//            pieces by all 128 producer threads, zero outside the frame,
//            each thread's arrival made by the hardware once its copies
//            land (cp.async.mbarrier.arrive.noinc);
//     runs   (ConvBN_0: C = 3, k = 3, K = 27) a thread a row: the three
//            runs of nine bytes (a tap row's three pixels) by aligned
//            4-byte loads and funnel shifts, the next tile's loads in
//            flight while this one is packed; one k step, the
//            consumers' one-step path;
//     bytes  (any other C: a GEMM with K not a multiple of 16) a thread a
//            row, byte by byte: correct, not fast.
//   The consumers fence the async proxy after a stage that threads wrote
//   (gather, runs, bytes) and before their products read it.
// - Epilogue: each consumer warpgroup takes 32 accumulator columns of its
//   64 rows at a time, requantizes them in the fragments' registers (sx,
//   sw and bias from tables loaded into shared memory once a block; the
//   f64 operand built from the accumulator's bits where f32(acc) is exact,
//   decided for a warp's chunk at once), writes them into a 64 x 32 chunk
//   in the 128-byte swizzle and stores it with one TMA tensor store (N %
//   4 == 0; else the threads store it element by element).

#include <climits>
#include <cstdint>
#include <type_traits>

#include "gv_hopper.cuh"
#include "gv_wgmma_ss.cuh"

namespace {

constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kBM = 128;             // output rows a tile
constexpr int kBK = 128;             // bytes of K a stage
constexpr int kABytes = kBM * kBK;   // a stage's A rows
constexpr int kEpiBytes = 2 * 64 * 128;   // a 64 x 32 staged chunk each
constexpr int kRowBytes = kBM * 16;  // the gather's row table
constexpr int kTable = 768;          // mode 1: sx, sw (f32) and bias
constexpr int kTableBytes = 4 * kTable * 4;  // (f64) in shared memory,
                                             // up to this many each
constexpr int kMaxSmem = 232448;     // a block's dynamic shared memory
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 88;   // 128 x 88 + 256 x 208 = 384 x 168
constexpr int kConsumerRegs = 208;
constexpr long long kWatchdog = 1LL << 34;   // cycles (~10 s): then trap

enum Route { kTiled = 0, kIm2col = 1, kGather = 2, kRuns = 3, kBytes = 4 };

template <int BN>
struct Smem {
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kFixed =
      kEpiBytes + kRowBytes + kTableBytes + 256 + 1024;
  static constexpr int kFit = (kMaxSmem - kFixed) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kBytes = kStages * kStage + kFixed;
  static_assert(kStages >= 4, "a ring of at least 4 stages");
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1; the
// multiplier and shift made on the host): a division by a value known
// only at run time is some twenty dependent instructions, and the single
// thread that issues the copies would spend most of a stage on them.
struct FastDiv {
  uint32_t m, s;
};

inline FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return {(uint32_t)((((1ull << 32) * ((1ull << s) - d)) / d) + 1), s};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.s);
}

struct Conv {
  CUtensorMap amap;                 // A: tiled (M, C) or im2col over x
  CUtensorMap bmap;                 // B: wt (N, Kp), tiled
  CUtensorMap omap;                 // out (M, N), 4-byte, for TMA stores
  const char* x;                    // (B, H, W, C), T
  const char* x_end;                // one past x's last byte
  int h, w_in, c, ho, wo, ksize, stride, pad_y, pad_x;
  int m;                            // B * Ho * Wo
  int n;
  int k;                            // k * k * C elements
  int stages_k;                     // stages a tile: K bytes / 128, up
  int one_step;                     // K within one 32-byte k step
  int route;
  int a_w;                          // bytes a row of an A sub-tile: 128,
                                    // or C (32, 64: im2col of narrow taps)
  int tma_out;                      // out by TMA stores (N % 4 == 0)
  int m_tiles, n_tiles;
  FastDiv by_hw, by_wo, by_n_tiles; // / (Ho Wo), / Wo, / n_tiles
  const float* sx;                  // (B,) mode 1
  const float* sw;                  // (N,) mode 1
  const float* bias;                // (N,) mode 1
  void* out;                        // (M, N): int32 (s8) or f32
};

template <typename T>
struct Elem;

template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr int kSize = 1;
};

template <>
struct Elem<gv::bf16> {
  using Acc = float;
  static constexpr int kSize = 2;
};

// Waits for the phase of `bar` of this parity; a wait that outlasts the
// watchdog traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  if (gv::mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!gv::mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWatchdog) __trap();
  }
}

// Byte offset of 16-byte chunk j of row r of a tile in the 128-byte
// swizzle.
__device__ __forceinline__ uint32_t sw128(int r, int j) {
  return (uint32_t)(r * kBK + ((j ^ (r & 7)) << 4));
}

// yolov4_int8.requant of one accumulator, given s = f64(f32(sx * sw))
// and the bias widened: f64(f32(acc)) * s + bias, one f64 rounding, then
// to f32 and the leaky. Conversions run at a quarter of the f64 rate, so
// where f32(acc) is exact (kExact: |acc| <= 2^24, the common case, checked
// for a warp's whole chunk at once: a branch an element would keep the
// compiler from interleaving the chains) f64(acc) is built from its bits:
// 2^52 + 2^31 + acc as a double, less 2^52 + 2^31, exact. s and the bias
// are widened once for a fragment's columns.
template <bool kExact>
__device__ __forceinline__ float requant(int acc, double s, double bias) {
  double a;
  if constexpr (kExact) {
    a = __hiloint2double(0x43300000, (int)((unsigned)acc ^ 0x80000000u)) -
        4503601774854144.0;
  } else {
    a = (double)__int2float_rn(acc);
  }
  const float y = __double2float_rn(__fma_rn(a, s, bias));
  return y > 0.0f ? y : __fmul_rn(y, 0.1f);
}

// The input window of output position m: its frame, top row and left
// column, and the element offset of (b, y0, x0) (rows past M get a row
// that no tap reaches).
__device__ __forceinline__ int4 row_of(const Conv& p, int m) {
  int4 r = make_int4(0, INT_MIN / 2, 0, 0);
  if (m < p.m) {
    const int b = fdiv(m, p.by_hw);
    const int rem = m - b * p.ho * p.wo;
    const int oy = fdiv(rem, p.by_wo);
    r.y = oy * p.stride - p.pad_y;
    r.z = (rem - oy * p.wo) * p.stride - p.pad_x;
    r.x = ((b * p.h + r.y) * p.w_in + r.z) * p.c;
    r.w = b;
  }
  return r;
}

// -DGV_INT8_CLOCKS: thread 0 of the producer and of the first consumer
// warpgroup add the cycles of each phase into g_int8_clocks (producer:
// 0 waiting for an empty stage, 1 the rest; consumer: 2 waiting for a full
// stage, 3 the products, 4 the epilogue's wait for its buffer, 5 a tile's
// start, 6 the epilogue's requant and staging, 7 its stores; 8 blocks, 9
// tiles), read back and zeroed by gv_int8_clocks (a measurement build).
constexpr int kClockSlots = 8;
#ifdef GV_INT8_CLOCKS
__device__ unsigned long long g_int8_clocks[kClockSlots + 2];

struct Clocks {
  bool on;
  long long t;
  long long acc[kClockSlots];
  __device__ explicit Clocks(bool on_) {
    on = on_;
    for (int i = 0; i < kClockSlots; ++i) acc[i] = 0;
#ifdef __CUDA_ARCH__
    t = clock64();
#endif
  }
  __device__ void lap(int slot) {
#ifdef __CUDA_ARCH__
    if (!on) return;
    const long long now = clock64();
    acc[slot] += now - t;
    t = now;
#endif
  }
  long long n[2] = {0, 0};                // blocks, tiles
  __device__ void count(int slot) { n[slot - kClockSlots] += 1; }
  __device__ void flush() {
    if (!on) return;
    for (int i = 0; i < kClockSlots; ++i) {
      atomicAdd(&g_int8_clocks[i], (unsigned long long)acc[i]);
    }
    for (int i = 0; i < 2; ++i) {
      atomicAdd(&g_int8_clocks[kClockSlots + i], (unsigned long long)n[i]);
    }
  }
};
#else
struct Clocks {
  __device__ explicit Clocks(bool) {}
  __device__ void lap(int) {}
  __device__ void count(int) {}
  __device__ void flush() {}
};
#endif

// ---- producer ----------------------------------------------------------

struct Ring {
  uint32_t a, b;          // stage 0's A and B tiles
  uint32_t full, empty;   // stage 0's barriers (8 bytes each)
  int b_bytes;            // a stage's B tile
};

// ConvBN_0's row m: the three runs of nine bytes x[b, y0 + ty, x0 .. x0 +
// 2, 0 .. 2], loaded as the aligned words that hold them (clamped to x's
// words: a word outside x holds only bytes outside the frame, masked
// later). runs_load issues the loads, runs_pack assembles the row's 32
// bytes (27 used) once they have landed: the producer loads the next
// tile's rows before it packs this one's.
struct RunsLoad {
  uint32_t w[3][3];     // a run's three words
  uint32_t sh[3];       // its first byte's offset in w[ty][0], in bits
  uint32_t valid;       // bits 0-2: rows inside the frame; 4-7, 8-11: the
                        // run's bytes [lo, hi) inside it
};

__device__ __forceinline__ void runs_load(const Conv& p, int m,
                                          RunsLoad& L) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(p.x) & ~(uintptr_t)3;
  const uintptr_t last =
      (reinterpret_cast<uintptr_t>(p.x_end) - 1) & ~(uintptr_t)3;
  int4 r = make_int4(0, INT_MIN / 2, 0, 0);
  uint32_t lo = 0, hi = 0, rows = 0;
  if (m < p.m) {
    r = row_of(p, m);
    lo = 3 * (r.z < 0 ? -r.z : 0);
    hi = 3 * (p.w_in - r.z < 3 ? p.w_in - r.z : 3);
  }
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    const int iy = r.y + ty;
    const bool ok = m < p.m && (unsigned)iy < (unsigned)p.h && lo < hi;
    const uintptr_t addr =
        ok ? reinterpret_cast<uintptr_t>(p.x) +
                 (uintptr_t)(((long long)(r.w * p.h + iy) * p.w_in + r.z) * 3)
           : first;
    rows |= (uint32_t)ok << ty;
    L.sh[ty] = (uint32_t)(addr & 3) * 8;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      uintptr_t a = (addr & ~(uintptr_t)3) + 4 * i;
      a = a < first ? first : a > last ? last : a;
      L.w[ty][i] = __ldg(reinterpret_cast<const uint32_t*>(a));
    }
  }
  L.valid = rows | (lo << 4) | (hi << 8);
}

__device__ __forceinline__ void runs_pack(const RunsLoad& L, uint4& lo4,
                                          uint4& hi4) {
  const uint32_t lo = (L.valid >> 4) & 15, hi = (L.valid >> 8) & 15;
  // the run's bytes lo .. hi - 1 (of 9) are taps inside the frame
  const unsigned long long m64 =
      lo >= 8 ? 0ull
              : (hi >= 8 ? ~0ull : (1ull << (8 * hi)) - 1) &
                    ~((1ull << (8 * lo)) - 1);
  const unsigned long long m8 = lo <= 8 && 8 < hi ? 0xFF : 0;
  unsigned long long q[4] = {0, 0, 0, 0};
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
    if ((L.valid >> ty & 1) == 0) continue;
    const uint32_t sh = L.sh[ty];
    const uint32_t s0 = __funnelshift_r(L.w[ty][0], L.w[ty][1], sh);
    const uint32_t s1 = __funnelshift_r(L.w[ty][1], L.w[ty][2], sh);
    const unsigned long long lo64 =
        ((unsigned long long)s0 | ((unsigned long long)s1 << 32)) & m64;
    const unsigned long long hi8 = (L.w[ty][2] >> sh) & m8;
    // run ty at bit 72 ty of the row
    if (ty == 0) {
      q[0] |= lo64;
      q[1] |= hi8;
    } else if (ty == 1) {
      q[1] |= lo64 << 8;
      q[2] |= (lo64 >> 56) | (hi8 << 8);
    } else {
      q[2] |= lo64 << 16;
      q[3] |= (lo64 >> 48) | (hi8 << 16);
    }
  }
  lo4 = make_uint4((uint32_t)q[0], (uint32_t)(q[0] >> 32), (uint32_t)q[1],
                   (uint32_t)(q[1] >> 32));
  hi4 = make_uint4((uint32_t)q[2], (uint32_t)(q[2] >> 32), (uint32_t)q[3],
                   (uint32_t)(q[3] >> 32));
}

// Any C (s8): a thread stages bytes [128 kt, 128 kt + 128) of row m's K,
// walking (ty, tx, c) byte by byte; zero outside the frame and past K.
__device__ __forceinline__ void bytes_row(const Conv& p, int m, int kt,
                                          uint32_t row_dst, int r) {
  int4 g = row_of(p, m);
  const int k0 = kt * kBK;
  int tap = k0 / p.c, cc = k0 - tap * p.c;
  int ty = tap / p.ksize, tx = tap - ty * p.ksize;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(p.x);
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    uint32_t w[4];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      uint32_t word = 0;
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        const int e = k0 + 16 * j + 4 * wi + bi;
        if (m < p.m && e < p.k) {
          const int iy = g.y + ty, ix = g.z + tx;
          if ((unsigned)iy < (unsigned)p.h &&
              (unsigned)ix < (unsigned)p.w_in) {
            word |= (uint32_t)xb[(size_t)g.x +
                                 (size_t)((ty * p.w_in + tx) * p.c + cc)]
                    << (8 * bi);
          }
          if (++cc == p.c) {
            cc = 0;
            if (++tx == p.ksize) {
              tx = 0;
              ++ty;
            }
          }
        }
      }
      w[wi] = word;
    }
    gv::sts128(row_dst + ((j ^ (r & 7)) << 4),
               make_uint4(w[0], w[1], w[2], w[3]));
  }
}

template <typename T, int BN>
__device__ __forceinline__ void produce(const Conv& p, const Ring& ring,
                                        int4* rows, int lt) {
  constexpr int S = Smem<BN>::kStages;
  constexpr int kSize = Elem<T>::kSize;
  const int route = p.route;
  const bool tma_a = route == kTiled || route == kIm2col;
  if (tma_a && lt != 0) return;           // one thread issues the copies
  const int tiles = p.m_tiles * p.n_tiles;
  const int j = lt & 7;                   // gather: this thread's chunk
  int it = 0;                             // stages issued, over all tiles
  Clocks clk(lt == 0);
  if (route == kRuns) {                   // one stage a tile (K = 27)
    RunsLoad cur, next;
    if (blockIdx.x < tiles) {
      runs_load(p, fdiv(blockIdx.x, p.by_n_tiles) * kBM + lt, cur);
    }
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
      const int t_next = t + gridDim.x;
      if (t_next < tiles) {               // in flight while this one packs
        runs_load(p, fdiv(t_next, p.by_n_tiles) * kBM + lt, next);
      }
      const int slot = it % S;
      const uint32_t full = ring.full + 8 * slot;
      const uint32_t a = ring.a + slot * kABytes;
      clk.lap(1);
      bar_wait(ring.empty + 8 * slot, ((it / S) & 1) ^ 1);
      clk.lap(0);
      if (lt == 0) {
        gv::mbar_expect_tx(full, ring.b_bytes);
        gv::tensor_copy_2d(ring.b + slot * ring.b_bytes, &p.bmap, 0,
                           (t - fdiv(t, p.by_n_tiles) * p.n_tiles) * BN,
                           full);
      }
      uint4 lo, hi;
      runs_pack(cur, lo, hi);
      gv::sts128(a + sw128(lt, 0), lo);
      gv::sts128(a + sw128(lt, 1), hi);
      if (!p.one_step) {                  // the stage's other k steps
#pragma unroll
        for (int c = 2; c < 8; ++c) {
          gv::sts128(a + sw128(lt, c), make_uint4(0, 0, 0, 0));
        }
      }
      gv::mbar_arrive(full);
      cur = next;
    }
    clk.lap(1);
    clk.flush();
    return;
  }
  const int taps_k = p.ksize * p.ksize;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = fdiv(t, p.by_n_tiles);
    const int m0 = mt * kBM;
    const int n0 = (t - mt * p.n_tiles) * BN;
    int4 base = make_int4(0, 0, 0, 0);
    // im2col: the next copy's tap (tx, ty) and channel, walked on a stage
    // at a time (no division on the issuing thread's path)
    int tx = 0, ty = 0, c_at = 0, taps_done = 0;
    if (route == kGather) {
      gv::bar_sync(1, 128);               // the last tile's rows are read
      rows[lt] = row_of(p, m0 + lt);
      gv::bar_sync(1, 128);
    } else if (route == kIm2col) {
      base = row_of(p, m0);               // the walk's first base pixel
    }
    for (int kt = 0; kt < p.stages_k; ++kt, ++it) {
      const int slot = it % S;
      const uint32_t full = ring.full + 8 * slot;
      const uint32_t a = ring.a + slot * kABytes;
      clk.lap(1);
      bar_wait(ring.empty + 8 * slot, ((it / S) & 1) ^ 1);
      clk.lap(0);
      if (lt == 0) {
        // narrow im2col (a_w < 128): a stage holds kBK / a_w taps, each a
        // sub-tile of 128 rows x a_w bytes; the taps past k x k are not
        // copied (B is zero there, and s8 products of any byte with zero
        // are zero)
        const int per = p.a_w == 32 ? 4 : p.a_w == 64 ? 2 : 1;
        const int taps = taps_k - taps_done < per ? taps_k - taps_done : per;
        const int a_bytes = route == kTiled ? kABytes
                            : route != kIm2col ? 0
                            : p.a_w == kBK ? kABytes
                            : taps * kBM * p.a_w;
        gv::mbar_expect_tx(full, ring.b_bytes + a_bytes);
        gv::tensor_copy_2d(ring.b + slot * ring.b_bytes, &p.bmap,
                           kt * (kBK / kSize), n0, full);
        if (route == kTiled) {
          gv::tensor_copy_2d(a, &p.amap, kt * (kBK / kSize), m0, full);
        } else if (route == kIm2col && p.a_w == kBK) {
          gv::im2col_copy_4d(a, &p.amap, c_at, base.z, base.y, base.w,
                             (uint16_t)tx, (uint16_t)ty, full);
          c_at += kBK / kSize;
          if (c_at == p.c) {
            c_at = 0;
            if (++tx == p.ksize) {
              tx = 0;
              ++ty;
            }
          }
        } else if (route == kIm2col) {
          for (int q = 0; q < taps; ++q) {
            gv::im2col_copy_4d(a + q * kBM * p.a_w, &p.amap, 0, base.z,
                               base.y, base.w, (uint16_t)tx, (uint16_t)ty,
                               full);
            if (++tx == p.ksize) {
              tx = 0;
              ++ty;
            }
          }
          taps_done += taps;
        }
      }
      if (route == kGather) {
        const int ke = (kt * kBK + 16 * j) / kSize;   // this chunk's k
        const bool in_k = ke < p.k;
        int tap_off = 0, ty = 0, tx = 0;
        if (in_k) {
          const int tap = ke / p.c;
          ty = tap / p.ksize;
          tx = tap - ty * p.ksize;
          tap_off = (ty * p.w_in + tx) * p.c + (ke - tap * p.c);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = (lt >> 3) + 16 * i;
          const int4 g = rows[r];
          const int iy = g.y + ty, ix = g.z + tx;
          const bool ok = in_k && (unsigned)iy < (unsigned)p.h &&
                          (unsigned)ix < (unsigned)p.w_in;
          const char* src =
              ok ? p.x + (size_t)(g.x + tap_off) * kSize : p.x;
          gv::cp_async16_ca(a + sw128(r, j), src, ok);
        }
        gv::cp_async_mbar_arrive(full);   // an arrival once they land
      } else if (route == kBytes) {
        bytes_row(p, m0 + lt, kt, a + lt * kBK, lt);
        gv::mbar_arrive(full);
      }
    }
  }
  clk.lap(1);
  clk.flush();
}

// ---- consumers ---------------------------------------------------------

// Column n's sw and its bias widened, from the block's tables (kTables)
// or global memory; 0 past N. Branch-free (the column clamped, the value
// selected), so that a chunk's loads and requants can interleave.
template <bool kTables>
__device__ __forceinline__ float col_sw(const Conv& p, const float* tab,
                                        int n) {
  const int at = n < p.n ? n : p.n - 1;
  const float v = kTables ? tab[kTable + at] : __ldg(p.sw + at);
  return n < p.n ? v : 0.0f;
}

template <bool kTables>
__device__ __forceinline__ double col_bias(const Conv& p, const float* tab,
                                           int n) {
  const int at = n < p.n ? n : p.n - 1;
  const double v = kTables
                       ? reinterpret_cast<const double*>(tab + 2 * kTable)[at]
                       : (double)__ldg(p.bias + at);
  return n < p.n ? v : 0.0;
}

// Chunk cc (32 columns) of a consumer thread's fragments into the staged
// chunk at `stage` (the 128-byte swizzle): requantized in mode 1 (kExact:
// every accumulator of the warp's chunk within 2^24; kTables: sw and bias
// from the block's tables; kOneFrame: the thread's two rows in one frame,
// one s for both), else the raw bits.
template <typename Acc, int kMode, bool kExact, bool kTables, bool kOneFrame,
          int R>
__device__ __forceinline__ void stage_chunk(const Acc (&acc)[R], int cc,
                                            const Conv& p, const float* tab,
                                            const float (&sxr)[2],
                                            int n0, int warp, int g, int t4,
                                            uint32_t stage) {
  // a half chunk's 8 values first (columns 16 h .. 16 h + 15), then its
  // stores: each requant a chain of f64 operations, interleaved only if
  // no store stands between them; halves keep the 128 accumulators of a
  // 256-column tile and the epilogue's values within the registers
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[8];
    if constexpr (kMode == 1) {
      float swn[4];
      double bias[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // columns 8 (2 h + i / 2) + 2 t4 + i % 2
        const int n = n0 + 32 * cc + 8 * (2 * h + (i >> 1)) + 2 * t4 + (i & 1);
        swn[i] = col_sw<kTables>(p, tab, n);
        bias[i] = col_bias<kTables>(p, tab, n);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double s0 = __fmul_rn(sxr[0], swn[i]);
        const double s1 =
            kOneFrame ? s0 : (double)__fmul_rn(sxr[1], swn[i]);
        const int j = 4 * cc + 2 * h + (i >> 1), e = i & 1;
        v[4 * (i >> 1) + e] = __float_as_uint(
            requant<kExact>((int)acc[4 * j + e], s0, bias[i]));
        v[4 * (i >> 1) + 2 + e] = __float_as_uint(
            requant<kExact>((int)acc[4 * j + 2 + e], s1, bias[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (std::is_same<Acc, int>::value) {
          v[i] = (uint32_t)acc[16 * cc + 8 * h + i];
        } else {
          v[i] = __float_as_uint(acc[16 * cc + 8 * h + i]);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 8 * (2 * h + jj) + 2 * t4;   // the chunk's columns c, c + 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * warp + g + 8 * half;
        gv::sts64(stage + sw128(row, c >> 2) + 4 * (c & 3),
                  v[4 * jj + 2 * half], v[4 * jj + 2 * half + 1]);
      }
    }
  }
}

template <typename T, int BN, int kMode>
__device__ __forceinline__ void consume(const Conv& p, const Ring& ring,
                                        uint32_t epi, float* table, int cw,
                                        int lt) {
  using Acc = typename Elem<T>::Acc;
  constexpr int S = Smem<BN>::kStages;
  constexpr int R = BN / 2;             // accumulators a thread
  constexpr bool kShort = Elem<T>::kSize == 2;   // bf16: short chains
  const int lane = lt & 31, warp = lt >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles = p.m_tiles * p.n_tiles;
  const uint32_t stage = epi + cw * 64 * 128;   // this warpgroup's chunk
  const int bar_id = 2 + cw;
  const int pc = lt & 7;                // fallback stores: a thread's piece
  int it = 0;
  const int hw = p.ho * p.wo;
  const bool thread_writes = p.route != kTiled && p.route != kIm2col;
  // mode 1: sx, sw and bias into shared memory once a block (when they
  // fit; else each is read from global memory where it is used)
  const float* tab = nullptr;             // null: read global memory
  if (kMode == 1 && p.m / hw <= kTable && p.n <= kTable) {
    const int ct = lt + 128 * cw;
    for (int i = ct; i < p.m / hw; i += 256) table[i] = p.sx[i];
    for (int i = ct; i < p.n; i += 256) {
      table[kTable + i] = p.sw[i];
      reinterpret_cast<double*>(table + 2 * kTable)[i] = p.bias[i];
    }
    gv::bar_sync(4, 256);
    tab = table;
  }
  // stage 0's descriptors: A's k step s (bytes 32 s .. 32 s + 31 of the
  // stage's rows) lies in sub-tile 32 s / a_w (rows a_w bytes apart, this
  // warpgroup's 64 rows 64 a_w bytes in), at 32 s % a_w into its rows
  uint64_t da0[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int q = 32 * s / p.a_w;
    da0[s] = gv::sw_desc(ring.a + cw * 64 * p.a_w + q * kBM * p.a_w +
                             32 * s - q * p.a_w,
                         p.a_w);
  }
  const uint64_t db0 = gv::sw128_desc(ring.b);
  Clocks clk(lt == 0 && cw == 0);
  if (blockIdx.x < tiles) clk.count(kClockSlots);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = fdiv(t, p.by_n_tiles);
    const int m0 = mt * kBM + 64 * cw;
    const int n0 = (t - mt * p.n_tiles) * BN;
    clk.count(kClockSlots + 1);
    // the frame scales of this thread's two fragment rows
    float sxr[2] = {0.0f, 0.0f};
    if constexpr (kMode == 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + 16 * warp + g + 8 * half;
        if (m < p.m) {
          const int b = fdiv(m, p.by_hw);
          sxr[half] = tab ? tab[b] : __ldg(p.sx + b);
        }
      }
    }
    Acc acc[R];
    Acc part[kShort ? R : 1];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    for (int kt = 0; kt < p.stages_k; ++kt, ++it) {
      const int slot = it % S;
      clk.lap(kt == 0 ? 5 : 3);
      bar_wait(ring.full + 8 * slot, (it / S) & 1);
      clk.lap(2);
      // the producer's threads wrote this stage through the generic proxy
      if (thread_writes) gv::fence_proxy_async();
      // this stage's descriptors: stage 0's moved on by the slot (in the
      // descriptor's 16-byte units)
      uint64_t da[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) da[s] = da0[s] + (uint64_t)(slot * (kABytes >> 4));
      const uint64_t db = db0 + (uint64_t)(slot * (ring.b_bytes >> 4));
      // four k steps, a partial last stage too: A and B are zero past K
      // (ConvBN_0, K within one step: that step alone, a path of its own)
      gv::wgmma_fence();
      if (p.one_step) {                   // (then also one stage)
        gv::Wgmma<T, BN>::mma(acc, da[0], db, 0);
        gv::wgmma_commit();
        gv::wgmma_wait<0>();
        if (lane == 0) gv::mbar_arrive(ring.empty + 8 * slot);
      } else if constexpr (kShort) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          gv::Wgmma<T, BN>::mma(part, da[s], db + 2 * s, s != 0);
        }
        gv::wgmma_commit();
        gv::wgmma_wait<0>();
        gv::fence_acc(part);
        if (lane == 0) gv::mbar_arrive(ring.empty + 8 * slot);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          gv::Wgmma<T, BN>::mma(acc, da[s], db + 2 * s, (kt | s) != 0);
        }
        gv::wgmma_commit();
        if (kt > 0) {                     // the last stage's products done
          gv::wgmma_wait<1>();
          if (lane == 0) gv::mbar_arrive(ring.empty + 8 * ((it - 1) % S));
        }
      }
    }
    if (!kShort && !p.one_step) {
      gv::wgmma_wait<0>();
      if (lane == 0) gv::mbar_arrive(ring.empty + 8 * ((it - 1) % S));
    }
    gv::fence_acc(acc);
    clk.lap(3);

    // Epilogue, 32 columns at a time: the fragments (requantized in mode
    // 1) into the warpgroup's 64 x 32 chunk in shared memory, in the
    // 128-byte swizzle, then out by one TMA tensor store (the copy engine
    // clips rows past M and columns past N), or, where N % 4 != 0, by the
    // threads: four rows' 16-byte pieces each, element by element.
#pragma unroll
    for (int cc = 0; cc < BN / 32; ++cc) {
      if (n0 + 32 * cc < p.n) {
        if (p.tma_out && lt == 0) gv::bulk_wait_read();  // chunk read out
        gv::bar_sync(bar_id, 128);
        clk.lap(4);
        // every accumulator of the warp's chunk within 2^24 in magnitude?
        bool exact = true;
        if constexpr (kMode == 1) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            exact &= acc[16 * cc + i] >= -(1 << 24) &&
                     acc[16 * cc + i] <= (1 << 24);
          }
        }
        // the common case (exact, tables, one frame) on a path of its
        // own; the warp's lanes agree on each choice
        if (__all_sync(0xFFFFFFFFu, exact && sxr[0] == sxr[1]) && tab) {
          stage_chunk<Acc, kMode, true, true, true>(acc, cc, p, tab, sxr,
                                                    n0, warp, g, t4, stage);
        } else if (tab) {
          stage_chunk<Acc, kMode, false, true, false>(acc, cc, p, tab, sxr,
                                                      n0, warp, g, t4, stage);
        } else {
          stage_chunk<Acc, kMode, false, false, false>(
              acc, cc, p, tab, sxr, n0, warp, g, t4, stage);
        }
        if (p.tma_out) gv::fence_proxy_async();   // for the copy engine
        clk.lap(6);
        gv::bar_sync(bar_id, 128);
        if (p.tma_out) {
          if (lt == 0) {
            gv::tensor_store_2d(&p.omap, stage, n0 + 32 * cc, m0);
            gv::bulk_commit();
          }
        } else {
          const int n = n0 + 32 * cc + 4 * pc;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = (lt >> 3) + 16 * i;
            const int m = m0 + row;
            if (m >= p.m || n >= p.n) continue;
            const uint4 v = gv::lds128(stage + sw128(row, pc));
            uint32_t* o = static_cast<uint32_t*>(p.out) + (size_t)m * p.n + n;
            o[0] = v.x;
            if (n + 1 < p.n) o[1] = v.y;
            if (n + 2 < p.n) o[2] = v.z;
            if (n + 3 < p.n) o[3] = v.w;
          }
        }
      }
    }
    clk.lap(7);
  }
  if (p.tma_out && lt == 0) gv::bulk_wait();   // the last stores landed
  clk.flush();
}

template <typename T, int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    gv_int8_conv_kernel(const __grid_constant__ Conv p) {
  static_assert(kMode == 0 || Elem<T>::kSize == 1, "requant is s8 only");
  constexpr int S = Smem<BN>::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = gv::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  Ring ring;
  ring.a = base;
  ring.b_bytes = Smem<BN>::kBBytes;
  ring.b = base + S * kABytes;
  const uint32_t epi = ring.b + S * Smem<BN>::kBBytes;
  int4* rows = reinterpret_cast<int4*>(smem + (epi - base) + kEpiBytes);
  const uint32_t tab = epi + kEpiBytes + kRowBytes;   // sx, sw, bias
  float* table = reinterpret_cast<float*>(smem + (tab - base));
  ring.full = tab + kTableBytes;
  ring.empty = ring.full + 8 * S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const int arrivals =
        p.route == kTiled || p.route == kIm2col ? 1 : 1 + 128;
    for (int s = 0; s < S; ++s) {
      gv::mbar_init(ring.full + 8 * s, arrivals);
      gv::mbar_init(ring.empty + 8 * s, 8);   // a consumer warp each
    }
  }
  __syncthreads();
  if (tid < 128) {
    gv::setmaxnreg_dec<kProducerRegs>();
    produce<T, BN>(p, ring, rows, tid);
  } else {
    gv::setmaxnreg_inc<kConsumerRegs>();
    consume<T, BN, kMode>(p, ring, epi, table, tid / 128 - 1, tid & 127);
  }
}

template <typename T, int BN, int kMode>
cudaError_t launch(const Conv& p, int blocks, cudaStream_t stream) {
  constexpr int smem = Smem<BN>::kBytes;
  static bool ready = false;              // the attribute, once an instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        gv_int8_conv_kernel<T, BN, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  gv_int8_conv_kernel<T, BN, kMode><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t launch_bn(const Conv& p, int bn, int blocks,
                      cudaStream_t stream) {
  switch (bn) {
    case 256:     // s8 only: bf16's split sums need twice the registers
      if constexpr (Elem<T>::kSize == 1) {
        return launch<T, 256, kMode>(p, blocks, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    case 128:
      return launch<T, 128, kMode>(p, blocks, stream);
    case 64:
      return launch<T, 64, kMode>(p, blocks, stream);
    case 32:
      return launch<T, 32, kMode>(p, blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The ring's stages and the dynamic shared memory of the instance with N
// tile bn (0 for a width the kernel does not have); ops/cuda_int8.py
// mirrors both.
extern "C" int gv_int8_stages(int bn) {
  switch (bn) {
    case 256: return Smem<256>::kStages;
    case 128: return Smem<128>::kStages;
    case 64: return Smem<64>::kStages;
    case 32: return Smem<32>::kStages;
    default: return 0;
  }
}

#ifdef GV_INT8_CLOCKS
// The phase cycles added since the last call (g_int8_clocks), zeroed.
extern "C" int gv_int8_clocks(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_int8_clocks, sizeof(g_int8_clocks));
  if (err != cudaSuccess) return (int)err;
  unsigned long long zero[kClockSlots + 2] = {};
  return (int)cudaMemcpyToSymbol(g_int8_clocks, zero, sizeof(zero));
}
#endif

extern "C" int gv_int8_smem(int bn) {
  switch (bn) {
    case 256: return Smem<256>::kBytes;
    case 128: return Smem<128>::kBytes;
    case 64: return Smem<64>::kBytes;
    case 32: return Smem<32>::kBytes;
    default: return 0;
  }
}

// x (batch, h, w, c) and w (n, kp), both s8 (bf16 == 0) or both bf16; the
// conv's output (batch, ho, wo, n) into out: int32 accumulators (mode 0;
// f32 in bf16) or the requantized f32 (mode 1, s8: sx (batch,), sw and
// bias (n,)). bn: the tile's N (32, 64, 128, or in s8 256); route: how A
// is staged (0 tiled, 1 im2col, 2 gather, 3 runs, 4 bytes: the wrapper's
// int8_plan); blocks: the persistent grid. Returns a cudaError_t.
extern "C" int gv_int8_conv(const void* x, const void* w, int bf16, int mode,
                            int batch, int h, int w_in, int c, int ho, int wo,
                            int ksize, int stride, int pad_y, int pad_x,
                            int n, int kp, int bn, int route, int blocks,
                            const float* sx, const float* sw,
                            const float* bias, void* out,
                            cudaStream_t stream) {
  const int size = bf16 ? 2 : 1;
  const long long m = (long long)batch * ho * wo;
  const long long k = (long long)ksize * ksize * c;
  const bool x16 = ((uintptr_t)x & 15) == 0;
  if (batch < 0 || h < 1 || w_in < 1 || c < 1 || ksize < 1 || stride < 1 ||
      n < 0 || k > kp || (long long)kp * size % 16 != 0 ||
      ((uintptr_t)w & 15) != 0 || m > INT_MAX ||
      (long long)batch * h * w_in * c > INT_MAX || blocks < 1 ||
      (mode != 0 && (bf16 || !sx || !sw || !bias)) || mode < 0 || mode > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int pad_y_hi = (ho - 1) * stride + ksize - h - pad_y;
  const int pad_x_hi = (wo - 1) * stride + ksize - w_in - pad_x;
  bool ok;
  switch (route) {
    case kTiled:
      ok = ksize == 1 && stride == 1 && pad_y == 0 && pad_x == 0 &&
           c * size % 16 == 0 && x16;
      break;
    case kIm2col:   // a tap of 128 bytes or more, or (s8) of 32 or 64
      ok = (c * size % kBK == 0 || (!bf16 && (c == 32 || c == 64))) && x16 &&
           stride <= 8 && ksize <= 256 &&
           pad_y >= 0 && pad_x >= 0 && pad_y < 128 && pad_x < 128 &&
           pad_y_hi - (ksize - 1) >= -128 && pad_x_hi - (ksize - 1) >= -128 &&
           pad_y_hi < 128 && pad_x_hi < 128;
      break;
    case kGather:
      ok = c * size % 16 == 0 && x16;
      break;
    case kRuns:
      ok = !bf16 && c == 3 && ksize == 3;
      break;
    case kBytes:
      ok = !bf16;
      break;
    default:
      ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  Conv p = {};
  p.x = static_cast<const char*>(x);
  p.x_end = p.x + (long long)batch * h * w_in * c * size;
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
  p.stages_k = (int)((k * size + kBK - 1) / kBK);
  p.one_step = k * size <= 32;
  p.route = route;
  p.a_w = route == kIm2col && c * size < kBK ? c * size : kBK;
  p.m_tiles = (int)((m + kBM - 1) / kBM);
  p.n_tiles = (n + bn - 1) / bn;
  p.by_hw = fast_div((uint32_t)ho * wo);
  p.by_wo = fast_div((uint32_t)wo);
  p.by_n_tiles = fast_div((uint32_t)p.n_tiles);
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.out = out;
  if ((long long)p.m_tiles * p.n_tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const CUtensorMapDataType type =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint32_t box_k = kBK / size;
  int err;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)kp * size};
    const cuuint32_t box[2] = {box_k, (cuuint32_t)bn};
    if ((err = gv::frame_map(&p.bmap, type, 2, w, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))) {
      return err;
    }
  }
  p.tma_out = n % 4 == 0 && ((uintptr_t)out & 15) == 0;
  if (p.tma_out) {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {32, 64};
    if ((err = gv::frame_map(&p.omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                             out, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))) {
      return err;
    }
  }
  if (route == kTiled) {
    const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)m};
    const cuuint64_t strides[1] = {(cuuint64_t)c * size};
    const cuuint32_t box[2] = {box_k, (cuuint32_t)kBM};
    if ((err = gv::frame_map(&p.amap, type, 2, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B))) {
      return err;
    }
  } else if (route == kIm2col) {
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w_in,
                                (cuuint64_t)h, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)c * size,
                                   (cuuint64_t)w_in * c * size,
                                   (cuuint64_t)h * w_in * c * size};
    // the base pixels: from -pad to the last window's top-left corner
    const int lower[2] = {-pad_x, -pad_y};
    const int upper[2] = {pad_x_hi - (ksize - 1), pad_y_hi - (ksize - 1)};
    const CUtensorMapSwizzle swz =
        p.a_w == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
        : p.a_w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    if ((err = gv::im2col_map(&p.amap, type, x, dims, strides, lower, upper,
                              p.a_w / size, kBM, stride, swz))) {
      return err;
    }
  }
  if (bf16) return (int)launch_bn<gv::bf16, 0>(p, bn, blocks, stream);
  if (mode == 1) return (int)launch_bn<int8_t, 1>(p, bn, blocks, stream);
  return (int)launch_bn<int8_t, 0>(p, bn, blocks, stream);
}
