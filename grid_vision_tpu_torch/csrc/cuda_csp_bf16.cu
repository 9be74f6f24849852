// The detector's first CSP stage, bf16 form, for Hopper (sm_90a), in one
// launch: ConvBN_2 (3x3, 64->64) + CSPBlock_0 (3x3 32->32 on channels
// [32:64), 3x3 32->32, 1x1 64->64 on concat[x2, x1]) + the 2x2/s2 max pool
// of concat[y, x3], folded BN and leaky 0.1: (B, H, W, 64) bf16 -> (B, H/2,
// W/2, 128) bf16.
//
// Replaces the TPU kernels of grid_vision_tpu/ops/pallas_csp.py at
// compute_dtype=bf16: detector_csp_pallas -> _csp_kernel ("pallas2") and
// detector_csp_flat -> _csp_flat_kernel ("pallas3"), which keep a whole
// frame's stage in VMEM (1.38 MB of bf16 activation a frame; a block here
// has 227 KB). The f32 form stays in cuda_csp.cu.
//
// Arithmetic, rounded where the Pallas kernels round in bf16: bf16 weights
// without the BN scale, f32 sums of exact bf16 products over each conv's
// whole K on the tensor cores, BN as x * s + b in f32 (a multiply, then an
// add) and leaky 0.1, every conv's output (y, x1, x2, x3) rounded to bf16
// once, the pool on the bf16 values.
//
// Bound on this card: operations. At 64 frames of 104 x 104 the stage is
// 82.2 GFLOP (0.083 ms at 989 TFLOP/s) against 133 MB of compulsory traffic
// (x in, the pooled output out: 0.040 ms at 3.35 TB/s). The earlier form
// (four launches of mma.sync kernels) wrote y and concat[x2, x1] to device
// memory and read them back, ~576 MB a call (>= 0.17 ms of bytes alone).
// Here nothing but x, the weights and the output touches device memory:
//   - A block (two warpgroups, 256 threads, ~215 KB of shared memory, one
//     an SM) owns a strip: one frame x 52 input columns, walked top to
//     bottom, one pooled output row a step; few frames also split a
//     strip's rows into bands (Plan). Persistent: a block walks units
//     blockIdx.x, + gridDim.x, ...; the weights arrive once.
//   - The stage flows through rolling rings of rows in shared memory, each
//     row 64 positions (flat pitch 64: the strip's 52 columns, 4 to the
//     left, 8 to the right; a pixel 128 bytes at 64 channels). A 3x3 tap
//     is an address shift of dy rows and dx positions (the flat-pitch
//     trick of _csp_flat_kernel's _flat_tap_off). Junk spreads inward one
//     position a conv from the window's edges (positions 0 and 63) and
//     never reaches positions 4 .. 55, the strip's own columns.
//   - Step s (pooled row s): input rows 2s+1 .. 2s+4 are in the ring of 6
//     (rows come two at a time by a TMA tensor copy, 128-byte swizzle,
//     zero outside the frame: the input's SAME padding, two steps ahead,
//     on an mbarrier a slot); y rows 2s+2, 2s+3 (ConvBN_2, K = 576) into
//     the y ring of 4; x1 rows 2s+1, 2s+2 into the x1 ring of 4; x2 rows
//     2s, 2s+1, kept in registers as the A fragments of the 1x1 (the
//     paired row order of its B is the accumulator's channel order); x3 =
//     the 1x1 (K = 64: x2 from registers, x1 from the ring); the pool of y
//     (ring) and x3 (registers): a thread's fragment rows g, g + 8 are the
//     two rows, so the vertical max is a register max and the horizontal
//     one a shuffle with lane ^ 16. conv a and conv b (32 -> 32) take each
//     of the step's two newest input rows as A against all three of its
//     dy taps (K = 96, N = 96: row_taps): one wide product in place of
//     three narrow ones (m64n32k16 ran at ~57 % of the tensor rate, the
//     A bytes a third), the partial sums of the next rows carried in
//     registers. A band's first two steps are lead steps (y and conv a's
//     carry, then y, x1 and conv b's carry).
//   - y and x1 are stored as zero outside the frame (rows and columns):
//     the SAME padding of the next 3x3 conv; from zero input ConvBN_2
//     would give leaky(shift) there.
//   - Every product on wgmma (m64n64k16 / m64n96k16, a warpgroup's 64
//     rows = 32 positions x the step's two rows), B resident in shared
//     memory (all four convs' weights, 116 KB, one bulk copy a block,
//     packed by ops/bf16mma.pack_wgmma_b with each 32-channel block's rows
//     paired, cuda_csp.k_pair_order), A from the rings through registers
//     (one 16-byte load a row gives two k steps; the rings' swizzles and
//     the thread's positions keep a warp's loads at the minimum of
//     wavefronts), the next group's A loaded while a group runs.
// A build with -DGV_CSP_CLOCKS counts cycles by phase (gv_csp_bf16_clocks;
// tools/torch_kernel_times.py csp_bf16 --variant
// cuda_csp_bf16:GV_CSP_CLOCKS).

#include <cuda.h>

#include <cstring>

#include "gv_hopper.cuh"

namespace {

using gv::b_desc;
using gv::bf16;
using gv::bulk_copy;
using gv::fence_acc;
using gv::fence_proxy_async;
using gv::lds128;
using gv::mbar_expect_tx;
using gv::mbar_init;
using gv::mbar_wait;
using gv::smem_u32;
using gv::sts128;
using gv::wgmma_commit;
using gv::wgmma_fence;
using gv::wgmma_wait0;

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kPitch = 64;                    // positions a ring row
constexpr int kStripCols = 52;                // input columns a strip owns
constexpr int kStripPooled = kStripCols / 2;
constexpr int kLeft = 4;                      // position of its first column
constexpr int kLeadSteps = 2;                 // a band's lead steps
constexpr int kRowBytes = kPitch * 128;       // a 64-channel ring row
constexpr int kRow1Bytes = kPitch * 64;       // a 32-channel (x1) ring row
constexpr int kPairBytes = 2 * kRowBytes;     // one tensor copy: two rows
// Shared memory from a 1024-byte boundary (the 128-byte swizzle's period):
// the BN constants (s2 b2 sa ba sb bb sc bc) and the mbarriers, then the
// input ring (3 slots of two rows), the y ring, the x1 ring, the weights.
// The head's unused end is the guard that a tap left of position 0 of the
// input ring's first slot reads.
constexpr int kBnFloats = 64 + 64 + 4 * 32 + 64 + 64;
constexpr int kBarOff = kBnFloats * 4;        // 1536: weights, 3 input slots
constexpr int kInOff = 2048;
constexpr int kYOff = kInOff + 3 * kPairBytes;
constexpr int kX1Off = kYOff + 4 * kRowBytes;
constexpr int kW2Off = kX1Off + 4 * kRow1Bytes;
constexpr int kW2Bytes = 36 * 2048;           // (576, 64), 36 k steps
constexpr int kWaOff = kW2Off + kW2Bytes;
constexpr int kWabBytes = 6 * 3072;           // (96, 96), 6 k steps
constexpr int kWbOff = kWaOff + kWabBytes;
constexpr int kWcOff = kWbOff + kWabBytes;
constexpr int kWcBytes = 4 * 2048;            // (64, 64), 4 k steps
constexpr int kSmem = kWcOff + kWcBytes + 1024;   // + alignment slack
static_assert(kBarOff + 4 * 8 <= kInOff, "head fits");
static_assert(kSmem <= 232448, "one block fits an SM");

// A call's units: strips of a frame, bands of a strip (rows pooled rows
// each, the last fewer), units = frames x strips x bands. The bands are
// the count that minimises the rounds of units over the SMs times a
// unit's steps (rows + 2 lead steps + ~1 of start). units == 0: nothing to
// compute. ops/cuda_csp.csp_bf16_plan mirrors it.
struct Plan {
  int strips, bands, rows, units;
};

inline Plan make_plan(int batch, int h, int w, int sms) {
  Plan p{0, 0, 0, 0};
  const int ho = h / 2, wo = w / 2;
  if (batch <= 0 || ho <= 0 || wo <= 0 || sms <= 0) return p;
  const int strips = (wo + kStripPooled - 1) / kStripPooled;
  const int64_t per_band = (int64_t)batch * strips;
  int64_t best = -1;
  for (int b = 1; b <= ho; ++b) {
    const int rows = (ho + b - 1) / b;
    if ((ho + rows - 1) / rows != b) continue;  // the plan of a smaller b
    const int64_t units = per_band * b;
    const int64_t cost = (units + sms - 1) / sms * (rows + kLeadSteps + 1);
    if (units <= (1 << 30) && (best < 0 || cost < best)) {
      best = cost;
      p = Plan{strips, b, rows, (int)units};
    }
  }
  return p;
}

struct Args {
  int h, w, ho, wo;
  Plan plan;
  const bf16* w2;
  const bf16* wa;
  const bf16* wb;
  const bf16* wc;
  const float* bn[8];         // s2 b2 sa ba sb bb sc bc
  bf16* out;
};

// leaky 0.1: v for v > 0, else 0.1 v (the same values as a select).
__device__ __forceinline__ float leaky(float v) {
  return fmaxf(v, 0.1f * v);
}

// BN (a multiply, then an add) and leaky in f32.
__device__ __forceinline__ float bn_leaky(float v, float s, float b) {
  return leaky(__fadd_rn(__fmul_rn(v, s), b));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The byte of 16-byte piece `piece` (channels 8 piece ..) of pixel q in
// an x1 ring row: two pixels a 128-byte line, the line's eight 16-byte
// slots XOR-swizzled by 2 ((q >> 1) & 3), so that a quarter-warp's pieces
// (positions q, q + 4, four pieces each) fill eight distinct slots.
__device__ __forceinline__ int x1_off(int q, int piece) {
  return (q >> 1) * 128 +
         ((((q & 1) << 2) + piece) ^ (((q >> 1) & 3) << 1)) * 16;
}

// Eight f32 (four pairs) as bf16, one 16-byte piece.
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ uint32_t max2_bf16(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

__device__ __forceinline__ uint4 max4_bf16(uint4 a, uint4 b, uint4 c,
                                           uint4 d) {
  return make_uint4(max2_bf16(max2_bf16(a.x, b.x), max2_bf16(c.x, d.x)),
                    max2_bf16(max2_bf16(a.y, b.y), max2_bf16(c.y, d.y)),
                    max2_bf16(max2_bf16(a.z, b.z), max2_bf16(c.z, d.z)),
                    max2_bf16(max2_bf16(a.w, b.w), max2_bf16(c.w, d.w)));
}

// Eight BN constants (a channel's 8 neighbours from shared memory).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = lo.z;
  v[3] = lo.w;
  v[4] = hi.x;
  v[5] = hi.y;
  v[6] = hi.z;
  v[7] = hi.w;
}

// The thread's A fragments of k steps 2p, 2p + 1 from two 16-byte
// pieces, lo of its row g and hi of row g + 8: eight neighbouring channels
// 8t .. 8t + 7 of a 32-channel block. pack_wgmma_b's k order gives a
// thread logical k 4t .. 4t + 3 of a step (a0, a2 of row g; a1, a3 of row
// g + 8); the host orders B's rows (cuda_csp.k_pair_order) so that step 2p
// takes channels 8t .. 8t + 3 and step 2p + 1 channels 8t + 4 .. 8t + 7.
__device__ __forceinline__ void frag2(uint4 lo, uint4 hi, uint32_t (&a)[4],
                                      uint32_t (&b)[4]) {
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
  b[0] = lo.z;
  b[1] = hi.z;
  b[2] = lo.w;
  b[3] = hi.w;
}

// CSPBlock_0's 3x3 convs take each input row as A against all three of
// its dy taps (B = cuda_csp.row_taps_matrix, N = 96: dy blocks of 32
// output channels), the step's two input rows rho0 (fragment row g) and
// rho1 = rho0 + 1 (g + 8). Row rho feeds output rows rho + 1 (dy 0), rho
// (dy 1), rho - 1 (dy 2): with what the last step carried, output rows
// rho0 - 1 and rho0 are complete (out[0], out[1]; the thread's channels 8t
// .. 8t + 7), and rows rho0 + 1, rho0 + 2 are carried to the next step.
// d[4j + e]: row g + 8 (e >> 1), dy block j / 4, channel 8t + 2 (j % 4) +
// (e & 1).
__device__ __forceinline__ void row_taps(const float (&d)[48],
                                         float (&carry)[2][8],
                                         float (&out)[2][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int jj = i >> 1, e = i & 1;
    auto v = [&](int dy, int row) {
      return d[4 * (4 * dy + jj) + 2 * row + e];
    };
    out[0][i] = carry[0][i] + v(2, 0);
    out[1][i] = carry[1][i] + v(1, 0) + v(2, 1);
    carry[0][i] = v(0, 0) + v(1, 1);
    carry[1][i] = v(0, 1);
  }
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4],
                                    uint64_t desc, int scale_d) {
  static_assert(N == 64 || N == 96, "the kernel's widths");
  if constexpr (N == 96) {
    gv::wgmma_m64n96k16(d, a, desc, scale_d);
  } else {
    gv::wgmma_m64n64k16(d, a, desc, scale_d);
  }
}

// d = A (the warpgroup's 64 rows) x B over STEPS k steps, B (16 N bf16 a
// step, pack_wgmma_b's layout, rows in cuda_csp.k_pair_order) in shared
// memory at wb; load(p, a, b) gives the thread's A fragments of steps 2p
// and 2p + 1. G steps a commit group; the next group's A is loaded while a
// group runs (two register buffers).
template <int N, int STEPS, int G, class LoadA>
__device__ __forceinline__ void product(float (&d)[N / 2], uint32_t wb,
                                        LoadA load) {
  static_assert(STEPS % G == 0, "whole commit groups");
  constexpr int kStep = 32 * N;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
  static_assert(G % 2 == 0, "whole pairs of steps");
  uint32_t a[2][G][4];
#pragma unroll
  for (int i = 0; i < G; i += 2) load(i / 2, a[0][i], a[0][i + 1]);
#pragma unroll
  for (int grp = 0; grp < STEPS / G; ++grp) {
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = grp * G + i;
      mma<N>(d, a[grp & 1][i], b_desc(wb + k * kStep), k > 0);
    }
    wgmma_commit();
    if (grp + 1 < STEPS / G) {
      gv::wgmma_wait<1>();             // group grp - 1's A is free
#pragma unroll
      for (int i = 0; i < G; i += 2) {
        load(((grp + 1) * G + i) / 2, a[(grp + 1) & 1][i],
             a[(grp + 1) & 1][i + 1]);
      }
    }
  }
  wgmma_wait0();
  fence_acc(d);
}

#ifdef GV_CSP_CLOCKS
// Cycles by phase summed over the blocks (thread 0's view, barrier to
// barrier): unit start (its first copies, the weights), input wait, y
// products, y epilogue, barrier 1, x1 products, x1 epilogue, barrier 2, the
// pool of y and conv b (products and epilogue), the 1x1 products, the pool
// of x3 and its store; [11] steps, [12] units.
__device__ unsigned long long gv_csp_clocks[13];
#define GV_CLK(i)                                 \
  if (threadIdx.x == 0) {                         \
    const long long c_now = clock64();            \
    clk[i] += c_now - c_prev;                     \
    c_prev = c_now;                               \
  }
#else
#define GV_CLK(i)
#endif

// x: the (B, h, w, 64) bf16 frames as xmap, a 4-D tensor map (channels,
// columns, rows, frames), box (64, 64, 2, 1), 128-byte swizzle.
__global__ void __launch_bounds__(kThreads, 1)
gv_csp_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* bn = reinterpret_cast<const float*>(smem_raw + (base - raw));
  const uint32_t wbar = base + kBarOff;
  const uint32_t pbar = wbar + 8;             // input slot i: pbar + 8 i
  const uint32_t in_ring = base + kInOff;
  const uint32_t y_ring = base + kYOff;
  const uint32_t x1_ring = base + kX1Off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the thread's fragment rows g, g + 8: position P of the step's two rows.
  // A warp takes 8 positions, row g position 4 (g & 1) + 2 ((g >> 1) & 1) +
  // (g >> 2): a quarter-warp's 16-byte loads and stores (fragment rows g,
  // g ^ 1: positions 4 apart, 4 threads each) fall in eight distinct
  // 16-byte chunks of the swizzled rings. The pool's pair (positions 2m,
  // 2m + 1) is g, g ^ 4: lanes 16 apart.
  const int P = 32 * (tid >> 7) + 8 * ((tid >> 5) & 3) + 4 * (g & 1) +
                2 * ((g >> 1) & 1) + (g >> 2);
  const Plan pl = a.plan;

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < 3; ++i) mbar_init(pbar + 8 * i, 1);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(wbar, kW2Bytes + 2 * kWabBytes + kWcBytes + kBnFloats * 4);
    bulk_copy(base + kW2Off, a.w2, kW2Bytes, wbar);
    bulk_copy(base + kWaOff, a.wa, kWabBytes, wbar);
    bulk_copy(base + kWbOff, a.wb, kWabBytes, wbar);
    bulk_copy(base + kWcOff, a.wc, kWcBytes, wbar);
    const int n[8] = {64, 64, 32, 32, 32, 32, 64, 64};
    uint32_t off = base;
    for (int i = 0; i < 8; ++i) {
      bulk_copy(off, a.bn[i], 4 * n[i], wbar);
      off += 4 * n[i];
    }
  }
  const float* s2 = bn;
  const float* b2 = bn + 64;
  const float* sa = bn + 128;
  const float* ba = bn + 160;
  const float* sb = bn + 192;
  const float* bb = bn + 224;
  const float* sc = bn + 256;
  const float* bc = bn + 320;

  // Per-thread offsets (bytes from a ring row) of the thread's 16-byte A
  // pieces (channels 8t .. 8t + 7 of a 32-channel block) of tap column dx
  // = 0, 1, 2: position Q = P + dx - 1, the chunk XOR-swizzled.
  // 64-channel rings (input, y): chunk c of pixel Q at c ^ (Q & 7) (the
  // tensor copy's 128-byte swizzle); the input's blocks 0, 1, y's block 1
  // (channels [32:64), conv a's input). The x1 ring: x1_off.
  uint32_t off_in[3][2], off_y[3], off_x1[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int q = P + dx - 1;
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      off_in[dx][blk] = q * 128 + (((4 * blk + t) ^ (q & 7)) << 4);
    }
    off_y[dx] = off_in[dx][1];
    off_x1[dx] = x1_off(q, t);
  }
  // the thread's own pixel: a y / x1 store, the 1x1's x1 pieces
  const uint32_t own_y = P * 128;
  const uint32_t own_x1 = x1_off(P, t);
  const int hk = P & 1;            // the half of the pooled pixel it stores
  const int pe = P - hk;           // the pool pair's left position

#ifdef GV_CSP_CLOCKS
  long long clk[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long c_prev = clock64();
  long long n_steps = 0, n_units = 0;
#endif
  // the row-tap partial sums of conv a and conv b carried to the next step
  float carry_a[2][8], carry_b[2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    carry_a[0][i] = carry_a[1][i] = carry_b[0][i] = carry_b[1][i] = 0.0f;
  }
  int seq = 0;                     // tensor copies of earlier units
  bool weights_in = false;
  for (int u = blockIdx.x; u < pl.units; u += gridDim.x) {
    const int band = u % pl.bands;
    const int rest = u / pl.bands;
    const int strip = rest % pl.strips;
    const int frame = rest / pl.strips;
    const int s0 = band * pl.rows;
    const int s1 = min(s0 + pl.rows, a.ho);
    const int c0 = strip * kStripCols;
    const int steps = s1 - s0 + kLeadSteps;
    const int pairs = steps + 1;   // input rows 2 s0 - 3 .. 2 s1 + 2
    // input pair i (rows 2 s0 - 3 + 2i, + 1) into slot (seq + i) % 3
    auto issue = [&](int i) {
      const int slot = (seq + i) % 3;
      mbar_expect_tx(pbar + 8 * slot, kPairBytes);
      gv::tensor_copy_4d(in_ring + slot * kPairBytes, &xmap, 0, c0 - kLeft,
                         2 * s0 - 3 + 2 * i, frame, pbar + 8 * slot);
    };
    auto wait_pair = [&](int i) {
      mbar_wait(pbar + 8 * ((seq + i) % 3), ((seq + i) / 3) & 1);
    };
    __syncthreads();               // the last unit's ring reads are done
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) issue(i);
    }
    if (!weights_in) {
      mbar_wait(wbar, 0);
      weights_in = true;
    }
    const int col = c0 - kLeft + P;
    const bool col_in = P >= 1 && P <= kPitch - 2 && col >= 0 && col < a.w;
    GV_CLK(0)
#ifdef GV_CSP_CLOCKS
    n_units += 1;
    n_steps += steps;
#endif

    // ConvBN_2 of step st (s = s0 - 2 + st): y rows 2s + 2 (fragment row
    // g), 2s + 3 (g + 8) from input rows 2s + 1 .. 2s + 4 (pairs st, st + 1)
    auto conv_y = [&](int st) {
      const int s = s0 - kLeadSteps + st;
      if (st == 0) wait_pair(0);
      wait_pair(st + 1);
      GV_CLK(1)
      const uint32_t p0 = in_ring + ((seq + st) % 3) * kPairBytes;
      const uint32_t p1 = in_ring + ((seq + st + 1) % 3) * kPairBytes;
      const uint32_t rows[4] = {p0, p0 + kRowBytes, p1, p1 + kRowBytes};
      float d[32];
      product<64, 36, 4>(d, base + kW2Off,
                         [&](int p, uint32_t(&fa)[4], uint32_t(&fb)[4]) {
        const int tap = p >> 1, blk = p & 1;
        const int dy = tap / 3, dx = tap % 3;
        frag2(lds128(rows[dy] + off_in[dx][blk]),
              lds128(rows[dy + 1] + off_in[dx][blk]), fa, fb);
      });
      GV_CLK(2)
      const int r0 = 2 * s + 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sv[8], bv[8];
        load8(s2 + 32 * h + 8 * t, sv);
        load8(b2 + 32 * h + 8 * t, bv);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + hr;
          const bool in = col_in && r >= 0 && r < a.h;
          float v[8];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[2 * jj + e] = bn_leaky(d[4 * (4 * h + jj) + 2 * hr + e],
                                       sv[2 * jj + e], bv[2 * jj + e]);
            }
          }
          sts128(y_ring + (r & 3) * kRowBytes + own_y +
                     (((4 * h + t) ^ (P & 7)) << 4),
                 in ? pack8(v) : make_uint4(0, 0, 0, 0));
        }
      }
      fence_proxy_async();         // the input pair st is refilled next
      GV_CLK(3)
    };
    // CSP conv a of step st: y rows 2s + 2, 2s + 3, channels [32:64), as A
    // against all dy taps (row_taps): x1 rows 2s + 1, 2s + 2 complete. At
    // st = 0 it only fills the carry.
    auto conv_a = [&](int st) {
      const int s = s0 - kLeadSteps + st;
      const uint32_t y0 = y_ring + ((2 * s + 2) & 3) * kRowBytes;
      const uint32_t y1 = y_ring + ((2 * s + 3) & 3) * kRowBytes;
      float d[48];
      product<96, 6, 2>(d, base + kWaOff,
                        [&](int dx, uint32_t(&fa)[4], uint32_t(&fb)[4]) {
        frag2(lds128(y0 + off_y[dx]), lds128(y1 + off_y[dx]), fa, fb);
      });
      GV_CLK(5)
      float x[2][8];
      row_taps(d, carry_a, x);
      if (st == 0) return;
      float sv[8], bv[8];
      load8(sa + 8 * t, sv);
      load8(ba + 8 * t, bv);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 2 * s + 1 + hr;
        const bool in = col_in && r >= 0 && r < a.h;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = bn_leaky(x[hr][i], sv[i], bv[i]);
        sts128(x1_ring + (r & 3) * kRow1Bytes + own_x1,
               in ? pack8(v) : make_uint4(0, 0, 0, 0));
      }
      GV_CLK(6)
    };
    // The pool's pair of positions: the thread stores half hk of pooled
    // pixel pc of output row s (y channels 32 hk + 8t .. + 7, x3 channels
    // 64 + 32 hk + 8t .. + 7), if the strip owns it.
    const int pc = (c0 + pe - kLeft) >> 1;
    const bool owns = pe >= kLeft && pe < kLeft + kStripCols && pc < a.wo;
    auto out_at = [&](int s) {
      return a.out + (((int64_t)frame * a.ho + s) * a.wo + pc) * 128 +
             32 * hk + 8 * t;
    };
    // the pool of y rows 2s, 2s + 1 (step st): the y half of output row s
    auto pool_y = [&](int st) {
      const int s = s0 - kLeadSteps + st;
      if (owns) {
        const uint32_t ya = y_ring + ((2 * s) & 3) * kRowBytes;
        const uint32_t yb = y_ring + ((2 * s + 1) & 3) * kRowBytes;
        const int c = 4 * hk + t;
        const uint32_t o0 = pe * 128 + ((c ^ (pe & 7)) << 4);
        const uint32_t o1 = (pe + 1) * 128 + ((c ^ ((pe + 1) & 7)) << 4);
        *reinterpret_cast<uint4*>(out_at(s)) =
            max4_bf16(lds128(ya + o0), lds128(ya + o1), lds128(yb + o0),
                      lds128(yb + o1));
      }
    };
    // CSP conv b of step st: x1 rows 2s + 1, 2s + 2 as A against all dy
    // taps (row_taps): x2 rows 2s, 2s + 1 complete, into the 1x1's A
    // fragments (step ks takes channels 8t + 4ks .. + 3, k_pair_order); x3
    // = the 1x1 on concat[x2, x1]; its pool, the x3 half of output row s:
    // rows in registers, the pair's positions by lane ^ 16. At st = 1 it
    // only fills the carry.
    auto conv_b_x3 = [&](int st) {
      const int s = s0 - kLeadSteps + st;
      uint32_t ax2[2][4];
      {
        const uint32_t x0 = x1_ring + ((2 * s + 1) & 3) * kRow1Bytes;
        const uint32_t x1 = x1_ring + ((2 * s + 2) & 3) * kRow1Bytes;
        float d[48];
        product<96, 6, 2>(d, base + kWbOff,
                          [&](int dx, uint32_t(&fa)[4], uint32_t(&fb)[4]) {
          frag2(lds128(x0 + off_x1[dx]), lds128(x1 + off_x1[dx]), fa, fb);
        });
        float x[2][8];
        row_taps(d, carry_b, x);
        if (st < kLeadSteps) return;
        float sv[8], bv[8];
        load8(sb + 8 * t, sv);
        load8(bb + 8 * t, bv);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            x[hr][i] = bn_leaky(x[hr][i], sv[i], bv[i]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          ax2[ks][0] = pack_bf16(x[0][4 * ks], x[0][4 * ks + 1]);
          ax2[ks][1] = pack_bf16(x[1][4 * ks], x[1][4 * ks + 1]);
          ax2[ks][2] = pack_bf16(x[0][4 * ks + 2], x[0][4 * ks + 3]);
          ax2[ks][3] = pack_bf16(x[1][4 * ks + 2], x[1][4 * ks + 3]);
        }
      }
      GV_CLK(8)
      float d3[32];
      {
        const uint32_t r_a = x1_ring + ((2 * s) & 3) * kRow1Bytes;
        const uint32_t r_b = x1_ring + ((2 * s + 1) & 3) * kRow1Bytes;
        uint32_t ax1[2][4];
        frag2(lds128(r_a + own_x1), lds128(r_b + own_x1), ax1[0], ax1[1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) d3[i] = 0.0f;
        fence_acc(d3);
        wgmma_fence();
        const uint32_t wc = base + kWcOff;
        gv::wgmma_m64n64k16(d3, ax2[0], b_desc(wc), 0);
        gv::wgmma_m64n64k16(d3, ax2[1], b_desc(wc + 2048), 1);
        gv::wgmma_m64n64k16(d3, ax1[0], b_desc(wc + 4096), 1);
        gv::wgmma_m64n64k16(d3, ax1[1], b_desc(wc + 6144), 1);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(d3);
      }
      GV_CLK(9)
      float m[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sv[8], bv[8];
        load8(sc + 32 * h + 8 * t, sv);
        load8(bc + 32 * h + 8 * t, bv);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * (4 * h + jj) + e;
            m[h][2 * jj + e] =
                fmaxf(bn_leaky(d3[i], sv[2 * jj + e], bv[2 * jj + e]),
                      bn_leaky(d3[i + 2], sv[2 * jj + e], bv[2 * jj + e]));
          }
        }
      }
      // rounding is monotone: the max of the rounded values is the rounded
      // max
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float keep = hk ? m[1][i] : m[0][i];
        const float send = hk ? m[0][i] : m[1][i];
        o[i] = fmaxf(keep, __shfl_xor_sync(0xFFFFFFFFu, send, 16));
      }
      if (owns) *reinterpret_cast<uint4*>(out_at(s) + 64) = pack8(o);
      GV_CLK(10)
    };

    // The steps: barrier 1 after ConvBN_2 (conv a reads the other
    // warpgroup's boundary positions of y), barrier 2 after conv a (conv b
    // reads its x1); the pools and conv b's and the 1x1's rows are the
    // warpgroup's own. (Each phase has one call site, so that it is inlined
    // once.)
    for (int st = 0; st < steps; ++st) {
      conv_y(st);
      __syncthreads();               // barrier 1
      if (tid == 0 && st + 3 < pairs) issue(st + 3);
      GV_CLK(4)
      conv_a(st);
      __syncthreads();               // barrier 2
      GV_CLK(7)
      if (st >= kLeadSteps) pool_y(st);
      if (st >= 1) conv_b_x3(st);
    }
    seq += pairs;
  }
#ifdef GV_CSP_CLOCKS
  if (threadIdx.x == 0) {
    for (int i = 0; i < 11; ++i) {
      atomicAdd(gv_csp_clocks + i, (unsigned long long)clk[i]);
    }
    atomicAdd(gv_csp_clocks + 11, (unsigned long long)n_steps);
    atomicAdd(gv_csp_clocks + 12, (unsigned long long)n_units);
  }
#endif
}

constexpr int kMaxDevices = 64;

// The SMs of the current device, and the kernel's shared-memory attribute
// set on it, once a device (the tick is host-bound). Nonzero: a CUDA error.
int device_sms(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  if ((err = (int)cudaFuncSetAttribute(
           (const void*)gv_csp_bf16_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem))) {
    return err;
  }
  if ((err = (int)cudaDeviceGetAttribute(
           sms, cudaDevAttrMultiProcessorCount, dev))) {
    return err;
  }
  if (dev < kMaxDevices) cached[dev] = *sms;
  return 0;
}

}  // namespace

// x: (B, h, w, 64) bf16, 16-byte aligned; w2: ConvBN_2's (576, 64) matrix
// in (ty, tx, c) row order without the BN scale, its rows in
// cuda_csp.k_pair_order, packed by bf16mma.pack_wgmma_b; wa / wb:
// CSPBlock_0's two 3x3 convs' (288, 32), the same; wc: the 1x1's (64, 64)
// on concat[x2, x1], the same; s* / b*: each conv's BN scale and shift
// (f32); every constant 16-byte aligned. out: (B, h / 2,
// w / 2, 128) bf16. Nonzero: a CUDA error.
extern "C" int gv_detector_csp_bf16(
    const void* x, int batch, int h, int w, const void* w2, const float* s2,
    const float* b2, const void* wa, const float* sa, const float* ba,
    const void* wb, const float* sb, const float* bb, const void* wc,
    const float* sc, const float* bc, void* out, cudaStream_t stream) {
  if (batch < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = device_sms(&sms);
  if (err) return err;
  const Plan p = make_plan(batch, h, w, sms);
  if (p.units == 0) return 0;                  // an empty output
  CUtensorMap xmap;
  std::memset(&xmap, 0, sizeof(xmap));
  const cuuint64_t dims[4] = {64, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {128, (cuuint64_t)w * 128,
                                 (cuuint64_t)h * w * 128};
  const cuuint32_t box[4] = {64, kPitch, 2, 1};
  if ((err = gv::frame_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x,
                           dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B))) {
    return err;
  }
  Args args{h, w, h / 2, w / 2, p,
            static_cast<const bf16*>(w2), static_cast<const bf16*>(wa),
            static_cast<const bf16*>(wb), static_cast<const bf16*>(wc),
            {s2, b2, sa, ba, sb, bb, sc, bc}, static_cast<bf16*>(out)};
  const int grid = p.units < sms ? p.units : sms;
  gv_csp_bf16_kernel<<<grid, kThreads, kSmem, stream>>>(xmap, args);
  return (int)cudaGetLastError();
}

// The kernel's plan for (batch, h, w) on a card of `sms` SMs: {strips,
// bands, rows a band, units, dynamic shared memory, blocks resident an SM
// on the current device}.
extern "C" int gv_csp_bf16_plan(int batch, int h, int w, int sms,
                                int* plan) {
  const Plan p = make_plan(batch, h, w, sms);
  plan[0] = p.strips;
  plan[1] = p.bands;
  plan[2] = p.rows;
  plan[3] = p.units;
  plan[4] = kSmem;
  plan[5] = 0;
  int dev_sms = 0;
  const int err = device_sms(&dev_sms);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &plan[5], gv_csp_bf16_kernel, kThreads, kSmem);
}

#ifdef GV_CSP_CLOCKS
// Reads and clears the phase cycles (a measurement build only).
extern "C" int gv_csp_bf16_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, gv_csp_clocks, 13 * 8);
  if (err) return err;
  const unsigned long long zero[13] = {};
  return (int)cudaMemcpyToSymbol(gv_csp_clocks, zero, 13 * 8);
}
#endif
