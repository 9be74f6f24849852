// Warp-level building blocks shared by the convolution kernels of csrc/:
// a tile product on the tensor cores in 3xTF32 (error-compensated TF32),
// and 16-byte asynchronous copies from global to shared memory.
//
// 3xTF32. A tensor-core TF32 product keeps 10 mantissa bits of each
// operand, three decimal digits, which the f32 contracts of these kernels
// (1e-4, 1e-3) do not survive. Each f32 operand is therefore split into
//   hi = tf32(x),   lo = tf32(x - hi)          (x - hi is exact in f32)
// and a product a * b is accumulated in f32 as
//   a_lo * b_hi + a_hi * b_lo + a_hi * b_hi    (small terms first);
// the dropped a_lo * b_lo is ~2^-22 relative. Three
// mma.sync.m16n8k8.tf32 per tile; the weights (B) are split once on the
// host (ops/tf32x3.pack_b_fragments), the activations (A) in registers.
// The tensor core truncates its accumulator (round toward zero) at every
// mma, a bias that grows with the length of the chain and with the size of
// the running sum: chained through K = 432 it costs two decimal digits
// (1.5e-4 on sums of ~20, measured on an H100). So only a short chain runs
// on the tensor core, from a fresh zero accumulator (gv::mma_3xtf32_chain),
// and its partial sum is added to the running sum outside it, in f32 round
// to nearest (gv::add_chain): four FADD a tile and chain. A chain of one k
// step (3 mma) and one of a 32-channel weight chunk (12 mma) measure the
// same error against the f32 twins (1.2e-5 on the CSP stage), the longer
// one 10 % less time.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g)           b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
//
// Two permutations make the loads and stores wide; both are applied to B
// on the host, so the kernels only have to follow them:
// - k. Within a step of 8, the mma's k column t holds logical k = 2t and
//   column t + 4 holds logical k = 2t + 1. A thread's (a0, a2) are then two
//   neighbouring floats of row g and (a1, a3) of row g + 8: one 8-byte
//   shared-memory load each (gv::load_a).
// - n. Column c of n-tile nt holds output channel
//   16 * (nt / 2) + 4 * (c / 2) + 2 * (nt % 2) + c % 2, so a thread's c0, c1
//   of tile 2p and of tile 2p + 1 are the four consecutive channels
//   16p + 4t .. 16p + 4t + 3: one 16-byte store.
// A packed B is (K / 8, N / 8, 32 lanes, 4) floats, the four being
// {b0_hi, b1_hi, b0_lo, b1_lo}: one 16-byte shared-memory load per lane
// and n-tile.
//
// bf16 (the bf16 stem's resize passes and conv0). One
// mma.sync.m16n8k16.bf16 per tile and k step of 16: a bf16 product is exact
// and the tensor core sums in f32, so the whole K chain stays on the tensor
// core. Its fragments,
// each register two bf16 (the lower k in the low half):
//   A (16 x 16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)  a2 (g, 2t+8..2t+9)
//                a3 (g+8, 2t+8..2t+9)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g)   b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):  as m16n8k8.
// The k permutation: mma k columns (2t, 2t + 1) hold logical k 4t, 4t + 1
// and columns (2t + 8, 2t + 9) logical k 4t + 2, 4t + 3, so a thread's a0
// and a2 are four neighbouring bf16 of row g (one 8-byte load, and a1, a3
// of row g + 8), and its b0, b1 four neighbouring k of one channel. The n
// permutation is the one above. A packed bf16 B is (K / 16, N / 8, 32
// lanes, 4) bf16: one 8-byte load per lane and n-tile
// (ops/bf16mma.pack_b_fragments).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace gv {

// f32 -> TF32, round to nearest, ties away from zero (cvt.rna): the low 13
// mantissa bits of the result are zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// A thread's A fragment of one k step from row-major shared memory:
// row_g points at logical k = 2t of row g, row_g8 at the same k of row
// g + 8 (both 8-byte aligned). Split into hi and lo on the way.
__device__ __forceinline__ void load_a(const float* row_g,
                                       const float* row_g8,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float2 lo_rows = *reinterpret_cast<const float2*>(row_g);
  const float2 hi_rows = *reinterpret_cast<const float2*>(row_g8);
  tf32_split(lo_rows.x, ah[0], al[0]);
  tf32_split(hi_rows.x, ah[1], al[1]);
  tf32_split(lo_rows.y, ah[2], al[2]);
  tf32_split(hi_rows.y, ah[3], al[3]);
}

// d = a * b, one m16n8k8 TF32 mma on a zero accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += a * b, one m16n8k8 TF32 mma.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] (+)= a * b[n] in 3xTF32 for one k step and N n-tiles that share the
// A fragment, summed on the tensor core; b[n] = {b0_hi, b1_hi, b0_lo, b1_lo}
// of a packed B. With `first` d starts from zero. The three mma of a tile
// depend on each other, so the tiles take turns: N independent chains in
// flight hide the mma latency that one chain would wait out.
template <int N>
__device__ __forceinline__ void mma_3xtf32_chain(float (&d)[N][4], bool first,
                                                 const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4],
                                                 const float4 (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t b0 = __float_as_uint(b[n].x), b1 = __float_as_uint(b[n].y);
    if (first) {
      mma_tf32_first(d[n], al, b0, b1);
    } else {
      mma_tf32(d[n], al, b0, b1);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(d[n], ah, __float_as_uint(b[n].z), __float_as_uint(b[n].w));
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(d[n], ah, __float_as_uint(b[n].x), __float_as_uint(b[n].y));
  }
}

// c[n] += d[n]: a chain's partial sums into the running sums, in f32 round
// to nearest, outside the tensor core.
template <int N>
__device__ __forceinline__ void add_chain(float (&c)[N][4],
                                          const float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += d[n][e];
  }
}

// c[n] += a * b[n] in 3xTF32: a chain of one k step, added at once.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float4 (&b)[N]) {
  float d[N][4];
  mma_3xtf32_chain(d, true, ah, al, b);
  add_chain(c, d);
}

// ---- bf16 ------------------------------------------------------------

using bf16 = __nv_bfloat16;

// f32 -> the nearest bf16 value (ties to even), kept in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a * b, one m16n8k16 bf16 mma, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The tensor-core product of one operand type, for kernels templated on
// it: Op<float> is 3xTF32 (the f32 forms; the bf16 forms are cuda_*_bf16.cu).
// kK: k of one mma step; kPad:
// the padding (elements) of a staged pixel of C channels, C a multiple of
// 32, so that the 8-byte A loads of a half-warp from four consecutive
// pixels fall in 32 different banks (the pixels lie 8 or 24 words apart);
// kThreadK: the logical k of a thread's first A value in a step (times t);
// Frag: a lane's B fragment of one k step and n-tile; kSplitChains: the
// chains are summed outside the tensor core (3xTF32). step(): d[n] (+)=
// a * b[n] for the N n-tiles that share the A rows row_g, row_g8.
template <typename T>
struct Op;

template <>
struct Op<float> {
  static constexpr int kK = 8;
  static constexpr int kPad = 8;
  static constexpr int kThreadK = 2;
  static constexpr bool kSplitChains = true;
  using Frag = float4;
  template <int N>
  __device__ __forceinline__ static void step(float (&d)[N][4], bool first,
                                              const float* row_g,
                                              const float* row_g8,
                                              const Frag (&b)[N]) {
    uint32_t ah[4], al[4];
    load_a(row_g, row_g8, ah, al);
    mma_3xtf32_chain(d, first, ah, al, b);
  }
};

// Four neighbouring outputs to global memory: one 16-byte store in f32,
// one 8-byte store in bf16 (each rounded to nearest).
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(bf16* dst, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// 16 bytes global -> shared without passing through registers; with
// ok == false nothing is read and the 16 bytes are zero-filled (src must
// still be a valid address). dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace gv
