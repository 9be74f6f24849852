// Hopper (sm_90a) building blocks shared by the bf16 kernels of csrc/
// (cuda_stem_bf16.cu, cuda_orient_bf16.cu, cuda_csp_bf16.cu) and the int8
// conv (cuda_int8.cu): mbarriers, named barriers, setmaxnreg, bulk and
// tensor (TMA: tiled and im2col) copies by the copy engine and the host's
// tensor maps for them, the wgmma.m64n32k16 / m64n64k16 / m64n96k16 /
// m64n128k16 products with B in shared memory and A from registers (the
// int8 conv's products with both operands in shared memory are in
// gv_wgmma_ss.cuh), the 128-byte-swizzle descriptor, and the thread-block
// cluster's barrier and distributed shared memory.
//
// B of a wgmma comes from shared memory in the layout that
// ops/bf16mma.pack_wgmma_b writes: K-major, no swizzle, one k step of 16
// after another (32 N bytes each at N = 32, 64, 96;
// pack_wgmma_b_halves: 4096 at N = 128), 8 x 8 core matrices of 128
// contiguous bytes (8 accumulator
// columns x 8 k), the two k halves of a step 128 bytes apart (the
// descriptor's leading byte offset) and the channel groups of 8 256 apart
// (its stride byte offset). A's fragment is the
// mma.sync m16n8k16 one, with pack_b_fragments' k order: a thread's
// registers a0, a2 hold the four neighbouring logical k 4t .. 4t + 3 of
// row g, a1, a3 the same of row g + 8, so one 8-byte load gives each pair.

#pragma once

#include <cuda.h>

#include "gv_mma.cuh"

namespace gv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Shared-memory loads and stores by address (8 and 16 bytes, aligned).
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t x,
                                      uint32_t y) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(x),
               "r"(y)
               : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` (release: this thread's earlier writes to shared
// memory are seen by the thread whose wait completes the phase).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Named barrier `id` (1..15) over `count` threads (a multiple of 32).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The warpgroup's registers a thread, moved to or from the block's pool
// (every warp of the warpgroup executes it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Whether the phase of `bar` of this parity has completed (the hardware
// may suspend the thread a while first).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// 16 bytes global -> shared at `dst` (a shared address), zero-filled when
// !ok (src is then not read but must be a valid address); cached in L1.
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// An arrival on `bar` once this thread's earlier cp.async copies have
// landed (noinc: it counts as one of the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::
                   "r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the copy engine,
// completing on `bar`; dst and src 16-byte aligned.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst by the copy engine, completing on `bar`; elements
// outside the tensor (negative coordinates included) are written as zero.
__device__ __forceinline__ void tensor_copy_4d(uint32_t dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2, int c3,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The box of a 2-D tensor map at (c0 innermost, c1), as tensor_copy_4d.
__device__ __forceinline__ void tensor_copy_2d(uint32_t dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// An im2col copy of a 4-D (C, W, H, N) tensor map: the map's
// pixels-per-column pixels from base pixel (w, h, n) on, walked along W,
// then H, then N within the map's bounding box at its element strides,
// each pixel's channels c .. c + channels-per-pixel - 1 read at (w +
// off_w, h + off_h); zero outside the tensor. Completes on `bar`.
__device__ __forceinline__ void im2col_copy_4d(uint32_t dst,
                                               const CUtensorMap* map, int c,
                                               int w, int h, int n,
                                               uint16_t off_w, uint16_t off_h,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};" ::
          "r"(dst),
      "l"(map), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar), "h"(off_w),
      "h"(off_h)
      : "memory");
}

// The box at (c0, c1) of a 2-D tensor map from shared memory at src (in
// the map's swizzle) to global memory by the copy engine, in this
// thread's bulk group; rows and columns outside the tensor are not
// written. bulk_commit closes the group; bulk_wait_read waits until the
// committed stores have read their shared memory, bulk_wait until they
// are done.
__device__ __forceinline__ void tensor_store_2d(const CUtensorMap* map,
                                                uint32_t src, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, "
      "%2}], [%3];" ::"l"(map),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders this thread's earlier shared-memory accesses before later ones of
// the copy engine (a bulk copy into a buffer just read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The shared-memory descriptor of one k step of a B packed by
// bf16mma.pack_wgmma_b: the two k halves 128 bytes apart (leading byte
// offset), the eight channel groups 256 apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// The descriptor of a K-major operand tile in the 128-byte swizzle (what a
// tensor copy with CU_TENSOR_MAP_SWIZZLE_128B writes): rows of 128 bytes,
// 16-byte chunk j of row r at chunk j ^ (r % 8), groups of 8 rows 1024
// bytes apart (stride byte offset); the tile 1024-byte aligned. A k step
// of 32 bytes further into the rows is the descriptor plus 2.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for a K-major tile in the 32-, 64- or 128-byte swizzle (rows
// of w bytes, chunk j of row r at j ^ (r % 8) masked to the row, groups
// of 8 rows 8 w bytes apart; the tile 8 w-byte aligned).
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, int w) {
  const uint64_t layout = w == 128 ? 1 : w == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * w) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Wait until at most N of the warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= a * b, m64n32k16, bf16 operands, f32 sums (see m64n64k16): the
// thread's d[4j + e], j < 4, row g (e < 2) or g + 8, column 8j + 2t + (e &
// 1).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// d (+)= a * b, m64n64k16, bf16 operands, f32 sums: a the warp's A
// fragment of its 16 rows (the mma.sync m16n8k16 layout), b in shared
// memory. With scale_d == 0 d is overwritten. The thread's d[4j + e]:
// row g (e < 2) or g + 8, column 8j + 2t + (e & 1) of the warp's rows.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The same at m64n96k16: d[4j + e], j < 12, column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The same at m64n128k16: d[4j + e], j < 16, column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The output channel of accumulator column n (pack_wgmma_b's order): a
// thread's d[4j + e], j = 4h .. 4h + 3, e = 0, 1 of one row are the eight
// channels 32h + 8t .. 32h + 8t + 7, one 16-byte store.
__host__ __device__ constexpr int acc_channel(int j, int t, int e) {
  return 32 * (j / 4) + 8 * t + 2 * (j % 4) + e;
}

// Eight outputs to global memory as bf16, one 16-byte store.
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(dst) = u;
}

// ---- tensor maps (host) ----------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so that a
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A tiled tensor map of `rank` dimensions over the frames at `base`: dims
// innermost first, strides (bytes) of dims 1 .. rank - 1, box the tile a
// tensor copy brings; elements outside the tensor arrive as zero. Nonzero:
// a CUDA error.
inline int frame_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                     const void* base, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return (int)cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// An im2col tensor map over a (batch, h, w, c) NHWC tensor at `base` (dims
// innermost first {c, w, h, batch}, byte strides of w, h, batch): a copy
// brings `pixels` pixels of `channels` channels each; the bounding box of
// the base pixels runs from lower[i] to dim[i] - 1 + upper[i] (i = w, h),
// walked at `stride`. Nonzero: a CUDA error.
inline int im2col_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const int* lower,
                      const int* upper, int channels, int pixels, int stride,
                      CUtensorMapSwizzle swizzle) {
  static EncodeIm2col encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return (int)cudaErrorNotSupported;
    }
    encode = reinterpret_cast<EncodeIm2col>(fn);
  }
  const cuuint32_t steps[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, lower, upper,
      (cuuint32_t)channels, (cuuint32_t)pixels, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---- thread-block clusters ----------------------------------------------

// Every thread of every block of the cluster arrives (releasing its
// earlier writes to shared memory) / waits for all of them (acquiring
// theirs). Between an arrive and its wait a thread may go on working.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A float of block `rank`'s shared memory at the place `p` has in this
// block's (distributed shared memory).
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

}  // namespace gv
