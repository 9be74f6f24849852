// The bias add and activation after each of YOLOv4's ConvBN convs, in place
// on cuDNN's output (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no YOLOv4. Added to remove two
// of the three passes each conv output took on the port's YOLOv4 path
// (models/yolov4.py): cuDNN wrote it, ATen's add_ of the (1, C, 1, 1) bias
// read and wrote it (a broadcast that ATen runs unvectorized over a
// channels-last tensor), and F.mish or F.leaky_relu read and wrote it again.
// The conv now runs without its bias, and this pass reads each output
// element once and writes it once.
//
// What it computes: bit for bit the chain it replaces (ATen's CUDA add_ and
// activation kernels). Each element y of channel c, in the storage type T
// (bf16 or f32):
//   s = T(float(y) + float(bias[c]))       add_: an f32 sum, rounded once
//   Mish:  T(s * tanhf(log1pf(expf(s))))    ATen's mish_kernel, in f32
//   leaky: T(s > 0 ? s : s * 0.1f)          ATen's leaky_relu_kernel
// The library is built without --use_fast_math (ops/cuda_build.py), so
// expf, log1pf and tanhf are the accurate functions that ATen calls.
//
// What bounds it on this card: bytes, 2 x the output at 3.35 TB/s (at 128
// frames of 416, 13.48 GB of YOLOv4's conv outputs a forward in bf16:
// 8.05 ms). Leaky is a few operations a byte. Mish computed in f32 is not:
// expf, log1pf and tanhf take some 60 instructions an element, more time
// at the card's instruction rate than the element's 4 bytes of bf16 take
// at its bandwidth: computed so, the pass ran at 61 % of its byte bound
// (13.09 ms a forward against 8.05).
//
// Design:
// - y is cuDNN's channels-last output, physically (B, H, W, C) and
//   contiguous, C a multiple of 8 (every YOLOv4 width is): a thread moves
//   16-byte vectors (8 bf16 or 4 f32 values), none of which straddles a
//   pixel's run of channels.
// - A grid-stride loop whose stride is a multiple of C / (values a vector)
//   vectors, so each thread stays on one slice of channels and loads its
//   bias slice into registers once; kUnroll vectors a thread in flight;
//   64-bit offsets (the largest output, 32 x 416 x 416 at 128 frames, is
//   709 M elements).
// - Mish in bf16 reads a table. A bf16 input has 65536 values; the table
//   holds Mish's bf16 result for each, by the input's bits. The wrapper
//   (ops/cuda_epilogue.py) builds it once a device with ATen's own F.mish
//   over every bf16 value, so it equals the pass it replaces by
//   construction. Each block (1024 threads, one an SM) copies it, 128 KB,
//   into shared memory and looks the rounded sum's bits up there: a
//   handful of instructions an element, so the pass is bound by its bytes
//   (9.71 ms a forward, 1.21x the bound). f32 Mish and leaky compute the
//   function as written (256 threads, four blocks an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMish = 0;
constexpr int kLeaky = 1;
constexpr int kMishTable = 2;        // bf16 Mish by the table
constexpr int kUnroll = 4;
constexpr int kTableBytes = 65536 * 2;

__host__ __device__ constexpr int threads_for(int act) {
  return act == kMishTable ? 1024 : 256;
}
__host__ __device__ constexpr int blocks_per_sm(int act) {
  return act == kMishTable ? 1 : 4;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mish(float x) {
  return x * tanhf(log1pf(expf(x)));
}

// One element: the bias added in f32 and rounded to T, as add_ stores it,
// then the activation.
template <typename T, int kAct>
__device__ __forceinline__ T epilogue(T y, float b,
                                      const uint16_t* __restrict__ lut) {
  const T s = from_f32<T>(__fadd_rn(to_f32(y), b));
  if constexpr (kAct == kMishTable) {
    return __ushort_as_bfloat16(lut[__bfloat16_as_ushort(s)]);
  } else {
    const float x = to_f32(s);
    return from_f32<T>(kAct == kMish ? mish(x) : (x > 0.f ? x : x * 0.1f));
  }
}

template <typename T, int kAct>
__global__ void __launch_bounds__(threads_for(kAct), blocks_per_sm(kAct))
    gv_conv_epilogue_kernel(uint4* __restrict__ y,
                            const T* __restrict__ bias,
                            const uint4* __restrict__ table, long long n_vec,
                            int c_vec, long long stride) {
  constexpr int kPer = 16 / sizeof(T);
  extern __shared__ uint4 lut4[];
  if constexpr (kAct == kMishTable) {
    for (int k = threadIdx.x; k < kTableBytes / 16; k += blockDim.x) {
      lut4[k] = table[k];
    }
    __syncthreads();
  }
  const uint16_t* lut = reinterpret_cast<const uint16_t*>(lut4);
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (first >= stride) return;
  const int j = (int)(first % c_vec);
  float b[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) b[e] = to_f32(bias[j * kPer + e]);
  for (long long v0 = first; v0 < n_vec; v0 += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) r[u] = y[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) {
        T* e = reinterpret_cast<T*>(&r[u]);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          e[k] = epilogue<T, kAct>(e[k], b[k], lut);
        }
        y[v] = r[u];
      }
    }
  }
}

// A few resident blocks an SM, fewer where the tensor is small; the stride
// the largest multiple of c_vec that the grid's threads hold (at least
// c_vec: the grid covers one pixel at the least).
template <typename T, int kAct>
int launch(void* y, const void* bias, const uint4* table, long long n_vec,
           int c_vec, int sms, cudaStream_t stream) {
  constexpr int kThreads = threads_for(kAct);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * blocks_per_sm(kAct)) {
    blocks = (long long)sms * blocks_per_sm(kAct);
  }
  const long long stride = blocks * kThreads / c_vec * c_vec;
  gv_conv_epilogue_kernel<T, kAct>
      <<<(unsigned)blocks, kThreads, kAct == kMishTable ? kTableBytes : 0,
         stream>>>((uint4*)y, (const T*)bias, table, n_vec, c_vec, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Allows the bf16 Mish instance its 128 KB of shared memory on the current
// device; once a device, before its first bf16 Mish launch there. Returns
// a cudaError_t.
extern "C" int gv_conv_epilogue_init() {
  return (int)cudaFuncSetAttribute(
      gv_conv_epilogue_kernel<__nv_bfloat16, kMishTable>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
}

// y: n_vec 16-byte vectors of a channels-last conv output (bf16 != 0:
// bf16, else f32), c_vec of them a pixel, 16-byte aligned; bias: its C
// values in y's type; table: for bf16 Mish, the 65536 bf16 results by
// input bits, 16-byte aligned (else unread). act 0: Mish, 1: leaky 0.1.
// sms: the card's SMs (the grid's size). In place, on stream. Returns a
// cudaError_t.
extern "C" int gv_conv_epilogue(void* y, const void* bias, const void* table,
                                int bf16, int act, long long n_vec,
                                int c_vec, int sms, cudaStream_t stream) {
  if (n_vec < 0 || c_vec < 1 || n_vec % c_vec != 0 || sms < 1 ||
      (act != kMish && act != kLeaky) || ((uintptr_t)y & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_vec == 0) return 0;
  if (!bf16) {
    return act == kMish ? launch<float, kMish>(y, bias, nullptr, n_vec,
                                               c_vec, sms, stream)
                        : launch<float, kLeaky>(y, bias, nullptr, n_vec,
                                                c_vec, sms, stream);
  }
  if (act == kLeaky) {
    return launch<__nv_bfloat16, kLeaky>(y, bias, nullptr, n_vec, c_vec, sms,
                                         stream);
  }
  if (table == nullptr || ((uintptr_t)table & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<__nv_bfloat16, kMishTable>(y, bias, (const uint4*)table,
                                           n_vec, c_vec, sms, stream);
}
