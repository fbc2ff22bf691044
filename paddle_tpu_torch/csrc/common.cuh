// Helpers shared by the hand-written Hopper kernels of paddle_tpu_torch.
//
// Every source in this directory is compiled on its own by
// ops/cuda/_build.py into one shared library with a plain C interface
// (loaded with ctypes): pointers arrive as void*, the stream as void*,
// and every entry point returns cudaGetLastError() (0 = launched).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF16 = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The pair type of a 2-byte float (two elements in 32 bits) and its
// conversion to two fp32 values. A bf16 is the high half of the fp32 of
// the same value, an f16 is not: unpack through these, never by shifting.
template <typename E>
struct Pair2;
template <>
struct Pair2<__nv_bfloat16> {
  using T = __nv_bfloat162;
};
template <>
struct Pair2<__half> {
  using T = __half2;
};
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
__device__ __forceinline__ float2 to_f2(__half2 x) {
  return __half22float2(x);
}
// elements 2i and 2i + 1 of the 2-byte floats at p as fp32
template <typename E>
__device__ __forceinline__ float2 pair_f(const void* p, int i) {
  return to_f2(reinterpret_cast<const typename Pair2<E>::T*>(p)[i]);
}

// two fp32 values rounded to one pair of a 2-byte float E (lo in the low
// half), as 32 bits
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    static_assert(std::is_same<E, __nv_bfloat16>::value, "bf16 or f16");
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Calls f with a value-initialised element of the 2-byte type `dtype`
// names (kBF16 or kF16), so a dispatch instantiates both with one line:
//   with_half(dtype, [&](auto e) { return launch<decltype(e)>(...); })
// Any other code returns cudaErrorInvalidValue.
template <typename F>
__host__ int with_half(int dtype, F&& f) {
  if (dtype == kBF16) return f(__nv_bfloat16{});
  if (dtype == kF16) return f(__half{});
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt

// One translation unit per shared library, so this plain definition is
// safe: the wrappers turn a non-zero return code into a message.
extern "C" const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
