// K1 — fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/norms.py _rms_fwd_kernel (via _rms_fwd).
// Computes y = x * rsqrt(mean(x^2) + eps) * w per row with fp32 math and
// ONE cast at the end (the Pallas rounding: the weight is read in its own
// type, fp32, bf16 or f16, and multiplies in fp32, so an fp32 weight under
// a bf16 or f16 activation, a mixed-type call, is never rounded to x's
// type). x and y are fp32, bf16 or f16; the sum of squares is fp32.
//
// Bound on this card: bytes. A row is read, reduced and written with a
// handful of flops per element, far below the ~295 flop/byte ridge of an
// H100, so the kernel can at best stream x in and y out at device-memory
// rate. Design: one block per row (rows are independent, so a prefill of
// 8x128 rows gives 1024 blocks over 132 SMs); 16-byte vector loads and
// stores when the row and pointers allow it; an fp32 sum of squares
// reduced by warp shuffles; the second pass re-reads the row, which is
// then L1/L2-resident (8 KiB at H=4096 bf16), so device memory sees one
// read of x, one read of w per block (L2-resident too) and one write of y.
// On an H100 it reads within a few percent of a plain copy of the same
// bytes at the train steps' shapes (PERF.md, K1 rows), so a warp per row,
// measured there, gained nothing and is not built.
#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kMaxThreads = 256;

// VEC consecutive elements, aligned to their size, so that one load
// compiles to 16-byte vector loads
template <typename TW, int VEC>
struct alignas(sizeof(TW) * VEC) Pack {
  TW v[VEC];
};

template <typename T, typename TW, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                    T* __restrict__ y, int h, float eps) {
  __shared__ float red[kMaxThreads / 32];
  __shared__ float inv_s;
  const size_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* yr = y + row * h;
  const int nv = h / VEC;
  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if constexpr (VEC == 1) {
      const float f = to_f(xr[i]);
      ss = fmaf(f, f, ss);
    } else {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) / 32;
    float t = lane < nw ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_s = rsqrtf(t / static_cast<float>(h) + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if constexpr (VEC == 1) {
      yr[i] = from_f<T>(to_f(xr[i]) * inv * to_f(w[i]));
    } else {
      const uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
      // VEC weights in one or two 16-byte loads (the weight is L2-resident)
      const Pack<TW, VEC> pw = reinterpret_cast<const Pack<TW, VEC>*>(w)[i];
      const TW* ew = pw.v;
      uint4 out;
      T* eo = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        eo[k] = from_f<T>(to_f(e[k]) * inv * to_f(ew[k]));
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  }
}

template <typename T, typename TW, int VEC>
int launch(const void* x, const void* w, void* y, int rows, int h, float eps,
           void* stream) {
  const int nv = h / VEC;
  int threads = ((nv + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  rms_norm_kernel<T, TW, VEC><<<rows, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<T*>(y),
      h, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_w(int wdtype, int vec, const void* x, const void* w, void* y,
               int rows, int h, float eps, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (wdtype == kF32)
    return vec > 1 ? launch<T, float, kVec>(x, w, y, rows, h, eps, stream)
                   : launch<T, float, 1>(x, w, y, rows, h, eps, stream);
  return with_half(wdtype, [&](auto e) {
    using TW = decltype(e);
    return vec > 1 ? launch<T, TW, kVec>(x, w, y, rows, h, eps, stream)
                   : launch<T, TW, 1>(x, w, y, rows, h, eps, stream);
  });
}

}  // namespace

// dtype / wdtype (of x and of the weight): 0 = float32, 1 = bfloat16,
// 2 = float16.
// vec: 1 (scalar) or 16-byte vectors of x and y (the wrapper passes 1
// unless h and the pointers allow it: x and y 16-byte aligned, the weight
// aligned to 16 / sizeof(x element) of its own elements).
extern "C" int rms_norm_fwd(int dtype, int wdtype, int vec, const void* x,
                            const void* w, void* y, int rows, int h,
                            float eps, void* stream) {
  if (rows <= 0) return 0;
  if (dtype == kF32)
    return dispatch_w<float>(wdtype, vec, x, w, y, rows, h, eps, stream);
  return with_half(dtype, [&](auto e) {
    return dispatch_w<decltype(e)>(wdtype, vec, x, w, y, rows, h, eps,
                                   stream);
  });
}
