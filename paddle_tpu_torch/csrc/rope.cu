// K7 — fused rotate-half rotary embedding for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/rope.py _rope_kernel (via fused_rope),
// the counterpart of paddle/phi/kernels/fusion/fused_rope. For every row
// n of x [N, H, D] and every head:
//   out = cat(x1 * cos - x2 * sin, x2 * cos + x1 * sin)
// with x1, x2 the two halves of the head, cos/sin [R, D/2] fp32 rows
// (row n reads row n % R: R = S for one table shared by the batch, R = N
// for per-row tables), computed in fp32 and cast once to x's type, as the
// Pallas kernel does. `neg` flips the sign of sin: the rotation's
// transpose, which is the backward of the same function.
//
// The forward is bit-identical to the plain PyTorch version: each product
// and each sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into an FMA), exactly as PyTorch's separate
// elementwise kernels round them.
//
// x may be a strided view (q or k split out of the fused QKV product): a
// row starts `stride` elements after the previous one and holds H heads of
// D contiguous elements, so the view is read in place, without a copy.
// The output is contiguous [N, H, D].
//
// What bounds it on this card: bytes. Six flops per pair of elements
// against 2 * sizeof(T) bytes read and written per element, far below the
// ~295 flop/byte ridge. Design: a flat grid of threads, one thread per VEC
// consecutive elements of one half-head (VEC = 16 bytes of x: 8 bf16 or 4
// fp32), so each thread makes one 16-byte load from each half of the head
// and two 16-byte stores, and the cos/sin row (L2-resident: read by every
// head of the row) in 16-byte pieces. Neighbouring threads take
// neighbouring pieces of one head, then the next head, then the next row,
// so a warp's loads fall on a few contiguous segments. A scalar version
// serves shapes and pointers that the vector loads cannot take.
//
// rope_kv_write — K7 folded with the decode tick's KV pool write (the
// reference's llama_decode_step_paged: _apply_rope_rows on q and k, then
// _scatter_kv). One launch per layer and tick, where the unfused tick
// runs four (K7 on q, K7 on k, an index_put_ of k and one of v into the
// pools): for each decode row b it reads the q, k and v views of the
// fused QKV product in place, writes q rotated (contiguous [B, Hq, D],
// as K4 takes it), and k rotated and v as it is into the layer's pools
// at flat pool position dest[b] (the pool's sink block for an inactive
// row). The rotation is K7's to the bit (the same separately rounded
// products and sums) and the pool writes are copies, so the tick's
// outputs are those of the unfused tick. Bound: bytes, and at the decode
// shape (8 rows, 48 heads of 128) the launch itself: ~200 KB moved.
// Design: one thread per 16-byte piece of a half-head (q, k) or of a
// head (v), flat over the rows, as rope_kernel.
#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kThreads = 256;

// N consecutive elements, aligned to their size, so that one load or store
// compiles to 16-byte vector accesses
template <typename U, int N>
struct alignas(sizeof(U) * N) Pack {
  U v[N];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ x, const float* __restrict__ cos,
                const float* __restrict__ sin, T* __restrict__ out,
                long long n, int h, int d, long long stride, long long r,
                int neg) {
  const int half = d / 2;
  const int nv = half / VEC;  // pieces per half-head
  const long long total = n * h * nv;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int j = static_cast<int>(t % nv);
    const long long rest = t / nv;
    const int head = static_cast<int>(rest % h);
    const long long row = rest / h;
    const T* xr = x + row * stride + (long long)head * d + j * VEC;
    T* orow = out + (row * h + head) * d + j * VEC;
    const long long tr = (row % r) * half + j * VEC;
    const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr);
    const Pack<T, VEC> b = *reinterpret_cast<const Pack<T, VEC>*>(xr + half);
    const Pack<float, VEC> c = *reinterpret_cast<const Pack<float, VEC>*>(
        cos + tr);
    const Pack<float, VEC> s = *reinterpret_cast<const Pack<float, VEC>*>(
        sin + tr);
    Pack<T, VEC> o1, o2;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float x1 = to_f(a.v[k]), x2 = to_f(b.v[k]);
      const float ck = c.v[k], sk = neg ? -s.v[k] : s.v[k];
      o1.v[k] = from_f<T>(__fsub_rn(__fmul_rn(x1, ck), __fmul_rn(x2, sk)));
      o2.v[k] = from_f<T>(__fadd_rn(__fmul_rn(x2, ck), __fmul_rn(x1, sk)));
    }
    *reinterpret_cast<Pack<T, VEC>*>(orow) = o1;
    *reinterpret_cast<Pack<T, VEC>*>(orow + half) = o2;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* cos, const void* sin, void* out,
           long long n, int h, int d, long long stride, long long r, int neg,
           void* stream) {
  const long long total = n * h * ((d / 2) / VEC);
  // enough blocks to fill the card several times over; the grid-stride
  // loop takes the rest
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  rope_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(out), n, h, d, stride,
      r, neg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int vec, const void* x, const void* cos, const void* sin,
             void* out, long long n, int h, int d, long long stride,
             long long r, int neg, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  return vec > 1 ? launch<T, kVec>(x, cos, sin, out, n, h, d, stride, r, neg,
                                   stream)
                 : launch<T, 1>(x, cos, sin, out, n, h, d, stride, r, neg,
                                stream);
}

// Work of one decode row: (hq + hkv) rotated heads of nv pieces of each
// half, then hkv heads of v copied in 2 nv pieces.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rope_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, long long sq, long long sk,
                   long long sv, const float* __restrict__ cos,
                   const float* __restrict__ sin, T* __restrict__ q_out,
                   T* __restrict__ k_pool, T* __restrict__ v_pool,
                   const int64_t* __restrict__ dest, int b, int hq, int hkv,
                   int d, long long r) {
  const int half = d / 2;
  const int nv = half / VEC;
  const int rot = (hq + hkv) * nv, per_row = rot + 2 * hkv * nv;
  const long long total = (long long)b * per_row;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int row = static_cast<int>(t / per_row);
    const int i = static_cast<int>(t % per_row);
    if (i < rot) {
      const int head = i / nv, j = i % nv;
      const bool is_q = head < hq;
      const T* xr = is_q ? q + row * sq + (long long)head * d
                         : k + row * sk + (long long)(head - hq) * d;
      T* orow = is_q ? q_out + ((long long)row * hq + head) * d
                     : k_pool + (dest[row] * hkv + (head - hq)) * d;
      xr += j * VEC;
      orow += j * VEC;
      const long long tr = (row % r) * half + j * VEC;
      const Pack<T, VEC> a = *reinterpret_cast<const Pack<T, VEC>*>(xr);
      const Pack<T, VEC> bb =
          *reinterpret_cast<const Pack<T, VEC>*>(xr + half);
      const Pack<float, VEC> c =
          *reinterpret_cast<const Pack<float, VEC>*>(cos + tr);
      const Pack<float, VEC> s =
          *reinterpret_cast<const Pack<float, VEC>*>(sin + tr);
      Pack<T, VEC> o1, o2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float x1 = to_f(a.v[e]), x2 = to_f(bb.v[e]);
        o1.v[e] = from_f<T>(
            __fsub_rn(__fmul_rn(x1, c.v[e]), __fmul_rn(x2, s.v[e])));
        o2.v[e] = from_f<T>(
            __fadd_rn(__fmul_rn(x2, c.v[e]), __fmul_rn(x1, s.v[e])));
      }
      *reinterpret_cast<Pack<T, VEC>*>(orow) = o1;
      *reinterpret_cast<Pack<T, VEC>*>(orow + half) = o2;
    } else {
      const int c = i - rot, head = c / (2 * nv), j = c % (2 * nv);
      *reinterpret_cast<Pack<T, VEC>*>(
          v_pool + (dest[row] * hkv + head) * d + j * VEC) =
          *reinterpret_cast<const Pack<T, VEC>*>(v + row * sv +
                                                 (long long)head * d +
                                                 j * VEC);
    }
  }
}

template <typename T, int VEC>
int launch_kv(const void* q, const void* k, const void* v, long long sq,
              long long sk, long long sv, const void* cos, const void* sin,
              void* q_out, void* k_pool, void* v_pool, const void* dest,
              int b, int hq, int hkv, int d, long long r, void* stream) {
  const int nv = (d / 2) / VEC;
  const long long total = (long long)b * (hq + 3 * hkv) * nv;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  rope_kv_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sq, sk, sv, static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<T*>(q_out),
      static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const int64_t*>(dest), b, hq, hkv, d, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of x and out; cos/sin
// are float32).
// x: n rows of h heads of d elements, row i at x + i * stride (elements);
// cos/sin: [r, d / 2] contiguous, row i of x reads row i % r; out: [n, h,
// d] contiguous. vec: 1 (scalar) or 16-byte vectors (the wrapper passes 1
// unless d / 2 is a multiple of 16 / sizeof(x element) and the pointers
// and the row stride keep every piece 16-byte aligned). neg: 1 rotates by
// -sin (the backward).
extern "C" int rope_fwd(int dtype, int vec, const void* x, const void* cos,
                        const void* sin, void* out, long long n, int h, int d,
                        long long stride, long long r, int neg,
                        void* stream) {
  if (n <= 0 || h <= 0 || d <= 0) return 0;
  if (d % 2 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return dispatch<float>(vec, x, cos, sin, out, n, h, d, stride, r, neg,
                           stream);
  return with_half(dtype, [&](auto e) {
    return dispatch<decltype(e)>(vec, x, cos, sin, out, n, h, d, stride, r,
                                 neg, stream);
  });
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (of q, k, v, q_out and the pools;
// cos/sin are float32). q, k, v: b rows of hq / hkv / hkv heads of d
// elements, row i at q + i * sq (k: sk, v: sv; elements), heads d apart;
// cos/sin [r, d / 2] contiguous, row i reading row i % r; q_out [b, hq, d]
// contiguous; k_pool and v_pool contiguous [*, hkv, d] rows (the layer's
// pool viewed flat), dest [b] int64 the pool row of each decode row.
// vec: 1 (scalar) or 16-byte vectors (the wrapper passes 1 unless d / 2
// is a multiple of 16 / sizeof(element) and every pointer and row stride
// keeps each piece 16-byte aligned).
extern "C" int rope_kv_write(int dtype, int vec, const void* q,
                             const void* k, const void* v, long long sq,
                             long long sk, long long sv, const void* cos,
                             const void* sin, void* q_out, void* k_pool,
                             void* v_pool, const void* dest, int b, int hq,
                             int hkv, int d, long long r, void* stream) {
  if (b <= 0 || d <= 0) return 0;
  if (d % 2 || r <= 0 || hq <= 0 || hkv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_ROPE_KV(T)                                                      \
  return vec > 1 ? launch_kv<T, 16 / sizeof(T)>(q, k, v, sq, sk, sv, cos,  \
                                                sin, q_out, k_pool, v_pool, \
                                                dest, b, hq, hkv, d, r,     \
                                                stream)                     \
                 : launch_kv<T, 1>(q, k, v, sq, sk, sv, cos, sin, q_out,    \
                                   k_pool, v_pool, dest, b, hq, hkv, d, r,  \
                                   stream)
  if (dtype == kF32) PTT_ROPE_KV(float);
  return with_half(dtype, [&](auto e) { PTT_ROPE_KV(decltype(e)); });
#undef PTT_ROPE_KV
}
