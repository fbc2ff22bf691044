// K6a at the multi-LoRA call site — the two rank-r grouped products of
// the batched LoRA correction, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/grouped_matmul.py _fwd_kernel (K6a,
// out[r] = lhs[r] @ rhs[g(r)] over rows sorted by group) where
// paddle_tpu/models/paged.py _lora_delta calls it twice: t = x_sorted @
// A[g] (n = r, the rank) and d = t @ B[g] (k = r), together with the glue
// XLA fuses around them there (x cast to fp32, the row permutation, the
// null-adapter mask, the inverse permutation, the cast and the add into
// the projection's output).
//
// Notation: x [B, S, k] (bf16, f16 or fp32), y [B, S, n] (the projection's
// output, x's type), perm [B] int32, sizes [e] int32 token counts in
// sorted order, A [e, k, r] and B [e, r, n] fp32. Sorted row i (of m =
// B * S) is source row src(i) = (perm[i / S], i % S); it belongs to group
// g(i) by the prefix sums of sizes and is live when i < sum(sizes) (the
// rest is the null-adapter tail).
//
// lora_shrink: t[i] = float(x[src(i)]) @ A[g(i)], t fp32 [m, r], 0 for
//   rows that are not live. Bound on this card: bytes (2 r flops per x
//   element, 8 flop/byte at r = 16 in bf16 against the card's ~20 fp32
//   flop/byte), and at decode the launch floor. The general K6a kernels
//   give a block 128 or 256 output columns, so at n = r = 16 most lanes
//   idle and a handful of blocks walk all of k. Here a block owns kRows
//   rows of one group and one split of k (a static grid over row tiles x
//   splits x column chunks, its group found on the device from sizes), so
//   decode runs tens of blocks and every lane works: lane l of a warp
//   owns 8 consecutive k (one 16-byte load of bf16 x, read through perm
//   in x's own type and converted in registers) and 4 consecutive columns
//   of A, whose 8 x 4 values it holds in registers and applies to every
//   row of the tile. Each A element is read once a block, each x element
//   once a column chunk. Lanes sharing columns are summed by shuffles,
//   the block's warps through shared memory, in a fixed order, into one
//   fp32 partial per split (scratch from the wrapper); a second small
//   kernel sums the splits in order. No atomics: two launches give the
//   same bits, so a CUDA-graph replay equals the eager call. No tensor
//   cores: fp32 operands, memory-bound, and TF32 would round A.
//
// lora_expand_add: for every live i,
//   y[src(i)] = cast_y(float(y[src(i)]) + float(cast_x(t[i] @ B[g(i)])))
//   in place: d is an fp32 sum over r, rounded once to x's type (= y's),
//   added in fp32 and rounded once to y's type, as the unfused
//   d.to(x.dtype) and y + d round. Rows that are not live are left
//   untouched (the unfused path adds a masked 0, which turns a -0.0 into
//   +0.0; values compare equal). Bound: bytes, the y rows read and
//   written (n = 4096 or 12288) and each live group's B read once. A
//   block owns kExpandRows rows of one group and 128 * V columns; each
//   thread holds B[g]'s r x V values for its columns in registers
//   (16-byte loads), takes the tile's t rows from shared memory and
//   streams its y columns row by row, coalesced along n, kUnroll rows in
//   flight. This replaces the B product, the mask, the inverse gather,
//   the cast and the add: five launches a projection become one.
#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kShrinkWarps = 8;
constexpr int kShrinkRows = 16;  // rows of one group a shrink block owns
constexpr int kReduceThreads = 256;
constexpr int kExpandThreads = 128;
constexpr int kExpandRows = 64;  // rows of one group an expand block owns
constexpr int kUnroll = 4;       // y rows an expand thread keeps in flight

struct Tile {
  int g, row0, nrows;
};

// Row tile `slot` of the static bound ceil(m / rows) + e: the tiles of
// group 0 first, then group 1's, ...; nrows <= 0 past the live tiles.
__device__ __forceinline__ Tile find_tile(const int* __restrict__ sizes,
                                          int e, int m, int slot, int rows) {
  int start = 0;
  for (int g = 0; g < e; ++g) {
    const int sz = max(sizes[g], 0);
    const int tiles = (sz + rows - 1) / rows;
    if (slot < tiles) {
      const int row0 = start + slot * rows;
      return {g, row0, min(rows, min(start + sz, m) - row0)};
    }
    slot -= tiles;
    start += sz;
  }
  return {0, 0, 0};
}

// the offset of sorted row i's source row in a [B, S, width] tensor
__device__ __forceinline__ long long src_offset(const int* __restrict__ perm,
                                                int i, int s, int width) {
  return (static_cast<long long>(perm[i / s]) * s + i % s) * width;
}

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// 8 bf16 or f16 as fp32, through the pair type's own conversion (a bf16
// is the high half of the fp32 of the same value, an f16 is not)
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p,
                                      float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = pair_f<T>(&u, i);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// ------------------------------------------------------------- shrink
// Grid (ceil(m / kShrinkRows) + e, splits, ceil(r / (4 JQ))). JQ lanes of
// a warp share one k octet and own 4 columns each (r <= 4: 1, r <= 8: 2,
// else 4, a block then covering 16 columns); 32 / JQ octets a warp.
template <typename T, int JQ>
__global__ void __launch_bounds__(kShrinkWarps * 32)
    lora_shrink_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                       const float* __restrict__ a,
                       const int* __restrict__ sizes,
                       float* __restrict__ part, int m, int s, int k, int r,
                       int e, int ks) {
  constexpr int KG = 32 / JQ, CB = 4 * JQ, RB = kShrinkRows;
  constexpr int KP = kShrinkWarps * KG * 8;  // k rows of one pass
  __shared__ float red[kShrinkWarps][RB][CB];
  __shared__ long long xrow[RB];
  const Tile tile = find_tile(sizes, e, m, blockIdx.x, RB);
  if (tile.nrows <= 0) return;  // past the live tiles
  const int split = blockIdx.y, c0 = blockIdx.z * CB;
  const int kend = min(k, (split + 1) * ks);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jq = lane % JQ, kg = lane / JQ;
  const int col = c0 + 4 * jq;
  if (threadIdx.x < tile.nrows)
    xrow[threadIdx.x] = src_offset(perm, tile.row0 + threadIdx.x, s, k);
  __syncthreads();
  const float* ag = a + static_cast<size_t>(tile.g) * k * r + col;
  const bool vec = r % 4 == 0 && col < r;  // then col + 3 < r

  float acc[RB][4];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int kb = split * ks + (warp * KG + kg) * 8; kb < kend; kb += KP) {
    // A[g][kb .. kb + 8][col .. col + 4] in registers, for every row
    float w[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* ar = ag + static_cast<size_t>(kb + kk) * r;
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(ar);
        w[kk][0] = v.x, w[kk][1] = v.y, w[kk][2] = v.z, w[kk][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) w[kk][c] = col + c < r ? ar[c] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      if (i >= tile.nrows) break;  // block-uniform
      float xv[8];
      load8(x + xrow[i] + kb, xv);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[kk], w[kk][c], acc[i][c]);
    }
  }
  // the lanes of one column quad (lane % JQ), then the warps in order
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    if (i >= tile.nrows) break;  // block-uniform: the shuffles stay whole
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int o = JQ; o < 32; o <<= 1)
        acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], o);
    if (kg == 0)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][i][4 * jq + c] = acc[i][c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < tile.nrows * CB;
       idx += kShrinkWarps * 32) {
    const int i = idx / CB, cc = idx % CB;
    if (c0 + cc >= r) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kShrinkWarps; ++wi) sum += red[wi][i][cc];
    part[(static_cast<size_t>(split) * m + tile.row0 + i) * r + c0 + cc] =
        sum;
  }
}

// t[i] = sum of the splits' partials in order for live rows, 0 past them
// (a partial row that is not live was never written and is never read).
__global__ void __launch_bounds__(kReduceThreads)
    lora_shrink_reduce_kernel(const float* __restrict__ part,
                              const int* __restrict__ sizes,
                              float* __restrict__ t, int m, int r, int e,
                              int splits) {
  __shared__ int live_rows;
  if (threadIdx.x == 0) {
    int total = 0;
    for (int g = 0; g < e; ++g) total += max(sizes[g], 0);
    live_rows = min(total, m);
  }
  __syncthreads();
  const size_t mr = static_cast<size_t>(m) * r;
  const size_t live = static_cast<size_t>(live_rows) * r;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * kReduceThreads +
                    threadIdx.x;
       idx < mr; idx += static_cast<size_t>(gridDim.x) * kReduceThreads) {
    float sum = 0.f;
    if (idx < live)
      for (int sp = 0; sp < splits; ++sp) sum += part[sp * mr + idx];
    t[idx] = sum;
  }
}

template <typename T>
int launch_shrink(const void* x, const void* perm, const void* a,
                  const void* sizes, void* part, void* t, int m, int s,
                  int k, int r, int e, int splits, int ks,
                  cudaStream_t stream) {
  const int jq = r <= 4 ? 1 : r <= 8 ? 2 : 4;
  const int kp = kShrinkWarps * (32 / jq) * 8;
  // the wrapper's schedule: whole passes a split, every split non-empty
  if (ks <= 0 || ks % kp != 0 || splits <= 0 || splits > 65535 ||
      static_cast<long long>(splits) * ks < k ||
      static_cast<long long>(splits - 1) * ks >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kShrinkRows - 1) / kShrinkRows + e, splits,
                  (r + 4 * jq - 1) / (4 * jq));
#define PTT_SHRINK(JQ)                                                    \
  lora_shrink_kernel<T, JQ><<<grid, kShrinkWarps * 32, 0, stream>>>(      \
      static_cast<const T*>(x), static_cast<const int*>(perm),            \
      static_cast<const float*>(a), static_cast<const int*>(sizes),       \
      static_cast<float*>(part), m, s, k, r, e, ks)
  if (jq == 1)
    PTT_SHRINK(1);
  else if (jq == 2)
    PTT_SHRINK(2);
  else
    PTT_SHRINK(4);
#undef PTT_SHRINK
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mr = static_cast<long long>(m) * r;
  const long long blocks = (mr + kReduceThreads - 1) / kReduceThreads;
  lora_shrink_reduce_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks
                                                                  : 1024),
                              kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(sizes),
      static_cast<float*>(t), m, r, e, splits);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- expand
// V values of y's type at p as fp32, and back. bf16 or f16 (this
// template): one 8-byte (V = 4) or 4-byte (V = 2) access, unpacked through
// the pair type (pair_f) and packed by pack2; fp32: the specializations
template <typename T, int V>
struct YVec {
  static_assert(V == 2 || V == 4, "V = 2 or 4");
  static __device__ __forceinline__ void load(const T* p, float (&f)[V]) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 x = pair_f<T>(p, i);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ void store(T* p, const float (&f)[V]) {
    if constexpr (V == 4)
      *reinterpret_cast<uint2*>(p) = make_uint2(
          pack2<T>(f[0], f[1]), pack2<T>(f[2], f[3]));
    else
      *reinterpret_cast<unsigned*>(p) = pack2<T>(f[0], f[1]);
  }
};

template <>
struct YVec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct YVec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  }
};
template <int V>
__device__ __forceinline__ void load_b(const float* p, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Grid (ceil(n / (128 V)), ceil(m / kExpandRows) + e). RMAX >= r: the
// rank rows of B each thread keeps in registers.
template <typename TY, int RMAX, int V>
__global__ void __launch_bounds__(kExpandThreads)
    lora_expand_kernel(TY* __restrict__ y, const float* __restrict__ t,
                       const float* __restrict__ b,
                       const int* __restrict__ sizes,
                       const int* __restrict__ perm, int m, int s, int n,
                       int r, int e) {
  constexpr int RB = kExpandRows, BN = kExpandThreads * V;
  __shared__ float ts[RB][RMAX];
  __shared__ long long yrow[RB];
  const Tile tile = find_tile(sizes, e, m, blockIdx.y, RB);
  if (tile.nrows <= 0) return;  // past the live tiles
  // the tile's t rows are contiguous
  for (int idx = threadIdx.x; idx < tile.nrows * r; idx += kExpandThreads)
    ts[idx / r][idx % r] = t[static_cast<size_t>(tile.row0) * r + idx];
  if (threadIdx.x < tile.nrows)
    yrow[threadIdx.x] = src_offset(perm, tile.row0 + threadIdx.x, s, n);
  __syncthreads();
  const int col = blockIdx.x * BN + threadIdx.x * V;
  if (col >= n) return;  // then col + V <= n, as n % V == 0
  float w[RMAX][V];
  const float* bg = b + static_cast<size_t>(tile.g) * r * n + col;
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j < r) {
      load_b<V>(bg + static_cast<size_t>(j) * n, w[j]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) w[j][c] = 0.f;
    }
  }
  for (int i0 = 0; i0 < tile.nrows; i0 += kUnroll) {
    float yv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u < tile.nrows) YVec<TY, V>::load(y + yrow[i0 + u] + col, yv[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u >= tile.nrows) break;
      float d[V];
#pragma unroll
      for (int c = 0; c < V; ++c) d[c] = 0.f;
#pragma unroll
      for (int j = 0; j < RMAX; ++j) {
        if (j >= r) break;
        const float tv = ts[i0 + u][j];
#pragma unroll
        for (int c = 0; c < V; ++c) d[c] = fmaf(tv, w[j][c], d[c]);
      }
#pragma unroll
      for (int c = 0; c < V; ++c)
        yv[u][c] = yv[u][c] + round_to<TY>(d[c]);  // rounded on the store
      YVec<TY, V>::store(y + yrow[i0 + u] + col, yv[u]);
    }
  }
}

template <typename TY>
int launch_expand(void* y, const void* t, const void* b, const void* sizes,
                  const void* perm, int m, int s, int n, int r, int e,
                  cudaStream_t stream) {
  const int v = r <= 32 ? 4 : 2;
  if (r > 64 || n % v != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kExpandThreads * v - 1) / (kExpandThreads * v),
                  (m + kExpandRows - 1) / kExpandRows + e);
#define PTT_EXPAND(RMAX, V)                                               \
  lora_expand_kernel<TY, RMAX, V><<<grid, kExpandThreads, 0, stream>>>(   \
      static_cast<TY*>(y), static_cast<const float*>(t),                  \
      static_cast<const float*>(b), static_cast<const int*>(sizes),       \
      static_cast<const int*>(perm), m, s, n, r, e)
  if (r <= 16)
    PTT_EXPAND(16, 4);
  else if (r <= 32)
    PTT_EXPAND(32, 4);
  else
    PTT_EXPAND(64, 2);
#undef PTT_EXPAND
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x). x [B, S, k] contiguous, 16-byte
// aligned, k a multiple of 8; perm [B] and sizes [e] int32 on the device;
// a [e, k, r] fp32 (16-byte aligned); part fp32 [splits, m, r] scratch
// (m = B * S); t fp32 [m, r]. k is cut into `splits` runs of `ks` rows
// (the wrapper's lora_shrink_schedule: ks a whole number of the kernel's
// passes, every split non-empty). Two launches: the partials, then their
// sum in split order.
extern "C" int lora_shrink(int dtype, const void* x, const void* perm,
                           const void* a, const void* sizes, void* part,
                           void* t, int m, int s, int k, int r, int e,
                           int splits, int ks, void* stream) {
  if (m <= 0 || r <= 0 || e <= 0) return 0;
  if (s <= 0 || k % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_shrink<float>(x, perm, a, sizes, part, t, m, s, k, r, e,
                                splits, ks, st);
  return with_half(dtype, [&](auto h) {
    return launch_shrink<decltype(h)>(x, perm, a, sizes, part, t, m, s, k, r,
                                      e, splits, ks, st);
  });
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (y, and the x the
// correction is rounded to). y [B, S, n] contiguous, 16-byte aligned, n a multiple of
// 4 (of 2 for r > 32), updated in place on its live rows only; t fp32
// [m, r]; b [e, r, n] fp32 (16-byte aligned), r <= 64; sizes [e], perm
// [B] int32 on the device.
extern "C" int lora_expand_add(int dtype, void* y, const void* t,
                               const void* b, const void* sizes,
                               const void* perm, int m, int s, int n, int r,
                               int e, void* stream) {
  if (m <= 0 || n <= 0 || r <= 0 || e <= 0) return 0;
  if (s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_expand<float>(y, t, b, sizes, perm, m, s, n, r, e, st);
  return with_half(dtype, [&](auto h) {
    return launch_expand<decltype(h)>(y, t, b, sizes, perm, m, s, n, r, e,
                                      st);
  });
}
