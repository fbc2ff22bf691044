// K3 — ragged multi-query (chunk) attention over a paged KV pool, Hopper.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py _paged_chunk_kernel
// (via paged_chunk_attention_pallas). Row a of the batch holds
// chunk_lens[a] queries at positions offsets[a] .. offsets[a]+chunk_lens-1
// and attends causally over pool positions [0, offsets[a]+chunk_lens[a])
// read straight from the block pool through its table row (the gathered
// K/V is never materialised). Dead rows (chunk_lens == 0) and padding
// query rows write 0. q [A, C, H, D]; pools [N, bs, Hkv, D]; tables
// [A, MB] int32 with the sentinel N on unused slots (clamped, never read
// past the row's live length); o like q.
//
// What bounds it on this card: as for K2 (flash_fwd.cu) this first version
// runs the scores and P@V as fp32 FMAs on the CUDA cores, so it is bound
// by CUDA-core issue, not by the pool bytes it reads.
//
// Design: the H/Hkv query heads of one KV head fold into the query tile
// (folded row t = query t / G, head kvh*G + t % G — the reference's GQA
// fold), so every K/V element a block loads serves all G heads. One block
// per (64 folded rows, kv head, batch row); the block walks the row's
// table only up to the causal frontier of its last live query and from
// the window's lower edge of its first, loading each key's pool row by
// (table[pos / bs], pos % bs) with neighbouring threads on neighbouring
// head dims.
//
// int8 pools (the reference's `quantized` mode): with k_scale/v_scale
// [N, bs, Hkv] fp32 the pools hold int8 codes, and the K/V tile fill
// dequantizes each element on load (code times its row's (position, KV
// head) scale, the plain version's k.float() * scale) into the same fp32
// tiles, so the shared tile code (attn_tile.cuh) is untouched.
#include <type_traits>

#include "attn_tile.cuh"

using namespace ptt;

namespace {

// One pool element as fp32: as it is for a pool of q's type, an int8
// code times the scale of its pool row.
template <typename KV>
__device__ __forceinline__ float pool_at(const KV* __restrict__ p,
                                         const float* __restrict__ scale,
                                         size_t i, size_t row) {
  if constexpr (std::is_same<KV, int8_t>::value)
    return static_cast<float>(p[i]) * scale[row];
  else
    return to_f(p[i]);
}

// KV: the pool's element type, T (no scales) or int8_t (ks/vs per row)
template <int D, typename T, typename KV>
__global__ void __launch_bounds__(kWarps * 32)
    paged_chunk_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                       const KV* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ offsets,
                       const int* __restrict__ chunk_lens, T* __restrict__ o,
                       int C, int H, int Hkv, int N, int bs, int MB,
                       float scale, int window) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * D;
  float* v_s = k_s + kBK * (D + 1);
  const int t0 = blockIdx.x * kBQ, kvh = blockIdx.y, a = blockIdx.z;
  const int G = H / Hkv;
  const int off = offsets[a];
  const int nrows = max(chunk_lens[a], 0) * G;  // live folded rows

  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, t = t0 + r;
    float val = 0.f;
    if (t < nrows)
      val = to_f(q[((size_t)(a * C + t / G) * H + kvh * G + t % G) * D + d]);
    q_s[i] = val;
  }
  int kend = 0, kbeg = 0;
  if (t0 < nrows) {
    kend = off + (min(t0 + kBQ, nrows) - 1) / G + 1;  // causal frontier
    if (window > 0) kbeg = max(0, off + t0 / G - window + 1);
  }
  const int* trow = tables + (size_t)a * MB;

  RowState<D> st;
  st.init();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();  // q tile stored / previous K,V tile consumed
    for (int i = threadIdx.x; i < nk * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, pos = k0 + j;
      const int blk = min(max(trow[min(pos / bs, MB - 1)], 0), N - 1);
      const size_t row = (size_t)(blk * bs + pos % bs) * Hkv + kvh;
      const size_t src = row * D + d;
      k_s[j * (D + 1) + d] = pool_at(kp, ks, src, row);
      v_s[j * D + d] = pool_at(vp, vs, src, row);
    }
    __syncthreads();
    tile_update<D>(q_s, k_s, v_s, nk, scale, st, [&](int row, int j) {
      const int t = t0 + row;
      if (t >= nrows) return false;
      const int qp = off + t / G, kpos = k0 + j;
      return kpos <= qp && (window <= 0 || qp - kpos < window);
    });
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + warp * kRows + r;
    if (t >= C * G) continue;
    const float l = st.l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + ((size_t)(a * C + t / G) * H + kvh * G + t % G) * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      orow[lane + 32 * c] = from_f<T>(st.acc[r][c] * inv);
  }
}

template <int D, typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* offsets,
           const void* chunk_lens, void* o, int A, int C, int H, int Hkv,
           int N, int bs, int MB, float scale, int window, void* stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      paged_chunk_kernel<D, T, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = H / Hkv;
  dim3 grid((C * G + kBQ - 1) / kBQ, Hkv, A);
  paged_chunk_kernel<D, T, KV><<<grid, kWarps * 32, smem,
                                 (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(offsets), static_cast<const int*>(chunk_lens),
      static_cast<T*>(o), C, H, Hkv, N, bs, MB, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16; head_dim: 64 or 128;
// window <= 0 means no sliding window. k_scale / v_scale null: the pools
// hold q's type; non-null: the pools hold int8 codes and these are their
// fp32 [N, bs, Hkv] scales.
extern "C" int paged_chunk_fwd(int dtype, int head_dim, const void* q,
                               const void* k_pool, const void* v_pool,
                               const void* k_scale, const void* v_scale,
                               const void* tables, const void* offsets,
                               const void* chunk_lens, void* o, int A, int C,
                               int H, int Hkv, int N, int bs, int MB,
                               float scale, int window, void* stream) {
  if (A <= 0 || C <= 0) return 0;
#define PTT_CHUNK(DIM, T)                                                  \
  return k_scale                                                           \
      ? launch<DIM, T, int8_t>(q, k_pool, v_pool, k_scale, v_scale,       \
                               tables, offsets, chunk_lens, o, A, C, H,    \
                               Hkv, N, bs, MB, scale, window, stream)      \
      : launch<DIM, T, T>(q, k_pool, v_pool, k_scale, v_scale, tables,    \
                          offsets, chunk_lens, o, A, C, H, Hkv, N, bs, MB, \
                          scale, window, stream)
  if (dtype == kF32 && head_dim == 64) PTT_CHUNK(64, float);
  if (dtype == kF32 && head_dim == 128) PTT_CHUNK(128, float);
  if (dtype == kBF16 && head_dim == 64) PTT_CHUNK(64, __nv_bfloat16);
  if (dtype == kBF16 && head_dim == 128) PTT_CHUNK(128, __nv_bfloat16);
#undef PTT_CHUNK
  return static_cast<int>(cudaErrorInvalidValue);
}
