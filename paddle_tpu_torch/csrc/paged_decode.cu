// K4 — paged decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py _paged_decode_kernel
// (via paged_decode_attention_pallas). One query per sequence over its
// block-table row: q [B, H, D], pools [N, bs, Hkv, D], tables [B, MB]
// int32 (sentinel N on unused slots), lens [B] (including the new token,
// whose K/V is already in the pool); o [B, H, D]. A row with lens == 0
// writes 0 (the Pallas finalize's l = 0 case). With a sliding window only
// the last `window` positions are visible.
//
// What bounds it on this card: bytes. Every visible K/V element is read
// once and used for 2*G flops per head dim (G = H / Hkv query heads), far
// below the H100's ~295 flop/byte ridge, so the floor is the live pool
// bytes over device-memory rate.
//
// Design: one block per (kv head, sequence), 4 warps. The block reads its
// table row itself and walks only the live blocks below cdiv(lens, bs)
// (and above the window's lower edge); warps take pool blocks round-robin
// and each keeps its own online softmax, merged through shared memory at
// the end — the parallel replacement of the TPU's sequential kv-block grid
// axis. A lane owns D/32 contiguous head dims, so a warp reads one pool
// row (all D dims of one token of one kv head) as one contiguous segment,
// and all G query heads of the group are served from that single read:
// GQA never re-reads or repeats K/V.
//
// int8 pools (the reference's `quantized` mode): with k_scale/v_scale
// [N, bs, Hkv] fp32 the pools hold int8 codes and a lane loads its D/32
// codes of a row as one word (4 codes at D = 128, 2 at D = 64), converts
// them and multiplies by the row's (position, KV head) scale — the same
// fp32 products as the plain version's k.float() * scale. The bytes a
// visible position costs fall from 2*D*2 (bf16) to 2*(D + 4); the mask,
// window and four-warp merge are unchanged.
#include <type_traits>

#include "common.cuh"

using namespace ptt;

namespace {

constexpr int kDecWarps = 4;

// This lane's C head dims of one pool row as fp32: elements of a pool of
// q's type as they are; int8 codes (one C-byte load) times the row scale.
template <int C, typename KV>
__device__ __forceinline__ void load_row(const KV* __restrict__ p,
                                         const float* __restrict__ scale,
                                         float (&out)[C]) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const float sc = *scale;
    if constexpr (C == 4) {
      const char4 w = *reinterpret_cast<const char4*>(p);
      out[0] = static_cast<float>(w.x) * sc;
      out[1] = static_cast<float>(w.y) * sc;
      out[2] = static_cast<float>(w.z) * sc;
      out[3] = static_cast<float>(w.w) * sc;
    } else if constexpr (C == 2) {
      const char2 w = *reinterpret_cast<const char2*>(p);
      out[0] = static_cast<float>(w.x) * sc;
      out[1] = static_cast<float>(w.y) * sc;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = static_cast<float>(p[c]) * sc;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = to_f(p[c]);
  }
}

// KV: the pool's element type, T (no scales) or int8_t (ks/vs per row)
template <int D, int G, typename T, typename KV>
__global__ void __launch_bounds__(kDecWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                        const KV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, T* __restrict__ o,
                        int H, int Hkv, int N, int bs, int MB, float scale,
                        int window) {
  constexpr int C = D / 32;
  __shared__ float sm_m[kDecWarps][G];
  __shared__ float sm_l[kDecWarps][G];
  __shared__ float sm_acc[kDecWarps][G][D];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = max(lens[b], 0);
  const int lo = window > 0 ? max(0, L - window) : 0;

  float qr[G][C], m[G], l[G], acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + ((size_t)b * H + kvh * G + g) * D + lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qr[g][c] = to_f(qrow[c]);
      acc[g][c] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const int* trow = tables + (size_t)b * MB;
  const int nblk = min((L + bs - 1) / bs, MB);
  for (int bi = lo / bs + warp; bi < nblk; bi += kDecWarps) {
    const int blk = min(max(trow[bi], 0), N - 1);
    const int p0 = bi * bs, p1 = min(p0 + bs, L);
    for (int p = max(p0, lo); p < p1; ++p) {
      const size_t row = (size_t)(blk * bs + p - p0) * Hkv + kvh;
      const size_t base = row * D + lane * C;
      float kv[C], vv[C];
      load_row<C>(kp + base, ks + row, kv);
      load_row<C>(vp + base, vs + row, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) s = fmaf(qr[g][c], kv[c], s);
        s = warp_sum(s) * scale;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(s - m_new);
        l[g] = l[g] * corr + pr;
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(pr, vv[c], acc[g][c] * corr);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) sm_acc[warp][g][lane * C + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float ls = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (sm_m[w][g] == -INFINITY) continue;
        const float e = expf(sm_m[w][g] - mx);
        ls = fmaf(sm_l[w][g], e, ls);
        a = fmaf(sm_acc[w][g][d], e, a);
      }
    }
    o[((size_t)b * H + kvh * G + g) * D + d] =
        from_f<T>(ls > 0.f ? a / ls : 0.f);
  }
}

template <int D, int G, typename T, typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lens, void* o,
           int B, int H, int Hkv, int N, int bs, int MB, float scale,
           int window, void* stream) {
  dim3 grid(Hkv, B);
  paged_decode_kernel<D, G, T, KV><<<grid, kDecWarps * 32, 0,
                                     (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(o), H, Hkv, N, bs, MB,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T, typename KV>
int launch_g(int G, const void* q, const void* kp, const void* vp,
             const void* ks, const void* vs, const void* tables,
             const void* lens, void* o, int B, int H, int Hkv, int N, int bs,
             int MB, float scale, int window, void* stream) {
#define PTT_G(GG)                                                          \
  return launch<D, GG, T, KV>(q, kp, vp, ks, vs, tables, lens, o, B, H,   \
                              Hkv, N, bs, MB, scale, window, stream)
  switch (G) {
    case 1: PTT_G(1);
    case 2: PTT_G(2);
    case 4: PTT_G(4);
    case 8: PTT_G(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_G
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16; head_dim: 64 or 128;
// H / Hkv in {1, 2, 4, 8}; window <= 0 means no sliding window. k_scale /
// v_scale null: the pools hold q's type; non-null: the pools hold int8
// codes and these are their fp32 [N, bs, Hkv] scales.
extern "C" int paged_decode_fwd(int dtype, int head_dim, const void* q,
                                const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale,
                                const void* tables, const void* lens,
                                void* o, int B, int H, int Hkv, int N,
                                int bs, int MB, float scale, int window,
                                void* stream) {
  if (B <= 0) return 0;
  const int G = H / Hkv;
#define PTT_DEC(DIM, T)                                                    \
  return k_scale ? launch_g<DIM, T, int8_t>(G, q, k_pool, v_pool, k_scale, \
                                            v_scale, tables, lens, o, B,   \
                                            H, Hkv, N, bs, MB, scale,      \
                                            window, stream)                \
                 : launch_g<DIM, T, T>(G, q, k_pool, v_pool, k_scale,      \
                                       v_scale, tables, lens, o, B, H,     \
                                       Hkv, N, bs, MB, scale, window,      \
                                       stream)
  if (dtype == kF32 && head_dim == 64) PTT_DEC(64, float);
  if (dtype == kF32 && head_dim == 128) PTT_DEC(128, float);
  if (dtype == kBF16 && head_dim == 64) PTT_DEC(64, __nv_bfloat16);
  if (dtype == kBF16 && head_dim == 128) PTT_DEC(128, __nv_bfloat16);
#undef PTT_DEC
  return static_cast<int>(cudaErrorInvalidValue);
}
