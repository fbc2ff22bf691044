// K5 — flash-attention backward for Hopper (sm_90a): dq (K5a) and dk/dv
// (K5b), the flash-2 recomputation from the forward's saved O and LSE.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py _dq_kernel (K5a) and
// _dkv_kernel (K5b), both driven by _flash_bwd. Layouts are the JAX ones:
// q/dout/dq [B, S, H, D], k/v/dk/dv [B, Sk, Hkv, D], lse and delta
// [B, H, S] fp32. The LSE is K2's: natural log of the scaled scores, 0 for
// a row with no live key. delta = sum(dO * O, -1) comes from the wrapper.
//
// Per (query i, key j) entry that the forward's mask keeps:
//   P = exp(scale * q.k - lse_i),  dP = dO_i . v_j,
//   dS = P * (dP - delta_i) * scale,
//   dq_i += dS k_j,  dk_j += dS q_i,  dv_j += P dO_i.
// Masked entries give P = 0 exactly (the same causal / kv_lens / window
// rule as K2, with queries end-aligned to the key axis).
//
// ALiBi (the reference's _alibi_add, called from _dq_kernel and
// _dkv_kernel): with a slopes pointer ([B * H] fp32, by query head) every
// kernel runs a second instantiation (template flag kAlibi) that
// recomputes P with K2's bias, P = exp(scale * q.k + bias - lse), since
// K2's LSE includes it; without it the gradients would be silently wrong.
// K5b's slope changes with the query head inside the GQA group sum. The
// bias costs no memory traffic (it comes from the indices); without
// slopes the first instantiation runs, the code of the mode without ALiBi.
//
// Head dim 80 (Phi-2): every route keeps the head at a padded width with
// zeros past column 80, as K2 does (flash_fwd.cu): 128 on the tensor cores
// (S and dP run D / 16 = 5 k steps, the products with D as their n dim
// n 128, whose zero columns are never stored), 96 on the FMA routes.
//
// What bounds it on this card: at the training shapes (S = 2048, D = 128)
// the work is ~S flops per byte, far above the H100's ridge, so the bound
// is the tensor-core rate.
//
// Design (blocks run in parallel, so each output is owned by one block and
// written once; no atomics, so the result is deterministic, as on the TPU):
//   dq  — one block per (64-row q tile, head, batch row), a loop over the
//         live key tiles [kbeg, kend) of K2. Two routes, by dtype
//         (ops/cuda/flash_attention.py kernel_route):
//     bf16 and f16 — flash_bwd_dq_wgmma_kernel<E>, K5b's design
//         transposed (E the 2-byte type of the inputs and dq): one
//         warpgroup, Q and dO loaded once into swizzled shared tiles, the
//         rows' lse and delta in registers. Per streamed 64-key tile:
//         S = Q K^T and dP = dO V^T (wgmma m64n64k16, all four operands
//         K-major in shared memory), P = exp(S scale - lse) and
//         dS = P (dP - delta) scale on the fp32 fragments (K2's masks, only
//         on a tile that crosses an edge), then dq += dS K (m64nDk16, dS
//         rounded to E as the reference rounds it to q's type, a
//         register A operand; K read transposed from the same shared
//         tile). dq stays in fp32 registers (D / 2 a thread) and is
//         written once. The next K/V tile streams in with cp.async (two
//         stages, zero-filled past kend) while the current one computes.
//         Under causal the last q tile, the one with the most keys, is the
//         grid's first. Three products of 2 * 64 * 64 * D flops a tile:
//         the bound is the tensor-core rate; what holds it below is the
//         serial wait on each product (one warpgroup, no second one to
//         overlap the softmax part with).
//     fp32 — flash_bwd_dq_kernel: lane = key in a 32-key tile, a warp owns
//         8 query rows, dq accumulates in registers; fp32 FMAs (exact to
//         the card tests' 1e-4).
//   dkv — one block per (64-row k tile, KV head, batch row), a loop over
//         the G query heads of the group and, for each, over the q tiles
//         that reach the k tile (causal: from the tile's diagonal on;
//         window: up to the last key + window). The GQA sum over the group
//         happens inside the block: no per-q-head partial buffer. Two
//         routes, by dtype (ops/cuda/flash_attention.py kernel_route):
//     bf16 and f16 — flash_bwd_dkv_wgmma_kernel<E>, one warpgroup on the
//         tensor cores. Per streamed 64-row q tile: S^T = K Q^T and dP^T = V dO^T
//         (wgmma m64n64k16, all four operands K-major in shared memory),
//         P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale on
//         the fp32 fragments, then dV += P^T dO and dK += dS^T Q (m64nDk16,
//         P^T and dS^T rounded to E as register A operands, dO and Q
//         read transposed from the same shared tiles). dK and dV stay in
//         fp32 registers for the whole block. The next Q/dO tile (with its
//         rows' lse and delta) streams in with cp.async (two stages,
//         128-byte-swizzled) while the current one computes. k tile 0,
//         the one with the most live queries under causal, is the grid's
//         slowest axis, so the heaviest blocks of every head start first.
//     fp32 — flash_bwd_dkv_kernel: lane = query in a 32-row q tile, a warp
//         owns 8 key rows, fp32 FMAs (exact to the card tests' 1e-4).
#include "attn_tile.cuh"
#include "hopper_mma.cuh"

using namespace ptt;

namespace {

// fp32 words of dynamic shared memory, the same for both kernels: two
// 64-row tiles kept for the whole block and two 32-row tiles that stream
// (row stride D + 1, so the lanes of a warp reading rows hit distinct
// banks), plus the streamed rows' lse and delta
template <int D>
constexpr int bwd_smem_floats() {
  return 2 * kBQ * D + 2 * kBK * (D + 1) + 2 * kBK;
}

// The valid key length of batch row b and the position offset of its
// queries: the forward's rule (flash_fwd.cu, the reference's _q_offset)
__device__ __forceinline__ int row_geometry(const int* kv_lens, int b, int S,
                                            int Sk, int* klen) {
  int len = Sk;
  if (kv_lens != nullptr) len = min(max(kv_lens[b], 0), Sk);
  int q_off = Sk - S;
  if (kv_lens != nullptr && q_off > 0) q_off += len - Sk;
  *klen = len;
  return q_off;
}

__device__ __forceinline__ bool keep(int qp, int kp, int klen, int causal,
                                     int window) {
  return kp < klen && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

template <int D, typename T, bool kAlibi>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_lens,
                        const float* __restrict__ slopes, T* __restrict__ dq,
                        int S, int Sk, int H, int Hkv, float scale,
                        int causal, int window) {
  constexpr int DP = fma_cols<D>();   // the width kept: 96 at D = 80
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;       // [kBQ][DP]
  float* k_s = do_s + kBQ * DP;       // [kBK][DP + 1]
  float* v_s = k_s + kBK * (DP + 1);  // [kBK][DP + 1]
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  int klen;
  const int q_off = row_geometry(kv_lens, b, S, Sk, &klen);
  const float slope = kAlibi ? slopes[(size_t)b * H + h] : 0.f;

  for (int i = threadIdx.x; i < kBQ * DP; i += blockDim.x) {
    const int r = i / DP, d = i - r * DP, qi = q0 + r;
    const size_t off = ((size_t)(b * S + qi) * H + h) * D + d;
    const bool in = qi < S && d < D;
    q_s[i] = in ? to_f(q[off]) : 0.f;
    do_s[i] = in ? to_f(dout[off]) : 0.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lse_r[kRows], dl_r[kRows], acc[kRows][DP / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    const size_t row = ((size_t)b * H + h) * S + qi;
    lse_r[r] = qi < S ? lse[row] : 0.f;
    dl_r[r] = qi < S ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) acc[r][c] = 0.f;
  }
  const int last = min(q0 + kBQ, S) - 1;
  int kend = klen;
  if (causal) kend = min(kend, q_off + last + 1);
  const int kbeg = window > 0 ? max(0, q_off + q0 - window + 1) : 0;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();  // q/dO tiles stored / previous K,V tile consumed
    for (int i = threadIdx.x; i < nk * DP; i += blockDim.x) {
      const int j = i / DP, d = i - j * DP;
      const size_t src = ((size_t)(b * Sk + k0 + j) * Hkv + kvh) * D + d;
      k_s[j * (DP + 1) + d] = d < D ? to_f(k[src]) : 0.f;
      v_s[j * (DP + 1) + d] = d < D ? to_f(v[src]) : 0.f;
    }
    __syncthreads();
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    if (lane < nk) {
      const float* kr = k_s + lane * (DP + 1);
      const float* vr = v_s + lane * (DP + 1);
      const float* qw = q_s + warp * kRows * DP;
      const float* dw = do_s + warp * kRows * DP;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r] = fmaf(qw[r * DP + d], kd, s[r]);
          dp[r] = fmaf(dw[r * DP + d], vd, dp[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const bool ok = lane < nk && qi < S &&
                      keep(q_off + qi, k0 + lane, klen, causal, window);
      float sv = s[r] * scale;
      if constexpr (kAlibi)
        sv += alibi_bias(slope, q_off + qi, k0 + lane, causal);
      const float p = ok ? expf(sv - lse_r[r]) : 0.f;
      const float ds = p * (dp[r] - dl_r[r]) * scale;
      for (int j = 0; j < nk; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
        const float* kr = k_s + j * (DP + 1) + lane;
#pragma unroll
        for (int c = 0; c < DP / 32; ++c)
          acc[r][c] = fmaf(dsj, kr[32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= S) continue;
    T* row = dq + ((size_t)(b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c)
      if (lane + 32 * c < D) row[lane + 32 * c] = from_f<T>(acc[r][c]);
  }
}

template <int D, typename T, bool kAlibi>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_lens,
                         const float* __restrict__ slopes, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Sk, int H, int Hkv,
                         float scale, int causal, int window) {
  constexpr int DP = fma_cols<D>();     // the width kept: 96 at D = 80
  extern __shared__ float smem[];
  float* k_s = smem;                    // [kBQ][DP]: this block's 64 keys
  float* v_s = k_s + kBQ * DP;          // [kBQ][DP]
  float* q_s = v_s + kBQ * DP;          // [kBK][DP + 1]: 32 streamed queries
  float* do_s = q_s + kBK * (DP + 1);   // [kBK][DP + 1]
  float* lse_s = do_s + kBK * (DP + 1); // [kBK]
  float* dl_s = lse_s + kBK;           // [kBK]
  const int k0 = blockIdx.x * kBQ, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  int klen;
  const int q_off = row_geometry(kv_lens, b, S, Sk, &klen);

  for (int i = threadIdx.x; i < kBQ * DP; i += blockDim.x) {
    const int r = i / DP, d = i - r * DP, kj = k0 + r;
    const size_t off = ((size_t)(b * Sk + kj) * Hkv + kvh) * D + d;
    const bool in = kj < Sk && d < D;
    k_s[i] = in ? to_f(k[off]) : 0.f;
    v_s[i] = in ? to_f(v[off]) : 0.f;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dk_acc[kRows][DP / 32], dv_acc[kRows][DP / 32];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // the query rows that reach this tile's live keys [k0, klast]
  const int klast = min(k0 + kBQ, klen) - 1;
  int qbeg = 0, qend = S;
  if (causal) qbeg = max(0, k0 - q_off);
  if (window > 0) qend = min(qend, klast + window - q_off);
  if (klast < k0) qend = qbeg;  // the whole tile lies past kv_lens

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    // ALiBi: the slope of this query head of the group
    const float slope = kAlibi ? slopes[(size_t)b * H + h] : 0.f;
    for (int qt = qbeg; qt < qend; qt += kBK) {
      const int nq = min(kBK, qend - qt);
      __syncthreads();  // K/V tile stored / previous q tile consumed
      for (int i = threadIdx.x; i < nq * DP; i += blockDim.x) {
        const int j = i / DP, d = i - j * DP;
        const size_t src = ((size_t)(b * S + qt + j) * H + h) * D + d;
        q_s[j * (DP + 1) + d] = d < D ? to_f(q[src]) : 0.f;
        do_s[j * (DP + 1) + d] = d < D ? to_f(dout[src]) : 0.f;
      }
      if (threadIdx.x < nq) {
        const size_t row = ((size_t)b * H + h) * S + qt + threadIdx.x;
        lse_s[threadIdx.x] = lse[row];
        dl_s[threadIdx.x] = delta[row];
      }
      __syncthreads();
      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      if (lane < nq) {
        const float* qr = q_s + lane * (DP + 1);
        const float* dr = do_s + lane * (DP + 1);
        const float* kw = k_s + warp * kRows * DP;
        const float* vw = v_s + warp * kRows * DP;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float qd = qr[d], dd = dr[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            s[r] = fmaf(kw[r * DP + d], qd, s[r]);
            dp[r] = fmaf(vw[r * DP + d], dd, dp[r]);
          }
        }
      }
      const float lse_l = lane < nq ? lse_s[lane] : 0.f;
      const float dl_l = lane < nq ? dl_s[lane] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kp = k0 + warp * kRows + r;
        const bool ok = lane < nq &&
                        keep(q_off + qt + lane, kp, klen, causal, window);
        float sv = s[r] * scale;
        if constexpr (kAlibi)
          sv += alibi_bias(slope, q_off + qt + lane, kp, causal);
        const float p = ok ? expf(sv - lse_l) : 0.f;
        const float ds = p * (dp[r] - dl_l) * scale;
        for (int j = 0; j < nq; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
          const float* qr = q_s + j * (DP + 1) + lane;
          const float* dr = do_s + j * (DP + 1) + lane;
#pragma unroll
          for (int c = 0; c < DP / 32; ++c) {
            dv_acc[r][c] = fmaf(pj, dr[32 * c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(dsj, qr[32 * c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + warp * kRows + r;
    if (kj >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + kj) * Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) {
      if (lane + 32 * c >= D) continue;
      dk[off + lane + 32 * c] = from_f<T>(dk_acc[r][c]);
      dv[off + lane + 32 * c] = from_f<T>(dv_acc[r][c]);
    }
  }
}

template <int D, typename T, bool kAlibi>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kv_lens,
              const void* slopes, void* dq, int B, int S, int Sk, int H,
              int Hkv, float scale, int causal, int window, void* stream) {
  const int smem =
      bwd_smem_floats<fma_cols<D>()>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, T, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<D, T, kAlibi>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(kv_lens), static_cast<const float*>(slopes),
          static_cast<T*>(dq), S, Sk, H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T, bool kAlibi>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kv_lens,
               const void* slopes, void* dk, void* dv, int B, int S, int Sk,
               int H, int Hkv, float scale, int causal, int window,
               void* stream) {
  const int smem =
      bwd_smem_floats<fma_cols<D>()>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, T, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sk + kBQ - 1) / kBQ, Hkv, B);
  flash_bwd_dkv_kernel<D, T, kAlibi>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(kv_lens), static_cast<const float*>(slopes),
          static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, Hkv, scale,
          causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- K5b, tensor-core route
constexpr int kTile = 64;  // keys per block and queries per step (m64)

// Dynamic shared memory of K5b's tensor-core route: this block's K and V
// tiles, two stages of the streamed Q and dO tiles (each [64][D] in E,
// swizzled), then the two stages' lse and delta rows (64 fp32 each), plus
// the slack that aligns the tiles to 1024 bytes.
template <int D>
constexpr int dkv_wgmma_smem_bytes() {
  return 6 * kTile * hopper::tile_cols<D>() * 2 + 2 * 2 * kTile * 4 + 1024;
}

// The outputs one block of K5b's tensor-core route computes: dK and dV
// (D = 64, 128), or at D = 256 one of the two (two blocks a k tile; see
// the design note at the top)
constexpr int kDkvBoth = 0, kDkvOnlyDV = 1, kDkvOnlyDK = 2;

// One block of K5b's tensor-core route: the k tile at key k0 of KV head
// blockIdx.x, batch row blockIdx.y; base is the 1024-byte-aligned start of
// the dynamic shared memory (dkv_wgmma_smem_bytes<D>()).
template <typename E, int D, bool kAlibi, int kPart>
__device__ __forceinline__ void dkv_wgmma_block(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v,
    const E* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kv_lens,
    const float* __restrict__ slopes, E* __restrict__ dk,
    E* __restrict__ dv, int S, int Sk, int H, int Hkv,
    float scale, int causal, int window, int k0, uint8_t* base) {
  using namespace hopper;
  constexpr bool kDV = kPart != kDkvOnlyDK, kDK = kPart != kDkvOnlyDV;
  constexpr int DP = tile_cols<D>();  // 128 at D = 80
  constexpr int kTileBytes = kTile * DP * 2;
  const uint32_t k_s = smem_addr(base), v_s = k_s + kTileBytes;
  // stage st: Q at k_s + (2 + 2 st) tiles, dO right after it; its lse and
  // delta rows at rows_s + 2 * 64 * st
  float* rows_s = reinterpret_cast<float*>(base + 6 * kTileBytes);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  int klen;
  const int q_off = row_geometry(kv_lens, b, S, Sk, &klen);
  // the query rows that reach this tile's live keys [k0, klast]
  const int klast = min(k0 + kTile, klen) - 1;
  int qbeg = 0, qend = S;
  if (causal) qbeg = max(0, k0 - q_off);
  if (window > 0) qend = min(qend, klast + window - q_off);
  if (klast < k0) qend = qbeg;  // the whole tile lies past kv_lens
  const int nqt = qend > qbeg ? (qend - qbeg + kTile - 1) / kTile : 0;
  const int iters = G * nqt;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const size_t kv_off = ((size_t)b * Sk + k0) * kv_stride + kvh * D;
  // step it: q tile it % nqt of query head kvh * G + it / nqt
  auto load_q = [&](int it) {
    const int h = kvh * G + it / nqt, qt = qbeg + (it % nqt) * kTile;
    const uint32_t q_st = k_s + (2 + 2 * (it & 1)) * kTileBytes;
    const size_t off = ((size_t)b * S + qt) * q_stride + h * D;
    load_rows<kTile, D>(q_st, q + off, q_stride, qend - qt);
    load_rows<kTile, D>(q_st + kTileBytes, dout + off, q_stride, qend - qt);
    // threads 0..63 copy the lse rows, 64..127 the delta rows
    const int r = threadIdx.x & (kTile - 1);
    const bool ok = qt + r < qend;
    const float* src = (threadIdx.x < kTile ? lse : delta) +
                       ((size_t)b * H + h) * S + qt + (ok ? r : 0);
    cp_async4(smem_addr(rows_s + 2 * kTile * (it & 1) + threadIdx.x), src,
              ok);
  };
  if (iters > 0) {
    load_rows<kTile, D>(k_s, k + kv_off, kv_stride, klen - k0);
    if constexpr (kDK)  // V feeds dP^T only
      load_rows<kTile, D>(v_s, v + kv_off, kv_stride, klen - k0);
    load_q(0);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // key rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // query columns 8j + c0 + {0, 1}
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = scale * kLog2e;
  float dk_acc[kDK ? DP / 2 : 1], dv_acc[kDV ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    if constexpr (kDK) dk_acc[i] = 0.f;
    if constexpr (kDV) dv_acc[i] = 0.f;
  }

  for (int it = 0; it < iters; ++it) {
    const int qt = qbeg + (it % nqt) * kTile;
    // ALiBi: the slope of step it's query head, in log2 units
    const float a2 =
        kAlibi ? slopes[(size_t)b * H + kvh * G + it / nqt] * kLog2e : 0.f;
    const uint32_t q_st = k_s + (2 + 2 * (it & 1)) * kTileBytes;
    const uint32_t do_st = q_st + kTileBytes;
    const float* lse_s = rows_s + 2 * kTile * (it & 1);
    const float* dl_s = lse_s + kTile;
    cp_async_wait<0>();  // step it's tiles (and K, V) landed
    fence_async_smem();
    __syncthreads();     // ... for every thread; step it - 1 is consumed
    if (it + 1 < iters) {
      load_q(it + 1);    // streams in while step it computes
      cp_async_commit();
    }
    // S^T = K Q^T and (for dK) dP^T = V dO^T on the tensor cores
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    if constexpr (kDK) reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<E>(s, desc_kmajor<kTile>(k_s, kk),
                 desc_kmajor<kTile>(q_st, kk));
    if constexpr (kDK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64<E>(dp, desc_kmajor<kTile>(v_s, kk),
                   desc_kmajor<kTile>(do_st, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    if constexpr (kDK) reg_fence(dp);
    // element masks only on a step that crosses qend, kv_lens, the causal
    // diagonal or the window's edge
    const bool edge = qt + kTile > qend || k0 + kTile > klen ||
                      (causal && q_off + qt < k0 + kTile - 1) ||
                      (window > 0 && q_off + qt + kTile - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * j + c0 + (i & 1);
        const bool ok =
            !edge || (qt + c < qend && keep(q_off + qt + c,
                                            k0 + r0 + 8 * (i >> 1), klen,
                                            causal, window));
        float arg = -lse_s[c] * kLog2e;
        if constexpr (kAlibi)
          arg += alibi_bias(a2, q_off + qt + c, k0 + r0 + 8 * (i >> 1),
                            causal);
        const float p = ok ? exp2f(fmaf(s[4 * j + i], sl2, arg)) : 0.f;
        s[4 * j + i] = p;
        if constexpr (kDK)
          dp[4 * j + i] = p * (dp[4 * j + i] - dl_s[c]) * scale;
      }
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T (in E) from registers,
    // dO and Q transposed from shared memory
    uint32_t pa[4][4], da[4][4];
    if constexpr (kDV) to_operand_a<E, 4>(s, pa);
    if constexpr (kDK) to_operand_a<E, 4>(dp, da);
    if constexpr (kDV) reg_fence(dv_acc);
    if constexpr (kDK) reg_fence(dk_acc);
    wgmma_fence();
    if constexpr (kDV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<E, DP>(dv_acc, pa[kk], desc_mnmajor<kTile>(do_st, kk));
    }
    if constexpr (kDK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<E, DP>(dk_acc, da[kk], desc_mnmajor<kTile>(q_st, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDV) reg_fence(dv_acc);
    if constexpr (kDK) reg_fence(dk_acc);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = k0 + r0 + 8 * hr;
    if (kj >= Sk) continue;
    const size_t off = ((size_t)b * Sk + kj) * kv_stride + kvh * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hr;
      if constexpr (kDK)
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + c0) =
            pack2<E>(dk_acc[i], dk_acc[i + 1]);
      if constexpr (kDV)
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + c0) =
            pack2<E>(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <typename E, int D, bool kAlibi>
__global__ void __launch_bounds__(hopper::kWarpgroup, 2)
    flash_bwd_dkv_wgmma_kernel(
        const E* __restrict__ q,
        const E* __restrict__ k,
        const E* __restrict__ v,
        const E* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, const int* __restrict__ kv_lens,
        const float* __restrict__ slopes, E* __restrict__ dk,
        E* __restrict__ dv, int S, int Sk, int H, int Hkv,
        float scale, int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
#define PTT_ARGS                                                          \
  q, k, v, dout, lse, delta, kv_lens, slopes, dk, dv, S, Sk, H, Hkv, scale, \
      causal, window
  if constexpr (D == 256) {
    // two blocks a k tile, z = 2 * tile + part: the even one dV, the odd
    // one dK (blockIdx is uniform, so the branch does not split a
    // warpgroup's wgmma)
    const int k0 = (blockIdx.z >> 1) * kTile;
    if (blockIdx.z & 1)
      dkv_wgmma_block<E, D, kAlibi, kDkvOnlyDK>(PTT_ARGS, k0, base);
    else
      dkv_wgmma_block<E, D, kAlibi, kDkvOnlyDV>(PTT_ARGS, k0, base);
  } else {
    dkv_wgmma_block<E, D, kAlibi, kDkvBoth>(PTT_ARGS, blockIdx.z * kTile, base);
  }
#undef PTT_ARGS
}

template <typename E, int D, bool kAlibi>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* kv_lens, const void* slopes, void* dk,
                     void* dv, int B, int S, int Sk, int H, int Hkv,
                     float scale, int causal, int window, void* stream) {
  const int smem = dkv_wgmma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<E, D, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // D = 256: a dV block and a dK block for each k tile
  dim3 grid(Hkv, B, (D == 256 ? 2 : 1) * ((Sk + kTile - 1) / kTile));
  flash_bwd_dkv_wgmma_kernel<E, D, kAlibi>
      <<<grid, hopper::kWarpgroup, smem, (cudaStream_t)stream>>>(
          static_cast<const E*>(q),
          static_cast<const E*>(k),
          static_cast<const E*>(v),
          static_cast<const E*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(kv_lens), static_cast<const float*>(slopes),
          static_cast<E*>(dk), static_cast<E*>(dv), S,
          Sk, H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- K5a, tensor-core route
// Dynamic shared memory of K5a's tensor-core route: this block's Q and dO
// tiles, then two stages of the streamed K and V tiles (each [64][D] in E,
// swizzled), plus the slack that aligns the tiles to 1024 bytes.
template <int D>
constexpr int dq_wgmma_smem_bytes() {
  return 6 * kTile * hopper::tile_cols<D>() * 2 + 1024;
}

template <typename E, int D, bool kAlibi>
__global__ void __launch_bounds__(hopper::kWarpgroup, 2)
    flash_bwd_dq_wgmma_kernel(
        const E* __restrict__ q,
        const E* __restrict__ k,
        const E* __restrict__ v,
        const E* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, const int* __restrict__ kv_lens,
        const float* __restrict__ slopes, E* __restrict__ dq,
        int S, int Sk, int H, int Hkv, float scale, int causal, int window) {
  using namespace hopper;
  constexpr int DP = tile_cols<D>();  // 128 at D = 80
  constexpr int kTileBytes = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // Q, dO, then stage st's K at q_s + (2 + 2 st) tiles and V right after
  const uint32_t q_s = smem_addr(base), do_s = q_s + kTileBytes;
  const int h = blockIdx.x, b = blockIdx.y;
  // the last q tile, the one with the most live keys under causal, first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int kvh = h / (H / Hkv);
  int klen;
  const int q_off = row_geometry(kv_lens, b, S, Sk, &klen);
  // the live key range of this tile's rows: K2's [kbeg, kend)
  const int last = min(q0 + kTile, S) - 1;
  int kend = klen;
  if (causal) kend = min(kend, q_off + last + 1);
  const int kbeg = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int iters = kend > kbeg ? (kend - kbeg + kTile - 1) / kTile : 0;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const size_t q_off_el = ((size_t)b * S + q0) * q_stride + h * D;
  auto load_kv = [&](int it) {
    const int k0 = kbeg + it * kTile;
    const uint32_t k_st = q_s + (2 + 2 * (it & 1)) * kTileBytes;
    const size_t off = ((size_t)b * Sk + k0) * kv_stride + kvh * D;
    load_rows<kTile, D>(k_st, k + off, kv_stride, kend - k0);
    load_rows<kTile, D>(k_st + kTileBytes, v + off, kv_stride, kend - k0);
  };
  if (iters > 0) {
    load_rows<kTile, D>(q_s, q + q_off_el, q_stride, S - q0);
    load_rows<kTile, D>(do_s, dout + q_off_el, q_stride, S - q0);
    load_kv(0);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // query rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // key columns 8j + c0 + {0, 1}
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = scale * kLog2e;
  // ALiBi: this head's slope in log2 units (0 and unused without ALiBi)
  const float a2 = kAlibi ? slopes[(size_t)b * H + h] * kLog2e : 0.f;
  // this thread's two rows' lse (in base 2) and delta; 0 past S
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + 8 * hr;
    const size_t row = ((size_t)b * H + h) * S + qi;
    lse2[hr] = qi < S ? lse[row] * kLog2e : 0.f;
    dl[hr] = qi < S ? delta[row] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int k0 = kbeg + it * kTile;
    const uint32_t k_st = q_s + (2 + 2 * (it & 1)) * kTileBytes;
    const uint32_t v_st = k_st + kTileBytes;
    cp_async_wait<0>();  // step it's tiles (and Q, dO) landed
    fence_async_smem();
    __syncthreads();     // ... for every thread; step it - 1 is consumed
    if (it + 1 < iters) {
      load_kv(it + 1);   // streams in while step it computes
      cp_async_commit();
    }
    // S = Q K^T and dP = dO V^T on the tensor cores
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<E>(s, desc_kmajor<kTile>(q_s, kk),
                 desc_kmajor<kTile>(k_st, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<E>(dp, desc_kmajor<kTile>(do_s, kk),
                 desc_kmajor<kTile>(v_st, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // element masks only on a step that crosses kend (kv_lens or the
    // causal frontier), the causal diagonal or the window's edge
    const bool edge = k0 + kTile > kend ||
                      (causal && q_off + q0 < k0 + kTile - 1) ||
                      (window > 0 && q_off + q0 + kTile - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;
        const bool ok =
            !edge || keep(q_off + q0 + r0 + 8 * hr, k0 + 8 * j + c0 + (i & 1),
                          klen, causal, window);
        float arg = -lse2[hr];
        if constexpr (kAlibi)
          arg += alibi_bias(a2, q_off + q0 + r0 + 8 * hr,
                            k0 + 8 * j + c0 + (i & 1), causal);
        const float p = ok ? exp2f(fmaf(s[4 * j + i], sl2, arg)) : 0.f;
        dp[4 * j + i] = p * (dp[4 * j + i] - dl[hr]) * scale;
      }
    // dq += dS K: dS rounded to E (as the reference rounds it to q's
    // type) from registers, K transposed from the same shared tile
    uint32_t da[4][4];
    to_operand_a<E, 4>(dp, da);
    reg_fence(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<E, DP>(dq_acc, da[kk], desc_mnmajor<kTile>(k_st, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = q0 + r0 + 8 * hr;
    if (qi >= S) continue;
    E* row = dq + ((size_t)b * S + qi) * q_stride + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * hr;
      *reinterpret_cast<uint32_t*>(row + 8 * j + c0) =
          pack2<E>(dq_acc[i], dq_acc[i + 1]);
    }
  }
}

template <typename E, int D, bool kAlibi>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* kv_lens, const void* slopes, void* dq, int B,
                    int S, int Sk, int H, int Hkv, float scale, int causal,
                    int window, void* stream) {
  const int smem = dq_wgmma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<E, D, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (S + kTile - 1) / kTile);
  flash_bwd_dq_wgmma_kernel<E, D, kAlibi>
      <<<grid, hopper::kWarpgroup, smem, (cudaStream_t)stream>>>(
          static_cast<const E*>(q),
          static_cast<const E*>(k),
          static_cast<const E*>(v),
          static_cast<const E*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(kv_lens), static_cast<const float*>(slopes),
          static_cast<E*>(dq), S, Sk, H, Hkv, scale, causal,
          window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 or 2 = float16 (the tensor-core routes
// of both entry points: 16-byte-aligned pointers); head_dim: 64, 80, 128 or
// 256. kv_lens may be
// null (no padding); slopes null (no ALiBi) or fp32 [B * H], as K2 got
// them; window <= 0 means no sliding window. H % Hkv == 0.
extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta,
                            const void* kv_lens, const void* slopes, void* dq,
                            int B, int S, int Sk, int H, int Hkv, float scale,
                            int causal, int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
#define PTT_ARGS                                                        \
  (q, k, v, dout, lse, delta, kv_lens, slopes, dq, B, S, Sk, H, Hkv, scale, \
   causal, window, stream)
  return with_alibi(slopes, [&](auto alibi) {
    constexpr bool kA = decltype(alibi)::value;
    if (dtype == kF32 && head_dim == 64)
      return launch_dq<64, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 80)
      return launch_dq<80, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 128)
      return launch_dq<128, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 256)
      return launch_dq<256, float, kA> PTT_ARGS;
    return with_half(dtype, [&](auto e) {
      using E = decltype(e);
      if (head_dim == 64) return launch_dq_wgmma<E, 64, kA> PTT_ARGS;
      if (head_dim == 80) return launch_dq_wgmma<E, 80, kA> PTT_ARGS;
      if (head_dim == 128) return launch_dq_wgmma<E, 128, kA> PTT_ARGS;
      if (head_dim == 256) return launch_dq_wgmma<E, 256, kA> PTT_ARGS;
      return static_cast<int>(cudaErrorInvalidValue);
    });
  });
#undef PTT_ARGS
}

extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta,
                             const void* kv_lens, const void* slopes,
                             void* dk, void* dv, int B, int S, int Sk, int H,
                             int Hkv, float scale, int causal, int window,
                             void* stream) {
  if (B <= 0 || Sk <= 0) return 0;
#define PTT_ARGS                                                        \
  (q, k, v, dout, lse, delta, kv_lens, slopes, dk, dv, B, S, Sk, H, Hkv,    \
   scale, causal, window, stream)
  return with_alibi(slopes, [&](auto alibi) {
    constexpr bool kA = decltype(alibi)::value;
    if (dtype == kF32 && head_dim == 64)
      return launch_dkv<64, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 80)
      return launch_dkv<80, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 128)
      return launch_dkv<128, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 256)
      return launch_dkv<256, float, kA> PTT_ARGS;
    return with_half(dtype, [&](auto e) {
      using E = decltype(e);
      if (head_dim == 64) return launch_dkv_wgmma<E, 64, kA> PTT_ARGS;
      if (head_dim == 80) return launch_dkv_wgmma<E, 80, kA> PTT_ARGS;
      if (head_dim == 128) return launch_dkv_wgmma<E, 128, kA> PTT_ARGS;
      if (head_dim == 256) return launch_dkv_wgmma<E, 256, kA> PTT_ARGS;
      return static_cast<int>(cudaErrorInvalidValue);
    });
  });
#undef PTT_ARGS
}
