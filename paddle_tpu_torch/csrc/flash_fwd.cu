// K2 — flash-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py _fwd_kernel (via
// _flash_fwd, public flash_attention), the forward only.
// q [B, S, H, D], k/v [B, Sk, Hkv, D] (the JAX layout), o like q, and the
// log-sum-exp [B, H, S] fp32 (natural log of the scaled scores, 0 for a
// row with no live key) that the backward (K5) reads.
//
// Two routes, by dtype (ops/cuda/flash_attention.py kernel_route):
//   bf16 and f16 — flash_fwd_wgmma_kernel<E>, on the tensor cores (one
//     source; E the 2-byte type of q, k, v and o, which P is rounded to). At the training
//     shapes (S = 2048, D = 128) the work is ~S flops per byte, far above
//     the H100's ridge, so the bound is the tensor-core rate: both
//     products run as wgmma (m64n64k16 for S = Q K^T from shared memory,
//     m64nDk16 for O += P V with P from registers and V read transposed),
//     bf16 operands and fp32 accumulators. One warpgroup owns a 64-row q
//     tile and walks 64-key tiles; the next K/V tile streams in with
//     cp.async (two stages, 128-byte-swizzled) while the current one
//     computes. The online softmax runs on the accumulator fragment in
//     registers, in base 2 (log2(e) folded into the scale; the LSE is
//     converted back to the natural log), and P, rounded to bf16 as the
//     plain version rounds it, is P V's A operand without a trip through
//     shared memory (hopper_mma.cuh).
//   fp32 — flash_fwd_kernel, fp32 FMAs on the CUDA cores (attn_tile.cuh):
//     exact to the card tests' 1e-4, which TF32 tensor cores are not.
// Head dims 64, 80 (Phi-2), 128 and 256 (Gemma, GPT-J). At 80 both routes
// keep the head at a padded width, zeros past column 80 (hopper_mma.cuh
// tile_cols: 128 on the tensor cores, whose 128-byte swizzle wants whole
// 64-column panels, so S = Q K^T runs 5 k steps and O += P V n 128;
// attn_tile.cuh fma_cols: 96 on the FMA route). At 256 the tensor-core route
// keeps its design: the O accumulator takes D / 2 = 128 fp32 registers a
// thread (P V issued as two m64n128k16 halves, hopper_mma.cuh mma_rs), and
// the q tile plus two K/V stages take 164 864 bytes of shared memory, so
// one block runs on an SM; the FMA route's tiles take 131 200 bytes.
//
// ALiBi (the reference's _alibi_add, called from _fwd_kernel): with a
// slopes pointer ([B * H] fp32, by query head) both routes run a second
// instantiation (template flag kAlibi) that adds slope * (k_pos - q_pos)
// (causal; -slope * |k_pos - q_pos| without) to each scaled score, from
// the masks' query positions. It adds no memory traffic: the bias comes
// from the indices, as it did from iota on the TPU. Without slopes the
// first instantiation runs, the code of the mode without ALiBi. On the
// tensor-core route the bias goes in, in base-2 units, before the running
// max (max-then-scale holds for a common scale, not a per-element bias),
// so every live tile takes the element pass that only edge tiles take
// without ALiBi; the dead-tile bounds are the same.
//
// Both: one block per (q tile of 64 rows, head, batch row); the k loop
// lives inside the block (it was the sequential grid axis on the TPU) and
// only walks the tiles the mask leaves alive: the causal frontier of the
// tile's last row, the row's kv_lens and the lower edge of a sliding
// window bound [kbeg, kend). Element masks apply only on tiles that cross
// one of those edges. GQA reads kv head h / (H / Hkv) straight from k/v,
// never a repeated copy. Ragged S is masked in the kernel (rows >= S are
// zero-filled and never written), so nothing is padded. The tensor-core
// route issues its q tiles heaviest first: under causal the last q tile
// has the most live keys, and the grid's slowest axis walks the tiles
// from the last, so the long blocks of every head start in the first
// wave on the 132 SMs instead of finishing last.
#include "attn_tile.cuh"
#include "hopper_mma.cuh"

using namespace ptt;

namespace {

// ------------------------------------------------------------ FMA route
template <int D, typename T, bool kAlibi>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_lens,
                     const float* __restrict__ slopes, T* __restrict__ o,
                     float* __restrict__ lse, int S, int Sk, int H, int Hkv,
                     float scale, int causal, int window) {
  constexpr int DP = fma_cols<D>();  // the width kept: 96 at D = 80
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * DP;
  float* v_s = k_s + kBK * (DP + 1);
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  int klen = Sk;
  if (kv_lens != nullptr) klen = min(max(kv_lens[b], 0), Sk);
  // query positions align to the END of the key axis; with kv_lens and a
  // short query block (decode against a padded cache) to the row's valid
  // length instead — the reference's _q_offset rule
  int q_off = Sk - S;
  if (kv_lens != nullptr && q_off > 0) q_off += klen - Sk;

  for (int i = threadIdx.x; i < kBQ * DP; i += blockDim.x) {
    const int r = i / DP, d = i - r * DP, qi = q0 + r;
    q_s[i] = qi < S && d < D
                 ? to_f(q[((size_t)(b * S + qi) * H + h) * D + d])
                 : 0.f;
  }
  const int last = min(q0 + kBQ, S) - 1;
  int kend = klen;
  if (causal) kend = min(kend, q_off + last + 1);
  const int kbeg = window > 0 ? max(0, q_off + q0 - window + 1) : 0;

  const float slope = kAlibi ? slopes[(size_t)b * H + h] : 0.f;  // ALiBi
  RowState<DP> st;
  st.init();
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const int nk = min(kBK, kend - k0);
    __syncthreads();  // q tile stored / previous K,V tile consumed
    for (int i = threadIdx.x; i < nk * DP; i += blockDim.x) {
      const int j = i / DP, d = i - j * DP;
      const size_t src = ((size_t)(b * Sk + k0 + j) * Hkv + kvh) * D + d;
      k_s[j * (DP + 1) + d] = d < D ? to_f(k[src]) : 0.f;
      v_s[j * DP + d] = d < D ? to_f(v[src]) : 0.f;
    }
    __syncthreads();
    auto keep = [&](int row, int j) {
      const int qp = q_off + q0 + row, kp = k0 + j;
      return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
    };
    if constexpr (kAlibi) {
      tile_update<DP>(q_s, k_s, v_s, nk, scale, st, keep, [&](int row, int j) {
        return alibi_bias(slope, q_off + q0 + row, k0 + j, causal);
      });
    } else {
      tile_update<DP>(q_s, k_s, v_s, nk, scale, st, keep);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= S) continue;
    const float l = st.l[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + ((size_t)(b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c)
      if (lane + 32 * c < D)
        orow[lane + 32 * c] = from_f<T>(st.acc[r][c] * inv);
    if (lane == 0)
      lse[((size_t)b * H + h) * S + qi] = l > 0.f ? st.m[r] + logf(l) : 0.f;
  }
}

template <int D, typename T, bool kAlibi>
int launch(const void* q, const void* k, const void* v, const void* kv_lens,
           const void* slopes, void* o, void* lse, int B, int S, int Sk,
           int H, int Hkv, float scale, int causal, int window,
           void* stream) {
  const int smem =
      smem_floats<fma_cols<D>()>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, T, kAlibi>
      <<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(kv_lens),
          static_cast<const float*>(slopes), static_cast<T*>(o),
          static_cast<float*>(lse), S, Sk, H, Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- tensor-core route
constexpr int kTile = 64;  // q rows per block and keys per step (wgmma m64)

// Dynamic shared memory of the tensor-core route: the q tile and two
// stages of K and V tiles, each [64][D] bf16 swizzled (at the padded
// width tile_cols<D>(): 128 at D = 80), plus the slack that aligns them
// to 1024 bytes.
template <int D>
constexpr int wgmma_smem_bytes() {
  return 5 * kTile * hopper::tile_cols<D>() * 2 + 1024;
}

template <typename E, int D, bool kAlibi>
__global__ void __launch_bounds__(hopper::kWarpgroup, 2)
    flash_fwd_wgmma_kernel(const E* __restrict__ q,
                           const E* __restrict__ k,
                           const E* __restrict__ v,
                           const int* __restrict__ kv_lens,
                           const float* __restrict__ slopes,
                           E* __restrict__ o,
                           float* __restrict__ lse, int S, int Sk, int H,
                           int Hkv, float scale, int causal, int window) {
  using namespace hopper;
  constexpr int DP = tile_cols<D>();  // 128 at D = 80
  constexpr int kTileBytes = kTile * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  // stage st: K at q_s + (1 + 2 st) tiles, V right after it
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // heaviest first
  const int kvh = h / (H / Hkv);
  int klen = Sk;
  if (kv_lens != nullptr) klen = min(max(kv_lens[b], 0), Sk);
  // query positions align to the END of the key axis; with kv_lens and a
  // short query block (decode against a padded cache) to the row's valid
  // length instead — the reference's _q_offset rule
  int q_off = Sk - S;
  if (kv_lens != nullptr && q_off > 0) q_off += klen - Sk;
  const int last = min(q0 + kTile, S) - 1;
  int kend = klen;
  if (causal) kend = min(kend, q_off + last + 1);
  const int kbeg = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int ntiles = kend > kbeg ? (kend - kbeg + kTile - 1) / kTile : 0;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const E* q_src = q + ((size_t)b * S + q0) * q_stride + h * D;
  const E* k_src = k + (size_t)b * Sk * kv_stride + kvh * D;
  const E* v_src = v + (size_t)b * Sk * kv_stride + kvh * D;
  auto load_kv = [&](int t) {
    const int k0 = kbeg + t * kTile;
    const uint32_t k_s = q_s + (1 + 2 * (t & 1)) * kTileBytes;
    load_rows<kTile, D>(k_s, k_src + k0 * kv_stride, kv_stride, kend - k0);
    load_rows<kTile, D>(k_s + kTileBytes, v_src + k0 * kv_stride, kv_stride,
                        kend - k0);
  };
  if (ntiles > 0) {
    load_rows<kTile, D>(q_s, q_src, q_stride, S - q0);
    load_kv(0);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // columns 8j + c0 + {0, 1}
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = scale * kLog2e;  // scores -> log2 units
  // ALiBi: the slope in log2 units (0 and unused without ALiBi)
  const float a2 = kAlibi ? slopes[(size_t)b * H + h] * kLog2e : 0.f;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * kTile;
    const uint32_t k_s = q_s + (1 + 2 * (t & 1)) * kTileBytes;
    const uint32_t v_s = k_s + kTileBytes;
    cp_async_wait<0>();  // tile t (and the q tile) landed
    fence_async_smem();
    __syncthreads();     // ... for every thread; tile t - 1 is consumed
    if (t + 1 < ntiles) {
      load_kv(t + 1);    // streams in while tile t computes
      cp_async_commit();
    }
    // S = Q K^T on the tensor cores
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n64<E>(s, desc_kmajor<kTile>(q_s, kk), desc_kmajor<kTile>(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // element masks only on a tile that crosses kv_lens, the causal
    // diagonal or the window's lower edge
    const bool edge = k0 + kTile > klen ||
                      (causal && k0 + kTile - 1 > q_off + q0) ||
                      (window > 0 && q_off + q0 + kTile - 1 - k0 >= window);
    if constexpr (kAlibi) {
      // every live tile: s -> s * scale + bias in log2 units, masked -inf
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = q_off + q0 + r0 + 8 * (i >> 1);
          const int kp = k0 + 8 * j + c0 + (i & 1);
          const bool ok = !edge || (kp < klen && (!causal || qp >= kp) &&
                                    (window <= 0 || qp - kp < window));
          s[4 * j + i] = ok ? fmaf(s[4 * j + i], sl2,
                                   alibi_bias(a2, qp, kp, causal))
                            : -INFINITY;
        }
    } else if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = q_off + q0 + r0 + 8 * (i >> 1);
          const int kp = k0 + 8 * j + c0 + (i & 1);
          const bool ok = kp < klen && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
          if (!ok) s[4 * j + i] = -INFINITY;
        }
    }
    // online softmax on the fragment: this thread holds 16 of each of its
    // two rows' 64 scores, the quad (lanes 4i..4i+3) the whole row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // (with ALiBi the scores are in log2 units already)
      const float m_new = fmaxf(m[hr], kAlibi ? mx : mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[hr] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hr + e];
          x = kAlibi ? exp2f(x - m_use) : exp2f(fmaf(x, sl2, -m_use));
          sum += x;
        }
      l[hr] = l[hr] * corr + sum;  // this thread's share of the row
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * hr] *= corr;
        acc[4 * j + 2 * hr + 1] *= corr;
      }
    }
    // O += P V: P (in E) from registers, V transposed from shared memory
    uint32_t pa[4][4];
    to_operand_a<E, 4>(s, pa);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs<E, DP>(acc, pa[kk], desc_mnmajor<kTile>(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qi = q0 + r0 + 8 * hr;
    if (qi >= S) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    E* orow = o + ((size_t)b * S + qi) * q_stride + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c0) =
          pack2<E>(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * S + qi] =
          sum > 0.f ? m[hr] * 0.6931471805599453f + logf(sum) : 0.f;
  }
}

template <typename E, int D, bool kAlibi>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* kv_lens, const void* slopes, void* o, void* lse,
                 int B, int S, int Sk, int H, int Hkv, float scale,
                 int causal, int window, void* stream) {
  const int smem = wgmma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<E, D, kAlibi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, B, (S + kTile - 1) / kTile);
  flash_fwd_wgmma_kernel<E, D, kAlibi>
      <<<grid, hopper::kWarpgroup, smem, (cudaStream_t)stream>>>(
          static_cast<const E*>(q),
          static_cast<const E*>(k),
          static_cast<const E*>(v),
          static_cast<const int*>(kv_lens), static_cast<const float*>(slopes),
          static_cast<E*>(o), static_cast<float*>(lse), S, Sk, H,
          Hkv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (FMA route), 1 = bfloat16 or 2 = float16 (the
// tensor-core route); head_dim: 64, 80, 128 or 256. kv_lens may be null (no
// padding); slopes null (no ALiBi) or fp32 [B * H]; window <= 0 means no
// sliding window. bf16 and f16 pointers must be 16-byte aligned.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* kv_lens,
                         const void* slopes, void* o, void* lse, int B, int S,
                         int Sk, int H, int Hkv, float scale, int causal,
                         int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
#define PTT_ARGS                                                          \
  (q, k, v, kv_lens, slopes, o, lse, B, S, Sk, H, Hkv, scale, causal, window, \
   stream)
  return with_alibi(slopes, [&](auto alibi) {
    constexpr bool kA = decltype(alibi)::value;
    if (dtype == kF32 && head_dim == 64) return launch<64, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 80) return launch<80, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 128)
      return launch<128, float, kA> PTT_ARGS;
    if (dtype == kF32 && head_dim == 256)
      return launch<256, float, kA> PTT_ARGS;
    return with_half(dtype, [&](auto e) {
      using E = decltype(e);
      if (head_dim == 64) return launch_wgmma<E, 64, kA> PTT_ARGS;
      if (head_dim == 80) return launch_wgmma<E, 80, kA> PTT_ARGS;
      if (head_dim == 128) return launch_wgmma<E, 128, kA> PTT_ARGS;
      if (head_dim == 256) return launch_wgmma<E, 256, kA> PTT_ARGS;
      return static_cast<int>(cudaErrorInvalidValue);
    });
  });
#undef PTT_ARGS
}
