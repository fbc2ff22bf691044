// Online-softmax machinery shared by the multi-query attention kernels
// on fp32 FMAs (the float32 routes of K2, flash_fwd.cu, and K3,
// paged_chunk.cu).
//
// A block owns kBQ query rows (kWarps warps x kRows rows each) and walks
// key tiles of kBK keys, one key per lane. The query tile and the current
// K/V tile sit in shared memory as fp32; every row keeps its running max
// m, denominator l and output accumulator in registers, so nothing of the
// softmax ever goes back to device memory. Scores are fp32 FMAs on the
// CUDA cores (simple and exact against the plain versions). The bf16
// routes of K2 and K3 run on the tensor cores instead (hopper_mma.cuh).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 32;              // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

// The width the FMA routes keep a head of D dims at, in shared memory and
// in registers (a lane owns the dims lane + 32 c): D rounded up to whole
// lanes' columns. At D = 80 (Phi-2) that is 96, columns 80..95 zeros on
// load, which add nothing to a dot product and are never stored.
template <int D>
__host__ __device__ constexpr int fma_cols() {
  return (D + 31) / 32 * 32;
}

// fp32 words of dynamic shared memory: q tile, K tile (row stride D+1, so
// the lanes of a warp reading key rows hit distinct banks), V tile
template <int D>
constexpr int smem_floats() {
  return kBQ * D + kBK * (D + 1) + kBK * D;
}

// ALiBi (the reference's _alibi_add): the bias of the score of query
// position qp against key position kp under slope m, in the scores' units
// (after the scale): m * (kp - qp) under causal, -m * |kp - qp| without.
__device__ __forceinline__ float alibi_bias(float m, int qp, int kp,
                                            int causal) {
  const float d = static_cast<float>(kp - qp);
  return m * (causal ? d : -fabsf(d));
}

// The entry points' choice of instantiation (flash_fwd.cu, flash_bwd.cu):
// f(std::true_type) runs the ALiBi kernels when the caller passed slopes,
// f(std::false_type) the kernels without ALiBi when slopes is null.
template <class F>
inline int with_alibi(const void* slopes, F&& f) {
  return slopes != nullptr ? f(std::true_type{}) : f(std::false_type{});
}

template <int D>
struct RowState {
  float m[kRows];
  float l[kRows];
  float acc[kRows][D / 32];  // lane owns output dims lane + 32*c

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 32; ++c) acc[r][c] = 0.f;
    }
  }
};

// The score bias of a call without one (tile_update's default): adds
// nothing, and no instruction either.
struct NoBias {
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// Fold one key tile of nk (<= kBK) keys into this warp's rows.
// keep(row, j): is tile key j visible to block row `row` (mask rule of the
// caller: causal, window, ragged lengths). bias(row, j): added to the
// scaled score of a kept entry (ALiBi; NoBias compiles to nothing).
// Fully-masked rows keep m = -inf and l = 0, so the caller writes 0 for
// them instead of NaN.
template <int D, class Keep, class Bias = NoBias>
__device__ __forceinline__ void tile_update(const float* __restrict__ q_s,
                                            const float* __restrict__ k_s,
                                            const float* __restrict__ v_s,
                                            int nk, float scale,
                                            RowState<D>& st, Keep keep,
                                            Bias bias = Bias()) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.f;
  if (lane < nk) {
    const float* kr = k_s + lane * (D + 1);
    const float* qw = q_s + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool ok = lane < nk && keep(warp * kRows + r, lane);
    float sv = ok ? s[r] * scale : -INFINITY;
    if constexpr (!std::is_same<Bias, NoBias>::value) {
      if (ok) sv += bias(warp * kRows + r, lane);
    }
    const float m_new = fmaxf(st.m[r], warp_max(sv));
    float corr = 1.f, p = 0.f;
    if (m_new != -INFINITY) {
      corr = expf(st.m[r] - m_new);
      p = ok ? expf(sv - m_new) : 0.f;
    }
    st.l[r] = st.l[r] * corr + warp_sum(p);
    st.m[r] = m_new;
#pragma unroll
    for (int c = 0; c < D / 32; ++c) st.acc[r][c] *= corr;
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const float* vr = v_s + j * D + lane;
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        st.acc[r][c] = fmaf(pj, vr[32 * c], st.acc[r][c]);
    }
  }
}

}  // namespace ptt
