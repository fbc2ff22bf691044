// K6a / K6b — grouped (ragged) matrix products for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/grouped_matmul.py
//   K6a  _fwd_kernel (via _pallas_fwd): out[r] = lhs[r] @ rhs[g(r)] over rows
//        sorted so that each group's rows are contiguous; g(r) follows from
//        group_sizes. The backward's dlhs is the same product against rhs
//        read transposed.
//   K6b  _dw_kernel (via _pallas_dw): drhs[e] = lhs[seg(e)]^T @ g[seg(e)],
//        exactly 0 for an empty group.
// Both accumulate in fp32 and cast once to the operands' type.
//
// The TPU plan pads every group to a multiple of its row tile and scatters
// lhs into a padded buffer, because one BlockSpec tile must belong to one
// expert. Here a block bounds its rows by its group's [start, end) and
// masks the tail, so lhs, g and the result are used in place: no padded
// copy, no gather of the result. group_sizes stays on the device: the
// launch covers the static bound of row tiles, ceil(m / BM) + E, each
// block finds its group from the prefix sums of group_sizes (E is small)
// and returns when it is past the live tiles, so an empty group costs no
// weight read and the host never waits for the sizes.
//
// Bound on this card. Prefill and training (hundreds of rows per group):
// about balanced; at the MoE train shape (60 groups of ~273 rows, k 2048,
// n 2816) each weight byte meets ~273 flops, under the H100's ~295, so
// reading every expert's weights once bounds it, with the products close
// behind. Decode (a few rows over many groups): bytes, every non-empty
// group's weights are read once for one or two rows. Three kernels, chosen
// by the wrapper from the static shapes, dtype and alignment alone
// (ops/cuda/grouped_matmul.py fwd_route):
//   wgmma (bf16 or f16, k and n multiples of 8, 16-byte-aligned pointers)
//     — grouped_fwd_wgmma_kernel<E>: a 128 x 256 output tile, two
//     warpgroups of 64 rows each, products on the tensor cores (wgmma
//     m64n256k16, bf16 or f16 operands, fp32 accumulators cast once). lhs slabs [128][64] K-major
//     and rhs slabs 64 x 256 (MN-major from [k, n] for the forward, K-major
//     from [n, k] for dlhs, the descriptor's transpose bit choosing) stream
//     through a four-stage cp.async ring in 128-byte-swizzled tiles,
//     zero-filled past the group's rows, past k and past n; two slabs load
//     and one product runs while the next product is issued. The grid is
//     rastered by group (all row tiles of one column strip of one expert
//     next to each other), so an expert's weights come from device memory
//     about once and from L2 for its other row tiles; a warpgroup whose
//     rows all lie past its group's end (a tail tile) multiplies nothing,
//     so a tail wastes at most 63 rows of products. What holds it below
//     the bound: one block an SM (193 KB of shared memory), cp.async
//     issued by the compute warps themselves (no TMA producer), and the
//     tail rows.
//   fma (float32, and whatever the tensor-core route refuses) —
//     grouped_fwd_kernel: fp32 FMAs on the CUDA cores from shared-memory
//     tiles (operands converted to fp32 on the way in, register prefetch
//     of the next slab); exact to the card tests' 1e-4 in float32.
//   decode (a few rows per group, not transposed) — grouped_decode_kernel:
//     bound by bytes, every live group's weights read once (Qwen1.5-MoE's
//     decode: 32 rows over ~26 of 60 experts, 300 MB of gate_up weights
//     against 0.37 GFLOP). A static grid of persistent blocks, two an SM,
//     so that a CUDA graph replays it: each block computes the groups'
//     row tiles (up to kDecRows rows) from the sizes on the device and
//     walks equal-byte units (a row tile x a 256-byte column strip of its
//     group's weights over all of k) through a ring of 16 KB weight boxes
//     that the tensor memory accelerator fills; every row of the tile
//     multiplies the same staged bytes. Its second entry point
//     (grouped_decode) folds the MoE layer's glue into the two expert
//     products: the gate_up product gathers its rows from the layer's
//     tokens, the down product forms SwiGLU on load and scales and
//     scatters its rows in the epilogue, each with the unfused path's
//     roundings. What holds it below the bound: the last round of units
//     (616 units of the gate_up product over 264 blocks) and each block's
//     own steps.
//
// K6b (drhs [E, k, n]) is bound by bytes, and mostly by its output: at
// the MoE train shape (60 groups of ~273 rows, k 2048, n 2816) it writes
// 692 MB of bf16 against 159 MB of lhs and g read, and each of its 189
// GFLOP meets only ~273 rows of reduction, so a tile's prologue and
// epilogue weigh as much as its products. Each output tile is summed down
// its group's rows in registers in a fixed order by one block: no
// atomics, the result is deterministic, and an empty group's tiles write
// exact zeros. Two kernels, chosen by the wrapper's dw_route from the
// static shapes, dtype and alignment alone:
//   wgmma (bf16 or f16, k and n multiples of 8, 16-byte-aligned pointers)
//     — grouped_dw_wgmma_kernel<E>: 128 (k) x 256 (n) output tiles of two
//     warpgroups (wgmma m64n256k16, both operands MN-major: the lhs and g
//     slabs are used as they lie in memory), 64-row slabs through a
//     three-stage cp.async ring, rows past the group's end zero-filled.
//     Persistent blocks (one an SM) walk the static, group-major tile list
//     with a fixed stride, so the tile order needs no group size on the
//     host, a group's inputs stay in L2 for its tiles, and a tile's
//     epilogue overlaps the next tile's first loads. The epilogue casts
//     once to E into a shared staging tile and writes it with coalesced
//     16-byte stores (whole 512-byte rows, no per-element stores). What
//     holds it above the bound: every tile reads its group's rows from L2
//     again (2.2 GB a call at the gate_up shape, 14 times the inputs'
//     bytes), the output's writes share the L2 with those reads, and a
//     tile's epilogue stalls the tensor cores.
//   fma (float32, and whatever the tensor-core route refuses) —
//     grouped_dw_kernel: one block per (group, k tile, n tile), fp32 FMAs
//     from shared-memory tiles; exact to the card tests' 1e-4 in float32.
#include <cuda.h>

#include <type_traits>

#include "hopper_mma.cuh"

using namespace ptt;

namespace {

// A block computes a BM x BN tile from slabs of depth BK; a thread owns the
// TM x TN outputs at rows i * RY + ty and columns j * RX + tx, so that the
// shared-memory reads of a warp are a broadcast (rows) and consecutive
// banks (columns), and its global stores are coalesced along columns.
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int RY = BM / TM, RX = BN / TN, THREADS = RY * RX;
  static constexpr int AE = BM * BK / THREADS, BE = BK * BN / THREADS;
  static_assert(BM % TM == 0 && BN % TN == 0, "tile / thread shape");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "slab elements per thread");
};

using Large = Tile<128, 128, 16, 8, 8>;  // 256 threads, 8 x 8 per thread

// acc += A^T B over one slab: As [BK][BM] and Bs [BK][BN] in fp32. FULL:
// every row of the tile is live; otherwise the thread owns my_rows rows.
template <typename C, bool FULL>
__device__ __forceinline__ void fma_slab(const float (&As)[C::BK][C::BM + 1],
                                         const float (&Bs)[C::BK][C::BN + 1],
                                         float (&acc)[C::TM][C::TN], int tx,
                                         int ty, int my_rows) {
#pragma unroll
  for (int kk = 0; kk < C::BK; ++kk) {
    float b[C::TN];
#pragma unroll
    for (int j = 0; j < C::TN; ++j) b[j] = Bs[kk][j * C::RX + tx];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      if (!FULL && i >= my_rows) break;
      const float a = As[kk][i * C::RY + ty];
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------- K6a
// One slab of the forward into registers: x [nrows, k] (the tile's rows),
// w the group's weights, [k, n] or, TRANS, [n, k].
template <typename T, typename C, bool TRANS>
__device__ __forceinline__ void fwd_load(const T* __restrict__ x,
                                         const T* __restrict__ w, int nrows,
                                         int k0, int n0, int k, int n,
                                         int tid, float (&ra)[C::AE],
                                         float (&rb)[C::BE]) {
#pragma unroll
  for (int t = 0; t < C::AE; ++t) {
    const int idx = tid + t * C::THREADS;
    const int r = idx / C::BK, c = k0 + idx % C::BK;
    ra[t] = (r < nrows && c < k) ? to_f(x[(size_t)r * k + c]) : 0.f;
  }
#pragma unroll
  for (int t = 0; t < C::BE; ++t) {
    const int idx = tid + t * C::THREADS;
    if (TRANS) {
      const int c = n0 + idx / C::BK, r = k0 + idx % C::BK;
      rb[t] = (r < k && c < n) ? to_f(w[(size_t)c * k + r]) : 0.f;
    } else {
      const int r = k0 + idx / C::BN, c = n0 + idx % C::BN;
      rb[t] = (r < k && c < n) ? to_f(w[(size_t)r * n + c]) : 0.f;
    }
  }
}

template <typename T, typename C, bool TRANS>
__global__ void __launch_bounds__(C::THREADS, 2)
    grouped_fwd_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                       const int* __restrict__ sizes, T* __restrict__ out,
                       int m, int k, int n, int e, int n_tiles) {
  __shared__ float As[C::BK][C::BM + 1];
  __shared__ float Bs[C::BK][C::BN + 1];
  // this block's row tile: slot counts the tiles of the groups in order
  int slot = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * C::BN;
  int g = 0, start = 0, row0 = -1, row_end = 0;
  for (; g < e; ++g) {
    const int sz = max(sizes[g], 0);
    const int tiles = (sz + C::BM - 1) / C::BM;
    if (slot < tiles) {
      row0 = start + slot * C::BM;
      row_end = min(start + sz, m);
      break;
    }
    slot -= tiles;
    start += sz;
  }
  if (row0 < 0 || row0 >= row_end) return;  // past the live tiles
  const int nrows = min(C::BM, row_end - row0);
  const T* x = lhs + (size_t)row0 * k;
  const T* w = rhs + (size_t)g * k * n;
  const int tid = threadIdx.x, tx = tid % C::RX, ty = tid / C::RX;
  const int my_rows = min(C::TM, max(0, (nrows - ty + C::RY - 1) / C::RY));

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  float ra[C::AE], rb[C::BE];
  fwd_load<T, C, TRANS>(x, w, nrows, 0, n0, k, n, tid, ra, rb);
  for (int k0 = 0; k0 < k; k0 += C::BK) {
#pragma unroll
    for (int t = 0; t < C::AE; ++t) {
      const int idx = tid + t * C::THREADS;
      As[idx % C::BK][idx / C::BK] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < C::BE; ++t) {
      const int idx = tid + t * C::THREADS;
      if (TRANS)
        Bs[idx % C::BK][idx / C::BK] = rb[t];
      else
        Bs[idx / C::BN][idx % C::BN] = rb[t];
    }
    __syncthreads();
    if (k0 + C::BK < k)  // the next slab's loads fly during the FMAs
      fwd_load<T, C, TRANS>(x, w, nrows, k0 + C::BK, n0, k, n, tid, ra, rb);
    if (nrows == C::BM)
      fma_slab<C, true>(As, Bs, acc, tx, ty, my_rows);
    else if (my_rows > 0)
      fma_slab<C, false>(As, Bs, acc, tx, ty, my_rows);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = i * C::RY + ty;
    if (r >= nrows) break;
    T* orow = out + (size_t)(row0 + r) * n;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int c = n0 + j * C::RX + tx;
      if (c < n) orow[c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, typename C>
int launch_fwd(int trans, const void* lhs, const void* rhs, const void* sizes,
               void* out, int m, int k, int n, int e, void* stream) {
  const long long n_tiles = (n + C::BN - 1) / C::BN;
  const long long slots = (m + C::BM - 1) / C::BM + e;  // static bound
  if (n_tiles * slots > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_tiles * slots));
  const T* a = static_cast<const T*>(lhs);
  const T* b = static_cast<const T*>(rhs);
  const int* s = static_cast<const int*>(sizes);
  T* o = static_cast<T*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (trans)
    grouped_fwd_kernel<T, C, true><<<grid, C::THREADS, 0, st>>>(
        a, b, s, o, m, k, n, e, static_cast<int>(n_tiles));
  else
    grouped_fwd_kernel<T, C, false><<<grid, C::THREADS, 0, st>>>(
        a, b, s, o, m, k, n, e, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------- K6a, tensor-core route (bf16 and f16: E)
constexpr int kGemmBK = 64;     // k per stage: one 128-byte line of E
constexpr int kGemmStages = 4;  // cp.async ring: two loads and one
                                // product in flight beside the current one

// Dynamic shared memory of the tensor-core route: kGemmStages stages of an
// lhs tile [64 WG][64] and an rhs tile (64 x BN), plus the slack that
// aligns the tiles to 1024 bytes.
template <int WG, int BN>
constexpr int gemm_wgmma_smem_bytes() {
  return kGemmStages * (64 * WG + BN) * kGemmBK * 2 + 1024;
}

// WG warpgroups, each owning 64 rows of a (64 WG) x BN output tile; lhs
// K-major, rhs [k, n] MN-major or, TRANS, [n, k] K-major. Blocks are
// rastered by group: the linear block index walks group g's tiles (all its
// row tiles of one column strip next to each other, then the next strip)
// before group g + 1's, so the strips of one expert's weights are read
// from device memory about once and from L2 by its other row tiles.
template <typename E, int WG, int BN, bool TRANS>
__global__ void __launch_bounds__(WG * hopper::kWarpgroup, 1)
    grouped_fwd_wgmma_kernel(const E* __restrict__ lhs,
                             const E* __restrict__ rhs,
                             const int* __restrict__ sizes,
                             E* __restrict__ out, int m, int k,
                             int n, int e, int n_tiles) {
  using namespace hopper;
  constexpr int BM = 64 * WG, THREADS = WG * kWarpgroup;
  constexpr int kABytes = BM * kGemmBK * 2, kStage = kABytes + BN * kGemmBK * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(base);
  // this block's group, row tile and column strip
  int rest = blockIdx.x, g = 0, start = 0, row0 = -1, row_end = 0, n0 = 0;
  for (; g < e; ++g) {
    const int sz = max(sizes[g], 0);
    const int tiles = (sz + BM - 1) / BM;
    if (rest < tiles * n_tiles) {
      row0 = start + (rest % tiles) * BM;
      n0 = (rest / tiles) * BN;
      row_end = min(start + sz, m);
      break;
    }
    rest -= tiles * n_tiles;
    start += sz;
  }
  if (row0 < 0 || row0 >= row_end) return;  // past the live tiles
  const int nrows = min(BM, row_end - row0);
  const E* x = lhs + (size_t)row0 * k;
  const E* w = rhs + (size_t)g * k * n;
  const int nk = (k + kGemmBK - 1) / kGemmBK;
  // stage `step % kGemmStages` <- k slab `step`, zero-filled past the
  // group's rows, past k and past n; every thread commits one group
  auto load = [&](int step) {
    if (step < nk) {
      const uint32_t st = s0 + (step % kGemmStages) * kStage;
      const int k0 = step * kGemmBK;
      load_tile_masked<BM, kGemmBK, THREADS>(st, x + k0, k, nrows, k - k0);
      if (TRANS)
        load_tile_masked<BN, kGemmBK, THREADS>(
            st + kABytes, w + (size_t)n0 * k + k0, k, n - n0, k - k0);
      else
        load_tile_masked<kGemmBK, BN, THREADS>(
            st + kABytes, w + (size_t)k0 * n + n0, n, k - k0, n - n0);
    }
    cp_async_commit();
  };

  // a warpgroup whose 64 rows all lie past the group's end (the tail
  // tile of a group) loads with the others but multiplies nothing. The
  // warpgroup index is broadcast from lane 0 so that the compiler sees
  // the branch as uniform over each warp: a branch it must treat as
  // divergent makes it serialize every wgmma inside it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const bool live = 64 * wg < nrows;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  reg_fence(acc);
  for (int st = 0; st < kGemmStages - 2; ++st) load(st);
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kGemmStages - 3>();  // slab it landed
    fence_async_smem();
    // every thread's copies of slab it are visible, and every warpgroup
    // has retired its product of slab it - 2, whose stage the next load
    // takes
    __syncthreads();
    load(it + kGemmStages - 2);
    if (live) {
      const uint32_t a = s0 + (it % kGemmStages) * kStage + wg * 64 * 128;
      const uint32_t b = s0 + (it % kGemmStages) * kStage + kABytes;
      // (acc is not fenced here: the product of slab it - 1 may still
      // own it)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
        mma_ss<E, BN, (TRANS ? 0 : 1)>(acc, desc_kmajor<64>(a, kk),
                                  TRANS ? desc_kmajor<BN>(b, kk)
                                        : desc_mnmajor<kGemmBK>(b, kk));
      wgmma_commit();
      wgmma_wait<1>();  // slab it - 1's product retired
    }
  }
  if (!live) return;
  wgmma_wait<0>();
  reg_fence(acc);
  // fp32 accumulator -> E, once; rows past the group's end and
  // columns past n are not written
  const int warp = (threadIdx.x % kWarpgroup) >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + 64 * wg + 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= row_end) continue;
    E* orow = out + (size_t)r * n + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + c0;
      if (n0 + c < n)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack2<E>(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

template <typename E, int WG, int BN>
int launch_fwd_wgmma(int trans, const void* lhs, const void* rhs,
                     const void* sizes, void* out, int m, int k, int n, int e,
                     void* stream) {
  constexpr int BM = 64 * WG;
  const uintptr_t align = reinterpret_cast<uintptr_t>(lhs) |
                          reinterpret_cast<uintptr_t>(rhs) |
                          reinterpret_cast<uintptr_t>(out);
  if (k % 8 != 0 || n % 8 != 0 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + BN - 1) / BN;
  const long long slots = (m + BM - 1) / BM + e;  // static bound
  if (n_tiles * slots > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gemm_wgmma_smem_bytes<WG, BN>();
  auto kernel = trans ? grouped_fwd_wgmma_kernel<E, WG, BN, true>
                      : grouped_fwd_wgmma_kernel<E, WG, BN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles * slots), WG * hopper::kWarpgroup,
           smem, (cudaStream_t)stream>>>(
      static_cast<const E*>(lhs),
      static_cast<const E*>(rhs), static_cast<const int*>(sizes),
      static_cast<E*>(out), m, k, n, e,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core route's tile: two warpgroups (128 rows) by 256 columns,
// the fastest of the shapes chip_smoke.py's k6_tiles phase times
constexpr int kGemmWG = 2, kGemmBN = 256;

// ---------------------------------------------------------------- K6b
// One slab of BK rows of the group into registers: lhs columns k0.. and g
// columns n0..; rows at or past row_end read as 0.
template <typename T, typename C>
__device__ __forceinline__ void dw_load(const T* __restrict__ lhs,
                                        const T* __restrict__ gr, int r0,
                                        int row_end, int k0, int n0, int k,
                                        int n, int tid, float (&ra)[C::AE],
                                        float (&rb)[C::BE]) {
#pragma unroll
  for (int t = 0; t < C::AE; ++t) {
    const int idx = tid + t * C::THREADS;
    const int r = r0 + idx / C::BM, c = k0 + idx % C::BM;
    ra[t] = (r < row_end && c < k) ? to_f(lhs[(size_t)r * k + c]) : 0.f;
  }
#pragma unroll
  for (int t = 0; t < C::BE; ++t) {
    const int idx = tid + t * C::THREADS;
    const int r = r0 + idx / C::BN, c = n0 + idx % C::BN;
    rb[t] = (r < row_end && c < n) ? to_f(gr[(size_t)r * n + c]) : 0.f;
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(C::THREADS, 2)
    grouped_dw_kernel(const T* __restrict__ lhs, const T* __restrict__ gr,
                      const int* __restrict__ sizes, T* __restrict__ drhs,
                      int m, int k, int n) {
  __shared__ float Ls[C::BK][C::BM + 1];
  __shared__ float Gs[C::BK][C::BN + 1];
  const int grp = blockIdx.z;
  int start = 0;
  for (int i = 0; i < grp; ++i) start += max(sizes[i], 0);
  start = min(start, m);
  const int row_end = min(start + max(sizes[grp], 0), m);
  const int k0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int tid = threadIdx.x, tx = tid % C::RX, ty = tid / C::RX;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  float ra[C::AE], rb[C::BE];
  if (start < row_end)
    dw_load<T, C>(lhs, gr, start, row_end, k0, n0, k, n, tid, ra, rb);
  for (int r0 = start; r0 < row_end; r0 += C::BK) {
#pragma unroll
    for (int t = 0; t < C::AE; ++t) {
      const int idx = tid + t * C::THREADS;
      Ls[idx / C::BM][idx % C::BM] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < C::BE; ++t) {
      const int idx = tid + t * C::THREADS;
      Gs[idx / C::BN][idx % C::BN] = rb[t];
    }
    __syncthreads();
    if (r0 + C::BK < row_end)
      dw_load<T, C>(lhs, gr, r0 + C::BK, row_end, k0, n0, k, n, tid, ra, rb);
    fma_slab<C, true>(Ls, Gs, acc, tx, ty, C::TM);
    __syncthreads();
  }
  // an empty group's blocks reach here with acc == 0: exact zeros
  T* o = drhs + (size_t)grp * k * n;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = k0 + i * C::RY + ty;
    if (r >= k) break;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int c = n0 + j * C::RX + tx;
      if (c < n) o[(size_t)r * n + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_dw(const void* lhs, const void* gr, const void* sizes, void* drhs,
              int m, int k, int n, int e, void* stream) {
  using C = Large;
  const int k_tiles = (k + C::BM - 1) / C::BM;
  const int n_tiles = (n + C::BN - 1) / C::BN;
  if (k_tiles > 65535 || e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, k_tiles, e);
  grouped_dw_kernel<T, C><<<grid, C::THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(gr),
      static_cast<const int*>(sizes), static_cast<T*>(drhs), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------- K6b, tensor-core route (bf16 and f16: E)
constexpr int kDwBK = 128;     // k rows of an output tile: two warpgroups
constexpr int kDwBN = 256;     // n columns of an output tile
constexpr int kDwRows = 64;    // group rows per slab: the reduction step
constexpr int kDwStages = 3;   // cp.async ring: one slab loads while one
                               // product runs (deeper rings and 32-row
                               // slabs measured no faster)
constexpr int kDwMaxGroups = 1024;  // row offsets kept in shared memory
// staging row: 512 bytes of E and 16 of padding, so that the eight
// rows a warp's fragment store touches fall in different banks
constexpr int kDwPitch = kDwBN * 2 + 16;
constexpr int kDwStaging = kDwBK * kDwPitch;

// a ring stage: an lhs slab [64 rows][128] and a g slab [64 rows][256]
constexpr int kDwABytes = kDwRows * kDwBK * 2;
constexpr int kDwStage = kDwABytes + kDwRows * kDwBN * 2;

// Dynamic shared memory of the K6b tensor-core route for e groups: the
// ring, the output staging tile and the groups' row offsets, plus the
// slack that aligns the tiles to 1024 bytes.
constexpr int dw_wgmma_smem_bytes(int e) {
  return kDwStages * kDwStage + kDwStaging + 4 * (e + 1) + 1024;
}

// Persistent blocks of two warpgroups. Output tile t of the static list
// (group-major: t = (group * k_tiles + k tile) * n_tiles + n tile, so an
// expert's lhs and g rows come from device memory about once and from L2
// for its other tiles) is drhs[group][k0 .. k0+128][n0 .. n0+256]; block b
// takes tiles b, b + gridDim.x, ... Warpgroup wg owns the 64 k rows
// k0 + 64 wg .. and sums lhs[r][k]^T g[r][n] down the group's rows in
// slabs of 64: both slabs are stored as they lie in memory (lhs [64 r][128
// k], g [64 r][256 n]), so both operands are MN-major (the descriptors'
// transpose bits). Rows past the group's end are zero-filled in both
// operands (no 0 x inf from the next group), and the 16-row steps wholly
// past it are skipped. The slabs of a block's successive tiles form one
// stream through the ring, so the next tile's first slab loads during a
// tile's epilogue. Epilogue: fp32 -> E once, into a staging tile in
// shared memory (stmatrix), which the warpgroup writes to device memory
// with 16-byte stores, a 512-byte row a warp. An empty group's tiles load
// nothing and write exact zeros.
template <typename E>
__global__ void __launch_bounds__(2 * hopper::kWarpgroup, 1)
    grouped_dw_wgmma_kernel(const E* __restrict__ lhs,
                            const E* __restrict__ gr,
                            const int* __restrict__ sizes,
                            E* __restrict__ drhs, int m, int k,
                            int n, int e, int k_tiles, int n_tiles) {
  using namespace hopper;
  constexpr int THREADS = 2 * kWarpgroup;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = smem_addr(base);
  const uint32_t staging = s0 + kDwStages * kDwStage;
  int* seg = reinterpret_cast<int*>(base + kDwStages * kDwStage + kDwStaging);
  // row offsets of the groups, clipped to m (rows past sum(sizes) belong
  // to no group): group g owns rows [seg[g], seg[g + 1])
  if (threadIdx.x == 0) {
    int start = 0;
    for (int i = 0; i < e; ++i) {
      seg[i] = start;
      start = min(start + max(sizes[i], 0), m);
    }
    seg[e] = start;
  }
  __syncthreads();
  const int per_group = k_tiles * n_tiles, tiles = e * per_group;
  struct TileRows {
    int grp, r0, r1, k0, n0;
  };
  auto tile_rows = [&](int t) {
    TileRows v;
    v.grp = t / per_group;
    const int rest = t - v.grp * per_group;
    v.r0 = seg[v.grp];
    v.r1 = seg[v.grp + 1];
    v.k0 = (rest / n_tiles) * kDwBK;
    v.n0 = (rest % n_tiles) * kDwBN;
    return v;
  };
  auto n_slabs = [&](const TileRows& v) {
    return (v.r1 - v.r0 + kDwRows - 1) / kDwRows;
  };

  // the producer's cursor: slab ps of tile pt is the next to load, into
  // stage `loaded % kDwStages`; tiles without rows are passed over
  int pt = blockIdx.x, ps = 0, loaded = 0;
  auto skip_empty = [&]() {
    while (pt < tiles && n_slabs(tile_rows(pt)) == 0) pt += gridDim.x;
  };
  skip_empty();
  // every thread commits one group a call, empty past the last slab
  auto load = [&]() {
    if (pt < tiles) {
      const TileRows v = tile_rows(pt);
      const int row = v.r0 + ps * kDwRows;
      const int nrows = min(kDwRows, v.r1 - row);
      const uint32_t st = s0 + (loaded % kDwStages) * kDwStage;
      load_tile_masked<kDwRows, kDwBK, THREADS>(
          st, lhs + (size_t)row * k + v.k0, k, nrows, k - v.k0);
      load_tile_masked<kDwRows, kDwBN, THREADS>(
          st + kDwABytes, gr + (size_t)row * n + v.n0, n, nrows, n - v.n0);
      ++loaded;
      if (++ps == n_slabs(v)) {
        ps = 0;
        pt += gridDim.x;
        skip_empty();
      }
    }
    cp_async_commit();
  };

  // the warpgroup index and each tile's row count are broadcast from lane
  // 0, so that the compiler sees the branches around wgmma as uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t my_staging = staging + wg * 64 * kDwPitch;
  float acc[kDwBN / 2];
  for (int st = 0; st < kDwStages - 2; ++st) load();
  int used = 0;  // slabs consumed: slab `used` lies in stage used % kDwStages
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileRows v = tile_rows(t);
    const int rows = __shfl_sync(0xffffffffu, v.r1 - v.r0, 0);
#pragma unroll
    for (int i = 0; i < kDwBN / 2; ++i) acc[i] = 0.f;
    reg_fence(acc);
    for (int r = 0; r < rows; r += kDwRows, ++used) {
      cp_async_wait<kDwStages - 3>();  // slab `used` landed
      fence_async_smem();
      // every thread's copies of this slab are visible, and both
      // warpgroups have retired the product two slabs back, whose stage
      // the next load takes
      __syncthreads();
      load();
      const uint32_t a =
          s0 + (used % kDwStages) * kDwStage + wg * kDwRows * 128;  // panel wg
      const uint32_t b = s0 + (used % kDwStages) * kDwStage + kDwABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDwRows / 16; ++kk)
        if (r + 16 * kk < rows)  // 16-row steps past the group's end: 0
          mma_ss<E, kDwBN, 1, 1>(acc, desc_mnmajor<kDwRows>(a, kk),
                              desc_mnmajor<kDwRows>(b, kk));
      wgmma_commit();
      wgmma_wait<1>();  // the previous slab's product retired
    }
    wgmma_wait<0>();
    reg_fence(acc);
    // every thread of the warpgroup has read the staging rows it rewrites
    named_barrier(1 + wg, kWarpgroup);
    // fp32 -> E once: thread (warp, lane) holds rows 16 warp + lane / 4
    // (+ 8 hr), columns 8 j + 2 (lane % 4) + {0, 1}, so the 8 x 8 block
    // (j, hr) is one stmatrix operand; each stmatrix writes the blocks
    // (j, 0), (j, 1), (j + 1, 0) and (j + 1, 1), lane l addressing row
    // l % 8 of block l / 8
    {
      const int q = lane >> 3;
      const uint32_t row_addr =
          my_staging + (16 * warp + 8 * (q & 1) + (lane & 7)) * kDwPitch +
          (q >> 1) * 16;
#pragma unroll
      for (int j = 0; j < kDwBN / 8; j += 2) {
        const uint32_t r[4] = {pack2<E>(acc[4 * j], acc[4 * j + 1]),
                               pack2<E>(acc[4 * j + 2], acc[4 * j + 3]),
                               pack2<E>(acc[4 * j + 4], acc[4 * j + 5]),
                               pack2<E>(acc[4 * j + 6], acc[4 * j + 7])};
        stmatrix_x4(row_addr + j * 16, r);
      }
    }
    named_barrier(1 + wg, kWarpgroup);  // the tile is staged
    // to device memory: a warp writes a 512-byte row with one 16-byte
    // store a lane (columns past n and rows past k are not written)
#pragma unroll 4
    for (int i = tid; i < 64 * (kDwBN / 8); i += kWarpgroup) {
      const int rr = i / (kDwBN / 8), cc = i % (kDwBN / 8);
      const int kr = v.k0 + 64 * wg + rr, col = v.n0 + 8 * cc;
      const uint4 val = ld_shared16(my_staging + rr * kDwPitch + cc * 16);
      if (kr < k && col < n)
        *reinterpret_cast<uint4*>(drhs + ((size_t)v.grp * k + kr) * n +
                                  col) = val;
    }
  }
}

// streaming multiprocessors of the current device, asked of the runtime
// once a device (the query is not free, and a launcher runs it each call)
cudaError_t sm_count(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64)
    return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = cached[dev];
  return cudaSuccess;
}

template <typename E>
int launch_dw_wgmma(const void* lhs, const void* gr, const void* sizes,
                    void* drhs, int m, int k, int n, int e, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(lhs) |
                          reinterpret_cast<uintptr_t>(gr) |
                          reinterpret_cast<uintptr_t>(drhs);
  if (k % 8 != 0 || n % 8 != 0 || align % 16 != 0 || e > kDwMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long k_tiles = (k + kDwBK - 1) / kDwBK;
  const long long n_tiles = (n + kDwBN - 1) / kDwBN;
  const long long tiles = e * k_tiles * n_tiles;
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = dw_wgmma_smem_bytes(e);
  err = cudaFuncSetAttribute(grouped_dw_wgmma_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one persistent block an SM (the shared memory allows no second)
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  grouped_dw_wgmma_kernel<E><<<blocks, 2 * hopper::kWarpgroup, smem,
                               (cudaStream_t)stream>>>(
      static_cast<const E*>(lhs), static_cast<const E*>(gr),
      static_cast<const int*>(sizes), static_cast<E*>(drhs), m, k, n, e,
      static_cast<int>(k_tiles), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ K6a, decode route
// 16 bytes of T as floats: 8 bf16 or f16 (through the pair type's own
// conversion: a bf16 is the high half of the fp32 of the same value, an
// f16 is not), or 4 fp32 (the specialization)
template <typename T>
struct Vec16 {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[N]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = pair_f<T>(&u, i);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

constexpr int kDecThreads = 256;     // eight warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecRows = 8;          // rows of a unit: a group's row tile
constexpr int kDecStageW = 16384;    // weight bytes of a ring stage
constexpr int kDecMaxRows = 1024;    // m the per-row tables hold
constexpr int kDecMaxGroups = 256;   // e the group sizes' copy holds
// blocks an SM: a block's stream is held back by its own steps (a wait,
// a conversion, a block barrier per 16 KB), not by the bytes it has in
// flight, so a second block on the SM overlaps them; two blocks' shared
// memory fits an SM's 228 KB
constexpr int kDecBlocksPerSM = 2;

// Shared memory of the decode route for column strips of STRIP bytes:
// the ring (each stage a [kKT] x STRIP weight tile and the unit's lhs
// rows over the same k: one row chunk a row slot, two slots a row with
// DOWN, gate and up), the lhs converted to fp32 ([kKT][kDecRows],
// double-buffered), the warps' partial sums, the barriers, then the
// tables sized by m and e: the row tiles (group, first row, rows), the
// group sizes, each row's source or destination row and, with DOWN, its
// combine weight.
template <typename T, bool DOWN, int STRIP>
struct DecodeSmem {
  // what a block may take when kDecBlocksPerSM blocks share an SM (each
  // block also holds 1 KB the system reserves)
  static constexpr int kSmem = 228 * 1024 / kDecBlocksPerSM - 1024;
  static constexpr int kCols = STRIP / sizeof(T);    // columns of a unit
  static constexpr int kKT = kDecStageW / STRIP;     // k rows of a stage
  static constexpr int kXPitch = kKT * sizeof(T);    // an lhs row chunk
  static constexpr int kXSlots = kDecRows * (DOWN ? 2 : 1);
  static constexpr int kW = kDecStageW;
  static constexpr int kStage = kW + kXSlots * kXPitch;
  static constexpr int kXf = 2 * kKT * kDecRows * 4;
  static constexpr int kRed = kDecWarps * kDecRows * kCols * 4;
  static constexpr int kTables = 16 * ((kDecMaxRows + kDecRows - 1) /
                                           kDecRows + kDecMaxGroups) +
                                 4 * kDecMaxGroups + 8 * kDecMaxRows;
  // as many stages as the rest leaves room for: the bytes in flight
  static constexpr int kStages =
      (kSmem - 1024 - 16 - kXf - kRed - kTables) / (kStage + 8);
  static constexpr int kOffXf = kStages * kStage;
  static constexpr int kOffRed = kOffXf + kXf;
  static constexpr int kOffBar = kOffRed + kRed;
  static constexpr int kOffTiles = kOffBar + (kStages * 8 + 15) / 16 * 16;
  static_assert(kStage % 128 == 0 && kOffTiles % 16 == 0, "alignment");
  __host__ __device__ static constexpr int max_tiles(int m, int e) {
    return (m + kDecRows - 1) / kDecRows + e;
  }
  __host__ __device__ static constexpr int bytes(int m, int e) {
    return 128 + kOffTiles + 16 * max_tiles(m, e) + 4 * e +
           4 * m * (DOWN ? 2 : 1);
  }
};

// F.silu(gate) * up on tensors of type T: silu in fp32 as x / (1 +
// exp(-x)), rounded to T, times up in fp32, rounded to T
template <typename T>
__device__ __forceinline__ float swiglu(float g, float u) {
  const float s = to_f(from_f<T>(g / (1.f + expf(-g))));
  return to_f(from_f<T>(__fmul_rn(s, u)));
}

// Persistent blocks (kDecBlocksPerSM an SM). Every block builds the list
// of row tiles (group, first row, up to kDecRows rows; only the rows below
// min(sum(sizes), m)) from the sizes on the device; a unit is a row tile
// times a STRIP-byte column strip of its group's weights over all of k,
// and block b takes units b, b + gridDim.x, ... in tile-major order, so
// that the blocks that run at once read neighbouring strips of the same
// weight rows. The units' k steps form one stream through the ring, kept
// kStages - 1 steps ahead: a stage's 16 KB weight tile is one box of a
// tensor map, fetched by the tensor memory accelerator, and its lhs row
// chunks 16-byte cp.async pieces, all completing on the stage's barrier
// (one box a stage: a bulk copy a row costs the copy engine a request per
// 128 bytes). Each step, every thread first converts the next step's
// lhs into fp32 (SwiGLU with DOWN), then multiplies this step's: thread t
// owns the 16 bytes t % Q of the strip (V columns; Q = STRIP / 16) and 4
// consecutive k rows of the stage, for all the tile's rows in registers,
// so every staged weight byte is read from shared memory once and
// multiplies every row of the tile. At a unit's last step the partial
// sums of each output are added in a fixed order (lanes, then warps
// through shared memory) and stored: out[row] (lhs rows gathered through
// idx when it is given), or, with DOWN, out[idx[row]] = T(T(sum) *
// T(gate[row] * keep[row])). No atomics: the bits do not depend on which
// block ran a unit. A token picks distinct experts, so at a decode batch
// of up to kDecRows tokens every group is one tile; a larger group is cut
// into tiles of kDecRows rows, and each tile streams the group's strips
// again.
template <typename T, bool DOWN, int STRIP>
__global__ void __launch_bounds__(kDecThreads, kDecBlocksPerSM)
    grouped_decode_kernel(const T* __restrict__ lhs,
                          const int64_t* __restrict__ idx,
                          const T* __restrict__ rhs,
                          const int* __restrict__ sizes,
                          const float* __restrict__ gate,
                          const uint8_t* __restrict__ keep,
                          T* __restrict__ out, int m, int k, int n, int e,
                          const __grid_constant__ CUtensorMap wmap) {
  using namespace hopper;
  using L = DecodeSmem<T, DOWN, STRIP>;
  constexpr int V = Vec16<T>::N, C = L::kCols, S = L::kStages;
  static_assert(S >= 3, "ring");
  constexpr int Q = STRIP / 16;               // 16-byte pieces of a row
  constexpr int KT = L::kKT;
  constexpr int KK = KT / (kDecThreads / Q);  // k rows of a thread
  constexpr int XP = L::kXPitch / 16;         // pieces of an lhs chunk
  static_assert(Q <= 32 && KK >= 1, "strip");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const uint32_t s0 = smem_addr(base);
  float* xf = reinterpret_cast<float*>(base + L::kOffXf);
  float* red = reinterpret_cast<float*>(base + L::kOffRed);
  int4* tiles = reinterpret_cast<int4*>(base + L::kOffTiles);
  int* gsz = reinterpret_cast<int*>(tiles + L::max_tiles(m, e));
  int* row_to = gsz + e;  // the lhs row read (gather) or written (DOWN)
  float* wgt = reinterpret_cast<float*>(row_to + m);
  __shared__ int n_tiles_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t bars = s0 + L::kOffBar;

  if (tid == 0) {
    for (int i = 0; i < S; ++i)
      mbar_init(bars + 8 * i, kDecThreads + 1);
    mbar_init_fence();
  }
  for (int i = tid; i < e; i += kDecThreads) gsz[i] = max(sizes[i], 0);
  if (idx != nullptr)
    for (int i = tid; i < m; i += kDecThreads) {
      row_to[i] = static_cast<int>(idx[i]);
      if (DOWN)  // (gate * keep).to(T), as the unfused combine rounds it
        wgt[i] = to_f(
            from_f<T>(__fmul_rn(gate[i], keep[i] != 0 ? 1.f : 0.f)));
    }
  __syncthreads();
  // the row tiles, group by group: a warp-wide scan of the sizes and of
  // the tiles per group, 32 groups at a time
  if (warp == 0) {
    int rows_before = 0, tiles_before = 0;
    for (int g0 = 0; g0 < e; g0 += 32) {
      const int g = g0 + lane;
      const int sz = g < e ? gsz[g] : 0;
      int rows_incl = sz;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, rows_incl, o);
        if (lane >= o) rows_incl += v;
      }
      const int start = rows_before + rows_incl - sz;
      const int row0 = min(start, m), row_end = min(start + sz, m);
      const int nt = (row_end - row0 + kDecRows - 1) / kDecRows;
      int tiles_incl = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, tiles_incl, o);
        if (lane >= o) tiles_incl += v;
      }
      int t = tiles_before + tiles_incl - nt;
      for (int i = 0; i < nt; ++i, ++t) {
        const int r0 = row0 + i * kDecRows;
        tiles[t] = make_int4(g, r0, min(kDecRows, row_end - r0), 0);
      }
      rows_before += __shfl_sync(0xffffffffu, rows_incl, 31);
      tiles_before += __shfl_sync(0xffffffffu, tiles_incl, 31);
    }
    if (lane == 0) n_tiles_s = tiles_before;
  }
  __syncthreads();

  const int strips = (n + C - 1) / C;
  const int units = n_tiles_s * strips;
  const int nk = (k + KT - 1) / KT;
  const int bid = blockIdx.x, grid = gridDim.x;
  const int total = units > bid ? ((units - 1 - bid) / grid + 1) * nk : 0;
  // a walk over this block's steps in order: unit (tile, column strip)
  // and k step, advanced one step at a time (one division a unit)
  struct Cursor {
    int p, s, u;
    int4 tile;  // group, first row, rows
    int col0;
  };
  auto cursor_at_unit = [&](Cursor& c, int u) {
    c.s = 0;
    c.u = u;
    if (u < units) {
      c.tile = tiles[u / strips];
      c.col0 = (u % strips) * C;
    }
  };
  auto advance = [&](Cursor& c) {
    ++c.p;
    if (++c.s == nk) cursor_at_unit(c, c.u + grid);
  };
  Cursor pc, cc, mc;  // the copies', the conversion's and the products'
  pc.p = cc.p = mc.p = 0;
  cursor_at_unit(pc, bid);
  cursor_at_unit(cc, bid);
  cursor_at_unit(mc, bid);

  // step pc.p into stage pc.p % S: thread 0 announces the weight box's
  // bytes and has the copy engine fetch it; every thread copies its
  // 16-byte pieces of the lhs row chunks and arrives on the stage's
  // barrier when they have landed
  constexpr int E16 = 16 / sizeof(T);  // elements of a 16-byte piece
  auto issue = [&]() {
    if (pc.p >= total) return;
    const int stage = pc.p % S, k0 = pc.s * KT;
    const int kr = min(KT, k - k0), nrows = pc.tile.z;
    const uint32_t wdst = s0 + stage * L::kStage, xdst = wdst + L::kW;
    if (tid == 0) {  // the stage's weight box, by the copy engine
      mbar_arrive_expect_tx(bars + 8 * stage, L::kW);
      fence_async_smem();  // after the generic reads of the last round
      tma_load_3d(wdst, &wmap, pc.col0, k0, pc.tile.x, bars + 8 * stage);
    }
#pragma unroll
    for (int i = tid; i < L::kXSlots * XP; i += kDecThreads) {
      const int slot = i / XP, pc16 = i % XP;
      const int r = slot % kDecRows, half = slot / kDecRows;
      if (r < nrows && pc16 * E16 < kr) {
        const int row = pc.tile.y + r;
        const T* x =
            DOWN ? lhs + (size_t)row * (2 * k) + half * k + k0
                 : lhs + (size_t)(idx != nullptr ? row_to[row] : row) * k +
                       k0;
        cp_async16(xdst + slot * L::kXPitch + pc16 * 16, x + pc16 * E16,
                   true);
      }
    }
    cp_async_mbar_arrive(bars + 8 * stage);
    advance(pc);
  };
  // every thread: wait for step cc.p's stage, convert its lhs into
  // xf[cc.p & 1] (zeros past the tile's rows and past k)
  auto convert = [&]() {
    const int stage = cc.p % S, kr = min(KT, k - cc.s * KT);
    mbar_wait(bars + 8 * stage, (cc.p / S) & 1);
    const uint8_t* xs = base + stage * L::kStage + L::kW;
    float* dst = xf + (cc.p & 1) * KT * kDecRows;
#pragma unroll
    for (int i = tid; i < KT * kDecRows; i += kDecThreads) {
      const int r = i / KT, kk = i % KT;
      float v = 0.f;
      if (r < cc.tile.z && kk < kr) {
        const T* xr = reinterpret_cast<const T*>(xs + r * L::kXPitch);
        if (DOWN) {
          const T* ur =
              reinterpret_cast<const T*>(xs + (kDecRows + r) * L::kXPitch);
          v = swiglu<T>(to_f(xr[kk]), to_f(ur[kk]));
        } else {
          v = to_f(xr[kk]);
        }
      }
      dst[kk * kDecRows + r] = v;
    }
    advance(cc);
  };

  const int cq = tid % Q, kq = tid / Q;
  float acc[kDecRows][V];
#pragma unroll
  for (int r = 0; r < kDecRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;

  for (int p = 0; p < S - 1; ++p) issue();
  if (total > 0) convert();
  __syncthreads();
  for (int p = 0; p < total; ++p) {
    // stage (p - 1) % S was last read before the barrier that ended step
    // p - 1: refill it with step p + S - 1
    issue();
    if (p + 1 < total) convert();
    const int nrows = mc.tile.z, kr = min(KT, k - mc.s * KT);
    const uint8_t* ws = base + (p % S) * L::kStage;
    const float* xs = xf + (p & 1) * KT * kDecRows;
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      const int kk = kq * KK + j;
      if (kk >= kr) break;
      float wf[V];
      Vec16<T>::unpack(
          *reinterpret_cast<const uint4*>(ws + kk * STRIP + cq * 16), wf);
      const float4 xa = *reinterpret_cast<const float4*>(xs + kk * kDecRows);
      const float4 xb =
          *reinterpret_cast<const float4*>(xs + kk * kDecRows + 4);
      const float xv[kDecRows] = {xa.x, xa.y, xa.z, xa.w,
                                  xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        if (r >= nrows) break;  // block-uniform
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xv[r], wf[v], acc[r][v]);
      }
    }
    if (mc.s == nk - 1) {
      // the unit's last step: the lanes that share columns (l % Q), then
      // the warps in order
#pragma unroll
      for (int r = 0; r < kDecRows; ++r) {
        if (r >= nrows) break;
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int o = Q; o < 32; o <<= 1)
            acc[r][v] += __shfl_xor_sync(0xffffffffu, acc[r][v], o);
      }
      if (lane < Q)
#pragma unroll
        for (int r = 0; r < kDecRows; ++r) {
          if (r >= nrows) break;
#pragma unroll
          for (int v = 0; v < V; ++v)
            red[(warp * kDecRows + r) * C + cq * V + v] = acc[r][v];
        }
      __syncthreads();
      for (int i = tid; i < nrows * C; i += kDecThreads) {
        const int r = i / C, c = i % C, col = mc.col0 + c;
        if (col >= n) continue;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w)
          sum += red[(w * kDecRows + r) * C + c];
        const int row = mc.tile.y + r;
        if (DOWN)
          out[(size_t)row_to[row] * n + col] =
              from_f<T>(__fmul_rn(to_f(from_f<T>(sum)), wgt[row]));
        else
          out[(size_t)row * n + col] = from_f<T>(sum);
      }
#pragma unroll
      for (int r = 0; r < kDecRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
    }
    advance(mc);
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (the library
// links nothing beyond the CUDA runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the strip width of the decode route's units: 256 bytes (chip_smoke.py's
// k6_decode_strips phase builds the kernel at 128 too, in a library of its
// own, and times both: the narrower strip balances Qwen-MoE's gate_up
// better, the wider one streams the down product and Mixtral's both faster)
constexpr int kDecStrip = 256;

// lhs [*, k] (DOWN: gu [m, 2k]) and rhs 16-byte aligned, k and n whole
// 16-byte pieces of T, m <= kDecMaxRows, e <= kDecMaxGroups (the wrapper's
// fwd_route checks; here they are refused)
template <typename T, bool DOWN, int STRIP>
int launch_decode(const void* lhs, const void* idx, const void* rhs,
                  const void* sizes, const void* gate, const void* keep,
                  void* out, int m, int k, int n, int e, void* stream) {
  using L = DecodeSmem<T, DOWN, STRIP>;
  constexpr int V = Vec16<T>::N;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs);
  if (k % V != 0 || n % V != 0 || align % 16 != 0 || m > kDecMaxRows ||
      e > kDecMaxGroups || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DOWN && (idx == nullptr || gate == nullptr || keep == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = grouped_decode_kernel<T, DOWN, STRIP>;
  static bool attr = false;  // the attribute outlives the launch
  if (!attr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::bytes(kDecMaxRows, kDecMaxGroups));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const long long strips = (n + L::kCols - 1) / L::kCols;
  const long long units = (long long)L::max_tiles(m, e) * strips;
  if (units > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = (long long)sms * kDecBlocksPerSM;
  const int blocks = static_cast<int>(units < slots ? units : slots);
  // rhs as a 3-d tensor (n, k, e), boxes of one unit's strip over a
  // stage's k rows; rows past k and columns past n read as zeros
  CUtensorMap wmap{};
  {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)k, (cuuint64_t)e};
    const cuuint64_t strides[2] = {(cuuint64_t)n * sizeof(T),
                                   (cuuint64_t)k * n * sizeof(T)};
    const cuuint32_t box[3] = {L::kCols, L::kKT, 1};
    const cuuint32_t one[3] = {1, 1, 1};
    const CUtensorMapDataType dt =
        std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    static_assert(std::is_same<T, float>::value ||
                      std::is_same<T, __half>::value ||
                      std::is_same<T, __nv_bfloat16>::value,
                  "fp32, f16 or bf16 weights");
    if (encode(&wmap, dt, 3, const_cast<void*>(rhs), dims, strides, box, one,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, kDecThreads, L::bytes(m, e), (cudaStream_t)stream>>>(
      static_cast<const T*>(lhs), static_cast<const int64_t*>(idx),
      static_cast<const T*>(rhs), static_cast<const int*>(sizes),
      static_cast<const float*>(gate), static_cast<const uint8_t*>(keep),
      static_cast<T*>(out), m, k, n, e, wmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (lhs, rhs and out alike).
// lhs [m, k],
// sizes [e] int32 on the device, out [m, n]. trans == 0: rhs [e, k, n];
// trans != 0: rhs [e, n, k], read transposed (the backward's dlhs). kind
// picks the kernel (the wrapper's fwd_route decides from the static
// shapes, the dtype and the alignment): 0 the FMA tile, 1 the decode
// route (a few rows per group; no transposed rhs), 2 the tensor-core tile
// (bf16 or f16, k and n multiples of 8, 16-byte-aligned pointers). Rows past
// sum(sizes) are not written.
extern "C" int grouped_fwd(int dtype, int trans, int kind, const void* lhs,
                           const void* rhs, const void* sizes, void* out,
                           int m, int k, int n, int e, void* stream) {
  if (m <= 0 || n <= 0 || e <= 0) return 0;
  if (kind == 1 && trans) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 2)
    return with_half(dtype, [&](auto h) {
      return launch_fwd_wgmma<decltype(h), kGemmWG, kGemmBN>(
          trans, lhs, rhs, sizes, out, m, k, n, e, stream);
    });
#define PTT_GFWD(T)                                                        \
  return kind == 1                                                         \
             ? launch_decode<T, false, kDecStrip>(lhs, nullptr, rhs, sizes, \
                                                  nullptr, nullptr, out, m, \
                                                  k, n, e, stream)          \
             : launch_fwd<T, Large>(trans, lhs, rhs, sizes, out, m, k, n, \
                                    e, stream)
  if (dtype == kF32) PTT_GFWD(float);
  return with_half(dtype, [&](auto h) { PTT_GFWD(decltype(h)); });
#undef PTT_GFWD
}

// The MoE layer's two expert products at the decode shape, on the decode
// route, with the layer's glue folded in. sizes [e] int32 on the device;
// dtype as above for lhs, rhs and out.
//   down == 0 (gate_up): out[i] = lhs[idx[i]] @ rhs[g(i)], lhs [*, k] the
//     layer's tokens, idx [m] int64 the token of sorted row i (null: row
//     i itself), out [m, n].
//   down == 1: out[idx[i]] = T(T(act[i] @ rhs[g(i)]) * T(gate[i] *
//     keep[i])), act[i] = T(T(silu(gate half)) * up half) of lhs [m, 2k]
//     (the gate_up product), idx [m] int64 the destination row (the
//     sort's order), gate [m] float32, keep [m] bool; out [m, n]
//     choice-major.
// Rows past sum(sizes) are neither read nor written.
extern "C" int grouped_decode(int dtype, int down, const void* lhs,
                              const void* idx, const void* rhs,
                              const void* sizes, const void* gate,
                              const void* keep, void* out, int m, int k,
                              int n, int e, void* stream) {
  if (m <= 0 || n <= 0 || e <= 0) return 0;
#define PTT_GDEC(T)                                                        \
  return down ? launch_decode<T, true, kDecStrip>(lhs, idx, rhs, sizes,    \
                                                  gate, keep, out, m, k, n, \
                                                  e, stream)               \
              : launch_decode<T, false, kDecStrip>(lhs, idx, rhs, sizes,   \
                                                   nullptr, nullptr, out,  \
                                                   m, k, n, e, stream)
  if (dtype == kF32) PTT_GDEC(float);
  return with_half(dtype, [&](auto h) { PTT_GDEC(decltype(h)); });
#undef PTT_GDEC
}

// lhs [m, k], g [m, n], sizes [e] int32 -> drhs [e, k, n], every element
// written (zeros for an empty group). kind picks the kernel (the
// wrapper's dw_route decides from the static shapes, the dtype and the
// alignment): 0 the FMA tile, 2 the tensor-core tile (bf16 or f16, k and n
// multiples of 8, 16-byte-aligned pointers, at most kDwMaxGroups groups).
extern "C" int grouped_dw(int dtype, int kind, const void* lhs,
                          const void* g, const void* sizes, void* drhs, int m,
                          int k, int n, int e, void* stream) {
  if (k <= 0 || n <= 0 || e <= 0) return 0;
  if (kind == 2)
    return with_half(dtype, [&](auto h) {
      return launch_dw_wgmma<decltype(h)>(lhs, g, sizes, drhs, m, k, n, e,
                                          stream);
    });
  if (kind != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return launch_dw<float>(lhs, g, sizes, drhs, m, k, n, e, stream);
  return with_half(dtype, [&](auto h) {
    return launch_dw<decltype(h)>(lhs, g, sizes, drhs, m, k, n, e, stream);
  });
}
