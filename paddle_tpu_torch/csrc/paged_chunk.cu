// K3 — ragged multi-query (chunk) attention over a paged KV pool, Hopper.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py _paged_chunk_kernel
// (via paged_chunk_attention_pallas), both its modes. Row a of the batch
// holds chunk_lens[a] queries at positions offsets[a] ..
// offsets[a]+chunk_lens[a]-1 and attends causally over pool positions
// [0, offsets[a]+chunk_lens[a]) read straight from the block pool through
// its table row (the gathered K/V is never materialised). q [A, C, H, D];
// pools [N, bs, Hkv, D]; tables [A, MB] int32 with the sentinel N on
// unused slots (clamped, never read past the row's live length); o like
// q, acc / l divided as the reference's kernel does (so o is the partials
// mode's triple finalized by finalize_partials, bit for bit). Dead rows
// (chunk_lens == 0) and padding query rows write 0. partials
// mode (context parallelism) writes the un-normalised triple acc [A, C,
// H, D], m and l [A, C, H] (fp32, m the natural log of the scaled scores)
// over the table entries < N only — the others belong to another shard and
// are skipped — with m = -1e30, l = 0, acc = 0 for dead and padding rows
// and rows with no owned visible key.
//
// The H/H_kv query heads of one KV head fold into the query tile (folded
// row t = query t / G, head kvh*G + t % G — the reference's GQA fold), so
// every K/V element a block loads serves all G heads, for any G. One
// block per (64 folded rows, kv head, batch row); the block walks the
// row's table only up to the causal frontier of its last live query and
// from the window's lower edge of its first. Two routes, by q's dtype
// (ops/cuda/paged_attention.py chunk_route):
//
//   bf16 and f16 — paged_chunk_wgmma_kernel<E> (E q's 2-byte type), on
//     the tensor cores. At the serving
//     shapes the work is ~2 * 64 flops a K/V byte per q tile, so fp32 FMAs
//     on the CUDA cores bound the FMA route far above the bytes; this route
//     is K2's (flash_fwd.cu): one warpgroup owns the 64-row folded q tile,
//     S = Q K^T as wgmma m64n64k16 (Q's fragments held in registers, K
//     from a 128-byte-swizzled shared tile), the base-2 online softmax on
//     the accumulator fragment, P from registers in O += P V with V read
//     transposed, two cp.async stages, three blocks an SM. What differs is
//     the gather: each of a tile's 64 keys is one pool row of D * 2
//     contiguous bytes, found through the table (each lane of a warp loads
//     one of the tile's table entries a tile ahead; the rows take theirs
//     by shuffle, their positions walked without a division), and rows
//     past the block's causal frontier or the row's length are
//     zero-filled, so stale pool contents never meet a zero probability
//     in P V. Element masks run only on tiles that cross the causal
//     diagonal, the window's edge or the frontier (and on every tile in
//     partials mode, for the ownership of each key).
//     int8 pools: the codes and their row scales stream in by cp.async
//     into a staging ring, and each tile is dequantized into the same
//     swizzled tiles of E (code times row scale, rounded once to q's type,
//     bf16 or f16) before its products. That adds one rounding of K and V
//     that the plain version (k.float() * scale in fp32) does not have; the
//     card tests' tolerance covers it.
//   fp32 — paged_chunk_kernel, fp32 FMAs on the CUDA cores
//     (attn_tile.cuh): exact to the card tests' 1e-4, which TF32 tensor
//     cores are not. Over int8 pools the tile fill dequantizes each element
//     in fp32 (the plain version's k.float() * scale).
#include <type_traits>

#include "attn_tile.cuh"
#include "hopper_mma.cuh"

using namespace ptt;

namespace {

constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ FMA route
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
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int C, int H, int Hkv,
                       int N, int bs, int MB, float scale, int window,
                       int partials) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * D;
  float* v_s = k_s + kBK * (D + 1);
  int* own_s = reinterpret_cast<int*>(v_s + kBK * D);   // [kBK]
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
    kend = min(off + (min(t0 + kBQ, nrows) - 1) / G + 1,   // causal frontier
               MB * bs);
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
      const int e = trow[pos / bs];
      const bool own = !partials || e < N;   // another shard's entry: 0
      const int blk = min(max(e, 0), N - 1);
      const size_t row = (size_t)(blk * bs + pos % bs) * Hkv + kvh;
      const size_t src = row * D + d;
      k_s[j * (D + 1) + d] = own ? pool_at(kp, ks, src, row) : 0.f;
      v_s[j * D + d] = own ? pool_at(vp, vs, src, row) : 0.f;
      if (d == 0) own_s[j] = own;
    }
    __syncthreads();
    tile_update<D>(q_s, k_s, v_s, nk, scale, st, [&](int row, int j) {
      const int t = t0 + row;
      if (t >= nrows || !own_s[j]) return false;
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
    const size_t orow = (size_t)(a * C + t / G) * H + kvh * G + t % G;
    if (partials) {
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        acc_out[orow * D + lane + 32 * c] = st.acc[r][c];
      if (lane == 0) {
        m_out[orow] = l > 0.f ? st.m[r] : kNegBig;
        l_out[orow] = l;
      }
    } else {
      // acc / l, as the reference's kernel and finalize_partials divide:
      // the output is then the bits of the partials mode's finalized triple
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        o[orow * D + lane + 32 * c] =
            from_f<T>(l > 0.f ? st.acc[r][c] / l : 0.f);
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tables, *offsets, *chunk_lens;
  void *o, *acc, *m, *l;
  int A, C, H, Hkv, N, bs, MB;
  float scale;
  int window, partials;
  cudaStream_t stream;
};

template <int D, typename T, typename KV>
int launch(const Args& a) {
  constexpr int kSmem =
      smem_floats<D>() * static_cast<int>(sizeof(float)) + kBK * 4;
  auto kern = paged_chunk_kernel<D, T, KV>;
  static bool attr = false;   // the attribute outlives the launch
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int G = a.H / a.Hkv;
  dim3 grid((a.C * G + kBQ - 1) / kBQ, a.Hkv, a.A);
  kern<<<grid, kWarps * 32, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.offsets),
      static_cast<const int*>(a.chunk_lens), static_cast<T*>(a.o),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.C, a.H, a.Hkv, a.N, a.bs, a.MB, a.scale,
      a.window, a.partials);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- tensor-core route
constexpr int kTile = 64;  // folded q rows a block, keys a step (wgmma m64)
constexpr int kStages = 2;  // K/V tiles (or codes): one lands, one computes

// Dynamic shared memory: (pools of E) kStages stages of K and V tiles, or
// (int8 pools) one K and one V tile and kStages stages of staged codes
// [64][D] bytes each with their [64] K and V scales; then the rows'
// ownership flags [kStages][64]; plus the slack that aligns the swizzled
// tiles to 1024 bytes. The q tile lives in registers.
template <int D, bool kI8>
struct ChunkLayout {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kCodes = kTile * D;                    // a K or V
  static constexpr int kStaging = 2 * kCodes + 2 * kTile * 4;  // a stage
  static constexpr int kKV = (kI8 ? 1 : kStages) * 2 * kTileBytes;
  static constexpr int kFlags = kKV + (kI8 ? kStages * kStaging : 0);
  static constexpr int kBytes = kFlags + kStages * kTile + 1024;
};

// three blocks an SM (their shared memory fits three times): the wider
// pool of blocks hides their ramp-up better than the registers a third of
// them gives up (ptxas spills a few words at D = 128)
template <typename E, int D, bool kI8>
__global__ void __launch_bounds__(hopper::kWarpgroup, 3)
    paged_chunk_wgmma_kernel(const E* __restrict__ q,
                             const void* __restrict__ kp_,
                             const void* __restrict__ vp_,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const int* __restrict__ tables,
                             const int* __restrict__ offsets,
                             const int* __restrict__ chunk_lens,
                             E* __restrict__ o,
                             float* __restrict__ acc_out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int C, int H,
                             int Hkv, int N, int bs, int MB, float scale,
                             int window, int partials) {
  using namespace hopper;
  using Lay = ChunkLayout<D, kI8>;
  constexpr int kTileBytes = Lay::kTileBytes;
  constexpr int kChunks = D / 8;   // 16-byte chunks of E a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  uint8_t* const staging = gbase + Lay::kKV;        // int8: kStages stages
  uint8_t* const flags = gbase + Lay::kFlags;       // [kStages][64]
  const int kvh = blockIdx.x, a = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * kTile;   // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / Hkv;
  const int off = offsets[a];
  const int nrows = max(chunk_lens[a], 0) * G;     // live folded rows
  int kbeg = 0, kend = 0;
  if (t0 < nrows) {
    kend = min(off + (min(t0 + kTile, nrows) - 1) / G + 1, MB * bs);
    if (window > 0) kbeg = max(0, off + t0 / G - window + 1);
  }
  const int ntiles = kend > kbeg ? (kend - kbeg + kTile - 1) / kTile : 0;
  const int qp_first = off + t0 / G;
  const int qp_last = off + (min(t0 + kTile, max(nrows, 1)) - 1) / G;
  const int* trow = tables + (size_t)a * MB;

  // A thread copies rows r, r + step, ... of a tile, walking their
  // positions as (table index bi past the tile's first, offset o in its
  // block) with one division a tile. row() gives the pool row (element
  // offset / D) of the current one and whether it is read at all: below
  // the frontier and, in partials mode, owned; ent is this lane's table
  // entry of the tile (one load a lane), shared by shuffle.
  struct Walk {
    int pos, bi, o;
  };
  auto walk = [&](int k0, int r) {
    const int pos = k0 + r;
    return Walk{pos, pos / bs - k0 / bs, pos % bs};
  };
  auto step = [&](Walk& w, int n) {
    w.pos += n;
    w.o += n;
    while (w.o >= bs) {
      w.o -= bs;
      ++w.bi;
    }
  };
  auto this_row = [&](const Walk& w, int blk0, int ent,
                      bool& ok) -> size_t {
    int e = __shfl_sync(0xffffffffu, ent, w.bi & 31);
    ok = w.pos < kend;
    if (w.bi >= 32) e = ok ? trow[blk0 + w.bi] : 0;  // blocks under 3 keys
    if (partials) ok = ok && e < N;
    e = min(max(e, 0), N - 1);
    return ok ? ((size_t)e * bs + w.o) * Hkv + kvh : 0;
  };
  auto table_ent = [&](int t) {
    const int blk0 = (kbeg + t * kTile) / bs;
    return blk0 + lane < MB ? trow[blk0 + lane] : N;
  };

  // tile t's K and V (pools of E) or codes and row scales (int8 pools,
  // 16 codes a chunk) into stage t % kStages, by cp.async; ent is this
  // lane's table entry of the tile, loaded a tile ahead
  auto load_kv = [&](int t, int ent) {
    const int k0 = kbeg + t * kTile, st = t % kStages;
    const int blk0 = k0 / bs;
    if constexpr (kI8) {
      uint8_t* sg = staging + st * Lay::kStaging;
      const auto* kp = static_cast<const int8_t*>(kp_);
      const auto* vp = static_cast<const int8_t*>(vp_);
      constexpr int kC16 = D / 16, kStep = kWarpgroup / kC16;
      const int c = tid % kC16;
      Walk w = walk(k0, tid / kC16);
#pragma unroll
      for (int it = 0; it < kTile / kStep; ++it, step(w, kStep)) {
        const int r = it * kStep + tid / kC16;
        bool ok;
        const size_t row = this_row(w, blk0, ent, ok);
        cp_async16(smem_addr(sg + r * D + c * 16), kp + row * D + c * 16,
                   ok);
        cp_async16(smem_addr(sg + Lay::kCodes + r * D + c * 16),
                   vp + row * D + c * 16, ok);
        if (c == 0) {
          float* sc = reinterpret_cast<float*>(sg + 2 * Lay::kCodes);
          cp_async4(smem_addr(sc + r), ks + row, ok);
          cp_async4(smem_addr(sc + kTile + r), vs + row, ok);
          flags[st * kTile + r] = ok;
        }
      }
    } else {
      const uint32_t k_s = base + st * 2 * kTileBytes;
      const auto* kp = static_cast<const E*>(kp_);
      const auto* vp = static_cast<const E*>(vp_);
      constexpr int kStep = kWarpgroup / kChunks;
      const int c = tid % kChunks;
      Walk w = walk(k0, tid / kChunks);
#pragma unroll
      for (int it = 0; it < kTile / kStep; ++it, step(w, kStep)) {
        const int r = it * kStep + tid / kChunks;
        bool ok;
        const size_t row = this_row(w, blk0, ent, ok);
        cp_async16(k_s + sw128<kTile>(r, c), kp + row * D + c * 8, ok);
        cp_async16(k_s + kTileBytes + sw128<kTile>(r, c),
                   vp + row * D + c * 8, ok);
        if (c == 0) flags[st * kTile + r] = ok;
      }
    }
  };
  // int8 pools: staged tile t to the K and V tiles in E (zero codes and
  // scales of rows that were not read give 0)
  auto dequantize = [&](int t) {
    const uint8_t* sg = staging + (t % kStages) * Lay::kStaging;
    const float* sc = reinterpret_cast<const float*>(sg + 2 * Lay::kCodes);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv)
#pragma unroll
      for (int it = 0; it < kTile * kChunks / kWarpgroup; ++it) {
        const int i = it * kWarpgroup + tid;
        const int r = i / kChunks, c = i % kChunks;
        const uint2 w = *reinterpret_cast<const uint2*>(
            sg + kv * Lay::kCodes + r * D + c * 8);
        const char4* cc = reinterpret_cast<const char4*>(&w);
        const float s = sc[kv * kTile + r];
        uint4 out;
        out.x = pack2<E>(cc[0].x * s, cc[0].y * s);
        out.y = pack2<E>(cc[0].z * s, cc[0].w * s);
        out.z = pack2<E>(cc[1].x * s, cc[1].y * s);
        out.w = pack2<E>(cc[1].z * s, cc[1].w * s);
        *reinterpret_cast<uint4*>(gbase + kv * kTileBytes +
                                  sw128<kTile>(r, c)) = out;
      }
  };

  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // columns 8j + c0 + {0, 1}
  // the q tile as the A operand of S = Q K^T, in registers: folded row r
  // is query (t0 + r) / G of head kvh * G + (t0 + r) % G; k step kk holds
  // columns 16kk + c0 + {0, 1} and + 8 of rows r0 and r0 + 8
  uint32_t qa[D / 16][4];
  int qp[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int t = t0 + r0 + 8 * hr;
    const bool ok = t < nrows;             // padding rows: zeros
    qp[hr] = off + t / G;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (ok ? ((size_t)(a * C + t / G) * H + kvh * G + t % G) * D : 0));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][hr] = ok ? qrow[(16 * kk + c0) / 2] : 0u;
      qa[kk][2 + hr] = ok ? qrow[(16 * kk + 8 + c0) / 2] : 0u;
    }
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_kv(st, table_ent(st));
    cp_async_commit();
  }
  int ent_next = kStages - 1 < ntiles ? table_ent(kStages - 1) : N;
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = scale * kLog2e;        // scores -> log2 units
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kbeg + t * kTile;
    cp_async_wait<kStages - 2>();   // tile t landed
    if constexpr (!kI8) fence_async_smem();
    __syncthreads();   // ... for every thread; tile t - 1 is consumed
    if (t + kStages - 1 < ntiles) load_kv(t + kStages - 1, ent_next);
    cp_async_commit();
    if (t + kStages < ntiles) ent_next = table_ent(t + kStages);
    uint32_t k_s = base + (t % kStages) * 2 * kTileBytes;
    if constexpr (kI8) {
      dequantize(t);
      fence_async_smem();
      __syncthreads();
      k_s = base;
    }
    const uint32_t v_s = k_s + kTileBytes;
    const uint8_t* own = flags + (t % kStages) * kTile;
    // S = Q K^T on the tensor cores, Q from registers
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_rs_n64<E, 0>(s, qa[kk], desc_kmajor<kTile>(k_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    // element masks only on a tile that crosses the frontier, the causal
    // diagonal or the window's lower edge, and every tile in partials mode
    const bool edge = partials || k0 + kTile > kend ||
                      k0 + kTile - 1 > qp_first ||
                      (window > 0 && qp_last - k0 >= window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * j + c0 + (i & 1);
          const int kpos = k0 + col;
          const int qpos = qp[i >> 1];
          const bool ok = kpos < kend && kpos <= qpos &&
                          (window <= 0 || qpos - kpos < window) && own[col];
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
      const float m_new = fmaxf(m[hr], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[hr] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hr + e];
          x = exp2f(fmaf(x, sl2, -m_use));
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
      mma_rs<E, D>(acc, pa[kk], desc_mnmajor<kTile>(v_s, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float sum = l[hr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int t = t0 + r0 + 8 * hr;
    if (t >= C * G) continue;              // no such folded row
    const bool live = t < nrows && sum > 0.f;
    const size_t orow = (size_t)(a * C + t / G) * H + kvh * G + t % G;
    if (partials) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(acc_out + orow * D + 8 * j + c0) =
            live ? make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1])
                 : make_float2(0.f, 0.f);
      if ((lane & 3) == 0) {
        m_out[orow] = live ? m[hr] * kLn2 : kNegBig;
        l_out[orow] = live ? sum : 0.f;
      }
    } else {
      // divided, not scaled by 1 / sum: the FMA route's and the
      // reference's normalisation (finalize_partials of the triple)
      const float den = live ? sum : 1.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + orow * D + 8 * j + c0) =
            pack2<E>(live ? acc[4 * j + 2 * hr] / den : 0.f,
                     live ? acc[4 * j + 2 * hr + 1] / den : 0.f);
    }
  }
}

template <typename E, int D, bool kI8>
int launch_wgmma(const Args& a) {
  constexpr int kSmem = ChunkLayout<D, kI8>::kBytes;
  auto kern = paged_chunk_wgmma_kernel<E, D, kI8>;
  static bool attr = false;   // the attribute outlives the launch
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int G = a.H / a.Hkv;
  dim3 grid(a.Hkv, a.A, (a.C * G + kTile - 1) / kTile);
  kern<<<grid, hopper::kWarpgroup, kSmem, a.stream>>>(
      static_cast<const E*>(a.q), a.kp, a.vp,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.offsets),
      static_cast<const int*>(a.chunk_lens),
      static_cast<E*>(a.o), static_cast<float*>(a.acc),
      static_cast<float*>(a.m), static_cast<float*>(a.l), a.C, a.H, a.Hkv,
      a.N, a.bs, a.MB, a.scale, a.window, a.partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q and o): 0 = float32 (FMA route), 1 = bfloat16 or 2 =
// float16 (tensor-core route; pools of q's type or int8); head_dim: 64 or 128; window <= 0 means no sliding window.
// k_scale / v_scale null: the pools hold q's type; non-null: the pools
// hold int8 codes and these are their fp32 [N, bs, Hkv] scales. q and the
// pools 16-byte aligned. partials = 0 writes o; partials = 1 writes acc
// [A, C, H, D], m and l [A, C, H] (fp32) over the table entries < N.
extern "C" int paged_chunk_fwd(int dtype, int head_dim, const void* q,
                               const void* k_pool, const void* v_pool,
                               const void* k_scale, const void* v_scale,
                               const void* tables, const void* offsets,
                               const void* chunk_lens, void* o, void* acc,
                               void* m, void* l, int A, int C, int H,
                               int Hkv, int N, int bs, int MB, float scale,
                               int window, int partials, void* stream) {
  if (A <= 0 || C <= 0) return 0;
  const Args a{q,   k_pool, v_pool, k_scale, v_scale, tables, offsets,
               chunk_lens, o, acc, m, l, A, C, H, Hkv, N, bs, MB, scale,
               window, partials, static_cast<cudaStream_t>(stream)};
  const bool i8 = k_scale != nullptr;
  if (dtype == kF32 && head_dim == 64)
    return i8 ? launch<64, float, int8_t>(a) : launch<64, float, float>(a);
  if (dtype == kF32 && head_dim == 128)
    return i8 ? launch<128, float, int8_t>(a) : launch<128, float, float>(a);
  return with_half(dtype, [&](auto e) {
    using E = decltype(e);
    if (head_dim == 64)
      return i8 ? launch_wgmma<E, 64, true>(a) : launch_wgmma<E, 64, false>(a);
    if (head_dim == 128)
      return i8 ? launch_wgmma<E, 128, true>(a)
                : launch_wgmma<E, 128, false>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
