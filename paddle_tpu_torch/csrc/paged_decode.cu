// K4 — paged decode attention for Hopper (sm_90a), split over the key
// range (flash-decoding), then merged.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py _paged_decode_kernel
// (via paged_decode_attention_pallas), both its modes. One query per
// sequence over its block-table row: q [B, H, D], pools [N, bs, Hkv, D],
// tables [B, MB] int32 (sentinel N on unused slots), lens [B] (including
// the new token, whose K/V is already in the pool). Normal mode writes o
// [B, H, D] in q's type; a row with lens == 0 writes 0 (the Pallas
// finalize's l = 0 case). partials mode (context parallelism) writes the
// un-normalised online-softmax triple over the table entries < N only
// (the others belong to another shard and are skipped, not clamped):
// acc [B, H, D], m [B, H] (natural log of the scaled scores) and l [B, H],
// all fp32, with m = -1e30, l = 0, acc = 0 for a row with no owned live
// key. With a sliding window only the last `window` positions are visible.
//
// What bounds it on this card: bytes. Every visible K/V element is read
// once and used for 2 * G flops per head dim (G = H / Hkv query heads),
// far below the H100's ~295 flop/byte ridge, so the floor is the live
// pool bytes over device-memory rate; fp32 FMAs on the CUDA cores do the
// arithmetic with room to spare, and the tensor cores would not help.
//
// Design: what moves the bytes is the number of loads in flight, so the
// live key range [lo, L) of a row (lo the window's lower edge, both read
// from lens on the card) is cut into contiguous splits of `chunk` keys and
// the grid is (Hkv, B, nsplit): hundreds of blocks where one block per
// (kv head, row) gave 32 at Mistral's window shape. The host picks nsplit
// and chunk from the shapes alone (ops/cuda/paged_attention.py
// decode_schedule: about 256 blocks, splits of at least 128 keys), never
// from lens; splits past a row's live range exit at once. Inside a split
// a block of 4 warps streams 32-key tiles through a ring of three
// shared-memory stages with 16-byte cp.async copies (four threads a pool
// row, on neighbouring chunks; each row found through the table, its
// entry loaded a tile ahead), so two tiles are in flight while one
// computes. A warp owns 8 keys of a tile: four lanes a key, each over a
// quarter of the head dims, score it against all G heads of the group,
// so a tile needs one max and one sum reduction per head, not one per
// key; then P V runs with lanes on head dims, the probabilities
// broadcast from shared memory. The online softmax runs in base 2
// (log2(e) folded into q). Each warp keeps its own (m, l, acc); they
// merge through shared memory at the end of the split, and the split
// writes o directly (nsplit == 1) or its triple to a workspace [nsplit,
// B, H] that paged_decode_merge_kernel, launched from the same entry
// point, folds in split order — no float atomics, so repeated launches
// are bit-identical.
//
// int8 pools (the reference's `quantized` mode): with k_scale/v_scale
// [N, bs, Hkv] fp32 the pools hold int8 codes, staged as they are (half
// the bytes of bf16) with each row's two scales; a score is (q . codes)
// times the K row's scale, and the V row's scale multiplies the
// probability before P V — the plain version's k.float() * scale, the
// products reassociated.
#include <type_traits>

#include "hopper_mma.cuh"

using namespace ptt;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 32;                      // keys a stage holds
constexpr int kWarpKeys = kTileKeys / kWarps;      // 8 keys a warp scores
constexpr int kParts = 32 / kWarpKeys;             // 4 lanes share a key
constexpr int kRowThreads = kThreads / kTileKeys;  // 4 copy threads a row
constexpr int kStages = 3;
static_assert(kWarpKeys >= 4 && kWarpKeys <= 32 && 32 % kWarpKeys == 0,
              "a warp scores 4 to 32 keys");
constexpr float kNegBig = -1e30f;                  // "no key yet"
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory layout of one instantiation, in bytes: q [G][D] fp32
// (scaled into log2 units), the warps' probabilities [4][G][8], then
// kStages stages of K [32][RS] and V [32][RS] (a pool row padded by 16
// bytes, so the 8 lanes of a 16-byte load phase hit distinct banks), the
// rows' valid flags [32] and, over int8 pools, their K and V scales.
// After the key loop the stages hold the warps' merge.
template <int D, int G, typename KV>
struct DecLayout {
  static constexpr bool kI8 = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int kPieces = kRowBytes / 16;   // 16-byte pieces a row
  static_assert(kPieces % kParts == 0 && kPieces % kRowThreads == 0,
                "pieces split evenly over lanes and copy threads");
  static constexpr int kRS = kRowBytes + 16;
  static constexpr int kFlags = 2 * kTileKeys * kRS;
  static constexpr int kStage =
      kFlags + kTileKeys * 4 + (kI8 ? 2 * kTileKeys * 4 : 0);
  static constexpr int kQ = G * D * 4;
  static constexpr int kP = kWarps * G * kWarpKeys * 4;
  static constexpr int kMerge = kWarps * G * (D + 2) * 4;
  static constexpr int kRing =
      kStages * kStage > kMerge ? kStages * kStage : kMerge;
  static constexpr int kBytes = kQ + kP + kRing;
};

// 16 bytes of a staged pool row as fp32: 8 bf16 or f16 (this template),
// 4 fp32 or 16 int8 codes
template <typename KV>
struct Piece {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const uint8_t* p, float* f) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = pair_f<KV>(&w, i);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Piece<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const uint8_t* p, float* f) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    f[0] = w.x;
    f[1] = w.y;
    f[2] = w.z;
    f[3] = w.w;
  }
};
template <>
struct Piece<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void load(const uint8_t* p, float* f) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const char4* c = reinterpret_cast<const char4*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[4 * i] = static_cast<float>(c[i].x);
      f[4 * i + 1] = static_cast<float>(c[i].y);
      f[4 * i + 2] = static_cast<float>(c[i].z);
      f[4 * i + 3] = static_cast<float>(c[i].w);
    }
  }
};

// This lane's CD (2 or 4) contiguous head dims of a staged V row as fp32
template <int CD, typename KV>
__device__ __forceinline__ void load_dims(const uint8_t* p, float (&f)[CD]) {
  if constexpr (std::is_same<KV, float>::value) {
    if constexpr (CD == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
    } else {
      const float2 w = *reinterpret_cast<const float2*>(p);
      f[0] = w.x, f[1] = w.y;
    }
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    if constexpr (CD == 4) {
      const char4 w = *reinterpret_cast<const char4*>(p);
      f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
    } else {
      const char2 w = *reinterpret_cast<const char2*>(p);
      f[0] = w.x, f[1] = w.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CD / 2; ++i) {
      const float2 x = pair_f<KV>(p, i);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// One split of one (kv head, row): [start, end) of the row's live keys.
// Writes o (o != null: normalised, in T) or the triple at
// [split][b][h] of acc_out / m_out / l_out, m times m_unit (1: the
// workspace's log2 units; ln 2: the partials' natural log).
template <int D, int G, typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const KV* __restrict__ kp,
                              const KV* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ tables,
                              const int* __restrict__ lens, T* __restrict__ o,
                              float* __restrict__ acc_out,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out, int B, int H,
                              int Hkv, int N, int bs, int MB, float scale2,
                              int window, int chunk, int owned_only,
                              float m_unit) {
  using Lay = DecLayout<D, G, KV>;
  using hopper::cp_async16;
  using hopper::cp_async4;
  using hopper::smem_addr;
  constexpr int CD = D / 32;                 // P V: a lane's head dims
  constexpr int EPP = Piece<KV>::kN;         // elements a 16-byte piece
  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = reinterpret_cast<float*>(smem + Lay::kQ);
  uint8_t* ring = smem + Lay::kQ + Lay::kP;

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = max(lens[b], 0);
  const int hi = min(L, MB * bs);
  const int lo = window > 0 ? max(0, L - window) : 0;
  const int start = lo + split * chunk;
  if (split > 0 && start >= hi) return;      // the merge never reads it
  const int end = min(start + chunk, hi);
  const int ntiles =
      end > start ? (end - start + kTileKeys - 1) / kTileKeys : 0;

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f(q[((size_t)b * H + kvh * G) * D + i]) * scale2;

  const int* trow = tables + (size_t)b * MB;
  // rows of tile t: kRowThreads neighbouring threads copy row r's 16-byte
  // chunks c = par, par + kRowThreads, ... of K and V. entry(t) is the
  // table entry of this thread's row, loaded a tile ahead of its fill so
  // that its latency never stands between two tiles.
  const int r = tid / kRowThreads, par = tid % kRowThreads;
  auto entry = [&](int t) {
    const int pos = start + t * kTileKeys + r;
    return pos < end ? trow[pos / bs] : 0;
  };
  auto fill = [&](int t, int e) {
    uint8_t* st = ring + (t % kStages) * Lay::kStage;
    const int pos = start + t * kTileKeys + r;
    bool ok = pos < end;
    size_t row = 0;
    if (ok) {
      if (owned_only) ok = e < N;            // another shard's entry
      e = min(max(e, 0), N - 1);             // the sentinel, clamped
      row = ((size_t)e * bs + pos % bs) * Hkv + kvh;
    }
    if (!ok) row = 0;                        // zero-filled, nothing read
    const uint8_t* ksrc = reinterpret_cast<const uint8_t*>(kp + row * D);
    const uint8_t* vsrc = reinterpret_cast<const uint8_t*>(vp + row * D);
    const uint32_t kdst = smem_addr(st + r * Lay::kRS);
    const uint32_t vdst = kdst + kTileKeys * Lay::kRS;
#pragma unroll
    for (int i = 0; i < Lay::kPieces / kRowThreads; ++i) {
      const int c = kRowThreads * i + par;
      cp_async16(kdst + c * 16, ksrc + c * 16, ok);
      cp_async16(vdst + c * 16, vsrc + c * 16, ok);
    }
    if (par == 0) {
      reinterpret_cast<int*>(st + Lay::kFlags)[r] = ok;
      if constexpr (Lay::kI8) {
        float* sc =
            reinterpret_cast<float*>(st + Lay::kFlags + kTileKeys * 4);
        cp_async4(smem_addr(sc + r), ks + row, ok);
        cp_async4(smem_addr(sc + kTileKeys + r), vs + row, ok);
      }
    }
  };

  float m[G], l[G], acc[G][CD];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegBig;
    l[g] = 0.f;   // this lane's share: its key's probabilities
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[g][c] = 0.f;
  }
  // lane scores key lane % kWarpKeys of the warp's, over part
  // lane / kWarpKeys of the head dims (16-byte pieces part, part + kParts,
  // ...)
  const int part = lane / kWarpKeys;
  const int kl = lane % kWarpKeys, key = warp * kWarpKeys + kl;
  float* pw = p_s + warp * G * kWarpKeys;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) fill(s, entry(s));
    hopper::cp_async_commit();
  }
  int e_next = kStages - 1 < ntiles ? entry(kStages - 1) : 0;
  for (int t = 0; t < ntiles; ++t) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; tile t-1 consumed
    if (t + kStages - 1 < ntiles) fill(t + kStages - 1, e_next);
    hopper::cp_async_commit();
    if (t + kStages < ntiles) e_next = entry(t + kStages);
    const uint8_t* st = ring + (t % kStages) * Lay::kStage;

    // scores of this lane's key (its part of the head dims) for all G
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const uint8_t* krow = st + key * Lay::kRS;
#pragma unroll
    for (int i = 0; i < Lay::kPieces / kParts; ++i) {
      const int pc = kParts * i + part;
      float kf[EPP];
      Piece<KV>::load(krow + pc * 16, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qd = q_s + g * D + pc * EPP;
#pragma unroll
        for (int e = 0; e < EPP; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qd + e);
          s[g] = fmaf(qv.x, kf[e], s[g]);
          s[g] = fmaf(qv.y, kf[e + 1], s[g]);
          s[g] = fmaf(qv.z, kf[e + 2], s[g]);
          s[g] = fmaf(qv.w, kf[e + 3], s[g]);
        }
      }
    }
    const bool ok = reinterpret_cast<const int*>(st + Lay::kFlags)[key] != 0;
    float ksc = 1.f, vsc = 1.f;
    if constexpr (Lay::kI8) {
      const float* sc =
          reinterpret_cast<const float*>(st + Lay::kFlags + kTileKeys * 4);
      ksc = sc[key];
      vsc = sc[kTileKeys + key];
    }
    // one max a head over the warp's keys (the parts of a key hold the
    // same sums: float addition commutes), the probabilities to shared
    // memory for P V
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sv = s[g];
#pragma unroll
      for (int o2 = kWarpKeys; o2 < 32; o2 <<= 1)
        sv += __shfl_xor_sync(0xffffffffu, sv, o2);
      sv = ok ? sv * ksc : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int o2 = 1; o2 < kWarpKeys; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float m_new = fmaxf(m[g], mx);
      const float corr = exp2f(m[g] - m_new);
      const float p = exp2f(sv - m_new);
      l[g] = fmaf(l[g], corr, p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[g][c] *= corr;
      if (part == 0) pw[g * kWarpKeys + kl] = p * vsc;
    }
    __syncwarp();
    // P V: lane owns head dims lane * CD .. + CD - 1 of the warp's keys
    const uint8_t* vrow = st + kTileKeys * Lay::kRS +
                          warp * kWarpKeys * Lay::kRS + lane * CD * sizeof(KV);
#pragma unroll
    for (int j0 = 0; j0 < kWarpKeys; j0 += 4) {
      float4 pv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        pv[g] = *reinterpret_cast<const float4*>(pw + g * kWarpKeys + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[CD];
        load_dims<CD, KV>(vrow + (j0 + u) * Lay::kRS, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = u == 0 ? pv[g].x : u == 1 ? pv[g].y
                                            : u == 2 ? pv[g].z : pv[g].w;
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[g][c] = fmaf(pj, vf[c], acc[g][c]);
        }
      }
    }
    __syncwarp();
  }

  // the warps' states through shared memory (the ring is free now)
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int o2 = 1; o2 < kWarpKeys; o2 <<= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o2);
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(ring);
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < CD; ++c)
      sm_acc[(warp * G + g) * D + lane * CD + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(sm_m[w * G + g] - mx);
      ls = fmaf(sm_l[w * G + g], e, ls);
      a = fmaf(sm_acc[(w * G + g) * D + d], e, a);
    }
    const int h = kvh * G + g;
    if (o != nullptr) {
      o[((size_t)b * H + h) * D + d] = from_f<T>(ls > 0.f ? a / ls : 0.f);
    } else {
      const size_t r = ((size_t)split * B + b) * H + h;
      acc_out[r * D + d] = a;
      if (d == 0) {
        m_out[r] = ls > 0.f ? mx * m_unit : kNegBig;
        l_out[r] = ls;
      }
    }
  }
}

// Folds the splits' triples of one (row, head) a warp, in split order:
// o (normalised, in T) or the partials triple (m in natural log).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ ws_acc,
                              const float* __restrict__ ws_m,
                              const float* __restrict__ ws_l,
                              const int* __restrict__ lens, T* __restrict__ o,
                              float* __restrict__ acc_out,
                              float* __restrict__ m_out,
                              float* __restrict__ l_out, int B, int H,
                              int rows, int window, int chunk, int nsplit) {
  constexpr int CD = D / 32;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);   // b * H + h
  if (r >= B * H) return;
  const int L = max(lens[r / H], 0);
  const int hi = min(L, rows);
  const int lo = window > 0 ? max(0, L - window) : 0;
  // the splits the first kernel wrote: those that start below hi, and
  // split 0 always
  const int ns = hi > lo ? min((hi - lo + chunk - 1) / chunk, nsplit) : 1;
  const size_t plane = (size_t)B * H;
  float mx = kNegBig;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ws_m[s * plane + r]);
  float ls = 0.f, a[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) a[c] = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float e = exp2f(ws_m[s * plane + r] - mx);
    ls = fmaf(ws_l[s * plane + r], e, ls);
    const float* src = ws_acc + (s * plane + r) * D + lane * CD;
#pragma unroll
    for (int c = 0; c < CD; ++c) a[c] = fmaf(src[c], e, a[c]);
  }
  if (o != nullptr) {
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[(size_t)r * D + lane * CD + c] = from_f<T>(ls > 0.f ? a[c] / ls : 0.f);
  } else {
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_out[(size_t)r * D + lane * CD + c] = a[c];
    if (lane == 0) {
      m_out[r] = ls > 0.f ? mx * kLn2 : kNegBig;
      l_out[r] = ls;
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tables, *lens;
  void *o, *acc, *m, *l, *ws;
  int B, H, Hkv, N, bs, MB;
  float scale;
  int window, nsplit, chunk, partials;
  cudaStream_t stream;
};

template <int D, int G, typename T, typename KV>
int launch(const Args& a) {
  constexpr int kSmem = DecLayout<D, G, KV>::kBytes;
  auto kern = paged_decode_split_kernel<D, G, T, KV>;
  static bool attr = false;   // the attribute outlives the launch
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  constexpr float kLog2e = 1.4426950408889634f;
  const size_t plane = (size_t)a.B * a.H;
  // nsplit == 1 writes the result itself; otherwise the workspace:
  // acc [nsplit, B, H, D], then m and l [nsplit, B, H] (log2 units)
  float* ws = static_cast<float*>(a.ws);
  float* acc = a.nsplit > 1 ? ws : static_cast<float*>(a.acc);
  float* m =
      a.nsplit > 1 ? ws + a.nsplit * plane * D : static_cast<float*>(a.m);
  float* l = a.nsplit > 1 ? m + a.nsplit * plane : static_cast<float*>(a.l);
  T* o = a.nsplit == 1 && !a.partials ? static_cast<T*>(a.o) : nullptr;
  dim3 grid(a.Hkv, a.B, a.nsplit);
  kern<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lens), o, acc, m, l, a.B, a.H, a.Hkv, a.N,
      a.bs, a.MB, a.scale * kLog2e, a.window, a.chunk, a.partials,
      a.nsplit > 1 ? 1.f : kLn2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return static_cast<int>(e);
  const int blocks = static_cast<int>((plane + kWarps - 1) / kWarps);
  paged_decode_merge_kernel<D, T><<<blocks, kThreads, 0, a.stream>>>(
      acc, m, l, static_cast<const int*>(a.lens),
      a.partials ? nullptr : static_cast<T*>(a.o),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.B, a.H, a.MB * a.bs, a.window, a.chunk,
      a.nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T, typename KV>
int launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<D, 1, T, KV>(a);
    case 2: return launch<D, 2, T, KV>(a);
    case 3: return launch<D, 3, T, KV>(a);
    case 4: return launch<D, 4, T, KV>(a);
    case 5: return launch<D, 5, T, KV>(a);
    case 6: return launch<D, 6, T, KV>(a);
    case 7: return launch<D, 7, T, KV>(a);
    case 8: return launch<D, 8, T, KV>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D, typename T>
int launch_pool(const Args& a) {
  const int G = a.H / a.Hkv;
  return a.ks ? launch_g<D, T, int8_t>(G, a) : launch_g<D, T, T>(G, a);
}

}  // namespace

// dtype (of q and o): 0 = float32, 1 = bfloat16, 2 = float16; head_dim:
// 64 or 128;
// H / Hkv in 1..8; window <= 0 means no sliding window. k_scale / v_scale
// null: the pools hold q's type; non-null: the pools hold int8 codes and
// these are their fp32 [N, bs, Hkv] scales. Pools 16-byte aligned.
// partials = 0 writes o; partials = 1 writes acc [B, H, D], m and l
// [B, H] (fp32) over the table entries < N. nsplit splits of chunk keys
// each (nsplit * chunk >= the longest live range); nsplit > 1 needs ws,
// nsplit * B * H * (D + 2) floats.
extern "C" int paged_decode_fwd(int dtype, int head_dim, const void* q,
                                const void* k_pool, const void* v_pool,
                                const void* k_scale, const void* v_scale,
                                const void* tables, const void* lens,
                                void* o, void* acc, void* m, void* l,
                                void* ws, int B, int H, int Hkv, int N,
                                int bs, int MB, float scale, int window,
                                int nsplit, int chunk, int partials,
                                void* stream) {
  if (B <= 0) return 0;
  if (nsplit < 1 || chunk < 1 || (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, tables, lens,
               o,  acc,    m,      l,       ws,      B,      H,
               Hkv, N,     bs,     MB,      scale,   window, nsplit,
               chunk, partials, static_cast<cudaStream_t>(stream)};
  if (dtype == kF32 && head_dim == 64) return launch_pool<64, float>(a);
  if (dtype == kF32 && head_dim == 128) return launch_pool<128, float>(a);
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_half(dtype, [&](auto e) {
    using T = decltype(e);
    return head_dim == 64 ? launch_pool<64, T>(a) : launch_pool<128, T>(a);
  });
}
