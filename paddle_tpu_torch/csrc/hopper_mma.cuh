// Hopper (sm_90a) building blocks for the tensor-core kernels (bf16 or
// f16: every loader, packer and product takes the 2-byte element type E,
// __nv_bfloat16 or __half, as a template argument, so each kernel
// instantiates both from one source):
// flash_fwd.cu's K2, flash_bwd.cu's K5a and K5b, paged_chunk.cu's K3,
// grouped_matmul.cu's K6a and K6b. 16-byte cp.async copies into
// 128-byte-swizzled shared tiles, the shared-memory matrix descriptors of
// wgmma, and the wgmma.mma_async shapes they use: SS m64n64k16 (both
// operands K-major; K2, K5), SS m64n128k16 and m64n256k16 (A K-major or,
// TA = 1, MN-major; B K-major or, TB = 1, MN-major: K6a's forward A
// K-major B MN-major, its dlhs both K-major, K6b both MN-major), RS
// m64n64k16 and m64n128k16 (B MN-major; K2, K3, K5; m64n64k16 also B
// K-major, K3's S = Q K^T), and at D = 256 (K2, K5) two m64n128k16 RS
// products over the two 128-column halves of the B tile; and for an
// epilogue staged in shared memory (K6b), stmatrix, 16-byte shared loads
// and named barriers; for K6a's decode route, mbarriers and tensor-map
// copies.
//
// Tile layout. A [rows][D] bf16 or f16 tile (D = 64, 128 or 256) is stored as
// D / 64 panels of [rows][64]: one 128-byte line per row, the 16-byte
// chunk c of row r at chunk position c ^ (r % 8) of its line, panels
// rows * 128 bytes apart, every panel 1024-byte aligned. That is the
// canonical 128-byte-swizzle layout of wgmma for both operand majors:
//   K-major (the reduction runs along a row, e.g. Q and K in S = Q K^T):
//     8-row groups 1024 bytes apart (SBO), a 16-wide k step 32 bytes
//     further in the line, the next 64 columns one panel further;
//   MN-major (the reduction runs down the rows, e.g. V in O += P V, the
//     transpose bit set): 8-row groups 1024 bytes apart (SBO), a 16-row k
//     step 2048 bytes further, the next 64 output columns one panel
//     further (LBO).
// So one tile in shared memory feeds a product as either operand, A or
// B: an MN-major A of 64 rows is one panel of such a tile.
//
// Register fragments. The fp32 accumulator of an m64nN product gives
// thread t of the warpgroup (warp w = t / 32, lane l) rows 16w + l / 4 and
// that + 8, columns 8j + 2(l % 4) + {0, 1} for j < N / 8: d[4j + 0..1] on
// the first row, d[4j + 2..3] on the second. Packed to E pairs, the
// accumulator of columns 16kk..16kk+15 (d[8kk .. 8kk + 7]) is exactly the
// register A operand of the k step kk, so a product's result feeds the
// next product without passing through shared memory.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace hopper {

constexpr int kWarpgroup = 128;  // threads of one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; valid = false writes zeros
// and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; valid = false writes zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's finished shared-memory writes visible to wgmma's
// (asynchronous-proxy) reads; a barrier then publishes them to the block
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (c < D / 8) of row r in a swizzled
// [ROWS][D] tile (see the layout above)
template <int ROWS>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + ((((c & 7) ^ (r & 7))) << 4);
}

// the 2-byte element types of the tensor-core products
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;
template <typename E>
constexpr bool kIsHalf2B =
    kIsF16<E> || std::is_same<E, __nv_bfloat16>::value;

// Asynchronous load of a [ROWS][D] tile of 2-byte elements whose row r
// starts at src + r * row_stride (elements); rows >= nvalid are
// zero-filled. Every thread of the warpgroup takes part; consecutive
// threads read consecutive 16-byte chunks of a row.
template <int ROWS, int D, typename E>
__device__ __forceinline__ void load_tile(uint32_t dst, const E* src,
                                          size_t row_stride, int nvalid) {
  static_assert(kIsHalf2B<E>, "bf16 or f16 tiles");
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kWarpgroup == 0, "tile not whole");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kWarpgroup; ++it) {
    const int i = it * kWarpgroup + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < nvalid;
    cp_async16(dst + sw128<ROWS>(r, c),
               src + (ok ? r : 0) * row_stride + c * 8, ok);
  }
}

// Asynchronous load of a [ROWS][COLS] tile of 2-byte elements (COLS a
// multiple of 64,
// swizzled as above: COLS / 64 panels) whose row r starts at
// src + r * row_stride (elements), by THREADS threads; rows >= nrows and
// the 16-byte chunks at or past column ncols (a multiple of 8) are
// zero-filled, reading nothing (they point at src, which must be mapped).
template <int ROWS, int COLS, int THREADS, typename E>
__device__ __forceinline__ void load_tile_masked(uint32_t dst, const E* src,
                                                 size_t row_stride, int nrows,
                                                 int ncols) {
  static_assert(kIsHalf2B<E>, "bf16 or f16 tiles");
  constexpr int kChunks = COLS / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "tile not whole");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < nrows && c * 8 < ncols;
    cp_async16(dst + sw128<ROWS>(r, c),
               src + (ok ? r * row_stride + c * 8 : 0), ok);
  }
}

// The width in shared memory and in the accumulators of a [rows][D] tile
// of the attention kernels (K2, K5): D rounded up to whole 64-column
// panels, so that every tile keeps the canonical 128-byte-swizzle layout
// above. At D = 80 (Phi-2) a row's 160 bytes fill one panel and 16 columns
// of a second; the tile is laid out as a D = 128 one, its columns 80..127
// zero-filled (load_rows), the products over the reduction dim D run
// D / 16 k steps (5) and those with D as their n dim run at the padded
// width (n 128), whose last 48 columns are zeros that nothing stores.
template <int D>
__host__ __device__ constexpr int tile_cols() {
  return (D + 63) / 64 * 64;
}

// load_tile of a [ROWS][D] tile into the tile_cols<D>()-wide layout:
// columns D..tile_cols<D>() - 1 are zero-filled, reading nothing (the
// whole-panel widths take load_tile as it is)
template <int ROWS, int D, typename E>
__device__ __forceinline__ void load_rows(uint32_t dst, const E* src,
                                          size_t row_stride, int nvalid) {
  if constexpr (D == tile_cols<D>())
    load_tile<ROWS, D>(dst, src, row_stride, nvalid);
  else
    load_tile_masked<ROWS, tile_cols<D>(), kWarpgroup>(dst, src, row_stride,
                                                       nvalid, D);
}

// 16 bytes from shared memory
__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// four 8 x 8 matrices of 2-byte elements from registers to shared memory: r[q] is this
// thread's pair of matrix q (row lane / 4, columns 2 (lane % 4) + {0, 1}:
// the layout of an 8-row, 8-column block of a wgmma accumulator packed to
// E pairs), and lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// barrier `id` (1..15; 0 is __syncthreads') over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Barriers in shared memory (mbarrier) that copies complete on (K6a's
// decode route): a barrier initialised with count N completes a phase
// when N arrivals have happened (a thread's arrival triggered by the
// completion of every cp.async it issued before it, or one announcing
// bytes that a tensor-map copy then delivers) and every announced byte
// has landed; a waiter names the phase by its parity and then sees the
// copied bytes.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the initialised barriers visible to every thread and copy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread arrives on `bar` once its cp.async copies so far complete
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A box of a 3-d tensor map (coordinates innermost first) from global to
// shared memory by the tensor memory accelerator, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* tmap,
                                           int c0, int c1, int c2,
                                           uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand starting
// at shared address addr (byte offsets: lbo, sbo)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand: k step kk (16 columns) of a swizzled [ROWS][D] tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16,
                    1024);
}

// MN-major operand: k step kk (16 rows) of a swizzled [ROWS][D] tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator d of an m64nN product (N = 16 * KS) as KS register A
// operands of k steps of 16, rounded to E
template <typename E, int KS>
__device__ __forceinline__ void to_operand_a(const float (&d)[8 * KS],
                                             uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<E>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B in shared memory, both
// K-major
#define PTT_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(1))

template <typename E>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  if constexpr (kIsF16<E>)
    PTT_WGMMA_SS_N64("f16");
  else
    PTT_WGMMA_SS_N64("bf16");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A and B in shared memory, A
// K-major (TA = 0) or MN-major (TA = 1), B K-major (TB = 0) or MN-major
// (TB = 1)
#define PTT_WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(1), "n"(TB), "n"(TA))

template <typename E, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db) {
  if constexpr (kIsF16<E>)
    PTT_WGMMA_SS_N128("f16");
  else
    PTT_WGMMA_SS_N128("bf16");
}

// d[64 x 256] += A[64 x 16] B[16 x 256]: A and B in shared memory, A
// K-major (TA = 0) or MN-major (TA = 1), B K-major (TB = 0) or MN-major
// (TB = 1)
#define PTT_WGMMA_SS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %132, %131;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(1), "n"(TB), "n"(TA))

template <typename E, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t da,
                                            uint64_t db) {
  if constexpr (kIsF16<E>)
    PTT_WGMMA_SS_N256("f16");
  else
    PTT_WGMMA_SS_N256("bf16");
}

// d[64 x N] += A[64 x 16] B[16 x N] (N = 128 or 256), both from shared
// memory: A K-major (TA = 0) or MN-major (TA = 1), B K-major (TB = 0) or
// MN-major (TB = 1)
template <typename E, int N, int TB, int TA = 0>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  static_assert(N == 128 || N == 256, "SS shapes: n128, n256");
  if constexpr (N == 128)
    mma_ss_n128<E, TB, TA>(d, da, db);
  else
    mma_ss_n256<E, TB, TA>(d, da, db);
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B in shared
// memory MN-major (TB = 1) or K-major (TB = 0: K3's S = Q K^T with its
// Q fragments held in registers)
#define PTT_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), \
        "n"(TB))

template <typename E, int TB = 1>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (kIsF16<E>)
    PTT_WGMMA_RS_N64("f16");
  else
    PTT_WGMMA_RS_N64("bf16");
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B in shared
// memory MN-major
#define PTT_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename E>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (kIsF16<E>)
    PTT_WGMMA_RS_N128("f16");
  else
    PTT_WGMMA_RS_N128("bf16");
}

// d += A B over the D / 64 panels' width: d[64 x D], A in registers, B a
// swizzled MN-major tile of ROWS rows. D = 256 is issued as two
// m64n128k16 products, one for each 128-column half of B (panels 0-1 and
// 2-3: the second half starts 2 * ROWS * 128 bytes further, which is
// (2 * ROWS * 128) >> 4 in the descriptor's address field); columns 0-127
// of the accumulator are d[0..63] and 128-255 are d[64..127], exactly the
// two halves' fragments. That route was taken over one m64n256k16 RS
// product (an asm statement of 128 accumulator operands): the same
// tensor-core work, from the n128 product the D = 128 kernels already run.
template <typename E, int D, int ROWS = 64>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(D == 64 || D == 128 || D == 256, "RS widths: 64, 128, 256");
  if constexpr (D == 64) {
    mma_rs_n64<E>(d, a, db);
  } else if constexpr (D == 128) {
    mma_rs_n128<E>(d, a, db);
  } else {
    float(&lo)[64] = *reinterpret_cast<float(*)[64]>(&d[0]);
    float(&hi)[64] = *reinterpret_cast<float(*)[64]>(&d[64]);
    mma_rs_n128<E>(lo, a, db);
    mma_rs_n128<E>(hi, a, db + ((2 * ROWS * 128) >> 4));
  }
}

#undef PTT_WGMMA_SS_N64
#undef PTT_WGMMA_SS_N128
#undef PTT_WGMMA_SS_N256
#undef PTT_WGMMA_RS_N64
#undef PTT_WGMMA_RS_N128

}  // namespace hopper
}  // namespace ptt
