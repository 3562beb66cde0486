// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels:
// mbarriers, TMA tile loads, wgmma descriptors and products, and the
// host-side tensor-map encode.
//
// Shared-memory tiles. Every tile is loaded by TMA as boxes of 64 bf16 (128
// bytes a row) x 64 rows (attention; up to 256 rows for the conv weights,
// encode_rows) with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row
// r lands at chunk c ^ (r % 8), a pattern that repeats every 1024 bytes (8
// rows), so each box must start on a 1024-byte boundary. A head row of 128
// values takes two boxes (columns 0-63, then 64-127), 8 KB apart. The same
// bytes serve wgmma in two ways:
//  - K-major (the reduction runs along the row, e.g. Q and K in Q K^T):
//    rows are M or N, 8-row groups 1024 bytes apart (SBO); a k16 step moves
//    the start address by 32 bytes inside the 128-byte row, and k-steps
//    4-7 start in the second box. LBO is unused for swizzled K-major.
//  - MN-major (the reduction runs down the rows, e.g. V in P V: rows are
//    keys, the 128 columns are N): a k16 step is 16 rows, 2048 bytes; the
//    8-row groups of a step are 1024 bytes apart (SBO); the second 64
//    columns of N are in the second box, 8192 bytes on (LBO).
//
// wgmma accumulator layout (m64nN, fp32), thread i of the warpgroup, warp
// w = i / 32, lane = 4 g + t: d[4j + 0, 1] = (row 16w + g, cols 8j + 2t,
// +1), d[4j + 2, 3] = (row 16w + g + 8, the same cols). The A operand of a
// register-sourced (RS) m64k16 product has mma.sync's A layout per warp:
// a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8,
// 2t+8..), so accumulator columns 16kk..16kk+15 repack into the A operand of
// k-step kk as pack(d[8kk+0,1]), pack(d[8kk+2,3]), pack(d[8kk+4,5]),
// pack(d[8kk+6,7]). The same operand loads from a row-major bf16 buffer in
// shared memory with one ldmatrix.x4 a warp (ldmatrix_x4).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acestep {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
// A barrier completes a phase when `count` arrivals and every byte it was
// told to expect (expect_tx) have come in. wait(parity) returns once the
// phase of that parity has completed; a fresh barrier is in phase 0, so
// wait(1) passes at once (the producer's first pass over an empty ring).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also raises the bytes the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that outlasts ~10 s of clock cycles traps: a lost arrival fails
// the launch (an error the wrapper raises) instead of hanging the card.
constexpr long long MBAR_TIMEOUT_CYCLES = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > MBAR_TIMEOUT_CYCLES) __trap();
}

// ------------------------------------------------------------------ TMA
// One box of a 4-D tensor map into shared memory; the barrier's phase
// counts its bytes (the whole box, zero-filled where it leaves the tensor).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (see encode_rows).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A named barrier over the first `threads` threads of the block (id 1;
// __syncthreads is id 0), for the consumer warpgroups without the producer.
template <int threads>
__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(threads) : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a 128-byte-swizzled tile: start
// address, LBO and SBO in 16-byte units, layout type 1 (128B swizzle),
// base offset 0 (tiles start on 1024-byte boundaries).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Register writes before a product (zeroing, rescaling an accumulator,
// packing an A operand) must be fenced from the product's async reads.
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
// Pins registers that an asynchronous product reads (an A operand) or
// writes (an accumulator). Called just before the product is issued and
// just after the wait for it, it keeps the compiler from moving any other
// write of them (a rescale, a repack) into the product's flight: ptxas
// would then serialise the kernel's wgmmas (its warning C7515).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 64) = A B^T (+ D when scale_d): A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128) += A B: A (64 x 16) bf16 from registers, B (16 x 128)
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs_mn(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128) += A B^T and D (64 x 256) += A B^T: A (64 x 16) bf16 from
// registers, B (N x 16) K-major in shared memory (no transpose bit): the
// products of the snake + conv stack, whose weight tiles are stored (out,
// in), N = out rows of 128 bytes of `in` each.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The A operand of an RS product (one warp's 16 rows x 16 bf16, in the
// layout at the top of this file) from a row-major shared-memory buffer:
// lane l gives the address of row (l % 16), column 8 (l / 16) of the 16 x 16
// block. Rows need only be 16-byte aligned, so any row offset works.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Descriptors of k-step kk (16 values of the reduction) of a tile made of
// 128-byte-wide boxes of BOX bytes each (see the top of this file): a
// 64 x 128 attention tile is two boxes of 8192 bytes.
template <int BOX = 8192>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * BOX + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile,
                                                 int kk) {
  return desc_sw128(tile + kk * 2048, 8192, 1024);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ host side
// cuTensorMapEncodeTiled is a driver-API symbol; it is taken through the
// runtime's entry-point query, so the library needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (B, L, H, 128) bf16 tensor with element strides (sb, sl, sh, 1) as a
// 4-D map ordered (d, head, position, batch) with boxes of 64 d x 1 head x
// 64 positions: one box is a 64 x 64 tile, rows = positions. Positions past
// L read as zero. Returns 0 or a cudaError_t.
inline int encode_blhd(CUtensorMap* map, const void* ptr, int B, int L, int H,
                       long long sb, long long sl, long long sh) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(H),
                        static_cast<cuuint64_t>(L > 0 ? L : 1),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sl) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A row-major (rows, cols) bf16 matrix, contiguous, as a 2-D map ordered
// (col, row) with boxes of 64 columns x box_rows rows (box_rows <= 256):
// one box is box_rows rows of 128 bytes, swizzled as above. The snake +
// conv stack's (3, 8, C, C) weights are (24 C, C): the rows of tap i of
// unit u start at row (8 u + i) C. Returns 0 or a cudaError_t.
inline int encode_rows(CUtensorMap* map, const void* ptr, int rows, int cols,
                       int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace acestep
