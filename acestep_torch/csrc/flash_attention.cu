// Flash-attention forward for Hopper: bidirectional GQA attention with an
// optional band |i - j| <= W, online softmax, fp32 accumulation, scale
// 1/sqrt(D). Returns `out` (bf16) and the fp32 logsumexp `lse` (natural
// log) that the backward kernels recompute P from.
//
// Replaces acestep_tpu/ops/flash_attention.py::_kernel (the Pallas forward
// kernel). It keeps that kernel's semantics, not its TPU blocking: padded
// keys are masked in-kernel at their true length, a row with no valid key
// writes out = 0 and lse = -1e30, and the band is inclusive.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a full layer does
// 4*Hq*Lq*Lk*D operations against (|q|+|k|+|v|+|out|) bytes, so it is
// compute-bound (L = 750: ~4.6 GFLOP vs ~9 MB); a banded layer (W = 128)
// does at most 4*Hq*Lq*(2W+1)*D operations and is memory-bound.
//
// Design (TMA + wgmma, warp-specialised):
//  - one block per (query unit, KV head, batch), two blocks an SM (192
//    blocks at B = 1, L = 750). A unit is 64 query rows of one query head;
//    units run head-fastest over the G query heads of the KV head, so the
//    heads of a group read the same K/V tiles at about the same time, the
//    second mostly from L2. Both heads of a group in one block (two
//    consumer warpgroups, each K/V tile fetched once per group as the TPU
//    kernel's (B, Hkv, nQ, nK) grid does, one block an SM) measured 3-8%
//    slower on an H100 at every main-path shape: its two warpgroups run in
//    lockstep on the same tiles, so their softmaxes leave the tensor cores
//    idle together, and making them take turns (named barriers, FA3's
//    ping-pong) measured slower still;
//  - a producer warp issues TMA loads: the unit's Q tile once, then the
//    K and V tiles of 64 keys into a ring of STAGES stages (128-byte
//    swizzle, two 64-column boxes per 128-wide row), tracked by full/empty
//    mbarriers. Only the key tiles that meet the unit's rows widened by
//    W are visited when the attention is banded;
//  - one consumer warpgroup computes S = Q K^T with wgmma (both
//    operands K-major in shared memory), masks it (only on tiles at the
//    band's or the keys' edge) and updates the online softmax in registers
//    in the log2 domain (the scale, log2(e) folded in, fused into the
//    exponent's FMA), and computes O += P V with wgmma: P from registers as
//    the A operand, V as an MN-major B operand straight from its TMA tile,
//    so V is never transposed. The running max m and sum l are fp32. P V
//    of tile i runs while the consumer waits for tile i + 1 and issues its
//    S; the softmax itself overlaps the other block's products on the SM.
//    Overlapping it with this warpgroup's own P V as well (S of tile i + 1
//    issued before the softmax of tile i) measured no faster on an H100,
//    so the loop stays the simple one.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = acestep::hopper;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int D = 128;                 // head dim
constexpr int BM = 64;                 // query rows per consumer warpgroup
constexpr int BN = 64;                 // keys per K/V tile
constexpr int TILE = BN * D * 2;       // one 64 x 128 bf16 tile: 16 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;      // lse of a row with no valid key

// One consumer warpgroup and one producer warp. The launch bound sets the
// registers ptxas may use: 65536 / (THREADS x blocks an SM), rounded down
// to 8, 200 at two blocks an SM (the kernel needs fewer).
constexpr int STAGES = 2;                 // K/V ring
constexpr int THREADS = 128 + 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int K_OFF = TILE;               // after the Q tile
constexpr int V_OFF = K_OFF + STAGES * TILE;
constexpr int SMEM = V_OFF + STAGES * TILE + 1024;   // + alignment

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ out, float* __restrict__ lse, int Lq,
                 int Lk, int Hq, int Hkv, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[STAGES];
  __shared__ __align__(8) uint64_t kv_empty[STAGES];

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int u = blockIdx.x;                 // this block's query unit
  const int h = hk * G + u % G;
  const int q0 = (u / G) * BM;              // the unit's first row
  // the key tiles that meet the unit's rows widened by the band
  int k_lo = 0, k_hi = Lk - 1;
  if (window >= 0) {
    k_lo = max(0, q0 - window);
    k_hi = min(Lk - 1, q0 + BM - 1 + window);
  }
  const int kt_first = k_lo / BN;
  const int n_tiles = k_hi >= k_lo ? k_hi / BN - kt_first + 1 : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&kv_full[s], 1);
      hp::mbar_init(&kv_empty[s], 4);     // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every load
    if (threadIdx.x == 128) {
      hp::mbar_arrive_expect_tx(&q_full, TILE);
      hp::tma_load_4d(smem, &qmap, &q_full, 0, h, q0, b);
      hp::tma_load_4d(smem + TILE / 2, &qmap, &q_full, 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        hp::mbar_wait(&kv_empty[s], ((i / STAGES) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&kv_full[s], 2 * TILE);
        const int key0 = (kt_first + i) * BN;
        uint8_t* kd = smem + K_OFF + s * TILE;
        uint8_t* vd = smem + V_OFF + s * TILE;
        hp::tma_load_4d(kd, &kmap, &kv_full[s], 0, hk, key0, b);
        hp::tma_load_4d(kd + TILE / 2, &kmap, &kv_full[s], 64, hk, key0, b);
        hp::tma_load_4d(vd, &vmap, &kv_full[s], 0, hk, key0, b);
        hp::tma_load_4d(vd + TILE / 2, &vmap, &kv_full[s], 64, hk, key0, b);
      }
    }
  } else {
    // ---- consumer warpgroup: the unit's 64 query rows
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const uint8_t* sq = smem;
    // the keys each of this thread's two rows sees: [lo, hi] (inclusive)
    const int lo0 = window >= 0 ? max(0, r0 - window) : 0;
    const int lo1 = window >= 0 ? max(0, r1 - window) : 0;
    const int hi0 = window >= 0 ? min(Lk - 1, r0 + window) : Lk - 1;
    const int hi1 = window >= 0 ? min(Lk - 1, r1 + window) : Lk - 1;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = NEG_BIG, m1 = NEG_BIG;   // running max, log2 domain
    float l0 = 0.f, l1 = 0.f;           // this thread's part of the sum
    float alpha0 = 1.f, alpha1 = 1.f;   // o's rescale for the latest tile

    float sacc[32];                 // S, then P in fp32
    uint32_t pa[BN / 16][4];        // P as bf16 A operands

    // S = Q K^T (64 rows x 64 keys) of tile i
    auto issue_s = [&](int i) {
      const int s = i % STAGES;
      hp::mbar_wait(&kv_full[s], (i / STAGES) & 1);
      const uint8_t* sk = smem + K_OFF + s * TILE;
      hp::fence_regs(sacc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n64k16_ss(sacc, hp::desc_kmajor(sq, kk),
                               hp::desc_kmajor(sk, kk), kk > 0);
      hp::wgmma_commit();
    };
    // O += P V of tile i (V MN-major: keys are the reduction)
    auto issue_pv = [&](int i) {
      const uint8_t* sv = smem + V_OFF + (i % STAGES) * TILE;
      hp::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hp::fence_regs(pa[kk]);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hp::wgmma_m64n128k16_rs_mn(o, pa[kk], hp::desc_mnmajor(sv, kk));
      hp::wgmma_commit();
    };
    // the online softmax of tile i, in place on S: mask (band and key <
    // Lk; skipped for a tile every row of this unit sees whole), the row
    // max, P = exp2(S * scale - m) in the log2 domain with the scale folded
    // into the exponent's FMA (masked entries give exp2(-inf) = 0), the
    // row sums. It runs with no product in flight, so its branch cannot
    // make ptxas serialise the products.
    auto softmax = [&](int i) {
      const int kbase = (kt_first + i) * BN;
      const bool whole = kbase + BN <= Lk &&
                         (window < 0 || (kbase >= q0 + BM - 1 - window &&
                                         kbase + BN - 1 <= q0 + window));
      if (!whole) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kbase + j * 8 + 2 * t + e;
            if (!(key >= lo0 && key <= hi0)) sacc[4 * j + e] = -INFINITY;
            if (!(key >= lo1 && key <= hi1)) sacc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      alpha0 = hp::exp2_approx(m0 - mn0);
      alpha1 = hp::exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sacc[4 * j] = hp::exp2_approx(fmaf(sacc[4 * j], scale_log2, -m0));
        sacc[4 * j + 1] =
            hp::exp2_approx(fmaf(sacc[4 * j + 1], scale_log2, -m0));
        sacc[4 * j + 2] =
            hp::exp2_approx(fmaf(sacc[4 * j + 2], scale_log2, -m1));
        sacc[4 * j + 3] =
            hp::exp2_approx(fmaf(sacc[4 * j + 3], scale_log2, -m1));
        l0 += sacc[4 * j] + sacc[4 * j + 1];
        l1 += sacc[4 * j + 2] + sacc[4 * j + 3];
      }
    };
    // o *= alpha, and P rounded to bf16 as the A operands of P V
    // (accumulator columns 16kk..16kk+15 are A operand kk)
    auto rescale_pack = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
    };
    auto release = [&](int i) {   // this warp is done with K/V tile i
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&kv_empty[i % STAGES]);
    };

    // Every register a product reads or writes is fenced where the product
    // is issued and where it is waited for, so the compiler moves no
    // rescale or repack into a product's flight (ptxas would serialise
    // the products).
    hp::mbar_wait(&q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      issue_s(i);
      hp::wgmma_wait<0>();          // S of tile i and P V of tile i - 1
      hp::fence_regs(sacc);
      hp::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hp::fence_regs(pa[kk]);
      if (i > 0) release(i - 1);
      softmax(i);
      rescale_pack();
      issue_pv(i);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(o);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    if (r0 < Lq) {
      bf16* op = out + (((long long)b * Lq + r0) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (t == 0)
        lse[((long long)b * Hq + h) * Lq + r0] =
            l0 > 0.f ? (m0 + log2f(l0)) * LN2 : NEG_BIG;
    }
    if (r1 < Lq) {
      bf16* op = out + (((long long)b * Lq + r1) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      if (t == 0)
        lse[((long long)b * Hq + h) * Lq + r1] =
            l1 > 0.f ? (m1 + log2f(l1)) * LN2 : NEG_BIG;
    }
  }
}

}  // namespace

extern "C" const char* acestep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Lq, Hq, 128), k/v (B, Lk, Hkv, 128) bf16 with unit stride on the
// head dim and 16-byte aligned rows and strides (checked by the Python
// wrapper); out (B, Lq, Hq, 128) bf16 and lse (B, Hq, Lq) fp32 contiguous.
// window < 0 means full attention. Returns 0 or a cudaError_t.
extern "C" int acestep_flash_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int Lq, int Lk,
                                 int Hq, int Hkv, long long qsb, long long qsl,
                                 long long qsh, long long ksb, long long ksl,
                                 long long ksh, long long vsb, long long vsl,
                                 long long vsh, int window, float scale,
                                 void* stream) {
  if (B == 0 || Lq == 0) return 0;
  CUtensorMap qm, km, vm;
  int err = hp::encode_blhd(&qm, q, B, Lq, Hq, qsb, qsl, qsh);
  if (err == 0) err = hp::encode_blhd(&km, k, B, Lk, Hkv, ksb, ksl, ksh);
  if (err == 0) err = hp::encode_blhd(&vm, v, B, Lk, Hkv, vsb, vsl, vsh);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Hq / Hkv) * ((Lq + BM - 1) / BM), Hkv, B);
  flash_fwd_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), Lq, Lk,
      Hq, Hkv, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
