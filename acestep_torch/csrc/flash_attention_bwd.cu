// Flash-attention backward for Hopper: the gradients of the bidirectional
// GQA attention of flash_attention.cu (optional band |i - j| <= W, scale
// 1/sqrt(D)), recomputing P from the forward's fp32 logsumexp.
//
// Replaces acestep_tpu/ops/flash_attention.py::_bwd_dq_kernel (K2) and
// ::_bwd_dkv_kernel (K3), the two Pallas kernels of that file's custom_vjp.
// Both compute, for the pairs (i, j) in the band and inside the real
// lengths,
//   P  = exp(scale * q_i.k_j - lse_i),   dP = dO_i.v_j,
//   dS = P * (dP - delta_i) * scale,     delta_i = rowsum(dO_i * O_i),
// and K2 writes dQ = dS K, K3 writes dV = P^T dO and dK = dS^T Q summed
// over the G query heads of a KV head. delta is a plain PyTorch reduction
// computed by the wrapper (the JAX package computes it outside its kernels
// too). Pairs outside the band or past a real length are selected to 0
// before any product, so a row with no valid key (lse = -1e30, where
// exp(s - lse) overflows) contributes exactly 0 and never NaN.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): K2 does 6*B*Hq*D
// operations per (query, key) pair in the band (S, dP, dQ), K3 8*B*Hq*D
// (S, dP, dV, dK); the bytes are the q, k, v, dO, lse and delta reads plus
// the stores. Full attention at B = 1, L = 1500 is compute-bound (~28 us
// for K2, ~37 us for K3); a banded layer (W = 128) is memory-bound.
//
// K2 (TMA + wgmma, warp-specialised; K3's design mirrored): one block per
// (64 queries, query head, batch), units head-fastest so the G heads of a
// KV group read the same K/V tiles at about the same time, two blocks an
// SM (384 blocks at B = 1, L = 1500). Its producer warp loads the block's
// Q and dO tiles once by TMA, then streams the 64-key K and V tiles of the
// band through a ring of two stages. Its consumer warpgroup keeps dQ (64 x
// 128, fp32) in registers until the one store. Per tile it computes S =
// Q K^T and dP = dO V^T with wgmma (all operands K-major in shared
// memory), makes P with exp2 from the lse in the log2 domain (the scale
// folded into the FMA), dS = P (dP - delta) scale selected to 0 outside
// the band and the real lengths, repacks dS to bf16 as the A operand of
// dQ += dS K (K read MN-major from the same TMA tile) and waits for that
// product before the next tile: the other block on the SM fills the gap.
// dQ is owned by one block: no atomics, the same bits run to run.
// Measured on an H100 (PERF.md) and not kept, each about as fast or
// slower: issuing the next tile's S and dP while dQ += dS K runs (both
// sets of registers live, so one block an SM at 178 registers: 0.0779
// ms at full B = 1, L = 1500 against 0.0701 in one run), and a KV
// group's two query heads in one block sharing each K/V tile (two
// consumer warpgroups, one block an SM: within 3%, except 9-12% slower
// banded at B = 1, L = 1500).
//
// K3 (TMA + wgmma, warp-specialised, the design of K1 in
// flash_attention.cu): one block per (64 keys, KV head, batch). Its
// producer warp loads the block's K and V once by TMA (they stay in shared
// memory), then streams the Q and dO tiles of 64 queries through a ring of
// KV_STAGES stages over the G query heads of the KV head and the query
// tiles in the symmetric band, staging each tile's lse (log2 domain) and
// delta beside them. Its consumer warpgroup owns the 64 keys and keeps their
// dK and dV (64 x 128 each, fp32) in registers. Per
// tile it computes S^T = K Q^T and dP^T = V dO^T with wgmma (all operands
// K-major in shared memory), so P^T and dS^T come out in accumulator
// layout, and feeds them from registers as the A operands of dV += P^T dO
// and dK += dS^T Q, whose B operands dO and Q are read MN-major from the
// same TMA tiles. dK and dV are owned by one block and summed in a fixed
// order: no atomics, deterministic sums. 64 keys a block give 192 blocks at
// B = 1, L = 1500, one an SM at 255 registers; 128 keys a block in two
// consumer warpgroups (96 blocks) left ptxas 168 registers a thread and
// spilled, and measured about twice as slow on an H100; so did it with
// setmaxnreg giving the consumers 240. The consumer's loop issues S^T and
// dP^T of tile it, waits (which also retires tile it - 1's dK/dV
// products), makes P^T and dS^T and issues tile it's dK/dV products
// without waiting, so they run while the next tile is awaited and its S^T
// issued; issuing S^T of the next tile before the softmax of this one (a
// second pair of accumulators in flight) measured only slightly faster
// and spilled, and was not kept.
//
// Both round P and dS to bf16 before their products, as the forward rounds
// P.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = acestep::hopper;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int D = 128;         // head dim
constexpr int KV_STAGES = 3;   // K3: stages of the query-tile ring
constexpr float LOG2E = 1.4426950408889634f;

// Tiles of `tile` positions that meet [lo_pos - W, hi_pos + W] inside
// [0, n); last < first when none does.
__device__ __forceinline__ void band_tiles(int lo_pos, int hi_pos, int n,
                                           int window, int tile, int& first,
                                           int& last) {
  int lo = 0, hi = n - 1;
  if (window >= 0) {
    lo = max(0, lo_pos - window);
    hi = min(n - 1, hi_pos + window);
  }
  first = lo / tile;
  last = hi >= lo ? hi / tile : first - 1;
}

// ---------------------------------------------------------------- K2: dQ
// One consumer warpgroup and one producer warp, two blocks an SM (ptxas
// may use up to 204 registers a thread; the kernel needs fewer).
struct Dq {
  static constexpr int STAGES = 2;                       // K/V ring
  static constexpr int THREADS = 128 + 32;
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int TILE = 64 * D * 2;                // 64 x 128 bf16
  static constexpr int O_OFF = TILE;                     // after the Q tile
  static constexpr int K_OFF = 2 * TILE;                 // the K/V ring
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int SMEM = V_OFF + STAGES * TILE + 1024;  // + align
};

__global__ void __launch_bounds__(Dq::THREADS, Dq::BLOCKS_PER_SM)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Lq, int Lk, int Hq, int Hkv, int window, float scale) {
  using C = Dq;
  constexpr int TILE = C::TILE, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t kv_full[STAGES];
  __shared__ __align__(8) uint64_t kv_empty[STAGES];

  // units run head-fastest over the G query heads of the KV head, so the
  // blocks that read the same K/V tiles run at about the same time
  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int h = hk * G + blockIdx.x % G;
  const int q0 = (blockIdx.x / G) * 64;
  int kt_first, kt_last;
  band_tiles(q0, q0 + 63, Lk, window, 64, kt_first, kt_last);
  const int n_tiles = kt_last - kt_first + 1;

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
      hp::mbar_arrive_expect_tx(&q_full, 2 * TILE);
      uint8_t* od = smem + C::O_OFF;
      hp::tma_load_4d(smem, &qmap, &q_full, 0, h, q0, b);
      hp::tma_load_4d(smem + TILE / 2, &qmap, &q_full, 64, h, q0, b);
      hp::tma_load_4d(od, &omap, &q_full, 0, h, q0, b);
      hp::tma_load_4d(od + TILE / 2, &omap, &q_full, 64, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        hp::mbar_wait(&kv_empty[s], ((i / STAGES) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&kv_full[s], 2 * TILE);
        const int key0 = (kt_first + i) * 64;
        uint8_t* kd = smem + C::K_OFF + s * TILE;
        uint8_t* vd = smem + C::V_OFF + s * TILE;
        hp::tma_load_4d(kd, &kmap, &kv_full[s], 0, hk, key0, b);
        hp::tma_load_4d(kd + TILE / 2, &kmap, &kv_full[s], 64, hk, key0, b);
        hp::tma_load_4d(vd, &vmap, &kv_full[s], 0, hk, key0, b);
        hp::tma_load_4d(vd + TILE / 2, &vmap, &kv_full[s], 64, hk, key0, b);
      }
    }
  } else {
    // ---- consumer warpgroup: the 64 query rows, dQ in registers
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    const uint8_t* sq = smem;
    const uint8_t* so = smem + C::O_OFF;
    const float scale_log2 = scale * LOG2E;
    // the keys each of this thread's two rows sees: [lo, hi] (inclusive;
    // none for a row past Lq)
    const int lo0 = window >= 0 ? max(0, r0 - window) : 0;
    const int lo1 = window >= 0 ? max(0, r1 - window) : 0;
    const int hi0 = r0 >= Lq ? -1
                    : window >= 0 ? min(Lk - 1, r0 + window) : Lk - 1;
    const int hi1 = r1 >= Lq ? -1
                    : window >= 0 ? min(Lk - 1, r1 + window) : Lk - 1;
    const long long row_base = ((long long)b * Hq + h) * Lq;
    const float l0 = r0 < Lq ? lse[row_base + r0] * LOG2E : 0.f;
    const float l1 = r1 < Lq ? lse[row_base + r1] * LOG2E : 0.f;
    const float dl0 = r0 < Lq ? delta[row_base + r0] : 0.f;
    const float dl1 = r1 < Lq ? delta[row_base + r1] : 0.f;

    float dq_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;
    float sacc[32], dpacc[32];      // S, dP; then P, dS in fp32
    uint32_t sa[4][4];              // dS as bf16 A operands

    // S = Q K^T and dP = dO V^T (64 queries x 64 keys) of tile i
    auto issue_sdp = [&](int i) {
      const int s = i % STAGES;
      hp::mbar_wait(&kv_full[s], (i / STAGES) & 1);
      const uint8_t* sk = smem + C::K_OFF + s * TILE;
      const uint8_t* sv = smem + C::V_OFF + s * TILE;
      hp::fence_regs(sacc);
      hp::fence_regs(dpacc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n64k16_ss(sacc, hp::desc_kmajor(sq, kk),
                               hp::desc_kmajor(sk, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n64k16_ss(dpacc, hp::desc_kmajor(so, kk),
                               hp::desc_kmajor(sv, kk), kk > 0);
      hp::wgmma_commit();
    };
    // dQ += dS K of tile i (K MN-major: the keys are the reduction)
    auto issue_dq = [&](int i) {
      const uint8_t* sk = smem + C::K_OFF + (i % STAGES) * TILE;
      hp::fence_regs(dq_acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hp::fence_regs(sa[kk]);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_m64n128k16_rs_mn(dq_acc, sa[kk], hp::desc_mnmajor(sk, kk));
      hp::wgmma_commit();
    };
    // dS = P (dP - delta) scale of tile i, P = exp2(S scale log2(e) - lse
    // log2(e)) selected to 0 outside the band and the real lengths (a row
    // with no valid key has lse = -1e30: exp2 overflows, the select drops
    // it), rounded to bf16 as the A operands (accumulator columns
    // 16kk..16kk+15 are A operand kk)
    auto make_ds = [&](int i) {
      const int kbase = (kt_first + i) * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kbase + j * 8 + 2 * t + e;
          const float e0 =
              hp::exp2_approx(fmaf(sacc[4 * j + e], scale_log2, -l0));
          const float e1 =
              hp::exp2_approx(fmaf(sacc[4 * j + 2 + e], scale_log2, -l1));
          const float p0 = key >= lo0 && key <= hi0 ? e0 : 0.f;
          const float p1 = key >= lo1 && key <= hi1 ? e1 : 0.f;
          ds[e] = p0 * (dpacc[4 * j + e] - dl0) * scale;
          ds[2 + e] = p1 * (dpacc[4 * j + 2 + e] - dl1) * scale;
        }
        sa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        sa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    };
    auto release = [&](int i) {   // this warp is done with K/V tile i
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&kv_empty[i % STAGES]);
    };

    // Every register a product reads or writes is fenced where the product
    // is issued and where it is waited for (else ptxas serialises them).
    // Tile i's dQ product is waited for before tile i + 1's S and dP are
    // issued: with both in flight the kernel needs more registers than two
    // blocks an SM leave it (see the note at the top).
    hp::mbar_wait(&q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      issue_sdp(i);
      hp::wgmma_wait<0>();
      hp::fence_regs(sacc);
      hp::fence_regs(dpacc);
      hp::fence_regs(dq_acc);
      make_ds(i);
      issue_dq(i);
      hp::wgmma_wait<0>();
      hp::fence_regs(dq_acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hp::fence_regs(sa[kk]);
      release(i);
    }

    const long long qrow = (long long)Hq * D;
    if (r0 < Lq) {
      bf16* op = dq + ((long long)b * Lq + r0) * qrow + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
            pack_bf16(dq_acc[4 * j], dq_acc[4 * j + 1]);
    }
    if (r1 < Lq) {
      bf16* op = dq + ((long long)b * Lq + r1) * qrow + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
            pack_bf16(dq_acc[4 * j + 2], dq_acc[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------ K3: dK, dV
// One consumer warpgroup and one producer warp; with one block an SM the
// launch bound leaves 255 registers a thread.
struct Dkv {
  static constexpr int STAGES = KV_STAGES;
  static constexpr int THREADS = 128 + 32;
  static constexpr int TILE = 64 * D * 2;                // 64 x 128 bf16
  static constexpr int V_OFF = TILE;                     // after the K tile
  static constexpr int Q_OFF = 2 * TILE;                 // the ring
  static constexpr int O_OFF = Q_OFF + STAGES * TILE;
  static constexpr int L_OFF = O_OFF + STAGES * TILE;    // lse, log2 domain
  static constexpr int DL_OFF = L_OFF + STAGES * 64 * 4; // delta
  static constexpr int SMEM = DL_OFF + STAGES * 64 * 4 + 1024;  // + align
};

__global__ void __launch_bounds__(Dkv::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int Hq, int Hkv,
                     int window, float scale) {
  using C = Dkv;
  constexpr int TILE = C::TILE, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* sL = reinterpret_cast<float*>(smem + C::L_OFF);
  float* sD = reinterpret_cast<float*>(smem + C::DL_OFF);
  __shared__ __align__(8) uint64_t kv_full;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const int G = Hq / Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * 64;            // this block's first key
  int qt_first, qt_last;
  band_tiles(k0, k0 + 63, Lq, window, 64, qt_first, qt_last);
  const int n_qt = qt_last - qt_first + 1;
  const int n_iter = G * n_qt;               // (query head, query tile)

  if (threadIdx.x == 0) {
    hp::mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 32);            // the producer warp's lanes
      hp::mbar_init(&empty[s], 4);            // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 128) {
    // ---- producer warp: streams the query tiles
    {
      if (lane == 0) {
        uint8_t* vd = smem + C::V_OFF;
        hp::mbar_arrive_expect_tx(&kv_full, 2 * TILE);
        hp::tma_load_4d(smem, &kmap, &kv_full, 0, hk, k0, b);
        hp::tma_load_4d(smem + TILE / 2, &kmap, &kv_full, 64, hk, k0, b);
        hp::tma_load_4d(vd, &vmap, &kv_full, 0, hk, k0, b);
        hp::tma_load_4d(vd + TILE / 2, &vmap, &kv_full, 64, hk, k0, b);
      }
      // lse (log2 domain) and delta of a tile's 64 queries, two a lane,
      // loaded one tile ahead so their latency hides behind the ring
      float pl[2], pd[2];
      auto fetch = [&](int it) {
        const int h = hk * G + it / n_qt;
        const int qbase = (qt_first + it % n_qt) * 64;
        const long long row = ((long long)b * Hq + h) * Lq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qbase + lane + 32 * e;
          pl[e] = qi < Lq ? lse[row + qi] * LOG2E : 0.f;
          pd[e] = qi < Lq ? delta[row + qi] : 0.f;
        }
      };
      if (n_iter > 0) fetch(0);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int h = hk * G + it / n_qt;
        const int qbase = (qt_first + it % n_qt) * 64;
        hp::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sL[s * 64 + lane + 32 * e] = pl[e];
          sD[s * 64 + lane + 32 * e] = pd[e];
        }
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&full[s], 2 * TILE);
          uint8_t* qd = smem + C::Q_OFF + s * TILE;
          uint8_t* od = smem + C::O_OFF + s * TILE;
          hp::tma_load_4d(qd, &qmap, &full[s], 0, h, qbase, b);
          hp::tma_load_4d(qd + TILE / 2, &qmap, &full[s], 64, h, qbase, b);
          hp::tma_load_4d(od, &omap, &full[s], 0, h, qbase, b);
          hp::tma_load_4d(od + TILE / 2, &omap, &full[s], 64, h, qbase, b);
        } else {
          hp::mbar_arrive(&full[s]);
        }
        if (it + 1 < n_iter) fetch(it + 1);
      }
    }
  } else {
    // ---- consumer warpgroup: the 64 keys, dK and dV in registers
    const int warp = threadIdx.x / 32;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;
    const uint8_t* sk = smem;
    const uint8_t* sv = smem + C::V_OFF;
    const float scale_log2 = scale * LOG2E;
    // the queries each of this thread's two keys sees: [lo, hi] (inclusive;
    // none for a key past Lk)
    const int lo0 = window >= 0 ? max(0, key0 - window) : 0;
    const int lo1 = window >= 0 ? max(0, key1 - window) : 0;
    const int hi0 = key0 >= Lk ? -1
                    : window >= 0 ? min(Lq - 1, key0 + window) : Lq - 1;
    const int hi1 = key1 >= Lk ? -1
                    : window >= 0 ? min(Lq - 1, key1 + window) : Lq - 1;

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dpt[32];          // S^T, dP^T; then P^T, dS^T in fp32
    uint32_t pa[4][4], sa[4][4];    // P^T, dS^T as bf16 A operands

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries) of tile `it`
    auto issue_sdp = [&](int it) {
      const int s = it % STAGES;
      hp::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* sq = smem + C::Q_OFF + s * TILE;
      const uint8_t* so = smem + C::O_OFF + s * TILE;
      hp::fence_regs(st);
      hp::fence_regs(dpt);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n64k16_ss(st, hp::desc_kmajor(sk, kk),
                               hp::desc_kmajor(sq, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_m64n64k16_ss(dpt, hp::desc_kmajor(sv, kk),
                               hp::desc_kmajor(so, kk), kk > 0);
      hp::wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of tile `it` (dO and Q MN-major: the
    // queries are the reduction)
    auto issue_dkv = [&](int it) {
      const int s = it % STAGES;
      const uint8_t* sq = smem + C::Q_OFF + s * TILE;
      const uint8_t* so = smem + C::O_OFF + s * TILE;
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::fence_regs(pa[kk]);
        hp::fence_regs(sa[kk]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_m64n128k16_rs_mn(dv_acc, pa[kk], hp::desc_mnmajor(so, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_m64n128k16_rs_mn(dk_acc, sa[kk], hp::desc_mnmajor(sq, kk));
      hp::wgmma_commit();
    };
    // P^T and dS^T of tile `it` in place on S^T and dP^T, selected to 0
    // outside the band and the real lengths (selects, no branch)
    auto make_p_ds = [&](int it) {
      const int s = it % STAGES;
      const int qbase = (qt_first + it % n_qt) * 64;
      const float* ls = sL + s * 64;
      const float* ds = sD + s * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = j * 8 + 2 * t + e;
          const int qi = qbase + ql;
          const float l = ls[ql], dl = ds[ql];
          const float e0 = hp::exp2_approx(st[4 * j + e] * scale_log2 - l);
          const float e1 =
              hp::exp2_approx(st[4 * j + 2 + e] * scale_log2 - l);
          const float p0 = qi >= lo0 && qi <= hi0 ? e0 : 0.f;
          const float p1 = qi >= lo1 && qi <= hi1 ? e1 : 0.f;
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl) * scale;
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl) * scale;
        }
      }
    };
    // rounded to bf16 as the A operands (accumulator columns 16kk..+15 are
    // A operand kk)
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pa[j / 2][(j & 1) * 2] = pack_bf16(st[4 * j], st[4 * j + 1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
        sa[j / 2][(j & 1) * 2] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
        sa[j / 2][(j & 1) * 2 + 1] = pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
      }
    };
    auto fence_dkv = [&]() {
      hp::fence_regs(dk_acc);
      hp::fence_regs(dv_acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hp::fence_regs(pa[kk]);
        hp::fence_regs(sa[kk]);
      }
    };
    auto release = [&](int it) {   // this warp is done with query tile it
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[it % STAGES]);
    };

    // Every register a product reads or writes is fenced where the product
    // is issued and where it is waited for (else ptxas serialises them).
    hp::mbar_wait(&kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      issue_sdp(it);
      hp::wgmma_wait<0>();          // S^T, dP^T of it; dK/dV of it - 1
      hp::fence_regs(st);
      hp::fence_regs(dpt);
      fence_dkv();
      if (it > 0) release(it - 1);
      make_p_ds(it);
      pack();
      issue_dkv(it);
    }
    hp::wgmma_wait<0>();
    fence_dkv();

    const long long krow = (long long)Hkv * D;
    if (key0 < Lk) {
      const long long off = ((long long)b * Lk + key0) * krow + (long long)hk * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + j * 8 + 2 * t) =
            pack_bf16(dk_acc[4 * j], dk_acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + j * 8 + 2 * t) =
            pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
    }
    if (key1 < Lk) {
      const long long off = ((long long)b * Lk + key1) * krow + (long long)hk * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + j * 8 + 2 * t) =
            pack_bf16(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dv + off + j * 8 + 2 * t) =
            pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

}  // namespace

// q, dout (B, Lq, Hq, 128) and k, v (B, Lk, Hkv, 128) bf16, contiguous;
// lse, delta (B, Hq, Lq) fp32 contiguous; dq like q. window < 0 means full
// attention. Returns 0 or a cudaError_t.
extern "C" int acestep_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int Lq, int Lk, int Hq,
                                    int Hkv, int window, float scale,
                                    void* stream) {
  if (B == 0 || Lq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Lk == 0)   // no key: the gradient is zero
    return static_cast<int>(cudaMemsetAsync(
        dq, 0, (size_t)B * Lq * Hq * D * sizeof(bf16), st));
  const long long qrow = (long long)Hq * D, krow = (long long)Hkv * D;
  CUtensorMap qm, km, vm, om;
  int err = hp::encode_blhd(&qm, q, B, Lq, Hq, Lq * qrow, qrow, D);
  if (err == 0) err = hp::encode_blhd(&km, k, B, Lk, Hkv, Lk * krow, krow, D);
  if (err == 0) err = hp::encode_blhd(&vm, v, B, Lk, Hkv, Lk * krow, krow, D);
  if (err == 0) err = hp::encode_blhd(&om, dout, B, Lq, Hq, Lq * qrow, qrow, D);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dq::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Hq / Hkv) * ((Lq + 63) / 64), Hkv, B);
  flash_bwd_dq_kernel<<<grid, Dq::THREADS, Dq::SMEM, st>>>(
      qm, km, vm, om, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Lq, Lk, Hq,
      Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// q, dout (B, Lq, Hq, 128) and k, v (B, Lk, Hkv, 128) bf16, contiguous;
// lse, delta (B, Hq, Lq) fp32 contiguous; dk, dv like k. window < 0 means
// full attention. Returns 0 or a cudaError_t.
extern "C" int acestep_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int Lq,
                                     int Lk, int Hq, int Hkv, int window,
                                     float scale, void* stream) {
  if (B == 0 || Lk == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long qrow = (long long)Hq * D, krow = (long long)Hkv * D;
  if (Lq == 0) {   // no query: both gradients are zero
    const size_t bytes = (size_t)B * Lk * krow * sizeof(bf16);
    cudaError_t e = cudaMemsetAsync(dk, 0, bytes, st);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, bytes, st);
    return static_cast<int>(e);
  }
  CUtensorMap qm, km, vm, om;
  int err = hp::encode_blhd(&qm, q, B, Lq, Hq, Lq * qrow, qrow, D);
  if (err == 0) err = hp::encode_blhd(&km, k, B, Lk, Hkv, Lk * krow, krow, D);
  if (err == 0) err = hp::encode_blhd(&vm, v, B, Lk, Hkv, Lk * krow, krow, D);
  if (err == 0) err = hp::encode_blhd(&om, dout, B, Lq, Hq, Lq * qrow, qrow, D);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Dkv::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Lk + 63) / 64, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, Dkv::THREADS, Dkv::SMEM, st>>>(
      qm, km, vm, om, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Lq, Lk, Hq, Hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}
