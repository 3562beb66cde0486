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
// K2 (correct first, mma.sync m16n8k16 with fp32 accumulation): one block
// of 4 warps per (64-row query tile, query head, batch), K1's old
// geometry. Each warp keeps its 16 query rows of Q and dO as A fragments in
// registers and dQ in fp32 accumulators until the one store. It loops over
// the 32-key tiles that meet [q0 - W, q1 + W], staged in shared memory; S
// and dP are recomputed there, dS is made in registers and repacked as the
// A operand of dS K (the C-to-A identity of common.cuh). dQ is owned by one
// block: no atomics. Left on the table: it re-reads each K/V tile once per
// query head of a group; K's B fragments along the key axis are gathered
// from two 16-bit shared loads each; no TMA pipelining; mma.sync instead
// of wgmma.
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
using acestep::load_u32;
using acestep::mma_bf16_16816;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int D = 128;         // head dim
constexpr int THREADS = 128;   // 4 warps
constexpr int PAD = D + 8;     // padded smem rows: conflict-free fragments

constexpr int DQ_BQ = 64;      // K2: query rows per block (16 per warp)
constexpr int DQ_BK = 32;      // K2: keys per tile

constexpr int KV_STAGES = 3;   // K3: stages of the query-tile ring
constexpr float LOG2E = 1.4426950408889634f;

// Two bf16 values from two addresses -> one register, the first in the
// low half (the lower k index of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_pair(const bf16* lo, const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

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

__device__ __forceinline__ bool in_band(int i, int j, int window) {
  return window < 0 || abs(i - j) <= window;
}

// ---------------------------------------------------------------- K2: dQ
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Lq, int Lk, int Hq, int Hkv, int window, float scale) {
  __shared__ __align__(16) bf16 sK[DQ_BK][PAD];
  __shared__ __align__(16) bf16 sV[DQ_BK][PAD];

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * DQ_BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long long qrow = (long long)Hq * D;    // (B, L, H, D) contiguous
  const long long krow = (long long)Hkv * D;

  // Q and dO rows of this warp as A fragments; rows past Lq are zero.
  uint32_t qf[D / 16][4], of[D / 16][4];
  {
    const long long base = (long long)b * Lq * qrow + (long long)h * D;
    const bf16* q0p = q + base + r0 * qrow;
    const bf16* q1p = q + base + r1 * qrow;
    const bf16* o0p = dout + base + r0 * qrow;
    const bf16* o1p = dout + base + r1 * qrow;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = r0 < Lq ? load_u32(q0p + c) : 0u;
      qf[kk][1] = r1 < Lq ? load_u32(q1p + c) : 0u;
      qf[kk][2] = r0 < Lq ? load_u32(q0p + c + 8) : 0u;
      qf[kk][3] = r1 < Lq ? load_u32(q1p + c + 8) : 0u;
      of[kk][0] = r0 < Lq ? load_u32(o0p + c) : 0u;
      of[kk][1] = r1 < Lq ? load_u32(o1p + c) : 0u;
      of[kk][2] = r0 < Lq ? load_u32(o0p + c + 8) : 0u;
      of[kk][3] = r1 < Lq ? load_u32(o1p + c + 8) : 0u;
    }
  }
  const long long row_base = ((long long)b * Hq + h) * Lq;
  const float lse0 = r0 < Lq ? lse[row_base + r0] : 0.f;
  const float lse1 = r1 < Lq ? lse[row_base + r1] : 0.f;
  const float del0 = r0 < Lq ? delta[row_base + r0] : 0.f;
  const float del1 = r1 < Lq ? delta[row_base + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int kt_first, kt_last;
  band_tiles(q0, q0 + DQ_BQ - 1, Lk, window, DQ_BK, kt_first, kt_last);
  const bf16* kb = k + (long long)b * Lk * krow + (long long)hk * D;
  const bf16* vb = v + (long long)b * Lk * krow + (long long)hk * D;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int kbase = kt * DQ_BK;
    __syncthreads();   // every warp is done with the previous tile
    for (int c = threadIdx.x; c < DQ_BK * (D / 8); c += THREADS) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = kbase + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < Lk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * krow + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * krow + col);
      }
      *reinterpret_cast<uint4*>(&sK[row][col]) = kv4;
      *reinterpret_cast<uint4*>(&sV[row][col]) = vv4;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for 16 rows x 32 keys
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j) {
        uint32_t bk[2], bv[2];
        bk[0] = load_u32(&sK[j * 8 + g][kk * 16 + 2 * t]);
        bk[1] = load_u32(&sK[j * 8 + g][kk * 16 + 2 * t + 8]);
        bv[0] = load_u32(&sV[j * 8 + g][kk * 16 + 2 * t]);
        bv[1] = load_u32(&sV[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(s[j], qf[kk], bk);
        mma_bf16_16816(dp[j], of[kk], bv);
      }
    }

    // P from lse, selected to 0 outside the band / real lengths; dS into s
#pragma unroll
    for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kbase + j * 8 + 2 * t + e;
        const bool kv = key < Lk;
        const bool v0 = kv && r0 < Lq && in_band(r0, key, window);
        const bool v1 = kv && r1 < Lq && in_band(r1, key, window);
        const float p0 = v0 ? expf(s[j][e] * scale - lse0) : 0.f;
        const float p1 = v1 ? expf(s[j][2 + e] * scale - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - del0) * scale;
        s[j][2 + e] = p1 * (dp[j][2 + e] - del1) * scale;
      }
    }

    // dQ += dS K: dS (bf16) straight from the accumulators; K's B
    // fragments run along the key axis
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + g;
        uint32_t bfrag[2];
        bfrag[0] = pack_pair(&sK[kr][col], &sK[kr + 1][col]);
        bfrag[1] = pack_pair(&sK[kr + 8][col], &sK[kr + 9][col]);
        mma_bf16_16816(acc[j], a, bfrag);
      }
    }
  }

  if (r0 < Lq) {
    bf16* op = dq + ((long long)b * Lq + r0) * qrow + (long long)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
          pack_bf16(acc[j][0], acc[j][1]);
  }
  if (r1 < Lq) {
    bf16* op = dq + ((long long)b * Lq + r1) * qrow + (long long)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
          pack_bf16(acc[j][2], acc[j][3]);
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
// attention. Returns cudaGetLastError().
extern "C" int acestep_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int Lq, int Lk, int Hq,
                                    int Hkv, int window, float scale,
                                    void* stream) {
  if (B == 0 || Lq == 0) return 0;
  dim3 grid((Lq + DQ_BQ - 1) / DQ_BQ, Hq, B);
  flash_bwd_dq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Lq, Lk, Hq, Hkv, window, scale);
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
