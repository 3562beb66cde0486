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
// Design (correct first, mma.sync m16n8k16 with fp32 accumulation):
//  - K2: one block of 4 warps per (64-row query tile, query head, batch),
//    K1's geometry. Each warp keeps its 16 query rows of Q and dO as A
//    fragments in registers and dQ in fp32 accumulators until the one
//    store. It loops over the 32-key tiles that meet [q0 - W, q1 + W],
//    staged in shared memory; S and dP are recomputed there, dS is made in
//    registers and repacked as the A operand of dS K (the C-to-A identity
//    of common.cuh). dQ is owned by one block: no atomics.
//  - K3: one block of 4 warps per (64-key tile, KV head, batch). Each warp
//    owns 16 keys and keeps dK and dV (16 x 128 each) in fp32
//    accumulators; K and V stay in shared memory. The block loops over the
//    G query heads of its KV head and over the 32-query tiles in the
//    symmetric band. It computes S^T = K Q^T and dP^T = V dO^T directly,
//    so P^T and dS^T come out in accumulator layout and repack as the A
//    operands of P^T dO and dS^T Q. dK and dV are owned by one block: no
//    atomics, deterministic sums.
//  - P and dS are rounded to bf16 before their products, as the forward
//    rounds P.
//
// Left on the table: K2 re-reads each K/V tile once per query head of a
// group (one block per group would read it once); the B operands that run
// along the key or query axis (K in dS K, dO and Q in K3) are gathered
// from two 16-bit shared loads each instead of ldmatrix.trans; no
// cp.async/TMA pipelining of the tile loads; mma.sync instead of wgmma.
#include "common.cuh"

namespace {

using acestep::load_u32;
using acestep::mma_bf16_16816;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int D = 128;         // head dim
constexpr int THREADS = 128;   // 4 warps
constexpr int PAD = D + 8;     // padded smem rows: conflict-free fragments

constexpr int DQ_BQ = 64;      // K2: query rows per block (16 per warp)
constexpr int DQ_BK = 32;      // K2: keys per tile

constexpr int KV_BK = 64;      // K3: keys per block (16 per warp)
constexpr int KV_BQ = 32;      // K3: queries per tile
constexpr int KV_SMEM = (2 * KV_BK + 2 * KV_BQ) * PAD * 2 + 2 * KV_BQ * 4;

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
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int Hq, int Hkv,
                     int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*sK)[PAD] = reinterpret_cast<bf16 (*)[PAD]>(smem);
  bf16 (*sV)[PAD] = sK + KV_BK;
  bf16 (*sQ)[PAD] = sV + KV_BK;
  bf16 (*sO)[PAD] = sQ + KV_BQ;
  float* sL = reinterpret_cast<float*>(sO + KV_BQ);
  float* sD = sL + KV_BQ;

  const int b = blockIdx.z, hk = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * KV_BK;
  const int kr0 = warp * 16 + g, kr1 = kr0 + 8;     // rows in the tile
  const int key0 = k0 + kr0, key1 = k0 + kr1;
  const long long qrow = (long long)Hq * D;
  const long long krow = (long long)Hkv * D;

  // this block's K and V tile; keys past Lk are zero
  {
    const bf16* kb = k + (long long)b * Lk * krow + (long long)hk * D;
    const bf16* vb = v + (long long)b * Lk * krow + (long long)hk * D;
    for (int c = threadIdx.x; c < KV_BK * (D / 8); c += THREADS) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = k0 + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < Lk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * krow + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * krow + col);
      }
      *reinterpret_cast<uint4*>(&sK[row][col]) = kv4;
      *reinterpret_cast<uint4*>(&sV[row][col]) = vv4;
    }
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  int qt_first, qt_last;
  band_tiles(k0, k0 + KV_BK - 1, Lq, window, KV_BQ, qt_first, qt_last);

  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const bf16* qb = q + (long long)b * Lq * qrow + (long long)h * D;
    const bf16* ob = dout + (long long)b * Lq * qrow + (long long)h * D;
    const float* lb = lse + ((long long)b * Hq + h) * Lq;
    const float* db = delta + ((long long)b * Hq + h) * Lq;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int qbase = qt * KV_BQ;
      __syncthreads();   // every warp is done with the previous tile
      for (int c = threadIdx.x; c < KV_BQ * (D / 8); c += THREADS) {
        const int row = c / (D / 8), col = (c % (D / 8)) * 8;
        const int qi = qbase + row;
        uint4 qv4 = make_uint4(0, 0, 0, 0), ov4 = make_uint4(0, 0, 0, 0);
        if (qi < Lq) {
          qv4 = *reinterpret_cast<const uint4*>(qb + qi * qrow + col);
          ov4 = *reinterpret_cast<const uint4*>(ob + qi * qrow + col);
        }
        *reinterpret_cast<uint4*>(&sQ[row][col]) = qv4;
        *reinterpret_cast<uint4*>(&sO[row][col]) = ov4;
      }
      if (threadIdx.x < KV_BQ) {
        const int qi = qbase + threadIdx.x;
        sL[threadIdx.x] = qi < Lq ? lb[qi] : 0.f;
        sD[threadIdx.x] = qi < Lq ? db[qi] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 32 queries
      float st[KV_BQ / 8][4], dpt[KV_BQ / 8][4];
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        uint32_t ak[4], av[4];
        ak[0] = load_u32(&sK[kr0][c]);
        ak[1] = load_u32(&sK[kr1][c]);
        ak[2] = load_u32(&sK[kr0][c + 8]);
        ak[3] = load_u32(&sK[kr1][c + 8]);
        av[0] = load_u32(&sV[kr0][c]);
        av[1] = load_u32(&sV[kr1][c]);
        av[2] = load_u32(&sV[kr0][c + 8]);
        av[3] = load_u32(&sV[kr1][c + 8]);
#pragma unroll
        for (int j = 0; j < KV_BQ / 8; ++j) {
          uint32_t bq[2], bo[2];
          bq[0] = load_u32(&sQ[j * 8 + g][c]);
          bq[1] = load_u32(&sQ[j * 8 + g][c + 8]);
          bo[0] = load_u32(&sO[j * 8 + g][c]);
          bo[1] = load_u32(&sO[j * 8 + g][c + 8]);
          mma_bf16_16816(st[j], ak, bq);
          mma_bf16_16816(dpt[j], av, bo);
        }
      }

      // P^T into st, dS^T into dpt; invalid pairs selected to 0
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = j * 8 + 2 * t + e;
          const int qi = qbase + ql;
          const bool qv = qi < Lq;
          const bool v0 = qv && key0 < Lk && in_band(qi, key0, window);
          const bool v1 = qv && key1 < Lk && in_band(qi, key1, window);
          const float l = sL[ql], dl = sD[ql];
          const float p0 = v0 ? expf(st[j][e] * scale - l) : 0.f;
          const float p1 = v1 ? expf(st[j][2 + e] * scale - l) : 0.f;
          st[j][e] = p0;
          st[j][2 + e] = p1;
          dpt[j][e] = p0 * (dpt[j][e] - dl) * scale;
          dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dl) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q; dO's and Q's B fragments run along
      // the query axis
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        uint32_t ap[4], as[4];
        ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        as[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        as[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        as[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        as[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        const int qr = kk * 16 + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = j * 8 + g;
          uint32_t bo[2], bq[2];
          bo[0] = pack_pair(&sO[qr][col], &sO[qr + 1][col]);
          bo[1] = pack_pair(&sO[qr + 8][col], &sO[qr + 9][col]);
          bq[0] = pack_pair(&sQ[qr][col], &sQ[qr + 1][col]);
          bq[1] = pack_pair(&sQ[qr + 8][col], &sQ[qr + 9][col]);
          mma_bf16_16816(dv_acc[j], ap, bo);
          mma_bf16_16816(dk_acc[j], as, bq);
        }
      }
    }
  }

  if (key0 < Lk) {
    const long long off = ((long long)b * Lk + key0) * krow + (long long)hk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8 + 2 * t) =
          pack_bf16(dk_acc[j][0], dk_acc[j][1]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8 + 2 * t) =
          pack_bf16(dv_acc[j][0], dv_acc[j][1]);
    }
  }
  if (key1 < Lk) {
    const long long off = ((long long)b * Lk + key1) * krow + (long long)hk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8 + 2 * t) =
          pack_bf16(dk_acc[j][2], dk_acc[j][3]);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8 + 2 * t) =
          pack_bf16(dv_acc[j][2], dv_acc[j][3]);
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

// The same inputs; dk, dv like k. Returns cudaGetLastError().
extern "C" int acestep_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int Lq,
                                     int Lk, int Hq, int Hkv, int window,
                                     float scale, void* stream) {
  if (B == 0 || Lk == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + KV_BK - 1) / KV_BK, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, THREADS, KV_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Lq, Lk, Hq, Hkv,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}
