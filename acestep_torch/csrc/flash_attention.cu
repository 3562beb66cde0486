// Flash-attention forward for Hopper: bidirectional GQA attention with an
// optional band |i - j| <= W, online softmax, fp32 accumulation, scale
// 1/sqrt(D). Returns `out` (bf16) and the fp32 logsumexp `lse` that a
// backward kernel recomputes P from.
//
// Replaces acestep_tpu/ops/flash_attention.py::_kernel (the Pallas forward
// kernel). It keeps that kernel's semantics, not its TPU blocking: padded
// keys are masked in-kernel at their true length, a row with no valid key
// writes out = 0 and lse = m + log 1, and the band is inclusive.
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a full layer does
// 4*Hq*Lq*Lk*D operations against (|q|+|k|+|v|+|out|) bytes, so it is
// compute-bound (L = 750: ~4.6 GFLOP vs ~9 MB); a banded layer (W = 128)
// does at most 4*Hq*Lq*(2W+1)*D operations and is memory-bound.
//
// Design (correct first; wgmma, TMA and warp specialisation come later):
//  - one block of 4 warps per (64-row query tile, query head, batch); query
//    head h reads KV head h / (Hq / Hkv). q, k and v are read through their
//    (B, L, H, D) strides, with no transpose copy;
//  - each warp keeps its 16 query rows as mma A fragments in registers;
//  - K/V tiles of 64 keys are staged in shared memory (V transposed, so
//    its B fragments are contiguous pairs); only the key tiles that meet
//    [q0 - W, q1 + W] are visited when the attention is banded;
//  - S = Q K^T and O += P V run on mma.sync bf16 tensor cores; S stays in
//    registers, is masked and exponentiated there, and is repacked as the
//    A operand of the P V product. The running max m and sum l are fp32.
#include "common.cuh"

namespace {

using acestep::load_u32;
using acestep::mma_bf16_16816;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int D = 128;     // head dim
constexpr int BQ = 64;     // query rows per block (16 per warp)
constexpr int BK = 64;     // keys per tile
constexpr int THREADS = 128;
constexpr int KPAD = D + 8;    // padded smem rows: conflict-free fragments
constexpr int VPAD = BK + 8;

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int Hq, int Hkv,
                 long long qsb, long long qsl, long long qsh,
                 long long ksb, long long ksl, long long ksh,
                 long long vsb, long long vsl, long long vsh,
                 int window, float scale) {
  __shared__ __align__(16) bf16 sK[BK][KPAD];
  __shared__ __align__(16) bf16 sVt[D][VPAD];

  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  // Q tile rows of this warp as A fragments; rows past Lq are zero.
  uint32_t qf[D / 16][4];
  {
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* q0p = qb + (long long)r0 * qsl;
    const bf16* q1p = qb + (long long)r1 * qsl;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qf[kk][0] = r0 < Lq ? load_u32(q0p + c) : 0u;
      qf[kk][1] = r1 < Lq ? load_u32(q1p + c) : 0u;
      qf[kk][2] = r0 < Lq ? load_u32(q0p + c + 8) : 0u;
      qf[kk][3] = r1 < Lq ? load_u32(q1p + c + 8) : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;   // running max (rows g, g+8)
  float l0 = 0.f, l1 = 0.f;         // this lane's part of the running sum

  int k_lo = 0, k_hi = Lk - 1;
  if (window >= 0) {
    k_lo = max(0, q0 - window);
    k_hi = min(Lk - 1, q0 + BQ - 1 + window);
  }
  const int kt_first = k_lo / BK;
  const int kt_last = k_hi >= k_lo ? k_hi / BK : kt_first - 1;

  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int kbase = kt * BK;
    __syncthreads();   // every warp is done with the previous tile
    for (int c = threadIdx.x; c < BK * (D / 8); c += THREADS) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      const int key = kbase + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < Lk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * ksl + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * vsl + col);
      }
      *reinterpret_cast<uint4*>(&sK[row][col]) = kv4;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[col + e][row] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        uint32_t bfrag[2];
        bfrag[0] = load_u32(&sK[j * 8 + g][kk * 16 + 2 * t]);
        bfrag[1] = load_u32(&sK[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(s[j], qf[kk], bfrag);
      }
    }

    // mask (key < Lk, band) and the online-softmax update
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kbase + j * 8 + 2 * t + e;
        const bool kv = key < Lk;
        const bool v0 = kv && (window < 0 || abs(r0 - key) <= window);
        const bool v1 = kv && (window < 0 || abs(r1 - key) <= window);
        s[j][e] = v0 ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = v1 ? s[j][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = expf(s[j][0] - m0);   // masked: exp(-inf) = 0
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V, with P (bf16) taken straight from the S registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bfrag[2];
        bfrag[0] = load_u32(&sVt[j * 8 + g][kk * 16 + 2 * t]);
        bfrag[1] = load_u32(&sVt[j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(o[j], a, bfrag);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;

  if (r0 < Lq) {
    bf16* op = out + (((long long)b * Lq + r0) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
          pack_bf16(o[j][0] / ls0, o[j][1] / ls0);
    if (t == 0) lse[((long long)b * Hq + h) * Lq + r0] = m0 + logf(ls0);
  }
  if (r1 < Lq) {
    bf16* op = out + (((long long)b * Lq + r1) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t) =
          pack_bf16(o[j][2] / ls1, o[j][3] / ls1);
    if (t == 0) lse[((long long)b * Hq + h) * Lq + r1] = m1 + logf(ls1);
  }
}

}  // namespace

extern "C" const char* acestep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Lq, Hq, 128), k/v (B, Lk, Hkv, 128) bf16 with unit stride on the
// head dim and 16-byte aligned rows (checked by the Python wrapper);
// out (B, Lq, Hq, 128) bf16 and lse (B, Hq, Lq) fp32 contiguous.
// window < 0 means full attention. Returns cudaGetLastError().
extern "C" int acestep_flash_fwd(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int Lq, int Lk,
                                 int Hq, int Hkv, long long qsb, long long qsl,
                                 long long qsh, long long ksb, long long ksl,
                                 long long ksh, long long vsb, long long vsl,
                                 long long vsh, int window, float scale,
                                 void* stream) {
  if (B == 0 || Lq == 0) return 0;
  dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), Lq, Lk, Hq, Hkv, qsb, qsl, qsh, ksb, ksl, ksh,
      vsb, vsl, vsh, window, scale);
  return static_cast<int>(cudaGetLastError());
}
