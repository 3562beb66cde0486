// Fused Snake + conv residual stack of the Oobleck VAE for Hopper: three
// residual units with dilations 1, 3, 9, each
//     x <- x + conv1(snake2(conv7_dilated(snake1(x))))
// on (N, L, C) bf16, with the convs' positions outside [0, L) zero, as a
// chain of zero-padded 'same' convs sees them.
//
// Replaces acestep_tpu/ops/snake_conv.py::_kernel (the Pallas kernel).
// Same numerics: snake in fp32 as x + sin^2(e^a x) / (e^b + 1e-9), with
// sin^2 from the Cody-Waite reduced degree-6 cos(2 pi r) polynomial of
// `_sin2`; conv operands rounded to bf16 and accumulated in fp32; the
// residual carried in fp32 across the three units and re-zeroed outside
// [0, L) after every unit.
//
// Bound on an H100: 48*C^2 operations per sample (three units of a k=7
// and a k=1 product) against 4*C bytes moved, so it is tensor-core-bound
// (C = 128 at 48 kHz in a 4 x 491520 window: ~1.5 TFLOP, ~1.6 ms at 989
// TFLOP/s, against ~1 GB, ~0.3 ms at 3.35 TB/s).
//
// Design (correct first):
//  - one block of 8 warps per (batch row, tile of BL output samples); the
//    tile plus a 39-sample halo on each side (3 * (1 + 3 + 9)) sits in
//    shared memory as an fp32 residual carrier, with a bf16 operand buffer
//    beside it: (BL + 78) * C * 6 bytes, BL chosen per C under 227 KB;
//  - per unit: snake1 of the carrier into the operand buffer; then each
//    warp takes 16-row tiles of the unit's (shrinking) output range and
//    runs the k=7 dilated conv as 7 shifted (16 x C) . (C x C) mma.sync
//    products into fp32 registers, adds the bias, applies snake2 in
//    registers and repacks the result as the A operand of the k=1 product
//    (no shared-memory round trip), whose result is added to the carrier
//    rows in place;
//  - the weights (2.75 MB at C = 256) do not fit in shared memory; they are
//    read tile by tile from L2, pre-transposed by the wrapper to (out, in)
//    so each B fragment is one 32-bit load.
#include "common.cuh"

namespace {

using acestep::load_u32;
using acestep::mma_bf16_16816;
using acestep::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int HALO = 39;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int OPAD = 8;   // bf16 padding per operand row: conflict-free loads

template <int C>
struct Tile {
  static constexpr int BL = C >= 256 ? 64 : (C >= 128 ? 192 : 256);
  static constexpr int W = BL + 2 * HALO;           // carrier rows
  static constexpr int OROWS = W + 16;              // operand rows (+ tile pad)
  static constexpr size_t SMEM =
      size_t(W) * C * sizeof(float) + size_t(OROWS) * (C + OPAD) * sizeof(bf16);
};

// sin(t)^2 = 0.5 - 0.5 cos(2t); acestep_tpu/ops/snake_conv.py::_sin2
__device__ __forceinline__ float sin2_poly(float t) {
  const float inv_pi = 0.318309886183790671f;
  const float n = rintf(t * inv_pi);
  const float r = ((t - n * 3.140625f) - n * 9.6765358979e-4f) * inv_pi;
  const float z = r * r;
  float c = 5.3783531880e+00f;
  c = c * z + -2.4793177246e+01f;
  c = c * z + 5.9704888277e+01f;
  c = c * z + -8.5364105726e+01f;
  c = c * z + 6.4931763898e+01f;
  c = c * z + -1.9738972511e+01f;
  c = c * z + 9.9999880376e-01f;
  return 0.5f - 0.5f * c;
}

__device__ __forceinline__ float snake(float x, float ea, float ieb) {
  return x + ieb * sin2_poly(ea * x);
}

// w7t: (3, 7, C_out, C_in) bf16; wpt: (3, C_out, C_in) bf16;
// b7, bp: (3, C) fp32; ea, ieb: (3, 2, C) fp32 = exp(alpha),
// 1/(exp(beta) + 1e-9) for [unit][snake1, snake2][channel].
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
snake_conv_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                  const bf16* __restrict__ w7t, const bf16* __restrict__ wpt,
                  const float* __restrict__ b7, const float* __restrict__ bp,
                  const float* __restrict__ ea, const float* __restrict__ ieb,
                  int L) {
  using T = Tile<C>;
  constexpr int LD = C + OPAD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* carrier = reinterpret_cast<float*>(smem);
  bf16* opnd = reinterpret_cast<bf16*>(smem + size_t(T::W) * C * sizeof(float));

  const long long n = blockIdx.y;
  const int t0 = blockIdx.x * T::BL;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // operand rows past the tile range feed only rows that are never stored;
  // zero them once so they hold no stale bits
  for (int i = threadIdx.x; i < T::OROWS * LD / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(opnd)[i] = 0u;
  for (int i = threadIdx.x; i < T::W * C / 2; i += THREADS) {
    const int r = i / (C / 2), c = (i % (C / 2)) * 2;
    const int pos = t0 - HALO + r;
    float2 val = make_float2(0.f, 0.f);
    if (pos >= 0 && pos < L)
      val = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          x + (n * L + pos) * C + c));
    *reinterpret_cast<float2*>(carrier + r * C + c) = val;
  }
  __syncthreads();

  int lo = 0, hi = T::W;   // carrier rows that hold this unit's input
#pragma unroll 1
  for (int u = 0; u < 3; ++u) {
    const int d = u == 0 ? 1 : (u == 1 ? 3 : 9);
    const float* ea1 = ea + (u * 2 + 0) * C;
    const float* ieb1 = ieb + (u * 2 + 0) * C;
    const float* ea2 = ea + (u * 2 + 1) * C;
    const float* ieb2 = ieb + (u * 2 + 1) * C;
    const float* b7u = b7 + u * C;
    const float* bpu = bp + u * C;

    for (int i = threadIdx.x; i < (hi - lo) * (C / 2); i += THREADS) {
      const int r = lo + i / (C / 2), c = (i % (C / 2)) * 2;
      const float2 xv = *reinterpret_cast<const float2*>(carrier + r * C + c);
      *reinterpret_cast<uint32_t*>(opnd + r * LD + c) = pack_bf16(
          snake(xv.x, ea1[c], ieb1[c]), snake(xv.y, ea1[c + 1], ieb1[c + 1]));
    }
    __syncthreads();

    const int olo = lo + 3 * d, ohi = hi - 3 * d;
    const int ntile = (ohi - olo + 15) / 16;
#pragma unroll 1
    for (int tile = warp; tile < ntile; tile += NWARP) {
      const int rbase = olo + tile * 16;

      // k=7 dilated conv: 7 shifted (16 x C) . (C x C) products
      float acc[C / 8][4];
#pragma unroll
      for (int j = 0; j < C / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
      for (int i = 0; i < 7; ++i) {
        const bf16* a0p = opnd + (rbase - 3 * d + i * d + g) * LD + 2 * t;
        const bf16* a1p = a0p + 8 * LD;
        const bf16* wt = w7t + (size_t(u) * 7 + i) * C * C + size_t(g) * C + 2 * t;
#pragma unroll 1
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t a[4];
          a[0] = load_u32(a0p + kk * 16);
          a[1] = load_u32(a1p + kk * 16);
          a[2] = load_u32(a0p + kk * 16 + 8);
          a[3] = load_u32(a1p + kk * 16 + 8);
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            const bf16* wp = wt + size_t(j) * 8 * C + kk * 16;
            uint32_t bfrag[2] = {__ldg(reinterpret_cast<const unsigned int*>(wp)),
                                 __ldg(reinterpret_cast<const unsigned int*>(wp + 8))};
            mma_bf16_16816(acc[j], a, bfrag);
          }
        }
      }

      // bias + snake2 in registers, repacked as the k=1 product's A operand
      uint32_t zf[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * kk + half;
          const int c = j * 8 + 2 * t;
          const float bias0 = b7u[c], bias1 = b7u[c + 1];
          const float e0 = ea2[c], e1 = ea2[c + 1];
          const float i0 = ieb2[c], i1 = ieb2[c + 1];
          zf[kk][2 * half] = pack_bf16(snake(acc[j][0] + bias0, e0, i0),
                                       snake(acc[j][1] + bias1, e1, i1));
          zf[kk][2 * half + 1] = pack_bf16(snake(acc[j][2] + bias0, e0, i0),
                                           snake(acc[j][3] + bias1, e1, i1));
        }
      }

      // k=1 product in chunks of 64 output channels, added to the carrier
      constexpr int NCH = C / 8 < 8 ? C / 8 : 8;
#pragma unroll 1
      for (int nc = 0; nc < C / 8; nc += NCH) {
        float z[NCH][4];
#pragma unroll
        for (int j = 0; j < NCH; ++j) z[j][0] = z[j][1] = z[j][2] = z[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const bf16* wp = wpt + size_t(u) * C * C +
                             size_t((nc + j) * 8 + g) * C + kk * 16 + 2 * t;
            uint32_t bfrag[2] = {__ldg(reinterpret_cast<const unsigned int*>(wp)),
                                 __ldg(reinterpret_cast<const unsigned int*>(wp + 8))};
            mma_bf16_16816(z[j], zf[kk], bfrag);
          }
        }
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int c = (nc + j) * 8 + 2 * t;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = rbase + g + 8 * rr;
            if (r >= ohi) continue;
            const int pos = t0 - HALO + r;
            float2* cp = reinterpret_cast<float2*>(carrier + r * C + c);
            float2 cur = *cp;
            if (pos >= 0 && pos < L) {
              cur.x += z[j][2 * rr] + bpu[c];
              cur.y += z[j][2 * rr + 1] + bpu[c + 1];
            } else {
              cur = make_float2(0.f, 0.f);
            }
            *cp = cur;
          }
        }
      }
    }
    __syncthreads();
    lo = olo;
    hi = ohi;
  }

  // carrier rows [HALO, HALO + BL) are this tile's outputs
  for (int i = threadIdx.x; i < T::BL * C / 2; i += THREADS) {
    const int r = i / (C / 2), c = (i % (C / 2)) * 2;
    const int pos = t0 + r;
    if (pos >= L) continue;
    const float2 val = *reinterpret_cast<const float2*>(carrier + (r + HALO) * C + c);
    *reinterpret_cast<uint32_t*>(out + (n * L + pos) * C + c) = pack_bf16(val.x, val.y);
  }
}

template <int C>
int launch(const bf16* x, bf16* out, const bf16* w7t, const bf16* wpt,
           const float* b7, const float* bp, const float* ea, const float* ieb,
           int N, int L, cudaStream_t stream) {
  using T = Tile<C>;
  cudaError_t err = cudaFuncSetAttribute(
      snake_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + T::BL - 1) / T::BL, N);
  snake_conv_kernel<C><<<grid, THREADS, T::SMEM, stream>>>(
      x, out, w7t, wpt, b7, bp, ea, ieb, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/out (N, L, C) bf16 contiguous; C in {16, 32, 64, 128, 256} (checked by
// the Python wrapper). Returns cudaGetLastError().
extern "C" int acestep_snake_conv(const void* x, void* out, const void* w7t,
                                  const void* wpt, const void* b7,
                                  const void* bp, const void* ea,
                                  const void* ieb, int N, int L, int C,
                                  void* stream) {
  if (N == 0 || L == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const bf16*>(x);
  auto xo = static_cast<bf16*>(out);
  auto w7 = static_cast<const bf16*>(w7t);
  auto wp = static_cast<const bf16*>(wpt);
  auto b7f = static_cast<const float*>(b7);
  auto bpf = static_cast<const float*>(bp);
  auto eaf = static_cast<const float*>(ea);
  auto iebf = static_cast<const float*>(ieb);
  switch (C) {
    case 16: return launch<16>(xi, xo, w7, wp, b7f, bpf, eaf, iebf, N, L, s);
    case 32: return launch<32>(xi, xo, w7, wp, b7f, bpf, eaf, iebf, N, L, s);
    case 64: return launch<64>(xi, xo, w7, wp, b7f, bpf, eaf, iebf, N, L, s);
    case 128: return launch<128>(xi, xo, w7, wp, b7f, bpf, eaf, iebf, N, L, s);
    case 256: return launch<256>(xi, xo, w7, wp, b7f, bpf, eaf, iebf, N, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
