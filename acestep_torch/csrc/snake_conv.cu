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
// residual carried in fp32 across the three units and zero outside [0, L)
// after every unit.
//
// Bound on an H100: 48*C^2 operations per sample (three units of a k=7
// and a k=1 product) against 4*C bytes moved, so it is tensor-core-bound
// (C = 128 at 48 kHz in a 4 x 491520 window: ~1.5 TFLOP, ~1.6 ms at 989
// TFLOP/s, against ~1 GB, ~0.3 ms at 3.35 TB/s).
//
// Design for C = 128 and 256 (the main path's widths): one launch a unit,
// the fp32 residual carried between the three launches through device
// memory (two scratch buffers), each launch a TMA + wgmma kernel:
//  - one block per (batch row, 128 output samples): two consumer
//    warpgroups of one 64-row tile each and a producer warp, one block an
//    SM;
//  - the consumers apply snake1 to the unit's input over the block's rows
//    and a 3d halo each side (zero outside [0, L), as the residual is
//    there) into a padded bf16 operand window in shared memory, four rows'
//    loads in flight a thread;
//  - the producer streams the unit's weights, tap by tap (the seven taps of
//    the k=7 conv, then the k=1 conv), into a 96 KB ring by TMA, one box of
//    64 input channels x C output rows a stage (128-byte swizzle, K-major
//    for wgmma as stored (out, in): 16 KB at C = 128, 32 KB at 256). Both
//    tiles of the block reuse each stage, so a block reads a unit's weights
//    once (the PR 1 design read them again for every 16 rows: ~118 GB from
//    L2 at (4, 491520, 128), 11.8 GB now over the three launches);
//  - tap i is M = 64 rows x N = C x K = C as wgmma with A from registers,
//    loaded by ldmatrix from the operand window at the row shift i d (any
//    shift: the padded rows are 16-byte aligned) and B from the stage;
//  - bias and snake2 on the fp32 accumulators, written as bf16 into the
//    operand window over the block's own rows once both warpgroups are
//    done reading it; the k=1 product reads them back by ldmatrix; the
//    result plus bias plus the residual is stored, fp32 for the next unit,
//    bf16 after the last.
// Shared memory: the operand window (128 + 54) (C + 8) 2 bytes and the
// ring, 146 KB at C = 128 and 191 KB at C = 256 of the 227 KB a block may
// have. One fused launch does not fit at C = 256: a 128 KB tap beside an
// fp32 carrier of 1 KB a row leaves no useful BL. The per-unit launches
// cost ~20 bytes a sample of residual traffic (~5 GB at (4, 491520, 128),
// ~1.5 ms at 3.35 TB/s) but compute no halo rows in the products, where a
// fused launch computes 1.4-1.7x the output rows. TMA's zero fill is not
// used for the sequence edges: the activations pass through registers for
// the snake on their way in, so they are plain loads with a bounds test.
// Measured on an H100 (PERF.md) and not kept, all as fast within the
// run-to-run spread:
// two tiles a warpgroup (BL = 256; 168 registers with spills), one
// warpgroup a block at two blocks an SM, 64 or 128 KB rings, and four
// k16-steps a commit at C = 256 (it spills). Three consumer warpgroups at
// C = 256 do not compile (ptxas allows 416 threads 128 registers).
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = acestep::hopper;
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
  static constexpr int BL = 256;
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

// C <= 64 (the tiny test configurations): PR 1's design, the three units
// fused in one launch, mma.sync with the weights read from L2.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
snake_conv_small_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                        const bf16* __restrict__ w,
                        const float* __restrict__ b7,
                        const float* __restrict__ bp,
                        const float* __restrict__ ea,
                        const float* __restrict__ ieb, int L) {
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
        const bf16* wt = w + (size_t(u) * 8 + i) * C * C + size_t(g) * C + 2 * t;
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
            const bf16* wp = w + (size_t(u) * 8 + 7) * C * C +
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

// ------------------------------------------------- C = 128, 256: one unit
// Two consumer warpgroups of one 64-row tile each and a producer warp;
// ptxas caps the 288 threads at 168 registers, which the C = 256
// accumulators (128 a thread) fit with the A operands of two k16-steps in
// flight, C = 128 with four.
template <int C_>
struct Unit {
  static constexpr int C = C_;
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int BL = 64 * NWG;              // output rows a block
  static constexpr int LD = C + OPAD;              // operand row, bf16
  static constexpr int ROWS = BL + 6 * 9;          // widest window (d = 9)
  static constexpr int STAGE = C * 128;            // C rows x 64 inputs
  static constexpr int STAGES = 98304 / STAGE;     // a 96 KB ring
  static constexpr int KS = 4;                     // k16-steps a stage
  static constexpr int SPT = C / 64;               // stages a tap
  static constexpr int NST = 8 * SPT;              // stages a unit
  static constexpr int KG = C == 256 ? 2 : 4;      // k16-steps a commit
  static constexpr int CONSUMERS = NWG * 128;
  static constexpr int THREADS = CONSUMERS + 32;   // + a producer warp
  static constexpr int RING_OFF = (ROWS * LD * 2 + 1023) / 1024 * 1024;
  static constexpr int SMEM = RING_OFF + STAGES * STAGE + 1024;  // + align
  static_assert(SMEM <= 232448, "shared memory");
};

__device__ __forceinline__ void conv_mma(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  hp::wgmma_m64n128k16_rs(d, a, desc);
}
__device__ __forceinline__ void conv_mma(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  hp::wgmma_m64n256k16_rs(d, a, desc);
}

// 8 channels [c, c + 8) of one row of the unit's input as fp32.
__device__ __forceinline__ void load8(const void* in, bool in_f32,
                                      long long off, float (&v)[8]) {
  if (in_f32) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(in) + off);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(in) + off);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// One residual unit u (dilation d) on BL output samples of one batch row:
// out = in + conv1(snake2(conv7_d(snake1(in)))), in and out (N, L, C),
// fp32 or bf16 (in_f32, out_f32). w: (3, 8, C_out, C_in) bf16 through
// `wmap` (taps 0-6 the k=7 conv, tap 7 the k=1 conv); b7, bp: (3, C) fp32;
// ea, ieb: (3, 2, C) fp32 = exp(alpha), 1/(exp(beta) + 1e-9) for [unit]
// [snake1, snake2][channel].
template <class U>
__global__ void __launch_bounds__(U::THREADS, 1)
snake_unit_kernel(const __grid_constant__ CUtensorMap wmap,
                  const void* __restrict__ in, void* __restrict__ out,
                  const float* __restrict__ b7, const float* __restrict__ bp,
                  const float* __restrict__ ea, const float* __restrict__ ieb,
                  int L, int u, int d, int in_f32, int out_f32) {
  constexpr int C = U::C, LD = U::LD, STAGES = U::STAGES;
  constexpr int KS = U::KS, SPT = U::SPT, KG = U::KG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* opnd = reinterpret_cast<bf16*>(smem);
  uint8_t* ring = smem + U::RING_OFF;
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];

  const long long n = blockIdx.y;
  const int t0 = blockIdx.x * U::BL;
  const int halo = 3 * d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 4 * U::NWG);   // one arrival per consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= U::CONSUMERS) {
    // ---- producer warp: one thread streams the unit's 8 taps
    if (threadIdx.x == U::CONSUMERS) {
      for (int st = 0; st < U::NST; ++st) {
        const int s = st % STAGES;
        hp::mbar_wait(&empty[s], ((st / STAGES) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], U::STAGE);
        hp::tma_load_2d(ring + s * U::STAGE, &wmap, &full[s], (st % SPT) * 64,
                        (u * 8 + st / SPT) * C);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // snake1 of the input over [t0 - 3d, t0 + BL + 3d) into the operand
  // window (row r is position t0 - 3d + r). A thread always takes the same
  // 8 channels (its snake tables stay in registers) and every RSTEP-th
  // row, loading RB rows before it computes any, so RB loads are in flight
  {
    constexpr int RSTEP = U::CONSUMERS / (C / 8), RB = 4;
    const int c = (threadIdx.x % (C / 8)) * 8;
    float e1[8], i1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      e1[e] = __ldg(ea + (u * 2 + 0) * C + c + e);
      i1[e] = __ldg(ieb + (u * 2 + 0) * C + c + e);
    }
    const int rows = U::BL + 2 * halo;
    for (int r0 = threadIdx.x / (C / 8); r0 < rows; r0 += RB * RSTEP) {
      float v[RB][8];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int pos = t0 - halo + r0 + q * RSTEP;
        if (r0 + q * RSTEP < rows && pos >= 0 && pos < L) {
          load8(in, in_f32, (n * L + pos) * C + c, v[q]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[q][e] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = r0 + q * RSTEP;
        if (r >= rows) break;
        uint32_t pk[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pk[e] = pack_bf16(snake(v[q][2 * e], e1[2 * e], i1[2 * e]),
                            snake(v[q][2 * e + 1], e1[2 * e + 1],
                                  i1[2 * e + 1]));
        *reinterpret_cast<uint4*>(opnd + r * LD + c) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
    }
  }
  hp::bar_sync_consumers<U::CONSUMERS>();

  // this warp's ldmatrix address inside the 64-row tile
  const int lrow = warp * 16 + (lane & 15), lcol = (lane >> 4) * 8;
  const int o_first = wg * 64;        // the warpgroup's first output row
  float acc[C / 2];

  // The KS k16-steps of ring stage st against the operand rows from `arow`,
  // channels from 16 kbase; KG steps a commit, waited for before their A
  // registers are reloaded. Releases the stage.
  auto stage_products = [&](int st, int arow, int kbase) {
    const int s = st % STAGES;
    hp::mbar_wait(&full[s], (st / STAGES) & 1);
    const uint8_t* wt = ring + s * U::STAGE;
#pragma unroll
    for (int kg = 0; kg < KS; kg += KG) {
      uint32_t a[KG][4];
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
        hp::ldmatrix_x4(a[kk], opnd + (arow + lrow) * LD +
                                   (kbase + kg + kk) * 16 + lcol);
      hp::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) hp::fence_regs(a[kk]);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KG; ++kk)
        conv_mma(acc, a[kk], hp::desc_kmajor<U::STAGE>(wt, kg + kk));
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) hp::fence_regs(a[kk]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[s]);
  };

  // k=7 dilated conv: tap i reads the window at row shift i d
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  for (int st = 0; st < 7 * SPT; ++st)
    stage_products(st, o_first + (st / SPT) * d, (st % SPT) * KS);

  // every warpgroup is done reading the window: bias + snake2, as bf16,
  // over this warp's own output rows (window rows o + 3d)
  hp::bar_sync_consumers<U::CONSUMERS>();
  {
    const float* b7u = b7 + u * C;
    const float* ea2 = ea + (u * 2 + 1) * C;
    const float* ieb2 = ieb + (u * 2 + 1) * C;
    const int row = halo + o_first + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b7u + c));
      const float2 e = __ldg(reinterpret_cast<const float2*>(ea2 + c));
      const float2 ib = __ldg(reinterpret_cast<const float2*>(ieb2 + c));
      *reinterpret_cast<uint32_t*>(opnd + row * LD + c) =
          pack_bf16(snake(acc[4 * j] + bias.x, e.x, ib.x),
                    snake(acc[4 * j + 1] + bias.y, e.y, ib.y));
      *reinterpret_cast<uint32_t*>(opnd + (row + 8) * LD + c) =
          pack_bf16(snake(acc[4 * j + 2] + bias.x, e.x, ib.x),
                    snake(acc[4 * j + 3] + bias.y, e.y, ib.y));
    }
  }
  __syncwarp();   // each warp reads back only the 16 rows it wrote

  // k=1 conv on those rows
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  for (int sc = 0; sc < SPT; ++sc)
    stage_products(7 * SPT + sc, halo + o_first, sc * KS);

  // out = in + result + bias at the positions inside [0, L)
  const float* bpu = bp + u * C;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int pos = t0 + o_first + warp * 16 + g + 8 * rr;
    if (pos >= L) continue;
    const long long off = (n * L + pos) * C;
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(bpu + c));
      float2 x;
      if (in_f32)
        x = *reinterpret_cast<const float2*>(
            static_cast<const float*>(in) + off + c);
      else
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const bf16*>(in) + off + c));
      x.x += acc[4 * j + 2 * rr] + bias.x;
      x.y += acc[4 * j + 2 * rr + 1] + bias.y;
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off + c) = x;
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off + c) =
            pack_bf16(x.x, x.y);
    }
  }
}

template <int C>
int launch_small(const bf16* x, bf16* out, const bf16* w, const float* b7,
                 const float* bp, const float* ea, const float* ieb, int N,
                 int L, cudaStream_t stream) {
  using T = Tile<C>;
  cudaError_t err = cudaFuncSetAttribute(
      snake_conv_small_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + T::BL - 1) / T::BL, N);
  snake_conv_small_kernel<C><<<grid, THREADS, T::SMEM, stream>>>(
      x, out, w, b7, bp, ea, ieb, L);
  return static_cast<int>(cudaGetLastError());
}

// The three units as three launches: x (bf16) -> r0 -> r1 (fp32 scratch)
// -> out (bf16).
template <class U>
int launch_units(const CUtensorMap& wmap, const bf16* x, bf16* out,
                 float* scratch, const float* b7, const float* bp,
                 const float* ea, const float* ieb, int N, int L,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      snake_unit_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      U::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + U::BL - 1) / U::BL, N);
  float* r[2] = {scratch, scratch + (size_t)N * L * U::C};
  const void* ins[3] = {x, r[0], r[1]};
  void* outs[3] = {r[0], r[1], out};
  const int dilation[3] = {1, 3, 9};
  for (int u = 0; u < 3; ++u) {
    snake_unit_kernel<U><<<grid, U::THREADS, U::SMEM, stream>>>(
        wmap, ins[u], outs[u], b7, bp, ea, ieb, L, u, dilation[u], u > 0,
        u < 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// The weights' tensor map for acestep_snake_conv (C = 128 or 256): w is the
// (3, 8, C, C) bf16 weight tensor, contiguous; the 128-byte CUtensorMap is
// written to map_out (host memory). Returns 0 or a cudaError_t.
extern "C" int acestep_snake_conv_encode(const void* w, int C,
                                         void* map_out) {
  if (C != 128 && C != 256) return static_cast<int>(cudaErrorInvalidValue);
  return hp::encode_rows(static_cast<CUtensorMap*>(map_out), w, 24 * C, C, C);
}

// x/out (N, L, C) bf16 contiguous; C in {16, 32, 64, 128, 256} (checked by
// the Python wrapper); w (3, 8, C, C) bf16; b7, bp (3, C), ea, ieb (3, 2,
// C) fp32. For C >= 128: scratch (2, N, L, C) fp32 and wmap, the map that
// acestep_snake_conv_encode wrote for w (host memory); unused below.
// Returns 0 or a cudaError_t.
extern "C" int acestep_snake_conv(const void* x, void* out, void* scratch,
                                  const void* w, const void* b7,
                                  const void* bp, const void* ea,
                                  const void* ieb, const void* wmap, int N,
                                  int L, int C, void* stream) {
  if (N == 0 || L == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xi = static_cast<const bf16*>(x);
  auto xo = static_cast<bf16*>(out);
  auto wb = static_cast<const bf16*>(w);
  auto b7f = static_cast<const float*>(b7);
  auto bpf = static_cast<const float*>(bp);
  auto eaf = static_cast<const float*>(ea);
  auto iebf = static_cast<const float*>(ieb);
  auto sf = static_cast<float*>(scratch);
  switch (C) {
    case 16: return launch_small<16>(xi, xo, wb, b7f, bpf, eaf, iebf, N, L, s);
    case 32: return launch_small<32>(xi, xo, wb, b7f, bpf, eaf, iebf, N, L, s);
    case 64: return launch_small<64>(xi, xo, wb, b7f, bpf, eaf, iebf, N, L, s);
    case 128:
      return launch_units<Unit<128>>(*static_cast<const CUtensorMap*>(wmap), xi,
                                   xo, sf, b7f, bpf, eaf, iebf, N, L, s);
    case 256:
      return launch_units<Unit<256>>(*static_cast<const CUtensorMap*>(wmap), xi,
                                   xo, sf, b7f, bpf, eaf, iebf, N, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
