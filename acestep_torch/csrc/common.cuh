// Shared device helpers for the port's kernels: the bf16 tensor-core
// product (mma.sync m16n8k16, fp32 accumulate) and bf16 pair packing.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4*g + t):
//   A (16x16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                         a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9)
//   B (16x8, "col"):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C/D (16x8, fp32):     c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// Two neighbouring C tiles (columns 0-7 and 8-15) therefore hold exactly
// the registers of one A fragment, which lets a product's result feed the
// next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace acestep {

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16 (round to nearest even); the
// first value goes to the low half, i.e. the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace acestep
