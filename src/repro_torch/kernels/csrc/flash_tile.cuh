// Pieces the tensor-core flash-attention kernels share (the forward in
// flash_attention.cu, the backward in flash_attention_bwd.cu): 2^x on the
// special-function unit, two floats packed as a bf16 pair (a wgmma A
// operand register), and the cp.async copy of a bf16 tile into the
// 128-byte-swizzled slabs of wgmma.cuh.

#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// 2^x on the special-function unit (one instruction; denormals flush).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// cp.async the [R x DH] bf16 tile whose row r starts at g + r * stride
// into swizzled slabs at shared address dst, by the block's NT threads;
// rows >= n_rows and the columns from DH up to whole 64-column slabs
// are zero-filled.
template <int R, int DH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          int64_t stride, int n_rows,
                                          int tid) {
  constexpr int CPR = (DH + 63) / 64 * 8;          // 16-byte chunks per row
  static_assert(R * CPR % NT == 0, "whole passes over the tile");
#pragma unroll
  for (int it = 0; it < R * CPR / NT; ++it) {
    const int i = tid + it * NT, r = i / CPR, c = i % CPR;
    const bool ok = r < n_rows && c * 8 < DH;
    cp_async16(dst + swz_offset<R>(r, c * 8), ok ? g + r * stride + c * 8 : g,
               ok ? 16 : 0);
  }
}

}  // namespace
