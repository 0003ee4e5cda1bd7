// Helpers shared by the port's CUDA kernels: dtype codes, the finite
// NEG_INF of the JAX package, fp32 <-> storage conversions, 16-byte
// vector unpacking and warp reductions. Everything is internal to each
// translation unit that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2**30, as in the JAX package
constexpr unsigned FULL = 0xffffffffu;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// The elements of one 16-byte vector as floats (registers only; the
// lower address holds the lower half of each word): 4 for float, 8 for
// bfloat16.
__device__ __forceinline__ void unpack(const int4& r, float* f, float) {
  f[0] = __int_as_float(r.x);
  f[1] = __int_as_float(r.y);
  f[2] = __int_as_float(r.z);
  f[3] = __int_as_float(r.w);
}
__device__ __forceinline__ void unpack(const int4& r, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {(unsigned)r.x, (unsigned)r.y, (unsigned)r.z,
                         (unsigned)r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

}  // namespace
