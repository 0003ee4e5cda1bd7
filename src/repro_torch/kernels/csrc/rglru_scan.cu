// RG-LRU linear scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t per
// channel, over a whole sequence.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro_rglru_scan  <- repro/kernels/rglru_scan.py,
//                        _rglru_kernel / rglru_scan
//
// The contract is the Pallas kernel's: a and x in ([B,S,W], one dtype),
// h0 [B,W] fp32; y [B,S,W] in x's dtype and h_last [B,W] fp32 out. The
// gates stay outside the kernel, as in the JAX package.
//
// What bounds it: one multiply and one add per element read, so bytes
// (a and x read once, y written once). What stands in the way is the
// dependency along S: this first version gives one thread to each
// (row, channel) and steps through S with h in a register, which at
// batch 1 and W = 2560 is only 2560 threads. Each thread therefore issues
// UNROLL steps' loads of a and x (coalesced along W: neighbouring threads
// read neighbouring channels) before the dependent chain that consumes
// them, so many loads are in flight per thread. Splitting S across
// blocks (chunk-local scans plus a carry pass) is the known way to fill
// the card and is later work.
//
// The step is a multiply then an add, each rounded (__fmul_rn,
// __fadd_rn: no fused multiply-add), the same arithmetic as the plain
// PyTorch version, so the two agree bit for bit.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the entry point launches on the given stream
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int THREADS = 64;   // channels per block
constexpr int UNROLL = 16;    // steps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ x,
                 const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const int64_t base = (int64_t)b * S * W + w;
  float h = h0[(int64_t)b * W + w];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = base + (int64_t)(t + u) * W;
      av[u] = to_f(a[i]);
      xv[u] = to_f(x[i]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      y[base + (int64_t)(t + u) * W] = from_f<T>(h);
    }
  }
  for (; t < S; ++t) {                      // ragged tail
    const int64_t i = base + (int64_t)t * W;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(x[i]));
    y[i] = from_f<T>(h);
  }
  h_last[(int64_t)b * W + w] = h;
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* x, const float* h0,
                         void* y, float* h_last, int B, int S, int W,
                         cudaStream_t stream) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(y), h_last, S, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a/x [B,S,W] in one dtype (0 = float32, 1 = bfloat16); h0 [B,W] fp32;
// y [B,S,W] in that dtype; h_last [B,W] fp32.
int repro_rglru_scan(int dtype, const void* a, const void* x, const float* h0,
                     void* y, float* h_last, int B, int S, int W,
                     void* stream) {
  if (B < 1 || S < 0 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return (int)launch_typed<float>(a, x, h0, y, h_last, B, S, W, st);
  if (dtype == BF16)
    return (int)launch_typed<__nv_bfloat16>(a, x, h0, y, h_last, B, S, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
