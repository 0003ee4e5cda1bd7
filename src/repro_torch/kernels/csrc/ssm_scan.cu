// Mamba-1 selective scan for Hopper (sm_90a), discretised in the kernel:
//
//   h_t = exp(Δ_t ⊗ A) * h_{t-1} + (Δ_t u_t) ⊗ B_t   (channel d, state n)
//   y_t = Σ_n h_t C_t + D u_t
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro_ssm_scan  <- repro/kernels/ssm_scan.py, _ssm_kernel / ssm_scan
//
// The contract is the Pallas kernel's: u [B,S,Di] (float32 or bfloat16),
// Δ [B,S,Di], A [Di,N], B/C [B,S,N], D [Di] and h0 [B,Di,N] in float32; y
// [B,S,Di] in u's dtype and h_last [B,Di,N] float32 out. As in Pallas,
// exp(Δ⊗A) and Δu⊗B are formed in registers and never stored as
// [B,S,Di,N], and h stays float32. Unlike Pallas, any S and any Di are
// taken (exact-length prefill gives any S); N is 4, 8 or 16.
//
// What bounds it: per (row, step, channel, state) one exp, a few fp32
// multiplies and adds, and no bytes beyond u, Δ, B, C and y. At the main
// shape (B=1, S=2048, Di=8192, N=16, bf16 u) on an H100 SXM the bytes
// (~136 MB, ~0.041 ms at the datasheet's 3.35 TB/s) weigh less than the
// 268 M exponentials: each is one MUFU.EX2, 16 a clock per SM on sm_90,
// ~0.064 ms over 132 SMs at the 1980 MHz max SM clock. chip_smoke.py
// computes both for the run's card and clock.
//
// Design. One thread per (row, channel, state element); a channel's N
// lanes sit next to each other in a warp, so B=1 already gives Di*N
// independent recurrences (131,072 at Falcon-Mamba-7B's width) rather
// than Di. A block of 256 threads owns 256/N channels and walks S in
// chunks: each chunk's (Δ, u) pairs (coalesced along Di) and (B, C) pairs
// (N per step, shared by every channel of the block) are staged in
// shared memory, and y goes back through shared memory so that its store
// is coalesced too. y_t needs a sum over the N lanes of a channel: rather
// than log2 N shuffles for every step, each lane keeps its products h*C
// for N steps in registers and one reduce-scatter over the N lanes
// (N-1 shuffles in all) leaves lane n holding step n's sum, so a shuffle
// is spent per step per lane, not log2 N.
//
// Rounding. Each step multiplies and then adds, each rounded (__fmul_rn,
// __fadd_rn: no fused multiply-add), with expf (not __expf, and no fast
// math), and the sum over N folds halves in the reduce-scatter's order,
// as the plain PyTorch loop does, so h and y can match it bit for bit.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the entry point launches on the given stream
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Channels per block and steps per staged chunk for state size N: the
// [steps, channels] tiles hold 2048 entries; rows are padded by one entry
// so that lane n of channel c, writing y of step n, hits distinct banks.
template <int N>
struct Tile {
  static constexpr int CH = THREADS / N;
  static constexpr int STEPS = 2048 / CH;
  static constexpr int LD = CH + 1;
  static_assert(STEPS % N == 0, "a chunk holds whole groups of N steps");
  static_assert(STEPS * CH % THREADS == 0, "the tiles split evenly");
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 4)
    ssm_kernel(const T* __restrict__ u, const float* __restrict__ delta,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ h_last, int S, int Di) {
  constexpr int CH = Tile<N>::CH, STEPS = Tile<N>::STEPS, LD = Tile<N>::LD;
  __shared__ float2 s_du[STEPS * LD];   // (Δ, u) per step and channel
  __shared__ float2 s_bc[STEPS * N];    // (B, C) per step and state
  __shared__ float s_y[STEPS * LD];

  const int tid = threadIdx.x;
  const int n = tid % N;                // state element (lane within group)
  const int cl = tid / N;               // channel within the block
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < Di;
  const int64_t row0 = (int64_t)b * S;
  const int64_t hidx = ((int64_t)b * Di + c) * N + n;

  const float a = live ? A[(int64_t)c * N + n] : 0.f;
  const float d = live ? Dv[c] : 0.f;
  float h = live ? h0[hidx] : 0.f;

  for (int s0 = 0; s0 < S; s0 += STEPS) {
    const int tc = min(STEPS, S - s0);
    __syncthreads();                    // last chunk's readers are done
#pragma unroll
    for (int r = 0; r < STEPS * CH / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / CH, k = i % CH;
      float2 du = make_float2(0.f, 0.f);
      if (t < tc && c0 + k < Di) {
        const int64_t g = (row0 + s0 + t) * Di + c0 + k;
        du = make_float2(delta[g], to_f(u[g]));
      }
      s_du[t * LD + k] = du;
    }
    for (int i = tid; i < STEPS * N; i += THREADS) {
      const int64_t g = (row0 + s0) * N + i;
      s_bc[i] = i / N < tc ? make_float2(Bm[g], Cm[g])
                           : make_float2(0.f, 0.f);
    }
    __syncthreads();

    for (int g0 = 0; g0 < tc; g0 += N) {
      float p[N];                       // h*C of steps g0 .. g0+N-1
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int t = g0 + j;
        if (t < tc) {                   // uniform across the block
          const float2 du = s_du[t * LD + cl];
          const float2 bc = s_bc[t * N + n];
          const float dA = expf(__fmul_rn(du.x, a));
          const float dBu = __fmul_rn(__fmul_rn(du.x, du.y), bc.x);
          h = __fadd_rn(__fmul_rn(dA, h), dBu);
          p[j] = __fmul_rn(h, bc.y);
        } else {
          p[j] = 0.f;
        }
      }
      // Reduce-scatter over the channel's N lanes: at each stage a lane
      // keeps the half of its steps on its side of the partner bit and
      // sends the other half; after log2 N stages lane n holds the full
      // sum of step g0 + n in p[0].
#pragma unroll
      for (int half = N / 2; half >= 1; half /= 2) {
        const bool upper = (n & half) != 0;
#pragma unroll
        for (int j = 0; j < half; ++j) {
          const float send = upper ? p[j] : p[j + half];
          const float keep = upper ? p[j + half] : p[j];
          p[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, half));
        }
      }
      const int t = g0 + n;
      if (t < tc)
        s_y[t * LD + cl] =
            __fadd_rn(p[0], __fmul_rn(d, s_du[t * LD + cl].y));
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < STEPS * CH / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / CH, k = i % CH;
      if (t < tc && c0 + k < Di)
        y[(row0 + s0 + t) * Di + c0 + k] = from_f<T>(s_y[t * LD + k]);
    }
  }
  if (live) h_last[hidx] = h;
}

template <typename T, int N>
cudaError_t launch_typed(const void* u, const float* delta, const float* A,
                         const float* Bm, const float* Cm, const float* Dv,
                         const float* h0, void* y, float* h_last, int B,
                         int S, int Di, cudaStream_t stream) {
  constexpr int CH = Tile<N>::CH;
  dim3 grid((Di + CH - 1) / CH, B);
  ssm_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(u), delta, A, Bm, Cm, Dv, h0,
      static_cast<T*>(y), h_last, S, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int N, const void* u, const float* delta, const float* A,
                     const float* Bm, const float* Cm, const float* Dv,
                     const float* h0, void* y, float* h_last, int B, int S,
                     int Di, cudaStream_t st) {
  switch (N) {
    case 4:
      return launch_typed<T, 4>(u, delta, A, Bm, Cm, Dv, h0, y, h_last, B, S,
                                Di, st);
    case 8:
      return launch_typed<T, 8>(u, delta, A, Bm, Cm, Dv, h0, y, h_last, B, S,
                                Di, st);
    case 16:
      return launch_typed<T, 16>(u, delta, A, Bm, Cm, Dv, h0, y, h_last, B, S,
                                 Di, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// u [B,S,Di] in dtype (0 = float32, 1 = bfloat16); delta [B,S,Di], A
// [Di,N], B/C [B,S,N], D [Di], h0 [B,Di,N] float32; y [B,S,Di] in u's
// dtype; h_last [B,Di,N] float32. N is 4, 8 or 16.
int repro_ssm_scan(int dtype, int N, const void* u, const float* delta,
                   const float* A, const float* B, const float* C,
                   const float* D, const float* h0, void* y, float* h_last,
                   int Bb, int S, int Di, void* stream) {
  if (Bb < 1 || S < 0 || Di < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return (int)launch_n<float>(N, u, delta, A, B, C, D, h0, y, h_last, Bb,
                                S, Di, st);
  if (dtype == BF16)
    return (int)launch_n<__nv_bfloat16>(N, u, delta, A, B, C, D, h0, y,
                                        h_last, Bb, S, Di, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
