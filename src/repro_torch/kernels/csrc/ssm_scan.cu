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
// ~0.064 ms over 132 SMs at the 1980 MHz max SM clock. torch_time_kernels.py
// computes both for the run's card and clock. In practice the issue rate
// binds first: an accurate expf is ~8 instructions around its MUFU.EX2,
// and a step adds four rounded multiplies and an add per element, so
// every instruction spent per element beyond those ~13 costs time.
//
// Design: few instructions per element, and enough independent work per
// thread to issue them back to back. A channel's N states are split over
// L = LANES = 4 lanes (tune_scan's sweep found 2 and 8 slower), lane j
// holding the K = N/L states n = j + L*k. A thread carries G steps at
// once (8, or 4 where K = 8): the reads of all G steps are issued
// together, and their exponentials do not depend on h, so only the
// rounded multiply and add of the recurrence are serial. Per thread and
// step, (Δ, u) is read once and Δu formed once, and B and C come as
// 16-byte vector reads from shared memory (staged there lane-major, so a
// lane's K states are contiguous); the K products h*C are summed in
// registers, and one reduce-scatter over the L lanes per L steps (L-1
// shuffles) leaves lane j with step j's sum. A block owns CH = 32
// channels (32*L threads) and walks S in chunks of STEPS steps: the
// chunk's (Δ, u) tiles (coalesced along Di) and (B, C) rows are
// double-buffered in shared memory by cp.async, so chunk c+1 loads while
// chunk c runs; full chunks take an unguarded loop and only the last is
// guarded; y goes back through shared memory (rows rotated so that a
// channel's L lanes write distinct banks) so that its store is
// coalesced. Where Di or a pointer is not a multiple of 16 bytes, (Δ, u)
// are staged by plain loads instead (same arithmetic).
//
// Rounding, and why S is not split. Each step multiplies and then adds,
// each rounded (__fmul_rn, __fadd_rn: no fused multiply-add), with expf
// (not __expf, and no fast math), as the plain PyTorch loop does, so h
// matches it bit for bit; a split of S (chunk-local scans and a carry
// pass) would reorder those operations. The sum over N folds halves in
// the plain loop's order (ref._halving_sum pairs n with n + N/2, then
// n + N/4, ...): with n = j + L*k, the first log2 K folds pair states of
// one lane (k with k + K/2, ...) and the last log2 L pair lane j with
// lane j ^ L/2, ..., j ^ 1, which is what each stage of the
// reduce-scatter adds.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the entry point launches on the given stream
// and returns cudaGetLastError().

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int CH = 32;        // channels per block
constexpr int STEPS = 64;     // steps per staged chunk
constexpr int BUFFERS = 2;    // chunks in shared memory at once
constexpr int LANES = 4;      // lanes per channel (at most N)

// One instance's layout: L lanes a channel and K states a lane, G steps a
// thread carries at once (a multiple of L: 4 where a lane holds 8
// states, else 8), and its shared memory in bytes from the block's
// start: BUFFERS buffers of (Δ [STEPS][CH] fp32, u [STEPS][CH] in u's
// dtype, B and C [STEPS][N] fp32 lane-major), then y [STEPS][CH] fp32.
template <typename T, int N>
struct Plan {
  static constexpr int L = LANES < N ? LANES : N;
  static constexpr int K = N / L;
  static constexpr int G = K >= 8 ? 4 : 8;
  static constexpr int THREADS = CH * L;
  static constexpr int D = 0;
  static constexpr int U = D + STEPS * CH * 4;
  static constexpr int B = U + STEPS * CH * (int)sizeof(T);
  static constexpr int C = B + STEPS * N * 4;
  static constexpr int BUF = C + STEPS * N * 4;
  static constexpr int Y = BUFFERS * BUF;
  static constexpr int BYTES = Y + STEPS * CH * 4;
  static_assert(U % 16 == 0 && B % 16 == 0 && BUF % 16 == 0, "alignment");
  static_assert(N % L == 0 && G % L == 0 && STEPS % G == 0,
                "groups of whole lane runs");
};

// The launch of one call, as launch() makes it and repro_ssm_scan_config
// reports it.
struct Launch {
  int grid_x, grid_y, threads, smem_bytes, buffers, steps, lanes, group;
};

template <typename T, int N>
Launch launch_of(int B, int Di) {
  using P = Plan<T, N>;
  return {(Di + CH - 1) / CH, B, P::THREADS, P::BYTES, BUFFERS, STEPS, P::L,
          P::G};
}

// Stage steps s0 .. s0+STEPS-1 (those below S) of channels c0 .. c0+CH-1
// into one buffer. B and C go lane-major: state n = j + L*k of step t to
// t*N + j*K + k.
template <typename T, int N>
__device__ __forceinline__ void stage_chunk(
    unsigned char* buf, const T* __restrict__ u,
    const float* __restrict__ delta, const float* __restrict__ Bm,
    const float* __restrict__ Cm, int64_t row0, int s0, int S, int c0, int Di,
    bool vec) {
  using M = Plan<T, N>;
  constexpr int THREADS = M::THREADS, L = M::L, K = M::K;
  constexpr int VD = 4, VU = 16 / (int)sizeof(T);    // elements a cp.async
  const int tid = threadIdx.x, tc = min(STEPS, S - s0);
  float* sd = reinterpret_cast<float*>(buf + M::D);
  T* su = reinterpret_cast<T*>(buf + M::U);
  if (vec) {
#pragma unroll
    for (int r = 0; r < STEPS * CH / VD / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / (CH / VD);
      const int k = (i % (CH / VD)) * VD;
      if (t < tc && c0 + k < Di)
        cp_async16(smem_addr(sd + t * CH + k),
                   delta + (row0 + s0 + t) * Di + c0 + k, 16);
    }
#pragma unroll
    for (int r = 0; r < STEPS * CH / VU / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / (CH / VU);
      const int k = (i % (CH / VU)) * VU;
      if (t < tc && c0 + k < Di)
        cp_async16(smem_addr(su + t * CH + k),
                   u + (row0 + s0 + t) * Di + c0 + k, 16);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < STEPS * CH / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / CH, k = i % CH;
      if (t < tc && c0 + k < Di) {
        const int64_t g = (row0 + s0 + t) * Di + c0 + k;
        sd[t * CH + k] = delta[g];
        su[t * CH + k] = u[g];
      }
    }
  }
  const uint32_t sb = smem_addr(buf + M::B), sc = smem_addr(buf + M::C);
#pragma unroll
  for (int r = 0; r < (STEPS * N + THREADS - 1) / THREADS; ++r) {
    const int i = r * THREADS + tid, t = i / N, n = i % N;
    if (i < STEPS * N && t < tc) {
      const int64_t g = (row0 + s0) * N + i;
      const uint32_t o = 4 * (t * N + (n % L) * K + n / L);
      cp_async4(sb + o, Bm + g);
      cp_async4(sc + o, Cm + g);
    }
  }
}

// K consecutive floats of shared memory in 16-byte (or 8-byte) reads.
template <int K>
__device__ __forceinline__ void read_vec(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Plan<T, N>::THREADS)
    ssm_kernel(const T* __restrict__ u, const float* __restrict__ delta,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ h0, T* __restrict__ y,
               float* __restrict__ h_last, int S, int Di, bool vec) {
  using M = Plan<T, N>;
  constexpr int THREADS = M::THREADS, L = M::L, K = M::K, G = M::G;
  // y of step t, channel c in s_y: each row rotated by (t % L) * CH / L
  // entries, so that the L lanes of a channel, writing L consecutive
  // steps at once, hit distinct banks.
  auto ysw = [](int t, int c) {
    return t * CH + ((c + (t % L) * (CH / L)) % CH);
  };
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_y = reinterpret_cast<float*>(smem + M::Y);

  const int tid = threadIdx.x;
  const int j = tid % L;                // lane within the channel
  const int cl = tid / L;               // channel within the block
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < Di;
  const int64_t row0 = (int64_t)b * S;
  const int64_t hrow = ((int64_t)b * Di + c) * N + j;

  float a[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k] = live ? A[(int64_t)c * N + j + L * k] : 0.f;
    h[k] = live ? h0[hrow + L * k] : 0.f;
  }
  const float d = live ? Dv[c] : 0.f;

  // G steps of this thread's K states from a staged buffer, from step g0
  // on (steps from tc on are skipped when TAIL). The reads of all G steps
  // are issued together; y of the group is finished by a reduce-scatter
  // over the channel's L lanes, in runs of L steps, which leaves step
  // g0 + r + j's sum with lane j.
  auto group = [&](const unsigned char* buf, int g0, int tc, auto tail) {
    constexpr bool TAIL = decltype(tail)::value;
    const float* sd = reinterpret_cast<const float*>(buf + M::D);
    const T* su = reinterpret_cast<const T*>(buf + M::U);
    const float* sb = reinterpret_cast<const float*>(buf + M::B) + j * K;
    const float* sc = reinterpret_cast<const float*>(buf + M::C) + j * K;
    float p[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = g0 + i;
      p[i] = 0.f;
      if (TAIL && t >= tc) continue;      // uniform across the block
      const float dl = sd[t * CH + cl];
      const float du = __fmul_rn(dl, to_f(su[t * CH + cl]));
      float bv[K], cv[K], q[K];
      read_vec<K>(sb + t * N, bv);
      read_vec<K>(sc + t * N, cv);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dA = expf(__fmul_rn(dl, a[k]));
        h[k] = __fadd_rn(__fmul_rn(dA, h[k]), __fmul_rn(du, bv[k]));
        q[k] = __fmul_rn(h[k], cv[k]);
      }
#pragma unroll
      for (int w = K / 2; w >= 1; w /= 2)
#pragma unroll
        for (int k = 0; k < w; ++k) q[k] = __fadd_rn(q[k], q[k + w]);
      p[i] = q[0];
    }
#pragma unroll
    for (int r = 0; r < G; r += L) {
#pragma unroll
      for (int half = L / 2; half >= 1; half /= 2) {
        const bool upper = (j & half) != 0;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = upper ? p[r + i] : p[r + i + half];
          const float keep = upper ? p[r + i + half] : p[r + i];
          p[r + i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, half));
        }
      }
      const int t = g0 + r + j;
      if (!TAIL || t < tc)
        s_y[ysw(t, cl)] =
            __fadd_rn(p[r], __fmul_rn(d, to_f(su[t * CH + cl])));
    }
  };

  const int nc = (S + STEPS - 1) / STEPS;
  if (nc > 0)
    stage_chunk<T, N>(smem, u, delta, Bm, Cm, row0, 0, S, c0, Di, vec);
  cp_async_commit();
#pragma unroll 1
  for (int ci = 0; ci < nc; ++ci) {
    // Chunk ci+1 into the next buffer: its readers (chunk ci+1-BUFFERS)
    // passed the barrier after their steps.
    if (ci + 1 < nc)
      stage_chunk<T, N>(smem + ((ci + 1) % BUFFERS) * M::BUF, u, delta, Bm,
                        Cm, row0, (ci + 1) * STEPS, S, c0, Di, vec);
    cp_async_commit();
    cp_async_wait<1>();                   // chunk ci has landed
    __syncthreads();                      // ... for every thread
    const unsigned char* buf = smem + (ci % BUFFERS) * M::BUF;
    const int s0 = ci * STEPS, tc = min(STEPS, S - s0);
    if (tc == STEPS) {                    // a full chunk: no guard
#pragma unroll 1
      for (int g0 = 0; g0 < STEPS; g0 += G)
        group(buf, g0, STEPS, std::false_type{});
    } else {
#pragma unroll 1
      for (int g0 = 0; g0 < tc; g0 += G)
        group(buf, g0, tc, std::true_type{});
    }
    __syncthreads();                      // s_y done; ci's buffer free

#pragma unroll
    for (int r = 0; r < STEPS * CH / THREADS; ++r) {
      const int i = r * THREADS + tid, t = i / CH, k = i % CH;
      if (t < tc && c0 + k < Di)
        y[(row0 + s0 + t) * Di + c0 + k] = from_f<T>(s_y[ysw(t, k)]);
    }
  }
  cp_async_wait_all();
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) h_last[hrow + L * k] = h[k];
  }
}

template <typename T, int N>
cudaError_t launch(const Launch& c, const void* u, const float* delta,
                   const float* A, const float* Bm, const float* Cm,
                   const float* Dv, const float* h0, void* y, float* h_last,
                   int S, int Di, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssm_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      c.smem_bytes);
  if (err != cudaSuccess) return err;
  const bool vec = Di % 8 == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(delta) & 15) == 0;
  ssm_kernel<T, N><<<dim3(c.grid_x, c.grid_y), c.threads, c.smem_bytes,
                     stream>>>(static_cast<const T*>(u), delta, A, Bm, Cm,
                               Dv, h0, static_cast<T*>(y), h_last, S, Di,
                               vec);
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};

// f(Type<T>{}, std::integral_constant<int, N>{}) for the instance that
// takes u of this dtype at state size N; an error for any other.
template <typename F>
cudaError_t dispatch(int dtype, int N, F&& f) {
  auto by_n = [&](auto t) -> cudaError_t {
    switch (N) {
      case 4: return f(t, std::integral_constant<int, 4>{});
      case 8: return f(t, std::integral_constant<int, 8>{});
      case 16: return f(t, std::integral_constant<int, 16>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == F32) return by_n(Type<float>{});
  if (dtype == BF16) return by_n(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
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
  return (int)dispatch(dtype, N, [&](auto t, auto n) {
    using T = typename decltype(t)::type;
    constexpr int NN = decltype(n)::value;
    return launch<T, NN>(launch_of<T, NN>(Bb, Di), u, delta, A, B, C, D, h0,
                         y, h_last, S, Di, st);
  });
}

// The launch repro_ssm_scan makes for these arguments: out[0..7] = grid
// x, grid y, threads a block, dynamic shared bytes a block, buffers
// (chunks in shared memory at once), steps a chunk, lanes a channel,
// steps a thread carries at once.
int repro_ssm_scan_config(int dtype, int N, int Bb, int Di, int* out) {
  if (Bb < 1 || Di < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, N, [&](auto t, auto n) {
    using T = typename decltype(t)::type;
    constexpr int NN = decltype(n)::value;
    const Launch c = launch_of<T, NN>(Bb, Di);
    const int v[] = {c.grid_x, c.grid_y, c.threads, c.smem_bytes,
                     c.buffers, c.steps, c.lanes, c.group};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return cudaSuccess;
  });
}

}  // extern "C"
