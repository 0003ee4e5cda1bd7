// The dropless expert layer's pair-wise passes for Hopper (sm_90a):
// the gather of each held (token, choice) pair's input row, SwiGLU over
// the gate | up product, the gated combine of each token's held outputs,
// and their backward passes (models/moe.py, apply_dropless).
//
// No TPU kernel corresponds: the JAX package has no dropless layer (its
// MoE is one-hot einsums that XLA runs). These kernels were added because
// the layer's plain tensor code worked on all N*K pairs of a batch where
// a card that holds a share of the experts computes about one in eight.
//
// The pairs are sorted by held expert, the held ones first, and ends[H-1]
// is their count: rows r < ends[H-1] of the [N*K, ..] buffers are held,
// and a choice is held exactly when its row pos[n,k] < ends[H-1]. Each
// kernel reads that count from device memory at its start and touches
// nothing else, so its bytes follow the held pairs, the rows past them
// (left unspecified by the grouped products) are never read, and no count
// goes to the host: a CUDA graph holds the pass.
//
// What bounds them: bytes. Each held row is read and written once, in
// 16-byte vectors (at Mellum2's share, ~7,500 held rows of D = 2304 a
// microbatch: ~70 MB for the gather or the combine, ~20 us at 3.35 TB/s).
// A persistent grid, as many blocks as the SMs hold at once, strides
// over the rows (the gather, SwiGLU) or the tokens (the combine, one warp
// a token). Arithmetic is fp32, rounded once to the storage type; every
// output element is written by one thread and every sum is taken in a
// fixed order, with no atomics, so a replay repeats bit for bit.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// The most choices a token may have: the per-token kernels keep each
// choice's row, gate and gradient sum in registers.
constexpr int MAX_K = 8;

// 16-byte vector <-> floats, the lower address in the lower half.
__device__ __forceinline__ int4 pack(const float* f, float) {
  return make_int4(__float_as_int(f[0]), __float_as_int(f[1]),
                   __float_as_int(f[2]), __float_as_int(f[3]));
}
__device__ __forceinline__ int4 pack(const float* f, __nv_bfloat16) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned*>(&t);
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

template <typename T> __device__ __forceinline__ void load(const T* p, float* f) {
  unpack(*reinterpret_cast<const int4*>(p), f, T());
}
template <typename T> __device__ __forceinline__ void store(T* p, const float* f) {
  *reinterpret_cast<int4*>(p) = pack(f, T());
}

// The held rows: ends[H-1], at most the M rows of the buffers.
__device__ __forceinline__ long long held_rows(const int* ends, int H,
                                               long long M) {
  const long long n = ends[H - 1];
  return n < M ? n : M;
}

__device__ __forceinline__ long long global_warp() {
  return (long long)blockIdx.x * WARPS + threadIdx.x / 32;
}

// out[r] = x[tok[r]] for the held rows r: one warp a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_gather_kernel(const T* __restrict__ x, const long long* __restrict__ tok,
                      const int* __restrict__ ends, int H, T* __restrict__ out,
                      long long M, int D) {
  const long long rows = held_rows(ends, H, M);
  const int lane = threadIdx.x & 31, vecs = D * (int)sizeof(T) / 16;
  for (long long r = global_warp(); r < rows; r += (long long)gridDim.x * WARPS) {
    const int4* src = reinterpret_cast<const int4*>(x + tok[r] * D);
    int4* dst = reinterpret_cast<int4*>(out + r * D);
#pragma unroll 4
    for (int v = lane; v < vecs; v += 32) dst[v] = src[v];
  }
}

__device__ __forceinline__ float silu(float a) { return a / (1.f + expf(-a)); }

// h[r] = silu(a) * b for the held rows r of ab = [a | b] [M, 2F].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_swiglu_kernel(const T* __restrict__ ab, const int* __restrict__ ends,
                      int H, T* __restrict__ h, long long M, int F) {
  constexpr int V = 16 / sizeof(T);
  const int fv = F / V;
  const long long total = held_rows(ends, H, M) * fv;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long r = i / fv;
    const int c = (int)(i - r * fv) * V;
    float a[V], b[V];
    load(ab + r * 2 * F + c, a);
    load(ab + r * 2 * F + F + c, b);
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = silu(a[j]) * b[j];
    store(h + r * F + c, a);
  }
}

// d[a | b] for the held rows: da = dh b s (1 + a (1 - s)), db = dh silu(a),
// s = sigmoid(a).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_swiglu_bwd_kernel(const T* __restrict__ dh, const T* __restrict__ ab,
                          const int* __restrict__ ends, int H,
                          T* __restrict__ dab, long long M, int F) {
  constexpr int V = 16 / sizeof(T);
  const int fv = F / V;
  const long long total = held_rows(ends, H, M) * fv;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long r = i / fv;
    const int c = (int)(i - r * fv) * V;
    float g[V], a[V], b[V];
    load(dh + r * F + c, g);
    load(ab + r * 2 * F + c, a);
    load(ab + r * 2 * F + F + c, b);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float s = 1.f / (1.f + expf(-a[j]));
      const float gb = g[j] * b[j];
      b[j] = g[j] * (a[j] * s);
      a[j] = gb * (s * (1.f + a[j] * (1.f - s)));
    }
    store(dab + r * 2 * F + c, a);
    store(dab + r * 2 * F + F + c, b);
  }
}

// Each lane k < K of the warp reads token n's choice k: its row and gate
// (1 without gates). Returns the mask of the held choices; p[k] and g[k]
// then hold choice k's row and gate in every lane.
template <typename T>
__device__ __forceinline__ unsigned choices(const long long* pos, const T* gate,
                                            long long rows, long long n, int K,
                                            long long (&p)[MAX_K],
                                            float (&g)[MAX_K]) {
  const int lane = threadIdx.x & 31;
  long long mine = -1;
  float gm = 0.f;
  if (lane < K) {
    mine = pos[n * K + lane];
    gm = gate ? to_f(gate[n * K + lane]) : 1.f;
  }
  const unsigned held = __ballot_sync(FULL, mine >= 0 && mine < rows);
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    p[k] = __shfl_sync(FULL, mine, k);
    g[k] = __shfl_sync(FULL, gm, k);
  }
  return held;
}

// y[n] = sum over token n's held choices k, in choice order, of
// g[n,k] * ye[pos[n,k]], in fp32, rounded once; zero where none is held.
// One warp a token.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_combine_kernel(const T* __restrict__ ye, const T* __restrict__ gate,
                       const long long* __restrict__ pos,
                       const int* __restrict__ ends, int H, T* __restrict__ y,
                       long long M, int N, int K, int D) {
  constexpr int V = 16 / sizeof(T);
  const long long rows = held_rows(ends, H, M);
  const int lane = threadIdx.x & 31;
  for (long long n = global_warp(); n < N; n += (long long)gridDim.x * WARPS) {
    long long p[MAX_K];
    float g[MAX_K];
    const unsigned held = choices(pos, gate, rows, n, K, p, g);
    for (int c = lane * V; c < D; c += 32 * V) {
      float acc[V] = {};
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (!((held >> k) & 1)) continue;
        float e[V];
        load(ye + p[k] * D + c, e);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += g[k] * e[j];
      }
      store(y + n * D + c, acc);
    }
  }
}

// For token n with upstream gradient dy[n]: each held choice k gets
// dye[pos[n,k]] = g[n,k] * dy[n] and dgate[n,k] = dy[n] . ye[pos[n,k]]
// (each lane's share in its order, then a fixed butterfly over the warp);
// a choice not held gets dgate 0. One warp a token; dy[n] read once.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_combine_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ye,
                           const T* __restrict__ gate,
                           const long long* __restrict__ pos,
                           const int* __restrict__ ends, int H,
                           T* __restrict__ dye, T* __restrict__ dgate,
                           long long M, int N, int K, int D) {
  constexpr int V = 16 / sizeof(T);
  const long long rows = held_rows(ends, H, M);
  const int lane = threadIdx.x & 31;
  for (long long n = global_warp(); n < N; n += (long long)gridDim.x * WARPS) {
    long long p[MAX_K];
    float g[MAX_K], dot[MAX_K] = {};
    const unsigned held = choices(pos, gate, rows, n, K, p, g);
    for (int c = lane * V; c < D; c += 32 * V) {
      float d[V];
      load(dy + n * D + c, d);
#pragma unroll
      for (int k = 0; k < MAX_K; ++k) {
        if (!((held >> k) & 1)) continue;
        float e[V], o[V];
        load(ye + p[k] * D + c, e);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          dot[k] += d[j] * e[j];
          o[j] = g[k] * d[j];
        }
        store(dye + p[k] * D + c, o);
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      const float s = warp_sum(dot[k]);
      if (lane == 0 && k < K) dgate[n * K + k] = from_f<T>(s);
    }
  }
}

// As many blocks as the card's SMs hold at once, found once per kernel
// (before any graph capture: the learner's first pass runs eagerly).
template <auto Kernel>
int persistent_grid() {
  static const int grid = [] {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, THREADS, 0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }();
  return grid;
}

template <auto Kernel, typename... Args>
int launch(void* stream, Args... args) {
  Kernel<<<persistent_grid<Kernel>(), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

bool rows_ok(int dtype, int width) {
  return (dtype == F32 || dtype == BF16) && width > 0 &&
         width * (dtype == F32 ? 4 : 2) % 16 == 0;
}

}  // namespace

extern "C" {

// x [N,D] and out [M,D] in one dtype (0 = float32, 1 = bfloat16), tok [M]
// int64, ends [H] int32: out[r] = x[tok[r]] for r < ends[H-1].
int repro_moe_gather(int dtype, const void* x, const long long* tok,
                     const int* ends, int H, void* out, int M, int D,
                     void* stream) {
  if (!rows_ok(dtype, D) || H < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (dtype == F32)
    return launch<moe_gather_kernel<float>>(
        stream, (const float*)x, tok, ends, H, (float*)out, (long long)M, D);
  return launch<moe_gather_kernel<__nv_bfloat16>>(
      stream, (const __nv_bfloat16*)x, tok, ends, H, (__nv_bfloat16*)out,
      (long long)M, D);
}

// ab [M,2F] -> h [M,F] over the held rows.
int repro_moe_swiglu(int dtype, const void* ab, const int* ends, int H,
                     void* h, int M, int F, void* stream) {
  if (!rows_ok(dtype, F) || H < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (dtype == F32)
    return launch<moe_swiglu_kernel<float>>(stream, (const float*)ab, ends, H,
                                            (float*)h, (long long)M, F);
  return launch<moe_swiglu_kernel<__nv_bfloat16>>(
      stream, (const __nv_bfloat16*)ab, ends, H, (__nv_bfloat16*)h,
      (long long)M, F);
}

// dh [M,F], ab [M,2F] -> dab [M,2F] over the held rows.
int repro_moe_swiglu_bwd(int dtype, const void* dh, const void* ab,
                         const int* ends, int H, void* dab, int M, int F,
                         void* stream) {
  if (!rows_ok(dtype, F) || H < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (dtype == F32)
    return launch<moe_swiglu_bwd_kernel<float>>(
        stream, (const float*)dh, (const float*)ab, ends, H, (float*)dab,
        (long long)M, F);
  return launch<moe_swiglu_bwd_kernel<__nv_bfloat16>>(
      stream, (const __nv_bfloat16*)dh, (const __nv_bfloat16*)ab, ends, H,
      (__nv_bfloat16*)dab, (long long)M, F);
}

// ye [M,D], gate [N,K] (null: every gate 1), pos [N,K] int64 -> y [N,D].
int repro_moe_combine(int dtype, const void* ye, const void* gate,
                      const long long* pos, const int* ends, int H, void* y,
                      int M, int N, int K, int D, void* stream) {
  if (!rows_ok(dtype, D) || H < 1 || M < 0 || N < 0 || K < 1 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (dtype == F32)
    return launch<moe_combine_kernel<float>>(
        stream, (const float*)ye, (const float*)gate, pos, ends, H, (float*)y,
        (long long)M, N, K, D);
  return launch<moe_combine_kernel<__nv_bfloat16>>(
      stream, (const __nv_bfloat16*)ye, (const __nv_bfloat16*)gate, pos, ends,
      H, (__nv_bfloat16*)y, (long long)M, N, K, D);
}

// dy [N,D], ye [M,D], gate [N,K], pos [N,K] int64 -> dye [M,D] (held rows),
// dgate [N,K].
int repro_moe_combine_bwd(int dtype, const void* dy, const void* ye,
                          const void* gate, const long long* pos,
                          const int* ends, int H, void* dye, void* dgate,
                          int M, int N, int K, int D, void* stream) {
  if (!rows_ok(dtype, D) || H < 1 || M < 0 || N < 0 || K < 1 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (dtype == F32)
    return launch<moe_combine_bwd_kernel<float>>(
        stream, (const float*)dy, (const float*)ye, (const float*)gate, pos,
        ends, H, (float*)dye, (float*)dgate, (long long)M, N, K, D);
  return launch<moe_combine_bwd_kernel<__nv_bfloat16>>(
      stream, (const __nv_bfloat16*)dy, (const __nv_bfloat16*)ye,
      (const __nv_bfloat16*)gate, pos, ends, H, (__nv_bfloat16*)dye,
      (__nv_bfloat16*)dgate, (long long)M, N, K, D);
}

}  // extern "C"
