// Flash-decode for Hopper (sm_90a): one new token's GQA attention over a
// KV cache, flat or paged.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   repro_decode_attention        <- repro/kernels/decode_attention.py,
//                                    _decode_kernel / decode_attention
//   repro_paged_decode_attention  <- repro/kernels/decode_attention.py,
//                                    _paged_kernel / paged_decode_attention
//
// Both compute, for each row b and query head h (KV head h / G, G = H/KV),
//   out[b,h] = sum_j softmax_j(q[b,h].k[b,j] * scale | valid[b,j]) v[b,j]
// with an online softmax in fp32, masked probabilities set to 0
// explicitly, and an all-invalid row giving exact zeros. The paged kernel
// reads logical slot j of row b from physical page pages[b, j/ps] at
// offset j%ps, straight out of the [P, ps, KV, dh] pool.
//
// What bounds them: one query token means ~2 flops per K/V byte, far
// below the card's ~295 flop/byte balance point, so both are bound by
// the bytes of K and V they read. The design therefore reads each K/V
// tile once per *query group*: a block covers one (row, KV head) and all
// G query heads that share it (one warp per query head), so K/V bytes
// are read once, not G times. Tiles that hold no valid slot are not
// read at all.
//
// What the split does about the SM count: one block per (row, KV head)
// gives B*KV blocks -- 16 on the serving path (B=8, KV=2) against 132
// SMs. The cache length is therefore split across blocks
// (flash-decoding): each block reduces one split to fp32 partials
// (m, l, acc), and a small second kernel combines the splits and
// finalizes. A split with no valid slot contributes m=NEG_INF, l=0,
// acc=0, i.e. nothing.
//
// Inner loop (kept simple; tensor cores, TMA and cp.async pipelines are
// later work): K/V tiles of TILE slots are staged in shared memory with
// 16-byte vector loads, several in flight per thread; each warp computes
// its head's TILE scores one slot per lane with fp32 FMAs (q read as
// shared-memory broadcasts), then the online-softmax update and the P.V
// accumulation with each lane owning dh/32 output columns.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                 // cache slots per shared-memory tile
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

// The VEC elements of one 16-byte vector as floats (registers only; the
// lower address holds the lower half of each word).
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

// Element offset of logical slot j's (kv) row: flat [B, L, KV, DH] or
// paged [P, ps, KV, DH] through the row's page list.
template <bool PAGED>
__device__ __forceinline__ int64_t row_offset(int b, int j, int kv, int L,
                                              int KV, int DH,
                                              const int32_t* pages, int ps,
                                              int n_log) {
  int64_t r;
  if (PAGED) {
    const int64_t pid = pages[(int64_t)b * n_log + j / ps];
    r = (pid * ps + j % ps) * KV + kv;
  } else {
    r = ((int64_t)b * L + j) * KV + kv;
  }
  return r * DH;
}

// Shared-memory rows of K/V are padded by 16 bytes, so that the 16-byte
// reads of eight neighbouring lanes (one slot each) start on distinct
// bank quads: the lane-per-slot score loop is free of bank conflicts.
template <typename TKV, int DH>
struct Layout {
  static constexpr int VEC = 16 / sizeof(TKV);    // elements per 16 B
  static constexpr int VPR = DH / VEC;            // 16 B vectors per row
  static constexpr int DHP = DH + VEC;            // padded row (elements)
  static size_t bytes(int G) {
    return (size_t)G * DH * sizeof(float)              // q, fp32
           + 2 * (size_t)TILE * DHP * sizeof(TKV)      // K and V tiles
           + TILE * sizeof(int64_t) + TILE;            // row offsets, valid
  }
};

// One block = one (split, kv head, row); one warp per query head of the
// group. Writes the split's fp32 partials.
template <typename TQ, typename TKV, int DH, bool PAGED>
__global__ void split_kernel(const TQ* __restrict__ q,
                             const TKV* __restrict__ k,
                             const TKV* __restrict__ v,
                             const uint8_t* __restrict__ valid,
                             const int32_t* __restrict__ pages,
                             float* __restrict__ m_ws,
                             float* __restrict__ l_ws,
                             float* __restrict__ acc_ws,
                             int H, int KV, int L, int ps, int n_log,
                             int split_len, float sm_scale) {
  using Lay = Layout<TKV, DH>;
  constexpr int VEC = Lay::VEC, VPR = Lay::VPR, DHP = Lay::DHP;
  constexpr int E = DH >= 32 ? DH / 32 : 1;       // output columns per lane
  constexpr int UNROLL = 4;                       // 16 B loads in flight x2

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = kv * G + warp;
  const int nthreads = blockDim.x;
  const bool active = DH >= 32 || lane < DH;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);                 // [G][DH]
  TKV* sk = reinterpret_cast<TKV*>(sq + G * DH);              // [TILE][DHP]
  TKV* sv = sk + TILE * DHP;                                  // [TILE][DHP]
  int64_t* srow = reinterpret_cast<int64_t*>(sv + TILE * DHP);  // [TILE]
  uint8_t* sval = reinterpret_cast<uint8_t*>(srow + TILE);    // [TILE]

  // The group's queries, once, in fp32 (read back as broadcasts).
  const TQ* qg = q + ((int64_t)b * H + (int64_t)kv * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += nthreads) sq[i] = to_f(qg[i]);

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  const int j_begin = split * split_len;
  const int j_end = min(j_begin + split_len, L);
  for (int j0 = j_begin; j0 < j_end; j0 += TILE) {
    const int n = min(TILE, j_end - j0);
    __syncthreads();                              // previous tile consumed
    for (int t = threadIdx.x; t < TILE; t += nthreads) {
      sval[t] = t < n ? valid[(int64_t)b * L + j0 + t] : 0;
      if (t < n)
        srow[t] = row_offset<PAGED>(b, j0 + t, kv, L, KV, DH, pages, ps,
                                    n_log);
    }
    __syncthreads();
    // Block-uniform: every warp sees the same valid tile.
    const bool any = __syncthreads_or(lane < n && sval[lane]);
    if (!any) continue;                           // nothing to read here

    // Stage the tile: UNROLL loads of K and V in flight per thread
    // before any store to shared memory.
    const int total = n * VPR;
    for (int base = threadIdx.x; base < total; base += UNROLL * nthreads) {
      int4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * nthreads;
        if (idx < total) {
          const int64_t off = srow[idx / VPR] + (idx % VPR) * VEC;
          kr[u] = __ldg(reinterpret_cast<const int4*>(k + off));
          vr[u] = __ldg(reinterpret_cast<const int4*>(v + off));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int idx = base + u * nthreads;
        if (idx < total) {
          const int so = (idx / VPR) * DHP + (idx % VPR) * VEC;
          *reinterpret_cast<int4*>(sk + so) = kr[u];
          *reinterpret_cast<int4*>(sv + so) = vr[u];
        }
      }
    }
    __syncthreads();

    // Scores: lane t computes slot t's logit over the whole head dim.
    const bool ok = lane < n && sval[lane];
    float s = NEG_INF;
    if (lane < n) {
      const TKV* krow = sk + lane * DHP;
      const float* qw = sq + warp * DH;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int c = 0; c < DH; c += VEC) {
        float e[VEC];
        unpack(*reinterpret_cast<const int4*>(krow + c), e, TKV());
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qw + c + i);
          a0 = fmaf(qq.x, e[i], a0);
          a1 = fmaf(qq.y, e[i + 1], a1);
          a0 = fmaf(qq.z, e[i + 2], a0);
          a1 = fmaf(qq.w, e[i + 3], a1);
        }
      }
      s = (a0 + a1) * sm_scale;
    }
    s = ok ? s : NEG_INF;

    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = ok ? expf(s - m_new) : 0.f;   // masked -> exactly 0
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
    for (int t = 0; t < n; ++t) {
      const float pt = __shfl_sync(FULL, p, t);
      if (active) {
#pragma unroll
        for (int i = 0; i < E; ++i)
          acc[i] = fmaf(pt, to_f(sv[t * DHP + lane * E + i]), acc[i]);
      }
    }
    m = m_new;
  }

  const int64_t part = ((int64_t)b * H + h) * gridDim.x + split;
  if (lane == 0) {
    m_ws[part] = m;
    l_ws[part] = l;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i) acc_ws[part * DH + lane * E + i] = acc[i];
  }
}

// One block per (row, head), one thread per output column: rescale the
// splits to the common max and finalize as the Pallas kernel does
// (acc / max(l, 1e-30), so an all-invalid row is exactly 0).
template <typename TO, int DH>
__global__ void combine_kernel(const float* __restrict__ m_ws,
                               const float* __restrict__ l_ws,
                               const float* __restrict__ acc_ws,
                               TO* __restrict__ out, int n_splits) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* mr = m_ws + row * n_splits;
  const float* lr = l_ws + row * n_splits;
  float mx = NEG_INF;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, mr[s]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mr[s] - mx);
    den = fmaf(lr[s], w, den);
    num = fmaf(acc_ws[(row * n_splits + s) * DH + d], w, num);
  }
  out[row * DH + d] = from_f<TO>(num / fmaxf(den, 1e-30f));
}

template <typename TQ, typename TKV, int DH, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, const void* pages, void* out,
                         float* m_ws, float* l_ws, float* acc_ws, int B,
                         int H, int KV, int L, int ps, int n_log,
                         int split_len, int n_splits, float sm_scale,
                         cudaStream_t stream) {
  auto kern = split_kernel<TQ, TKV, DH, PAGED>;
  const size_t smem = Layout<TKV, DH>::bytes(H / KV);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_splits, KV, B);
  kern<<<grid, 32 * (H / KV), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(pages), m_ws, l_ws, acc_ws, H, KV, L, ps,
      n_log, split_len, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<TQ, DH><<<B * H, DH, 0, stream>>>(
      m_ws, l_ws, acc_ws, static_cast<TQ*>(out), n_splits);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      const void* valid, const void* pages, void* out,
                      float* m_ws, float* l_ws, float* acc_ws, int B, int H,
                      int KV, int L, int ps, int n_log, int split_len,
                      int n_splits, float sm_scale, cudaStream_t stream) {
#define REPRO_DH_CASE(D)                                                    \
  case D:                                                                   \
    return launch_typed<TQ, TKV, D, PAGED>(q, k, v, valid, pages, out, m_ws, \
                                           l_ws, acc_ws, B, H, KV, L, ps,    \
                                           n_log, split_len, n_splits,       \
                                           sm_scale, stream);
  switch (dh) {
    REPRO_DH_CASE(16)
    REPRO_DH_CASE(32)
    REPRO_DH_CASE(64)
    REPRO_DH_CASE(128)
    REPRO_DH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DH_CASE
}

template <bool PAGED>
cudaError_t launch(int q_dtype, int kv_dtype, int dh, const void* q,
                   const void* k, const void* v, const void* valid,
                   const void* pages, void* out, float* m_ws, float* l_ws,
                   float* acc_ws, int B, int H, int KV, int L, int ps,
                   int n_log, int split_len, int n_splits, float sm_scale,
                   cudaStream_t stream) {
  if (H % KV != 0 || H / KV > 32 || split_len < 1 || n_splits < 1)
    return cudaErrorInvalidValue;
#define REPRO_ARGS                                                         \
  dh, q, k, v, valid, pages, out, m_ws, l_ws, acc_ws, B, H, KV, L, ps,     \
      n_log, split_len, n_splits, sm_scale, stream
  if (q_dtype == F32 && kv_dtype == F32)
    return launch_dh<float, float, PAGED>(REPRO_ARGS);
  if (q_dtype == F32 && kv_dtype == BF16)
    return launch_dh<float, __nv_bfloat16, PAGED>(REPRO_ARGS);
  if (q_dtype == BF16 && kv_dtype == F32)
    return launch_dh<__nv_bfloat16, float, PAGED>(REPRO_ARGS);
  if (q_dtype == BF16 && kv_dtype == BF16)
    return launch_dh<__nv_bfloat16, __nv_bfloat16, PAGED>(REPRO_ARGS);
#undef REPRO_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B,H,dh]; k/v [B,L,KV,dh]; valid [B,L] bytes; out [B,H,dh] in q's
// dtype; m_ws/l_ws [B,H,n_splits] and acc_ws [B,H,n_splits,dh] fp32
// scratch. Dtype codes: 0 = float32, 1 = bfloat16.
int repro_decode_attention(int q_dtype, int kv_dtype, int dh, const void* q,
                           const void* k, const void* v, const void* valid,
                           void* out, float* m_ws, float* l_ws,
                           float* acc_ws, int B, int H, int KV, int L,
                           int split_len, int n_splits, float sm_scale,
                           void* stream) {
  return (int)launch<false>(q_dtype, kv_dtype, dh, q, k, v, valid, nullptr,
                            out, m_ws, l_ws, acc_ws, B, H, KV, L, 0, 0,
                            split_len, n_splits, sm_scale,
                            static_cast<cudaStream_t>(stream));
}

// q [B,H,dh]; k/v pages [P,ps,KV,dh]; pages [B,n_log] int32; valid
// [B, n_log*ps] bytes over logical slots; the rest as above.
int repro_paged_decode_attention(int q_dtype, int kv_dtype, int dh,
                                 const void* q, const void* k_pages,
                                 const void* v_pages, const void* pages,
                                 const void* valid, void* out, float* m_ws,
                                 float* l_ws, float* acc_ws, int B, int H,
                                 int KV, int ps, int n_log, int split_len,
                                 int n_splits, float sm_scale,
                                 void* stream) {
  return (int)launch<true>(q_dtype, kv_dtype, dh, q, k_pages, v_pages, valid,
                           pages, out, m_ws, l_ws, acc_ws, B, H, KV,
                           n_log * ps, ps, n_log, split_len, n_splits,
                           sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
