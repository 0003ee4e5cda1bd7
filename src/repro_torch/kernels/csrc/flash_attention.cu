// Prefill flash attention for Hopper (sm_90a): causal / sliding-window
// GQA attention over a whole sequence.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro_flash_attention  <- repro/kernels/flash_attention.py,
//                             _flash_kernel / flash_attention
//
// Computes, for each row b, query i (at position i + Sk - Sq: queries
// are right-aligned when Sq < Sk) and head h (KV head h / G, G = H/KV),
//   out[b,i,h] = sum_j softmax_j(q[b,i,h].k[b,j] * scale | visible) v[b,j]
// where key j is visible if j <= pos(i) (causal) and pos(i) - j < window
// (sliding window). Online softmax in fp32, masked probabilities set to 0
// explicitly, and the finalize divides by max(l, 1e-30), as the Pallas
// kernel does.
//
// What bounds it: two products of a 64-query tile against every visible
// 64-key tile, O(S^2 dh) operations on O(S dh) bytes, so at prefill
// lengths it is bound by operations, not bytes. This first version does
// them as fp32 FMAs from shared memory (tensor cores -- mma/wgmma -- are
// later work), so it runs far above the tensor-core bound.
//
// The design:
//   * one block per (query tile, query head, row); K/V are read through
//     h / G, as the Pallas index_map does, and the heaviest (latest)
//     causal tiles are scheduled first;
//   * tile skipping is the k loop's bounds: from the first tile that can
//     hold a key inside the window to the last causal tile (the Pallas
//     kernel's pl.when(visible));
//   * 256 threads as a 16 x 16 grid, each owning a 4 x 4 block of scores
//     and 4 rows x dh/16 columns of the output accumulator, so the
//     softmax statistics of a row stay within 16 neighbouring lanes
//     (shuffle reductions) and the rescale by alpha needs no exchange;
//   * Q and K are staged transposed ([dh][tile], fp32) so each score step
//     reads two float4s for 16 FMAs; V row-major with rows padded by 16
//     bytes so the staging stores are free of bank conflicts;
//   * ragged Sq and Sk are masked (the Pallas kernel needs S % block == 0):
//     out-of-range keys load as zeros and are masked, out-of-range query
//     rows are computed and not stored.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the entry point launches on the given stream
// and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 (tx, keys/columns) x 16 (ty, queries)
constexpr int TM = 4;         // query rows per thread
constexpr int TN = 4;         // scores per thread per row
constexpr int PSTRIDE = BK + 1;  // padded row of the probability tile

template <int DH>
struct Smem {
  static constexpr int DHP = DH + 4;  // padded V row (floats)
  static constexpr size_t floats =
      (size_t)DH * BQ + (size_t)DH * BK + (size_t)BK * DHP +
      (size_t)BQ * PSTRIDE;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Sk, int H, int KV, int causal, int window,
                 float sm_scale) {
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte vector
  constexpr int VPR = DH / VEC;          // vectors per row
  constexpr int DHP = Smem<DH>::DHP;
  constexpr int CPT = DH / 16;           // output columns per thread
  constexpr int VW = CPT < 4 ? CPT : 4;  // columns per shared-memory read
  constexpr int NCH = CPT / VW;
  constexpr int KV_ITERS = (BK * VPR + NT - 1) / NT;
  constexpr int UNROLL = KV_ITERS < 4 ? KV_ITERS : 4;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;                 // [DH][BQ]
  float* sKt = sQt + DH * BQ;        // [DH][BK]
  float* sV = sKt + DH * BK;         // [BK][DHP]
  float* sP = sV + BK * DHP;         // [BQ][PSTRIDE]

  const int q0 = qt * BQ;
  const int off = Sk - Sq;                        // right alignment
  const int64_t q_row = (int64_t)H * DH;          // elements between queries
  const int64_t kv_row = (int64_t)KV * DH;        // ... between keys
  const T* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * DH;
  const T* kb = k + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;
  const T* vb = v + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;

  // Q tile, transposed; consecutive threads take consecutive rows so the
  // transposed stores hit consecutive banks.
  for (int i = tid; i < BQ * VPR; i += NT) {
    const int r = i % BQ, c = i / BQ;
    float f[VEC];
    if (q0 + r < Sq) {
      unpack(__ldg(reinterpret_cast<const int4*>(
                 qb + (int64_t)(q0 + r) * q_row + c * VEC)),
             f, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sQt[(c * VEC + e) * BQ + r] = f[e];
  }

  // Visible key range of this query tile, in whole tiles.
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  float m[TM], l[TM], o[TM][CPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();               // Q staged / previous tile consumed

    // Stage K (transposed) and V (row-major, padded): UNROLL vectors of
    // each in flight per thread before any store to shared memory.
    for (int it = 0; it < KV_ITERS; it += UNROLL) {
      int4 kr[UNROLL], vr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = tid + (it + u) * NT;
        const int r = i % BK, c = i / BK;
        kr[u] = vr[u] = make_int4(0, 0, 0, 0);
        if (i < BK * VPR && k0 + r < Sk) {
          const int64_t offs = (int64_t)(k0 + r) * kv_row + c * VEC;
          kr[u] = __ldg(reinterpret_cast<const int4*>(kb + offs));
          vr[u] = __ldg(reinterpret_cast<const int4*>(vb + offs));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = tid + (it + u) * NT;
        if (i < BK * VPR) {
          const int r = i % BK, c = i / BK;
          float f[VEC];
          unpack(kr[u], f, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e) sKt[(c * VEC + e) * BK + r] = f[e];
          unpack(vr[u], f, T());
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(sV + r * DHP + c * VEC + e) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
      }
    }
    __syncthreads();

    // Scores: rows ty*TM.., keys tx*TN...
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(sQt + d * BQ + ty * TM);
      const float4 ka = *reinterpret_cast<const float4*>(sKt + d * BK + tx * TN);
      const float qv[TM] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[TN] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, online-softmax update (row statistics across the 16 tx
    // lanes of the row), probabilities to shared memory.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i + off;
      bool ok[TN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx * TN + j;
        const int diff = qpos - kpos;
        ok[j] = kpos < Sk && (!causal || diff >= 0) &&
                (window <= 0 || diff < window);
        s[i][j] = ok[j] ? s[i][j] * sm_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;  // masked -> 0
        ps += p;
        sP[(ty * TM + i) * PSTRIDE + tx * TN + j] = p;
      }
      l[i] = l[i] * alpha + ps;      // this lane's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V over the tile's keys.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) pr[i] = sP[(ty * TM + i) * PSTRIDE + c];
      const float* vrow = sV + c * DHP;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int col = ch * 16 * VW + tx * VW;
        float vv[VW];
        if constexpr (VW == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + col);
          vv[0] = t4.x;
          vv[1] = t4.y;
          vv[2] = t4.z;
          vv[3] = t4.w;
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) vv[e] = vrow[col + e];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            o[i][ch * VW + e] = fmaf(pr[i], vv[e], o[i][ch * VW + e]);
      }
    }
  }

  // Finalize: the row sum over its 16 lanes, then acc / max(l, 1e-30).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) li += __shfl_xor_sync(FULL, li, w);
    const int row = q0 + ty * TM + i;
    if (row >= Sq) continue;
    const float den = fmaxf(li, 1e-30f);
    T* orow = out + ((int64_t)b * Sq + row) * q_row + (int64_t)h * DH;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[ch * 16 * VW + tx * VW + e] = from_f<T>(o[i][ch * VW + e] / den);
  }
}

template <typename T, int DH>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KV,
                         int causal, int window, float sm_scale,
                         cudaStream_t stream) {
  auto kern = flash_kernel<T, DH>;
  const size_t smem = Smem<DH>::bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* out, int B, int Sq, int Sk, int H, int KV,
                      int causal, int window, float sm_scale,
                      cudaStream_t stream) {
#define REPRO_DH_CASE(D)                                                  \
  case D:                                                                 \
    return launch_typed<T, D>(q, k, v, out, B, Sq, Sk, H, KV, causal,     \
                              window, sm_scale, stream);
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

}  // namespace

extern "C" {

// q [B,Sq,H,dh], k/v [B,Sk,KV,dh], out [B,Sq,H,dh], all in one dtype
// (0 = float32, 1 = bfloat16). causal: 0/1; window: 0 = none, else the
// number of positions a query sees (itself included).
int repro_flash_attention(int dtype, int dh, const void* q, const void* k,
                          const void* v, void* out, int B, int Sq, int Sk,
                          int H, int KV, int causal, int window,
                          float sm_scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return (int)launch_dh<float>(dh, q, k, v, out, B, Sq, Sk, H, KV, causal,
                                 window, sm_scale, st);
  if (dtype == BF16)
    return (int)launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, Sq, Sk, H, KV,
                                         causal, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
