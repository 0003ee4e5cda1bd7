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
// gives B*KV blocks -- 8 at RecurrentGemma's decode (B=8, one KV head)
// against 132 SMs. The cache length is therefore split across blocks
// (flash-decoding): the wrapper's split_plan sizes the split for the
// whole block -- G warps already, a few tiles at least so that the
// staged q, the barriers and the partials are amortised and the
// two-stage ring has something to overlap, and partials (G x dh fp32)
// small against the split's K/V bytes. Each block reduces its split to
// fp32 partials (m, l, acc); the last block of a (row, KV head) to
// finish (a counter in a workspace, bumped with atomicAdd after a
// __threadfence) combines the splits of its G heads and writes out, then
// sets the counter back to 0 for the next call: one launch per call, no
// memset. The combine finds each head's max and denominator with one
// lane per split, then each lane sums its output columns over the
// splits. A split with no valid slot contributes m=NEG_INF, l=0, acc=0,
// i.e. nothing; with one split the block finalizes directly.
//
// Inner loop: K/V tiles of TILE slots go through a two-stage ring in
// shared memory, filled by 16-byte cp.async, so tile t+1 loads while tile
// t is reduced; tiles with no valid slot are found (one warp vote over
// the tile's valid bytes, the same in every warp) and never read. Each
// warp computes its head's TILE scores one slot per lane with fp32 FMAs
// (q read as shared-memory broadcasts), then the online-softmax update and
// the P.V accumulation with each lane owning dh/32 output columns.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; each entry point launches on the given
// stream and returns cudaGetLastError().

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TILE = 32;                 // cache slots per shared-memory tile

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
  static constexpr int STAGES = 2;                // depth of the K/V ring
  static size_t bytes(int G, int split_len) {
    return (size_t)G * DH * sizeof(float)                      // q, fp32
           + STAGES * 2 * (size_t)TILE * DHP * sizeof(TKV)     // K and V
           + (split_len + TILE - 1) / TILE * sizeof(uint32_t); // valid bits
  }
};

// E consecutive floats from global memory through L2 (written by other
// blocks of this launch), into registers.
template <int E>
__device__ __forceinline__ void load_cg(const float* p, float (&x)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p + i));
      x[i] = t.x;
      x[i + 1] = t.y;
      x[i + 2] = t.z;
      x[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = __ldcg(p + i);
  }
}

// One block = one (split, kv head, row); one warp per query head of the
// group. Reduces the split to fp32 partials; the last block of the (row,
// kv head) combines all splits and writes out (see the note above).
template <typename TQ, typename TKV, int DH, bool PAGED>
__global__ void decode_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k,
                              const TKV* __restrict__ v,
                              const uint8_t* __restrict__ valid,
                              const int32_t* __restrict__ pages,
                              TQ* __restrict__ out, float* __restrict__ m_ws,
                              float* __restrict__ l_ws,
                              float* __restrict__ acc_ws,
                              int* __restrict__ counters, int H, int KV,
                              int L, int ps, int n_log, int split_len,
                              float sm_scale) {
  using Lay = Layout<TKV, DH>;
  constexpr int VEC = Lay::VEC, VPR = Lay::VPR, DHP = Lay::DHP;
  constexpr int E = DH >= 32 ? DH / 32 : 1;       // output columns per lane

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = kv * G + warp;
  const int nthreads = blockDim.x;
  const bool active = DH >= 32 || lane < DH;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);                 // [G][DH]
  TKV* skv = reinterpret_cast<TKV*>(sq + G * DH);  // [stage][K, V][TILE][DHP]
  uint32_t* smask =                                // [tile]: valid slots
      reinterpret_cast<uint32_t*>(skv + Lay::STAGES * 2 * TILE * DHP);

  // The group's queries, once, in fp32 (read back as broadcasts), and
  // the split's valid bytes as one 32-bit vote per tile, all in flight
  // together.
  const TQ* qg = q + ((int64_t)b * H + (int64_t)kv * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += nthreads) sq[i] = to_f(qg[i]);
  const uint8_t* vrow = valid + (int64_t)b * L;
  const int j_begin = split * split_len;
  const int j_end = min(j_begin + split_len, L);
  const int n_tiles = (j_end - j_begin + TILE - 1) / TILE;
  for (int t = warp; t < n_tiles; t += G) {
    const int j = j_begin + t * TILE + lane;
    const unsigned bits = __ballot_sync(FULL, j < j_end && vrow[j]);
    if (lane == 0) smask[t] = bits;
  }
  __syncthreads();
  // The first tile at or after t with a valid slot (tiles with none are
  // never read), or n_tiles.
  auto next_valid = [&](int t) {
    while (t < n_tiles && !smask[t]) ++t;
    return t;
  };
  auto load = [&](int tile, int stage) {           // cp.async one K/V tile
    const int j0 = j_begin + tile * TILE;
    const int n = min(TILE, j_end - j0);
    TKV* sk = skv + 2 * stage * TILE * DHP;
    TKV* sv = sk + TILE * DHP;
    for (int idx = threadIdx.x; idx < n * VPR; idx += nthreads) {
      const int slot = idx / VPR, c = (idx % VPR) * VEC;
      const int64_t off =
          row_offset<PAGED>(b, j0 + slot, kv, L, KV, DH, pages, ps, n_log) +
          c;
      cp_async16(smem_addr(sk + slot * DHP + c), k + off, 16);
      cp_async16(smem_addr(sv + slot * DHP + c), v + off, 16);
    }
  };

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  int t = next_valid(0);
  if (t < n_tiles) load(t, 0);
  cp_async_commit();
  for (int stage = 0; t < n_tiles; stage ^= 1) {
    const int tn = next_valid(t + 1);
    cp_async_wait_all();                          // tile t landed; for all
    __syncthreads();                              // threads; other stage free
    if (tn < n_tiles) load(tn, stage ^ 1);        // overlaps this tile
    cp_async_commit();

    const int j0 = j_begin + t * TILE;
    const int n = min(TILE, j_end - j0);
    const TKV* sk = skv + 2 * stage * TILE * DHP;
    const TKV* sv = sk + TILE * DHP;

    // Scores: each lane computes its slot's logit over the whole head dim.
    const bool ok = (smask[t] >> lane) & 1;
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
    for (int slot = 0; slot < n; ++slot) {
      const float pt = __shfl_sync(FULL, p, slot);
      if (active) {
        const TKV* vrow_t = sv + slot * DHP + lane * E;
        if constexpr (E * sizeof(TKV) == 16) {
          float e[E];
          unpack(*reinterpret_cast<const int4*>(vrow_t), e, TKV());
#pragma unroll
          for (int i = 0; i < E; ++i) acc[i] = fmaf(pt, e[i], acc[i]);
        } else {
#pragma unroll
          for (int i = 0; i < E; ++i)
            acc[i] = fmaf(pt, to_f(vrow_t[i]), acc[i]);
        }
      }
    }
    m = m_new;
    t = tn;
  }

  // Finalize as the Pallas kernel does: acc / max(l, 1e-30), so an
  // all-invalid row is exactly 0.
  const int64_t row = (int64_t)b * H + h;
  if (n_splits == 1) {
    if (active) {
#pragma unroll
      for (int i = 0; i < E; ++i)
        out[row * DH + lane * E + i] = from_f<TQ>(acc[i] / fmaxf(l, 1e-30f));
    }
    return;
  }

  // Partials out; the last block of this (row, kv head) to arrive reads
  // every split's back through L2.
  const int64_t part = row * n_splits + split;
  if (lane == 0) {
    m_ws[part] = m;
    l_ws[part] = l;
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i) acc_ws[part * DH + lane * E + i] = acc[i];
  }
  __threadfence();                        // partials visible device-wide,
  __syncthreads();                        // from every thread, before
  int prev = 0;                           // the block counts itself in
  if (threadIdx.x == 0) prev = atomicAdd(&counters[b * KV + kv], 1);
  if (!__syncthreads_or(threadIdx.x == 0 && prev == n_splits - 1)) return;
  __threadfence();

  // Combine the splits of this warp's head: the max and the denominator
  // with one lane per split, then each lane's columns summed over the
  // splits with the weights broadcast from their lanes.
  const float* mr = m_ws + row * n_splits;
  const float* lr = l_ws + row * n_splits;
  float mx = NEG_INF;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, __ldcg(mr + s));
  mx = warp_max(mx);
  float den = 0.f, num[E];
#pragma unroll
  for (int i = 0; i < E; ++i) num[i] = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += 32) {
    const int s = s0 + lane;
    const float w = s < n_splits ? expf(__ldcg(mr + s) - mx) : 0.f;
    if (s < n_splits) den = fmaf(__ldcg(lr + s), w, den);
    const int cnt = min(32, n_splits - s0);
    for (int t0 = 0; t0 < cnt; t0 += 8) {        // 8 splits' loads in flight
      float a[8][E];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (active && t0 + u < cnt)
          load_cg<E>(acc_ws + (row * n_splits + s0 + t0 + u) * DH + lane * E,
                     a[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float wt = __shfl_sync(FULL, w, t0 + u);
        if (active && t0 + u < cnt) {
#pragma unroll
          for (int i = 0; i < E; ++i) num[i] = fmaf(a[u][i], wt, num[i]);
        }
      }
    }
  }
  den = warp_sum(den);
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i)
      out[row * DH + lane * E + i] = from_f<TQ>(num[i] / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) counters[b * KV + kv] = 0;   // ready for the next call
}

template <typename TQ, typename TKV, int DH, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, const void* pages, void* out,
                         float* m_ws, float* l_ws, float* acc_ws,
                         int* counters, int B, int H, int KV, int L, int ps,
                         int n_log, int split_len, int n_splits,
                         float sm_scale, cudaStream_t stream) {
  auto kern = decode_kernel<TQ, TKV, DH, PAGED>;
  const size_t smem = Layout<TKV, DH>::bytes(H / KV, split_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(n_splits, KV, B);
  kern<<<grid, 32 * (H / KV), smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(pages), static_cast<TQ*>(out), m_ws, l_ws,
      acc_ws, counters, H, KV, L, ps, n_log, split_len, sm_scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      const void* valid, const void* pages, void* out,
                      float* m_ws, float* l_ws, float* acc_ws, int* counters,
                      int B, int H, int KV, int L, int ps, int n_log,
                      int split_len, int n_splits, float sm_scale,
                      cudaStream_t stream) {
#define REPRO_DH_CASE(D)                                                     \
  case D:                                                                    \
    return launch_typed<TQ, TKV, D, PAGED>(                                  \
        q, k, v, valid, pages, out, m_ws, l_ws, acc_ws, counters, B, H, KV,  \
        L, ps, n_log, split_len, n_splits, sm_scale, stream);
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
                   float* acc_ws, int* counters, int B, int H, int KV, int L,
                   int ps, int n_log, int split_len, int n_splits,
                   float sm_scale, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > 32 || split_len < 1 || n_splits < 1 ||
      (n_splits > 1 && !(m_ws && l_ws && acc_ws && counters)))
    return cudaErrorInvalidValue;
#define REPRO_ARGS                                                         \
  dh, q, k, v, valid, pages, out, m_ws, l_ws, acc_ws, counters, B, H, KV,  \
      L, ps, n_log, split_len, n_splits, sm_scale, stream
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
// dtype. With n_splits > 1: m_ws/l_ws [B,H,n_splits] and acc_ws
// [B,H,n_splits,dh] fp32 scratch, and counters [B*KV] int32, zero before
// the call and zero again after it (calls that share counters must not
// overlap); with one split all four may be null. Dtype codes: 0 =
// float32, 1 = bfloat16.
int repro_decode_attention(int q_dtype, int kv_dtype, int dh, const void* q,
                           const void* k, const void* v, const void* valid,
                           void* out, float* m_ws, float* l_ws,
                           float* acc_ws, int* counters, int B, int H,
                           int KV, int L, int split_len, int n_splits,
                           float sm_scale, void* stream) {
  return (int)launch<false>(q_dtype, kv_dtype, dh, q, k, v, valid, nullptr,
                            out, m_ws, l_ws, acc_ws, counters, B, H, KV, L,
                            0, 0, split_len, n_splits, sm_scale,
                            static_cast<cudaStream_t>(stream));
}

// q [B,H,dh]; k/v pages [P,ps,KV,dh]; pages [B,n_log] int32; valid
// [B, n_log*ps] bytes over logical slots; the rest as above.
int repro_paged_decode_attention(int q_dtype, int kv_dtype, int dh,
                                 const void* q, const void* k_pages,
                                 const void* v_pages, const void* pages,
                                 const void* valid, void* out, float* m_ws,
                                 float* l_ws, float* acc_ws, int* counters,
                                 int B, int H, int KV, int ps, int n_log,
                                 int split_len, int n_splits, float sm_scale,
                                 void* stream) {
  return (int)launch<true>(q_dtype, kv_dtype, dh, q, k_pages, v_pages, valid,
                           pages, out, m_ws, l_ws, acc_ws, counters, B, H, KV,
                           n_log * ps, ps, n_log, split_len, n_splits,
                           sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
