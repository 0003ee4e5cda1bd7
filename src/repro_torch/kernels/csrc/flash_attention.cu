// Prefill flash attention for Hopper (sm_90a): causal / sliding-window
// GQA attention over a whole sequence.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro_flash_attention_bf16 / _f32
//       <- repro/kernels/flash_attention.py, _flash_kernel / flash_attention
//
// Computes, for each row b, query i (at position i + Sk - Sq: queries
// are right-aligned when Sq < Sk) and head h (KV head h / G, G = H/KV),
//   out[b,i,h] = sum_j softmax_j(q[b,i,h].k[b,j] * scale | visible) v[b,j]
// where key j is visible if j <= pos(i) (causal) and pos(i) - j < window
// (sliding window). Online softmax in fp32, masked probabilities set to 0
// explicitly, and the finalize divides by max(l, 1e-30), as the Pallas
// kernel does.
//
// What bounds it: two products of a query tile against every visible
// key tile, O(S^2 dh) operations on O(S dh) bytes, so at prefill lengths
// it is bound by operations, not bytes: on the H100 by the tensor cores'
// 989 TFLOP/s in bf16.
//
// Two kernels, chosen by dtype (the C entry points below; the wrapper
// calls one or the other):
//
// bf16 -- flash_tc_kernel, on the tensor cores (wgmma):
//   * one block per (query tile, query head, row): one warpgroup of 128
//     threads and 64 query rows up to dh 128, two sharing the K/V tiles
//     at dh 256 (see Cfg); K/V are read through h / G; the query tile is
//     the slowest grid dimension, so the heaviest (latest) causal tiles
//     of every head are scheduled first;
//   * S = Q K^T is a wgmma m64n64k16 chain with Q and the K tile in
//     shared memory (both K-major, as they are stored); the fp32 scores,
//     the row max and the row sum stay in registers, each row in one quad
//     of lanes (the wgmma accumulator layout);
//   * P is rounded to bf16 in registers and is the A operand of the P V
//     wgmma (m64n{dh}k16, V MN-major from shared memory); the fp32 output
//     accumulator stays in registers. The JAX model's dense path and SDPA
//     round P to bf16 as well;
//   * the softmax, not the tensor cores, sets the pace: a 64 x 64 tile is
//     4096 exponentials at 16 a clock per SM, half the time of its
//     2 x 64 x 64 x 128 multiply-adds at about 2048 a clock, and the max,
//     sum, select and rescale instructions around them cost more. So the
//     scale is folded into the exponent's FMA, exp2 is one ex2.approx instruction,
//     the mask is applied only on tiles that straddle the diagonal, the
//     window edge or the end of the keys (a second, unmasked copy of the
//     update runs on the rest), and the output is rescaled only when a
//     row's max moved (alpha is exactly 1 otherwise);
//   * K/V tiles of 64 keys go through a two-stage ring in shared memory,
//     kept in bf16 and written by 16-byte cp.async in the 128-byte swizzle
//     that the descriptors name; tile t+1's copies are issued while tile
//     t's S product runs;
//   * up to dh 128 a warpgroup issues S_t and P_{t-1} V_{t-1} together
//     and runs tile t's softmax while the value product is on the tensor
//     cores (at dh 256 the registers hold no second P: one product, then
//     the softmax, then the other);
//   * the head dim is zero-padded up to whole 64-column slabs (16 and 32
//     to 64, 80 to 128; the zero columns add nothing to q.k and are not
//     stored), and the S product stops at the last 16 columns that hold
//     data (5 of 8 steps at dh 80); the P V product runs the padded width;
//   * the k loop runs from the first tile that can hold a key inside the
//     window to the last causal tile (the Pallas kernel's pl.when), and a
//     warpgroup skips a tile none of its rows sees;
//   * ragged Sq and Sk: loads past the end are zero-filled, keys past Sk
//     masked, query rows past Sq computed and not stored;
//   * a template flag (LSE) also stores each row's log-sum-exp for the
//     backward pass (flash_attention_bwd.cu); the inference entry point
//     launches the instance without it.
//
// fp32 -- flash_kernel, fp32 FMAs from shared memory. fp32 is the parity
// dtype (greedy tokens are held exact at fp32 compute), and TF32 tensor
// cores would keep only about three digits, so it stays off them:
//   * one block per (64-query tile, query head, row), 256 threads as a
//     16 x 16 grid, each owning a 4 x 4 block of scores and 4 rows x dh/16
//     columns of the output accumulator (read from V in runs of 4, 2 or 1
//     columns, whichever divides dh/16: 1 at dh 80), so the softmax
//     statistics of a row stay within 16 neighbouring lanes (shuffle
//     reductions) and the rescale by alpha needs no exchange;
//   * Q and K are staged transposed ([dh][tile]) so each score step reads
//     two float4s for 16 FMAs; V row-major with rows padded by 16 bytes so
//     the staging stores are free of bank conflicts; the same tile
//     skipping and ragged-edge masking as above.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; each entry point launches on the given stream
// and returns cudaGetLastError().

#include "common.cuh"
#include "flash_tile.cuh"
#include "wgmma.cuh"

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
  // Columns per shared-memory read: it must divide CPT (dh 80: CPT 5).
  constexpr int VW = CPT % 4 == 0 ? 4 : (CPT % 2 == 0 ? 2 : 1);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;            // keys per tile
constexpr int STAGES = 2;         // depth of the K/V ring

// A block has NWG warpgroups of 64 query rows each, sharing the K/V
// tiles. Up to dh 128 a block is one warpgroup: two blocks fit an SM and
// run unsynchronized, so one's softmax overlaps the other's products,
// and causal work is cut finer. At dh 256 the ring takes 128 KB, so one
// block of two warpgroups fills the SM.
template <int DH>
struct Cfg {
  static constexpr int NWG = DH <= 128 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;                  // queries per block
  static constexpr int NT = 128 * NWG;                 // threads
  static constexpr int DP = (DH + 63) / 64 * 64;       // padded head dim
  static constexpr int KS = (DH + 15) / 16;            // S product's k steps
  static constexpr uint32_t Q = BQ * DP * 2;           // bytes of the Q tile
  static constexpr uint32_t KV = BK * DP * 2;          // of one K or V tile
  static constexpr size_t bytes = Q + 2 * STAGES * KV + 1024;  // + alignment
};

// The online-softmax update of one tile of scores s (a thread's 32 wgmma
// accumulator entries, two rows of 16: entry i is row (i / 2) % 2) in
// base 2: the rows' max m and sum l, alpha = 2^(m_old - m_new), and s
// replaced by the probabilities, exactly 0 where bit i of ok is clear
// (ALL: no entry is masked). Each row's four lanes are a quad.
template <bool ALL>
__device__ __forceinline__ void online_softmax(float (&s)[32], uint32_t ok,
                                               float scale_log2,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (!ALL && !((ok >> i) & 1)) s[i] = NEG_INF;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 2));
    const float m_new = fmaxf(m[j], mx[j] * scale_log2);
    alpha[j] = ex2(m[j] - m_new);
    m[j] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float p = ex2(fmaf(s[i], scale_log2, -m[(i / 2) % 2]));
    if (!ALL) p = (ok >> i) & 1 ? p : 0.f;           // masked -> exactly 0
    s[i] = p;
    ps[(i / 2) % 2] += p;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + ps[j];
}

// LSE: also write each row's log-sum-exp of its scaled scores, fp32
// [B, H, Sq] (+inf for a row that sees no key), for the backward pass.
template <int DH, bool LSE>
__global__ void __launch_bounds__(Cfg<DH>::NT, 1)
    flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Sk, int H, int KV, int causal, int window,
                    float scale_log2) {
  using S = Cfg<DH>;
  constexpr int DP = S::DP, BQ = S::BQ;
  constexpr int NO = DP / 2;      // output accumulators per thread

  const int qt = gridDim.z - 1 - blockIdx.z;   // heaviest tiles first,
  const int h = blockIdx.x, b = blockIdx.y;     // over every head and row
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + S::Q;  // stage s: K at sKV + 2 s KV, V after it

  const int q0 = qt * BQ;
  const int off = Sk - Sq;                        // right alignment
  const int64_t q_row = (int64_t)H * DH;          // elements between queries
  const int64_t kv_row = (int64_t)KV * DH;        // ... between keys
  const __nv_bfloat16* qb =
      q + ((int64_t)b * Sq + q0) * q_row + (int64_t)h * DH;
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;

  // Visible key range of the block's queries, in whole tiles.
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  // K and V rings: tile t's K in stage t % STAGES of the first, its V in
  // the same stage of the second.
  const uint32_t sK = sQ + S::Q, sV = sK + STAGES * S::KV;
  auto load = [&](uint32_t ring, const __nv_bfloat16* g, int t) {
    load_tile<BK, DH, S::NT>(ring + (t % STAGES) * S::KV,
                      g + (int64_t)t * BK * kv_row, kv_row, Sk - t * BK, tid);
  };
  load_tile<BQ, DH, S::NT>(sQ, qb, q_row, Sq - q0, tid);
  if (t_begin < t_end) {
    load(sK, kb, t_begin);
    if (S::NWG > 1) load(sV, vb, t_begin);
  }
  cp_async_commit();

  // This warpgroup's query positions are w_lo..w_hi (none if w_hi < w_lo);
  // the thread holds rows r and r + 8 of them, and in each 8-column block
  // of a wgmma accumulator the columns cq and cq + 1.
  const int wq0 = q0 + 64 * wg;
  const int w_lo = wq0 + off, w_hi = min(wq0 + 64, Sq) - 1 + off;
  const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int pos[2] = {wq0 + r + off, wq0 + r + 8 + off};

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // Every thread's copies landed, made visible to the tensor cores.
  auto tiles_ready = [&]() {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  };
  // Issue S = Q K_t^T over the head dim, 16 columns a step.
  auto issue_s = [&](int t, float (&s)[32]) {
    const uint32_t sk = sK + (t % STAGES) * S::KV;
#pragma unroll
    for (int kk = 0; kk < S::KS; ++kk)
      wgmma_ss_m64n64k16(
          s,
          sw128_desc(sQ + (kk / 4) * (BQ * 128) + wg * (64 * 128) +
                         (kk % 4) * 32, 16, 1024),
          sw128_desc(sk + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // Issue O += P V_t, 16 keys a step; V MN-major: 64-column slabs BK * 128
  // bytes apart, 8-key groups 1024 bytes apart.
  auto issue_pv = [&](int t, uint32_t (&pa)[4][4]) {
    const uint32_t sv = sV + (t % STAGES) * S::KV;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_m64k16(o, pa[j], sw128_desc(sv + j * 16 * 128, BK * 128, 1024));
    wgmma_commit();
  };
  // Tile t's online-softmax update: s to probabilities, in bf16 as the A
  // operand (the 16-key slice j is entries 8j..8j+7), and alpha. Entry i
  // is row r + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + cq + i % 2; the mask
  // is applied only on tiles that straddle an edge.
  auto softmax = [&](int t, float (&s)[32], uint32_t (&pa)[4][4],
                     float (&alpha)[2]) {
    const int k0 = t * BK;
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= w_lo) &&
                      (window <= 0 || w_hi - k0 < window);
    if (full) {
      online_softmax<true>(s, 0u, scale_log2, m, l, alpha);
    } else {
      uint32_t ok = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + cq + i % 2;
        const int diff = pos[(i / 2) % 2] - key;
        if (!(key < Sk && (!causal || diff >= 0) &&
              (window <= 0 || diff < window)))
          ok &= ~(1u << i);
      }
      online_softmax<false>(s, ok, scale_log2, m, l, alpha);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
  };
  // Rescale the output only where a row's max moved (alpha is exactly 1
  // elsewhere).
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];
    }
  };

  float s[32], alpha[2];
  uint32_t pa[2][4][4];           // P of a tile in bf16, two buffers
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  if constexpr (S::NWG == 1) {
    // The block is one warpgroup, so every tile of [t_begin, t_end) is
    // visible to it, and there is at least one. Step t issues S_t and,
    // behind it, O += P_{t-1} V_{t-1}, then runs tile t's softmax while
    // the tensor cores do the value product. V_t loads one step after
    // K_t; each stage is refilled only after the product that read it.
    // The wgmma operands are fenced before each issue, so that no write
    // to them lands inside a group in flight (ptxas would serialize it).
    tiles_ready();
    fence_regs(s);
    wgmma_fence();
    issue_s(t_begin, s);
    if (t_begin + 1 < t_end) load(sK, kb, t_begin + 1);
    load(sV, vb, t_begin);
    cp_async_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(t_begin, s, pa[0], alpha);
    // Two steps a pass, so that the two P buffers swap roles without a
    // register copy.
    auto step = [&](int t, uint32_t (&p_prev)[4][4], uint32_t (&p_next)[4][4]) {
      tiles_ready();            // K_t, V_{t-1} in; K_{t-1}, V_{t-2} read
      fence_regs(o);
      fence_regs(p_prev);
      fence_regs(s);
      wgmma_fence();
      issue_s(t, s);
      issue_pv(t - 1, p_prev);
      if (t + 1 < t_end) load(sK, kb, t + 1);
      load(sV, vb, t);
      cp_async_commit();
      wgmma_wait<1>();          // S_t done; the value product runs on
      fence_regs(s);
      softmax(t, s, p_next, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_prev);       // unwritten until its product ended
      rescale(alpha);
    };
    int t = t_begin + 1;
    for (; t + 1 < t_end; t += 2) {
      step(t, pa[0], pa[1]);
      step(t + 1, pa[1], pa[0]);
    }
    if (t < t_end) {
      step(t, pa[0], pa[1]);
      tiles_ready();
      fence_regs(o);
      fence_regs(pa[1]);
      wgmma_fence();
      issue_pv(t_end - 1, pa[1]);
    } else {
      tiles_ready();
      fence_regs(o);
      fence_regs(pa[0]);
      wgmma_fence();
      issue_pv(t_end - 1, pa[0]);
    }
    wgmma_wait<0>();
    fence_regs(o);
  } else {
    // Two warpgroups share each tile; a warpgroup skips (warpgroup-
    // uniformly) a tile none of its rows sees. Tile t+1's copies are
    // issued while the S product of tile t runs.
    for (int t = t_begin; t < t_end; ++t) {
      tiles_ready();            // tile t in place; tile t-1 consumed
      const int k0 = t * BK;
      if (w_hi < w_lo || (causal && k0 > w_hi) ||
          (window > 0 && k0 + BK - 1 <= w_lo - window)) {
        if (t + 1 < t_end) {
          load(sK, kb, t + 1);
          load(sV, vb, t + 1);
        }
        cp_async_commit();
        continue;
      }
      fence_regs(s);
      wgmma_fence();
      issue_s(t, s);
      if (t + 1 < t_end) {
        load(sK, kb, t + 1);
        load(sV, vb, t + 1);
      }
      cp_async_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(t, s, pa[0], alpha);
      rescale(alpha);
      fence_regs(o);
      fence_regs(pa[0]);
      wgmma_fence();
      issue_pv(t, pa[0]);
      wgmma_wait<0>();
      fence_regs(o);
    }
  }
  cp_async_wait_all();

  // Finalize: the row sum over its quad, then acc / max(l, 1e-30).
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(FULL, l[j], 1);
    l[j] += __shfl_xor_sync(FULL, l[j], 2);
    const int row = wq0 + r + 8 * j;
    if (row >= Sq) continue;
    if (LSE && lane % 4 == 0)   // m and l are in base 2
      lse[((int64_t)b * H + h) * Sq + row] =
          l[j] > 0.f ? (m[j] + log2f(l[j])) * 0.6931471805599453f
                     : __int_as_float(0x7f800000);
    const float den = fmaxf(l[j], 1e-30f);
    __nv_bfloat16* orow = out + ((int64_t)b * Sq + row) * q_row +
                          (int64_t)h * DH;
#pragma unroll
    for (int c8 = 0; c8 < DP / 8; ++c8) {
      const int col = 8 * c8 + cq;
      if (col < DH)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * c8 + 2 * j] / den, o[4 * c8 + 2 * j + 1] / den);
    }
  }
}

}  // namespace tc

// TC: the bf16 tensor-core kernel; else the fp32 FMA kernel.
// TC: lse is null (inference) or receives the rows' log-sum-exp.
template <bool TC, int DH>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int H,
                         int KV, int causal, int window, float sm_scale,
                         cudaStream_t stream) {
  if constexpr (TC) {
    using C = tc::Cfg<DH>;
    auto kern = lse ? tc::flash_tc_kernel<DH, true>
                    : tc::flash_tc_kernel<DH, false>;
    const size_t smem = C::bytes;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid(H, B, (Sq + C::BQ - 1) / C::BQ);   // query tile slowest
    kern<<<grid, C::NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, KV, causal,
        window, sm_scale * 1.4426950408889634f);  // scores in base 2
  } else {
    auto kern = flash_kernel<float, DH>;
    const size_t smem = Smem<DH>::bytes;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H,
        KV, causal, window, sm_scale);
  }
  return cudaGetLastError();
}

template <bool TC>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, int Sq, int Sk, int H,
                      int KV, int causal, int window, float sm_scale,
                      cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || window < 0)
    return cudaErrorInvalidValue;
#define REPRO_DH_CASE(D)                                                  \
  case D:                                                                 \
    return launch_typed<TC, D>(q, k, v, out, lse, B, Sq, Sk, H, KV,       \
                               causal, window, sm_scale, stream);
  switch (dh) {
    REPRO_DH_CASE(16)
    REPRO_DH_CASE(32)
    REPRO_DH_CASE(64)
    REPRO_DH_CASE(80)
    REPRO_DH_CASE(128)
    REPRO_DH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_DH_CASE
}

}  // namespace

extern "C" {

// q [B,Sq,H,dh], k/v [B,Sk,KV,dh], out [B,Sq,H,dh], all float32 (the FMA
// kernel) or all bfloat16 (the tensor-core kernel). causal: 0/1; window:
// 0 = none, else the number of positions a query sees (itself included).
int repro_flash_attention_f32(int dh, const void* q, const void* k,
                              const void* v, void* out, int B, int Sq, int Sk,
                              int H, int KV, int causal, int window,
                              float sm_scale, void* stream) {
  return (int)launch_dh<false>(dh, q, k, v, out, nullptr, B, Sq, Sk, H, KV,
                               causal, window, sm_scale,
                               static_cast<cudaStream_t>(stream));
}

int repro_flash_attention_bf16(int dh, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int H, int KV, int causal, int window,
                               float sm_scale, void* stream) {
  return (int)launch_dh<true>(dh, q, k, v, out, nullptr, B, Sq, Sk, H, KV,
                              causal, window, sm_scale,
                              static_cast<cudaStream_t>(stream));
}

// The bf16 kernel as above, which also writes lse [B,H,Sq] fp32: each
// row's log-sum-exp of its scaled visible scores (+inf where none).
int repro_flash_attention_bf16_lse(int dh, const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int Sq, int Sk, int H, int KV, int causal,
                                   int window, float sm_scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_dh<true>(dh, q, k, v, out, static_cast<float*>(lse), B,
                              Sq, Sk, H, KV, causal, window, sm_scale,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
