// Backward pass of the bf16 prefill flash attention (flash_attention.cu)
// for Hopper (sm_90a): the gradient of causal / sliding-window /
// bidirectional GQA attention over a whole sequence, for training.
//
// No TPU kernel corresponds: the JAX package's Pallas kernel has no
// backward pass (its training runs XLA's attention). It lets the port's
// learner train through the flash kernel instead of the dense fp32
// logits.
//
// Given q [B,Sq,H,dh], k/v [B,Sk,KV,dh], the forward's out [B,Sq,H,dh],
// each row's log-sum-exp of its scaled visible scores lse [B,H,Sq] (the
// forward's LSE instance writes it) and dout, with key j visible from
// query i as in the forward (queries right-aligned when Sq < Sk):
//   delta_i = sum_d dout_i,d out_i,d
//   P_ij    = exp(scale q_i.k_j - lse_i), exactly 0 where j is not visible
//   dV_j    = sum_i P_ij dout_i
//   dS_ij   = P_ij (dout_i.v_j - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j
//   dK_j    = scale sum_i dS_ij q_i
// with dK and dV summed over the query heads of each KV head's group.
// S, P, dP and dS stay fp32 in registers; P and dS are rounded to bf16
// only as the A operands of their products (the forward rounds P so).
//
// Kernels, one stream, in order (all named flash_tc_kernel*):
//   * flash_tc_kernel_bwd_delta: delta in fp32, a half-warp per row;
//   * flash_tc_kernel_bwd_dkdv: one warpgroup per (KV head and share of
//     its group's query heads, row, 64-key tile). K and V stay in shared
//     memory; the query tiles that see the key tile (from the diagonal
//     for causal attention, up to key + window for a window) of each of
//     its query heads stream through a two-stage ring of Q and dO tiles
//     (cp.async in the 128-byte swizzle), the next one's copies in flight
//     while the current one computes. Keys are the rows of every product,
//     so no operand needs a transpose: S^T = K Q^T and dP^T = V dO^T are
//     m64n64 products from shared memory, P^T and dS^T go from their
//     accumulators to bf16 A operands in registers, and dV += P^T dO,
//     dK += dS^T Q read dO and Q MN-major. dK and dV stay in fp32
//     registers over the whole loop and are written once. Key tiles are
//     scheduled in order, so a causal pass starts its heaviest ones
//     (the first keys, seen by every later query) first;
//   * flash_tc_kernel_bwd_dkdv_sum, only where the wrapper spreads a
//     group's query heads over several blocks (splits > 1: too few key
//     tiles to fill the card, or a heaviest block that would outlast the
//     rest): each block writes its fp32 partial dK and dV to scratch and
//     this pass adds the partials in split order. No float atomics
//     anywhere, so two calls agree bit for bit;
//   * flash_tc_kernel_bwd_dq: one warpgroup per (query head, row, 64-query
//     tile), Q and dO in shared memory, the visible K/V tiles through a
//     two-stage ring as in the forward: S = Q K^T and dP = dO V^T, then
//     dQ += dS K with K read MN-major. Heaviest (latest) tiles first.
// The head dim is zero-padded to whole 64-column slabs as in the forward
// (16 to 64, 80 to 128); dh 256 is not taken (dK and dV of a 64-key
// tile would need 256 fp32 registers a thread).
//
// What bounds it: five products over the visible pairs (seven run,
// the dQ kernel recomputing S and dP), so operations: the tensor cores'
// 989 TFLOP/s in bf16.
//
// Built by repro_torch/kernels/_build.py with the other sources; the C
// entry point launches on the given stream and returns the first CUDA
// error.

#include "common.cuh"
#include "flash_tile.cuh"
#include "wgmma.cuh"

namespace {
namespace bwd {

constexpr int BM = 64;    // queries per tile
constexpr int BN = 64;    // keys per tile
constexpr int NT = 128;   // threads: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int DP = (DH + 63) / 64 * 64;   // padded head dim
  static constexpr int KS = (DH + 15) / 16;        // q.k products' k steps
  static constexpr int NO = DP / 2;                // a [64 x DP] accumulator
  static constexpr uint32_t TILE = 64 * DP * 2;    // bytes of a 64-row tile
  // dK/dV: K, V, a ring of two (Q, dO) stages, their lse and delta.
  static constexpr size_t dkdv_bytes = 6 * TILE + 2 * 2 * BM * 4 + 1024;
  // dQ: Q, dO, a ring of two (K, V) stages.
  static constexpr size_t dq_bytes = 6 * TILE + 1024;
};

// D [64 x 64] = A B^T over the head dim, A and B 64-row tiles read
// K-major (as stored), KS steps of 16 columns; one commit group.
template <int KS>
__device__ __forceinline__ void mma_qk(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss_m64n64k16(
        d, sw128_desc(a + (kk / 4) * (64 * 128) + (kk % 4) * 32, 16, 1024),
        sw128_desc(b + (kk / 4) * (64 * 128) + (kk % 4) * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
}

// D [64 x DP] += A B: A [64 x 64] bf16 in registers (four 16-column
// slices), B a 64-row tile read MN-major; one commit group.
template <int NO>
__device__ __forceinline__ void mma_rs(float (&d)[NO],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_m64k16(d, a[j], sw128_desc(b + j * 16 * 128, 64 * 128, 1024));
  wgmma_commit();
}

// A [64 x 64] accumulator as the bf16 A operand of a k16 chain: slice j
// is columns 16j..16j+15, entries 8j..8j+7.
__device__ __forceinline__ void pack_a(const float (&s)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
}

__device__ __forceinline__ int floor_div(int x, int d) {
  return x >= 0 ? x / d : -((-x + d - 1) / d);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
    flash_tc_kernel_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ part, int B, int Sq, int Sk,
                             int H, int KV, int causal, int window,
                             float scale_log2, float sm_scale, int splits) {
  using C = Cfg<DH>;
  constexpr int DP = C::DP, NO = C::NO;
  constexpr uint32_t TILE = C::TILE;

  const int hs = H / KV / splits;                 // query heads a block takes
  const int kvh = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = blockIdx.y, kt = blockIdx.z;     // heaviest causal tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // The thread holds rows (keys) r and r + 8 of each accumulator, and in
  // each 8-column block the columns cq and cq + 1.
  const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + TILE;
  const uint32_t sQ = sV + TILE, sO = sQ + 2 * TILE;   // stage s at + s TILE
  const uint32_t sL = sO + 2 * TILE;   // stage s: lse [64], then delta [64]
  const float* lds =
      reinterpret_cast<const float*>(smem + (sL - smem_addr(smem)));

  const int k0 = kt * BN, off = Sk - Sq, nq = (Sq + BM - 1) / BM;
  // The query tiles that see a key of this tile.
  const int qt_lo = causal ? max(0, k0 - off) / BM : 0;
  const int qt_hi = window > 0
      ? min(nq - 1, floor_div(k0 + BN + window - 2 - off, BM))
      : nq - 1;
  const int n_qt = max(0, qt_hi - qt_lo + 1), n_it = hs * n_qt;
  const int h0 = kvh * (H / KV) + split * hs;

  const int64_t q_row = (int64_t)H * DH, kv_row = (int64_t)KV * DH;
  const int64_t kv_off = ((int64_t)b * Sk + k0) * kv_row + (int64_t)kvh * DH;
  // Iteration it: query head h0 + it / n_qt, query tile qt_lo + it % n_qt,
  // in stage it % 2.
  auto load_stage = [&](int it) {
    const int st = it % 2, h = h0 + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BM;
    const int64_t qo = ((int64_t)b * Sq + q0) * q_row + (int64_t)h * DH;
    load_tile<BM, DH, NT>(sQ + st * TILE, q + qo, q_row, Sq - q0, tid);
    load_tile<BM, DH, NT>(sO + st * TILE, dout + qo, q_row, Sq - q0, tid);
    // Rows past Sq read the last row's value; the mask drops them.
    cp_async4(sL + (st * 128 + tid) * 4,
              (tid < 64 ? lse : delta) + ((int64_t)b * H + h) * Sq +
                  min(q0 + tid % 64, Sq - 1));
  };
  load_tile<BN, DH, NT>(sK, k + kv_off, kv_row, Sk - k0, tid);
  load_tile<BN, DH, NT>(sV, v + kv_off, kv_row, Sk - k0, tid);
  if (n_it > 0) load_stage(0);
  cp_async_commit();

  float dK[NO], dV[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dK[i] = dV[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t pa[4][4], da[4][4];

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();    // stage it landed; stage it-1 read by all
    fence_proxy_async();
    __syncthreads();
    const int st = it % 2, q0 = (qt_lo + it % n_qt) * BM;
    const uint32_t sq = sQ + st * TILE, so = sO + st * TILE;
    const float* ls = lds + st * 128;     // lse of the tile's queries
    const float* dl = ls + 64;            // and their delta
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_qk<C::KS>(s, sK, sq);             // S^T: keys x queries
    mma_qk<C::KS>(dp, sV, so);            // dP^T = V dO^T
    if (it + 1 < n_it) load_stage(it + 1);
    cp_async_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // P^T; entry i is key k0 + r + 8 ((i / 2) % 2), query q0 + 8 (i / 4)
    // + cq + i % 2. The mask is applied only on tiles that straddle the
    // diagonal, the window edge or the end of the keys or queries.
    const bool full = q0 + BM <= Sq && k0 + BN <= Sk &&
                      (!causal || q0 + off >= k0 + BN - 1) &&
                      (window <= 0 || q0 + BM - 1 + off - k0 < window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + cq + i % 2;
      float p = ex2(fmaf(s[i], scale_log2, -ls[c] * LOG2E));
      if (!full) {
        const int key = k0 + r + 8 * ((i / 2) % 2), qi = q0 + c;
        const int diff = qi + off - key;
        if (!(key < Sk && qi < Sq && (!causal || diff >= 0) &&
              (window <= 0 || diff < window)))
          p = 0.f;
      }
      s[i] = p;
    }
    pack_a(s, pa);
    fence_regs(dV);
    fence_regs(pa);
    wgmma_fence();
    mma_rs(dV, pa, so);                   // dV += P^T dO
    wgmma_wait<1>();                      // dP^T done; dV runs on
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = s[i] * (dp[i] - dl[8 * (i / 4) + cq + i % 2]);
    pack_a(dp, da);
    fence_regs(dK);
    fence_regs(da);
    wgmma_fence();
    mma_rs(dK, da, sq);                   // dK += dS^T Q
    wgmma_wait<0>();
    fence_regs(dV);
    fence_regs(dK);
    fence_regs(pa);
    fence_regs(da);
  }
  cp_async_wait_all();

  // Entry 4 c8 + 2 j + e of an accumulator: key k0 + r + 8 j, column
  // 8 c8 + cq + e. Unsplit, bf16 into dK / dV; split, this block's fp32
  // share into its slice of the scratch.
  const int64_t n = (int64_t)B * Sk * kv_row;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = k0 + r + 8 * j;
    if (key >= Sk) continue;
    const int64_t o = ((int64_t)b * Sk + key) * kv_row + (int64_t)kvh * DH;
#pragma unroll
    for (int c8 = 0; c8 < DP / 8; ++c8) {
      const int col = 8 * c8 + cq;
      if (col >= DH) continue;
      const float k_lo = dK[4 * c8 + 2 * j] * sm_scale;
      const float k_hi = dK[4 * c8 + 2 * j + 1] * sm_scale;
      const float v_lo = dV[4 * c8 + 2 * j], v_hi = dV[4 * c8 + 2 * j + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(dk + o + col) = pack_bf16(k_lo, k_hi);
        *reinterpret_cast<uint32_t*>(dv + o + col) = pack_bf16(v_lo, v_hi);
      } else {
        float* pk = part + (int64_t)split * 2 * n + o + col;
        *reinterpret_cast<float2*>(pk) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(pk + n) = make_float2(v_lo, v_hi);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
    flash_tc_kernel_bwd_dq(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                           int H, int KV, int causal, int window,
                           float scale_log2, float sm_scale) {
  using C = Cfg<DH>;
  constexpr int DP = C::DP, NO = C::NO;
  constexpr uint32_t TILE = C::TILE;

  const int qt = gridDim.z - 1 - blockIdx.z;   // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);

  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sO = sQ + TILE;
  const uint32_t sK = sO + TILE, sV = sK + 2 * TILE;   // stage s at + s TILE

  const int q0 = qt * BM, off = Sk - Sq;
  const int64_t q_row = (int64_t)H * DH, kv_row = (int64_t)KV * DH;
  const int64_t qo = ((int64_t)b * Sq + q0) * q_row + (int64_t)h * DH;
  const __nv_bfloat16* kb = k + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;
  const __nv_bfloat16* vb = v + (int64_t)b * Sk * kv_row + (int64_t)kvh * DH;

  // Visible key range of the tile's queries, in whole tiles (as the
  // forward's).
  const int w_lo = q0 + off, w_hi = min(q0 + BM, Sq) - 1 + off;
  const int k_begin = window > 0 ? max(0, w_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, w_hi + 1) : Sk;
  const int t_begin = k_begin / BN;
  const int t_end = k_end > k_begin ? (k_end + BN - 1) / BN : t_begin;

  auto load_kv = [&](int t) {
    const int64_t o = (int64_t)t * BN * kv_row;
    load_tile<BN, DH, NT>(sK + (t % 2) * TILE, kb + o, kv_row, Sk - t * BN,
                          tid);
    load_tile<BN, DH, NT>(sV + (t % 2) * TILE, vb + o, kv_row, Sk - t * BN,
                          tid);
  };
  load_tile<BM, DH, NT>(sQ, q + qo, q_row, Sq - q0, tid);
  load_tile<BM, DH, NT>(sO, dout + qo, q_row, Sq - q0, tid);
  if (t_begin < t_end) load_kv(t_begin);
  cp_async_commit();

  // Rows r and r + 8: their positions, lse (base 2) and delta; rows past
  // Sq are computed from zero-filled Q and dO and not stored.
  int pos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r + 8 * j;
    pos[j] = row + off;
    const int64_t i = ((int64_t)b * H + h) * Sq + row;
    lse2[j] = row < Sq ? lse[i] * LOG2E : 0.f;
    dl[j] = row < Sq ? delta[i] : 0.f;
  }

  float dQ[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dQ[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t da[4][4];

  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait_all();    // tile t landed; tile t-1 read by all
    fence_proxy_async();
    __syncthreads();
    const uint32_t sk = sK + (t % 2) * TILE, sv = sV + (t % 2) * TILE;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_qk<C::KS>(s, sQ, sk);             // S = Q K^T
    mma_qk<C::KS>(dp, sO, sv);            // dP = dO V^T
    if (t + 1 < t_end) load_kv(t + 1);
    cp_async_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // Entry i is query row r + 8 ((i / 2) % 2), key k0 + 8 (i / 4) + cq
    // + i % 2; masked only on tiles that straddle an edge.
    const int k0 = t * BN;
    const bool full = k0 + BN <= Sk && (!causal || k0 + BN - 1 <= w_lo) &&
                      (window <= 0 || w_hi - k0 < window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i / 2) % 2;
      float p = ex2(fmaf(s[i], scale_log2, -lse2[j]));
      if (!full) {
        const int key = k0 + 8 * (i / 4) + cq + i % 2;
        const int diff = pos[j] - key;
        if (!(key < Sk && (!causal || diff >= 0) &&
              (window <= 0 || diff < window)))
          p = 0.f;
      }
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i / 2) % 2]);
    pack_a(dp, da);
    fence_regs(dQ);
    fence_regs(da);
    wgmma_fence();
    mma_rs(dQ, da, sk);                   // dQ += dS K
    wgmma_wait<0>();
    fence_regs(dQ);
    fence_regs(da);
  }
  cp_async_wait_all();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r + 8 * j;
    if (row >= Sq) continue;
    __nv_bfloat16* out = dq + ((int64_t)b * Sq + row) * q_row +
                         (int64_t)h * DH;
#pragma unroll
    for (int c8 = 0; c8 < DP / 8; ++c8) {
      const int col = 8 * c8 + cq;
      if (col < DH)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(dQ[4 * c8 + 2 * j] * sm_scale,
                      dQ[4 * c8 + 2 * j + 1] * sm_scale);
    }
  }
}

// delta [B,H,Sq] = rowsum(dout * out) in fp32: 16 rows of a block, a
// half-warp each, 8 elements a lane per 16-byte load.
__global__ void __launch_bounds__(256)
    flash_tc_kernel_bwd_delta(const __nv_bfloat16* __restrict__ out,
                              const __nv_bfloat16* __restrict__ dout,
                              float* __restrict__ delta, int rows, int Sq,
                              int H, int dh) {
  const int row = blockIdx.x * 16 + threadIdx.x / 16, l = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows) {
    const __nv_bfloat16* o = out + (int64_t)row * dh;
    const __nv_bfloat16* g = dout + (int64_t)row * dh;
    for (int d = l * 8; d < dh; d += 128) {
      float fo[8], fg[8];
      unpack(*reinterpret_cast<const int4*>(o + d), fo, __nv_bfloat16());
      unpack(*reinterpret_cast<const int4*>(g + d), fg, __nv_bfloat16());
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(fo[e], fg[e], acc);
    }
  }
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) acc += __shfl_xor_sync(FULL, acc, w);
  if (row < rows && l == 0) {                 // row = (b Sq + i) H + h
    const int h = row % H, i = (row / H) % Sq, b = row / H / Sq;
    delta[((int64_t)b * H + h) * Sq + i] = acc;
  }
}

// dK and dV from the splits' fp32 shares [splits][2][n], added in split
// order, as bf16; four elements a thread (n is a multiple of 8).
__global__ void __launch_bounds__(256)
    flash_tc_kernel_bwd_dkdv_sum(const float* __restrict__ part, int splits,
                                 int64_t n, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv) {
  const int64_t i = ((int64_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * 2 * n + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat16* dst = i < n ? dk + i : dv + (i - n);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

template <int DH>
cudaError_t launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* out,
                       const __nv_bfloat16* dout, const float* lse,
                       float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
                       __nv_bfloat16* dv, float* part, int B, int Sq, int Sk,
                       int H, int KV, int causal, int window, float sm_scale,
                       int splits, cudaStream_t stream) {
  using C = Cfg<DH>;
  const float scale_log2 = sm_scale * LOG2E;
  const int rows = B * Sq * H;
  flash_tc_kernel_bwd_delta<<<(rows + 15) / 16, 256, 0, stream>>>(
      out, dout, delta, rows, Sq, H, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  auto kv = flash_tc_kernel_bwd_dkdv<DH>;
  e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::dkdv_bytes);
  if (e != cudaSuccess) return e;
  dim3 g_kv(KV * splits, B, (Sk + BN - 1) / BN);
  kv<<<g_kv, NT, C::dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, B, Sq, Sk, H, KV, causal,
      window, scale_log2, sm_scale, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (splits > 1) {
    const int64_t n = (int64_t)B * Sk * KV * DH;
    flash_tc_kernel_bwd_dkdv_sum<<<(unsigned)((2 * n / 4 + 255) / 256), 256,
                                   0, stream>>>(part, splits, n, dk, dv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }

  auto kq = flash_tc_kernel_bwd_dq<DH>;
  e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::dq_bytes);
  if (e != cudaSuccess) return e;
  dim3 g_q(H, B, (Sq + BM - 1) / BM);
  kq<<<g_q, NT, C::dq_bytes, stream>>>(q, k, v, dout, lse, delta, dq, Sq,
                                       Sk, H, KV, causal, window, scale_log2,
                                       sm_scale);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace

extern "C" {

// All bf16 but lse / delta / part (fp32): q, out, dout, dq [B,Sq,H,dh];
// k, v, dk, dv [B,Sk,KV,dh]; lse [B,H,Sq] from the forward's LSE entry;
// delta [B,H,Sq] scratch; part [splits,2,B,Sk,KV,dh] scratch when splits
// > 1 (null otherwise). splits must divide the group H / KV. causal,
// window and sm_scale as the forward took them.
int repro_flash_attention_bwd_bf16(int dh, const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* part, int B, int Sq, int Sk, int H,
                                   int KV, int causal, int window,
                                   float sm_scale, int splits, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || window < 0 ||
      splits < 1 || (H / KV) % splits != 0 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  using T = __nv_bfloat16;
#define REPRO_BWD_CASE(D)                                                   \
  case D:                                                                   \
    return (int)bwd::launch_bwd<D>(                                         \
        static_cast<const T*>(q), static_cast<const T*>(k),                 \
        static_cast<const T*>(v), static_cast<const T*>(out),               \
        static_cast<const T*>(dout), static_cast<const float*>(lse),        \
        static_cast<float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk), \
        static_cast<T*>(dv), static_cast<float*>(part), B, Sq, Sk, H, KV,   \
        causal, window, sm_scale, splits, static_cast<cudaStream_t>(stream));
  switch (dh) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // extern "C"
