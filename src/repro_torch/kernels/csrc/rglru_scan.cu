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
// (a and x read once, y written once: 94 MB at RecurrentGemma-2B's
// prefill, B=1, S=3072, W=2560 in fp32, 0.028 ms at 3.35 TB/s). The
// dependent chain is not the limit: a rounded multiply and a rounded add
// per step is ~8 clocks, ~13 us for 3072 steps. What stands in the way
// is that at batch 1 there are only W chains, one warp's worth per SM at
// most: a thread that loads its own next steps keeps a few hundred KB in
// flight across the card, where Little's law at ~1 us of load latency
// asks for ~3 MB, and a lone warp that also computes addresses, issues
// its loads and stores y waits out the latency of every instruction.
//
// Design. A block owns CH = 32 channels and has three warps. Warp 0 runs
// the 32 chains and does nothing else: per step it reads a and x from
// shared memory (a stage's 32 steps at once, into registers), multiplies,
// adds and writes y back over a. Warps 1-2 feed it through a ring of
// STAGES slots (an a and an x tile of [32 steps][32 channels]; 12 stages
// in fp32, 24 in bf16, 96 KB): each producer thread owns fixed 16-byte
// chunks of a stage, issues their cp.asyncs (which arrive on the slot's
// "full" mbarrier when they land), and, once the chain has passed the
// slot's "empty" mbarrier, stores the same chunks of y (coalesced along
// W) before it loads the stage that reuses the slot. With the ring full,
// ~88 KB a block is in flight, ~7 MB over the 80 blocks of W = 2560.
// Two producer warps: at the main shape (fp32) on an H100 SXM one took
// 0.058 ms, two 0.048 and four 0.052 (tune_scan's variants); a chain
// warp that fed itself, or one TMA bulk copy per 128-byte row, was
// slower still. Where W or a pointer is not a multiple of 16 bytes, the
// producers move elements with plain loads and stores instead (same
// arithmetic).
//
// Why S is not split: chunk-local scans plus a carry pass would fill the
// card by parallelism along S, but they change the order of the rounded
// operations. This kernel keeps the plain loop's sequential chain per
// (row, channel) — each step a multiply then an add, each rounded
// (__fmul_rn, __fadd_rn: no fused multiply-add) — so y and h_last agree
// with the plain PyTorch version bit for bit, and fills the card with
// loads in flight instead.
//
// Built by repro_torch/kernels/_build.py with nvcc into a shared library
// with a plain C interface; the entry point launches on the given stream
// and returns cudaGetLastError().

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int CH = 32;                    // channels per block
constexpr int STEPS = 32;                 // steps per ring stage
constexpr int PRODUCERS = 2;              // warps that feed the chains
constexpr int PT = 32 * PRODUCERS;        // producer threads
constexpr int RING_BYTES = 96 * 1024;     // a and x, all stages

template <typename T>
struct Ring {
  static constexpr int TILE = STEPS * CH;                      // elements
  static constexpr int STAGES = RING_BYTES / (2 * TILE * (int)sizeof(T));
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16 bytes
  static constexpr int CPR = CH / VEC;              // 16-byte chunks a row
  static constexpr int ROWS = PT / CPR;             // rows a producer pass
  static constexpr int BARS = RING_BYTES;           // mbarriers from here
  static constexpr int SMEM = BARS + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && PT % CPR == 0 && STEPS % ROWS == 0 &&
                    PT % CH == 0,
                "ring shape");
};

// One producer thread's share of moving a stage (steps s0 .. s0+tc-1 of
// channels c0 .. c0+CH-1). With ``vec`` it owns the 16-byte chunk k of
// rows t0, t0 + ROWS, ... (k and t0 fixed by its index p): ``load``
// issues cp.asyncs of a and x into the stage's tiles, ``store`` copies
// y (left by the chain in the a tile) out; without, it owns channel
// p % CH of rows p / CH, p / CH + PT / CH, ... and moves elements.
template <typename T>
struct Mover {
  using R = Ring<T>;
  int p, k, t0;
  bool col_ok;

  __device__ Mover(int p_, int c0, int W, bool vec) : p(p_) {
    k = vec ? (p % R::CPR) * R::VEC : p % CH;
    t0 = vec ? p / R::CPR : p / CH;
    col_ok = c0 + k < W;
  }

  __device__ __forceinline__ void load(T* ta, const T* __restrict__ a,
                                       const T* __restrict__ x, int64_t g0,
                                       int tc, int W, bool vec) const {
    if (!col_ok) return;
    if (vec) {
#pragma unroll
      for (int t = t0; t < STEPS; t += R::ROWS) {
        if (t >= tc) break;
        const int64_t g = g0 + (int64_t)t * W + k;
        cp_async16(smem_addr(ta + t * CH + k), a + g, 16);
        cp_async16(smem_addr(ta + R::TILE + t * CH + k), x + g, 16);
      }
    } else {
#pragma unroll 4
      for (int t = t0; t < tc; t += PT / CH) {
        const int64_t g = g0 + (int64_t)t * W + k;
        ta[t * CH + k] = a[g];
        ta[R::TILE + t * CH + k] = x[g];
      }
    }
  }

  __device__ __forceinline__ void store(const T* ty, T* __restrict__ y,
                                        int64_t g0, int tc, int W,
                                        bool vec) const {
    if (!col_ok) return;
    if (vec) {
#pragma unroll
      for (int t = t0; t < STEPS; t += R::ROWS) {
        if (t >= tc) break;
        *reinterpret_cast<int4*>(y + g0 + (int64_t)t * W + k) =
            *reinterpret_cast<const int4*>(ty + t * CH + k);
      }
    } else {
#pragma unroll 4
      for (int t = t0; t < tc; t += PT / CH)
        y[g0 + (int64_t)t * W + k] = ty[t * CH + k];
    }
  }
};

// Warp 0 runs the chains (one per channel); warps 1 .. PRODUCERS feed
// them through a ring of STAGES slots, each an a tile and an x tile of
// [STEPS][CH], with an mbarrier "full" (the stage's loads landed) and
// "empty" (the chain is done with the stage and left y in its a tile)
// per slot.
template <typename T>
__global__ void __launch_bounds__(32 + PT)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ x,
                 const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ h_last, int S, int W, bool vec) {
  using R = Ring<T>;
  constexpr int STAGES = R::STAGES, TILE = R::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const uint32_t bars = smem_addr(smem + R::BARS);
  auto full = [&](int slot) { return bars + 8 * slot; };
  auto empty = [&](int slot) { return bars + 8 * (STAGES + slot); };

  const int c0 = blockIdx.x * CH;
  const int64_t row0 = (int64_t)blockIdx.y * S;
  const int nst = (S + STEPS - 1) / STEPS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), PT);
      mbar_init(empty(i), 32);
    }
  }
  __syncthreads();

  if (threadIdx.x >= 32) {                // producers
    const Mover<T> mv(threadIdx.x - 32, c0, W, vec);
#pragma unroll 1
    for (int s = 0; s < nst + STAGES; ++s) {
      const int q = s - STAGES;           // the stage whose slot s reuses
      const int slot = s % STAGES;
      T* ta = ring + slot * 2 * TILE;
      if (q >= 0) {
        // Each thread stores the chunks it will load next: its own reads
        // of the slot come before its own cp.asyncs into it.
        mbar_wait(empty(slot), (q / STAGES) & 1);
        mv.store(ta, y, (row0 + (int64_t)q * STEPS) * W + c0,
                 min(STEPS, S - q * STEPS), W, vec);
      }
      if (s < nst) {
        mv.load(ta, a, x, (row0 + (int64_t)s * STEPS) * W + c0,
                min(STEPS, S - s * STEPS), W, vec);
        if (vec) cp_async_mbar_arrive(full(slot));
        else mbar_arrive(full(slot));
      }
    }
    cp_async_wait_all();
    return;
  }

  // Consumer: one chain per channel, each step a multiply then an add,
  // each rounded; y goes in place of a in the stage's a tile.
  const int lane = threadIdx.x, w = c0 + lane;
  const bool live = w < W;
  float h = live ? h0[(int64_t)blockIdx.y * W + w] : 0.f;
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int slot = s % STAGES;
    T* ta = ring + slot * 2 * TILE + lane;
    const T* tx = ta + TILE;
    mbar_wait(full(slot), (s / STAGES) & 1);
    const int tc = min(STEPS, S - s * STEPS);
    if (tc == STEPS) {                    // a full stage: no guard
      float av[STEPS], xv[STEPS];
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        av[t] = to_f(ta[t * CH]);
        xv[t] = to_f(tx[t * CH]);
      }
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        h = __fadd_rn(__fmul_rn(av[t], h), xv[t]);
        ta[t * CH] = from_f<T>(h);
      }
    } else {                              // the ragged tail
#pragma unroll 1
      for (int t = 0; t < tc; ++t) {
        h = __fadd_rn(__fmul_rn(to_f(ta[t * CH]), h), to_f(tx[t * CH]));
        ta[t * CH] = from_f<T>(h);
      }
    }
    mbar_arrive(empty(slot));
  }
  if (live) h_last[(int64_t)blockIdx.y * W + w] = h;
}

template <typename T>
bool vec_ok(const void* a, const void* x, const void* y, int W) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y);
  return W * sizeof(T) % 16 == 0 && (any & 15) == 0;
}

// The launch of one call, as launch() makes it and
// repro_rglru_scan_config reports it.
struct Launch {
  int grid_x, grid_y, threads, smem_bytes, stages, steps;
};

template <typename T>
Launch launch_of(int B, int W) {
  return {(W + CH - 1) / CH, B, 32 + PT, Ring<T>::SMEM, Ring<T>::STAGES,
          STEPS};
}

template <typename T>
cudaError_t launch(const Launch& c, const void* a, const void* x,
                   const float* h0, void* y, float* h_last, int S, int W,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      c.smem_bytes);
  if (err != cudaSuccess) return err;
  rglru_kernel<T><<<dim3(c.grid_x, c.grid_y), c.threads, c.smem_bytes,
                    stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0,
      static_cast<T*>(y), h_last, S, W, vec_ok<T>(a, x, y, W));
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
    return (int)launch<float>(launch_of<float>(B, W), a, x, h0, y, h_last, S,
                              W, st);
  if (dtype == BF16)
    return (int)launch<__nv_bfloat16>(launch_of<__nv_bfloat16>(B, W), a, x,
                                      h0, y, h_last, S, W, st);
  return (int)cudaErrorInvalidValue;
}

// The launch repro_rglru_scan makes for this dtype and shape: out[0..5] =
// grid x, grid y, threads a block, dynamic shared bytes a block, ring
// stages, steps a stage.
int repro_rglru_scan_config(int dtype, int B, int W, int* out) {
  if (B < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Launch c;
  if (dtype == F32) c = launch_of<float>(B, W);
  else if (dtype == BF16) c = launch_of<__nv_bfloat16>(B, W);
  else return (int)cudaErrorInvalidValue;
  const int v[] = {c.grid_x, c.grid_y, c.threads, c.smem_bytes, c.stages,
                   c.steps};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
