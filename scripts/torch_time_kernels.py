"""Time the port's CUDA kernels at the shapes of PERF.md's kernel table
(§6): for each of K1-K5, K3's backward (K3b) and the dropless expert
layer's pair kernels (P1-P3 and their backward passes), at each shape,
the kernel, its plain version (``kernels/ref.py``), a PyTorch library
call where one computes the same thing, and the least time the work
could take on an H100 (the bound: bytes over HBM bandwidth against
operations over the peak rate for the inputs' type).

    python3 scripts/torch_time_kernels.py

Run from a checkout on a machine with a CUDA card and the CUDA toolkit
(the kernels build from ``src/repro_torch/kernels/csrc`` at first use).
Prints JSON lines: the card (name and power limit from nvidia-smi, its
SMs and memory beside ``roofline.hw.HBM_BYTES``, torch and CUDA
versions); ptxas' registers and spills of every kernel instance and
every ptxas note that names wgmma (a "serialized" note means the
tensor-core pipeline was broken); then one line per row and shape, the
first shape of each row first. Every time is ``time_ms``'s, which
``torch_tune_decode.py`` and ``torch_tune_scan.py`` use too.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

L2_FLUSH_BYTES = 64 << 20     # > the 50 MB L2: each timed launch starts cold
PEAK_FLOPS_FP32 = 67e12       # H100 SXM datasheet, outside the tensor cores
# Exponentials: one MUFU.EX2 each, 16 results a clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); the rate is this times the SMs and the card's max SM clock.
MUFU_PER_CLOCK_PER_SM = 16

# The rows' shapes, each row's first shape first. K1: B, query / KV
# heads, dh, cache slots, each row's valid slots, q's dtype (the cache is
# bf16).
_BF16, _FP32 = torch.bfloat16, torch.float32
K1_SHAPES = {
    "qwen2-1.5b B=8": (8, 12, 2, 128, 2048, [2048] * 8, _BF16),
    "recurrentgemma-2b B=1": (1, 10, 1, 256, 2048, [2048], _BF16),
    "recurrentgemma-2b B=8": (8, 10, 1, 256, 2048, [
        2048, 1500, 77, 2048, 2000, 1024, 300, 2048], _BF16),
    "llama-3.2-vision-11b cross B=8 L=1601 bf16 q":
        (8, 32, 8, 128, 1601, [1601] * 8, _BF16),
    "llama-3.2-vision-11b cross B=8 L=1601 fp32 q":
        (8, 32, 8, 128, 1601, [1601] * 8, _FP32),
    "mixtral-8x7b SWA B=3 L=160": (3, 32, 8, 128, 160, [160, 145, 129],
                                   _BF16),
    "llama-3.2-vision-11b self B=2 L=160":
        (2, 32, 8, 128, 160, [137, 137], _BF16),
}
# K2 at Qwen2-1.5B's decode: B, heads, KV heads, dh, pages a row, page size.
K2_SHAPE = (8, 12, 2, 128, 128, 16)
# K3: B, Sq, Sk, heads, KV heads, dh, causal, window, dtype.
K3_SHAPES = {
    "recurrentgemma-2b LOCAL S=3072 bf16":
        (1, 3072, 3072, 10, 1, 256, True, 2048, _BF16),
    "qwen2-1.5b S=1536 bf16": (1, 1536, 1536, 12, 2, 128, True, None, _BF16),
    "hubert-xlarge S=1500 dh 80 bf16":
        (1, 1500, 1500, 16, 16, 80, False, None, _BF16),
    "llama-3.2-vision-11b cross 128 x 1601 bf16":
        (1, 128, 1601, 32, 8, 128, False, None, _BF16),
    "mixtral-8x7b S=128 bf16": (1, 128, 128, 32, 8, 128, True, 4096, _BF16),
    "llama-3.2-vision-11b self B=2 S=128 bf16":
        (2, 128, 128, 32, 8, 128, True, None, _BF16),
    "train evaluator B=8 S=64 dh 64 bf16":
        (8, 64, 64, 12, 4, 64, True, None, _BF16),
    "hubert-xlarge S=1500 dh 80 fp32":
        (1, 1500, 1500, 16, 16, 80, False, None, _FP32),
    "llama-3.2-vision-11b cross 128 x 1601 fp32":
        (1, 128, 1601, 32, 8, 128, False, None, _FP32),
    "mesh group evaluator B=8 S=1024 dh 128 fp32":
        (8, 1024, 1024, 12, 2, 128, True, None, _FP32),
}
# K3b at the training cells' attention (bf16, causal): B, S, heads, KV
# heads, dh, window.
K3B_SHAPES = {
    "mellum2-12b-a2.5b full S=8192": (1, 8192, 32, 4, 128, None),
    "mellum2-12b-a2.5b sliding w=1024": (1, 8192, 32, 4, 128, 1024),
    "qwen2-1.5b B=4 S=1024": (4, 1024, 12, 2, 128, None),
}
K4_SHAPE = (1, 3072, 2560)            # B, S, W
K5_SHAPE = (1, 2048, 8192, 16)        # B, S, Di, N
# The pair kernels at Mellum2's share, one microbatch of one layer: N
# tokens of K choices over E experts, the first H held (uniform routing:
# ~N*K*H/E = N held rows), model width D, expert width F; bf16.
PAIR_SHAPE = (8192, 8, 64, 8, 2304, 896)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time in ms of ``fn`` from CUDA events, after
    ``warmup`` calls, each timed launch after an L2 flush. A sleep kernel
    keeps the device busy while the host queues the launches, so host
    overhead stays out of the events."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def ptxas_stats(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in nvcc's
    ``-Xptxas -v`` report, by demangled name, and every line that names
    wgmma (ptxas warns there when it has to serialize the tensor-core
    instructions)."""
    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or "_kernel" not in name:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stats.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            stats.setdefault(name, {})["registers"] = int(m.group(1))
    if stats and shutil.which("c++filt"):
        names = list(stats)
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
        if len(out) == len(names):
            stats = {d: stats[n] for n, d in zip(names, out)}
    return {"kernels": stats,
            "wgmma_notes": [ln.strip() for ln in log.splitlines()
                            if "wgmma" in ln]}


def _bound(nbytes: int, flops: int, dtype) -> dict:
    from repro_torch.roofline import hw
    t_bytes = nbytes / hw.HBM_BW * 1e3
    peak = hw.PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_FP32
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _decode_rows(gen):
    """K1 over a flat bf16 cache whose row b holds lengths[b] valid slots,
    then K2 through a page table with a shared prefix."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    bf16 = torch.bfloat16
    for label, (B, H, KV, dh, L, lengths, q_dtype) in K1_SHAPES.items():
        q = _randn(gen, (B, H, dh), q_dtype)
        k, v = (_randn(gen, (B, L, KV, dh), bf16) for _ in range(2))
        valid = (torch.arange(L, device="cuda")[None, :]
                 < torch.as_tensor(lengths, device="cuda")[:, None])
        slots = int(valid.sum())
        nbytes = (slots * KV * dh * 2 * 2 + valid.numel()
                  + 2 * q.numel() * q.element_size())
        library = None
        if q_dtype == bf16:
            q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
            mask = valid[:, None, None, :]
            library = time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True))
        yield "K1", label, {
            "ms": time_ms(lambda: dec.decode_attention(q, k, v, valid)),
            "plain_ms": time_ms(lambda: ref.decode_attention(q, k, v,
                                                             valid)),
            "library_ms": library,
            "library_call": "F.scaled_dot_product_attention(enable_gqa)"
            if library is not None else
            "none: SDPA takes q, k and v in one dtype",
            **_bound(nbytes, 4 * H * dh * slots, q_dtype)}

    B, H, KV, dh, n, ps = K2_SHAPE
    P = B * n + 1
    q = _randn(gen, (B, H, dh), bf16)
    kp, vp = (_randn(gen, (P, ps, KV, dh), bf16) for _ in range(2))
    pages = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    pages = pages[:B * n].reshape(B, n).contiguous()
    pages[1, :n // 4] = pages[0, :n // 4]
    pages[:, -1] = 0
    valid = torch.ones((B, n * ps), dtype=torch.bool, device="cuda")
    # Each distinct (page, offset) the valid slots reach is read once.
    slots = torch.arange(n * ps, device="cuda")
    phys = pages.long()[:, slots // ps] * ps + slots % ps
    distinct = int(torch.unique(phys[valid]).numel())
    nbytes = (distinct * KV * dh * 2 * 2 + pages.numel() * 4 + valid.numel()
              + 2 * q.numel() * 2)
    kg = kp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    vg = vp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    q4, mask = q[:, :, None, :], valid[:, None, None, :]
    yield "K2", f"qwen2-1.5b B={B} ps={ps}", {
        "ms": time_ms(lambda: dec.paged_decode_attention(q, kp, vp, pages,
                                                         valid)),
        "plain_ms": time_ms(lambda: ref.paged_decode_attention(
            q, kp, vp, pages, valid)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True)),
        "library_call": "F.scaled_dot_product_attention(enable_gqa) over "
                        "the pre-gathered pages (gather not timed)",
        **_bound(nbytes, 4 * B * H * n * ps * dh, bf16)}


def _prefill_rows(gen):
    """K3: causal and windowed prefill shapes, then non-causal ones."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for label, (B, Sq, Sk, H, KV, dh, causal, window,
                dtype) in K3_SHAPES.items():
        q = _randn(gen, (B, Sq, H, dh), dtype)
        k, v = (_randn(gen, (B, Sk, KV, dh), dtype) for _ in range(2))
        pairs = fa.visible_pairs(Sq, Sk, causal, window)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if not causal:
            kw, call = {}, "no mask"
        elif window is None or window >= Sk:       # the band is causal
            kw, call = {"is_causal": True}, "is_causal"
        else:
            kw = {"attn_mask": ref.visible(Sq, Sk, True, window, q.device)}
            call = "attn_mask=window band"
        yield "K3", label, {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal,
                                                     window)),
            "plain_ms": time_ms(lambda: ref.flash_attention(
                q, k, v, causal, window), iters=10),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **kw)),
            "library_call": f"F.scaled_dot_product_attention({call}, "
                            "enable_gqa)",
            **_bound(nbytes, 4 * B * H * pairs * dh, dtype)}


def by_kv_group(fn, q, k, v, *rest, lse=None):
    """``fn`` (a plain version over q/k/v and, for the backward, out,
    lse and dout) one KV head's group at a time, its outputs joined on
    the head axis: Mellum2's [32, 8192, 8192] fp32 logits, and the
    backward's five tensors of that size, would not fit at once."""
    KV = k.shape[2]
    G = q.shape[2] // KV
    parts = []
    for g in range(KV):
        hq = slice(g * G, (g + 1) * G)
        extra = [t[:, :, hq].contiguous() for t in rest]
        if lse is not None:
            extra.insert(1, lse[:, hq].contiguous())
        parts.append(fn(q[:, :, hq].contiguous(),
                        k[:, :, g:g + 1].contiguous(),
                        v[:, :, g:g + 1].contiguous(), *extra))
    return [torch.cat(xs, dim=1 if x.dim() == 3 else 2)
            for xs, x in zip(zip(*parts), parts[0])]


def _backward_rows(gen):
    """K3b at the two training cells' attention shapes (bf16, causal),
    beside K3's forward with its log-sum-exp and without, the plain
    backward and SDPA's backward. Bound: five products over the visible
    pairs at the bf16 peak."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.roofline import hw
    bf16 = torch.bfloat16
    ops = torch.ops.repro_torch
    for label, (B, S, H, KV, dh, window) in K3B_SHAPES.items():
        q, g = (_randn(gen, (B, S, H, dh), bf16) for _ in range(2))
        k, v = (_randn(gen, (B, S, KV, dh), bf16) for _ in range(2))
        out, lse = ops.flash_attention_fwd(q, k, v, True, window, None)
        pairs = fa.visible_pairs(S, S, True, window)
        qt, gt = q.transpose(1, 2), g.transpose(1, 2)
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  for t in (k, v))
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        if window is None:
            backend, kw = SDPBackend.FLASH_ATTENTION, {"is_causal": True}
            call = "flash backend (is_causal)"
        else:
            backend = SDPBackend.EFFICIENT_ATTENTION
            kw = {"attn_mask": ref.visible(S, S, True, window, q.device)}
            call = "memory-efficient backend (band mask)"
        with sdpa_kernel(backend):
            lib_out = F.scaled_dot_product_attention(*leaves, **kw)
            library = time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, gt, retain_graph=True), iters=20)
        del lib_out, leaves
        yield "K3b", label, {
            "ms": time_ms(lambda: ops.flash_attention_bwd(
                g, q, k, v, out, lse, True, window, None)),
            "splits": fa.bwd_splits(B, S, S, H, KV, True, window,
                                    fa._sm_count(q.device)),
            "forward_lse_ms": time_ms(lambda: ops.flash_attention_fwd(
                q, k, v, True, window, None)),
            "forward_inference_ms": time_ms(lambda: fa.flash_attention(
                q, k, v, True, window)),
            "plain_ms": time_ms(lambda: by_kv_group(
                lambda *a: ref.flash_attention_bwd(*a, True, window),
                q, k, v, out, g, lse=lse), iters=3, warmup=1),
            "plain_call": "ref.flash_attention_bwd one KV group at a time",
            "library_ms": library,
            "library_call": f"SDPA {call}, K/V repeated to the query "
                            "heads: backward only",
            "bound_ms": 10 * B * H * pairs * dh / hw.PEAK_FLOPS_BF16 * 1e3,
            "bound_by": "operations",
            "forward_bound_ms":
                4 * B * H * pairs * dh / hw.PEAK_FLOPS_BF16 * 1e3}
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()


def _scan_rows(gen):
    """K4 at RecurrentGemma-2B's prefill (fp32 a/x, as the gates hand
    them over), then K5 at Falcon-Mamba-7B's (bf16 u as served, fp32 u
    as in an fp32 run)."""
    from repro_torch.kernels import ref, scan_inputs
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.roofline import hw
    B, S, W = K4_SHAPE
    args = scan_inputs.rglru(gen, B, S, W, torch.float32, "cuda")
    nbytes = (3 * B * S * W + 2 * B * W) * 4      # a, x, y; h0, h_last
    yield "K4", f"recurrentgemma-2b S={S} W={W} fp32 a/x", {
        "ms": time_ms(lambda: rg.rglru_scan(*args)),
        "plain_ms": time_ms(lambda: ref.rglru_scan(*args), iters=5,
                            warmup=1),
        "library_ms": None,
        "library_call": "none: no PyTorch call computes a linear recurrence",
        **_bound(nbytes, 2 * B * S * W, torch.float32)}

    clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, S, Di, N = K5_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        args = scan_inputs.ssm(gen, B, S, Di, N, dtype, "cuda")
        u, delta, A, Bc, Cc, D, h0 = args
        elems = B * S * Di * N
        # u and y in u's dtype; Δ, B, C, A, D, h0 and h_last in fp32.
        nbytes = (2 * u.numel() * u.element_size()
                  + (delta.numel() + Bc.numel() + Cc.numel() + A.numel()
                     + D.numel() + 2 * h0.numel()) * 4)
        # One exp per (row, step, channel, state) at the MUFU rate, and
        # six fp32 operations (Δ*A, Δ*u*B, the step's multiply and add,
        # h*C and the sum over N) at the fp32 peak.
        terms = {"bytes": nbytes / hw.HBM_BW * 1e3,
                 "exp": elems / (MUFU_PER_CLOCK_PER_SM * sms * clock) * 1e3,
                 "fp32_ops": 6 * elems / PEAK_FLOPS_FP32 * 1e3}
        bound = max(terms.values())
        yield "K5", f"falcon-mamba-7b S={S} Di={Di} N={N} " \
            f"{str(dtype).split('.')[1]} u", {
                "ms": time_ms(lambda: ss.ssm_scan(*args)),
                "plain_ms": time_ms(lambda: ref.ssm_scan(*args), iters=5,
                                    warmup=1),
                "library_ms": None,
                "library_call": "none: no PyTorch call computes a "
                                "selective scan",
                "bound_ms": bound,
                "bound_by": "bytes" if bound == terms["bytes"]
                else "operations",
                "bound_terms_ms": terms, "sm_clock_mhz": clock / 1e6}


def _pair_rows(gen):
    """The pair kernels (bf16) against their plain versions, which work
    on all N*K pairs as the layer did before them. Bound: the bytes of
    the held rows (and of each token's row, index and gate where the
    kernel reads or writes them) at the HBM bandwidth."""
    from repro_torch.kernels import moe_pairs as mp
    from repro_torch.kernels import ref
    from repro_torch.models import moe
    N, K, E, H, D, F = PAIR_SHAPE
    bf16, es = torch.bfloat16, 2
    idx = torch.rand((N, E), generator=gen, device="cuda").argsort(-1)
    order, pos, ends = moe.sort_pairs(idx[:, :K], 0, H)
    tok = torch.div(order, K, rounding_mode="floor")
    n = int(ends[-1])
    x, dy = (_randn(gen, (N, D), bf16) for _ in range(2))
    ye, g = (_randn(gen, (N * K, D), bf16) for _ in range(2))
    ab = _randn(gen, (N * K, 2 * F), bf16)
    dh = _randn(gen, (N * K, F), bf16)
    gate = torch.rand((N, K), generator=gen, device="cuda").to(bf16)
    index = N * K * 8                 # pos (int64), read by a token's warp
    rows = {
        "P1": ("gather", lambda: mp._gather(x, tok, pos, ends),
               lambda: ref.moe_gather(x, tok, ends),
               2 * n * D * es + n * 8),
        "P1b": ("gather backward (unit-gate combine)",
                lambda: mp._combine(g, None, pos, ends),
                lambda: ref.moe_combine(g, None, pos, ends),
                n * D * es + N * D * es + index),
        "P2": ("SwiGLU", lambda: mp._swiglu(ab, ends),
               lambda: ref.moe_swiglu(ab, ends), 3 * n * F * es),
        "P2b": ("SwiGLU backward", lambda: mp._swiglu_bwd(dh, ab, ends),
                lambda: ref.moe_swiglu_bwd(dh, ab, ends), 5 * n * F * es),
        "P3": ("combine", lambda: mp._combine(ye, gate, pos, ends),
               lambda: ref.moe_combine(ye, gate, pos, ends),
               n * D * es + N * D * es + index + N * K * es),
        "P3b": ("combine backward",
                lambda: mp._combine_bwd(dy, ye, gate, pos, ends),
                lambda: ref.moe_combine_bwd(dy, ye, gate, pos, ends),
                N * D * es + 2 * n * D * es + index + 2 * N * K * es),
    }
    for row, (what, kernel, plain, nbytes) in rows.items():
        yield row, f"mellum2-12b-a2.5b {what}: N={N} K={K} D={D} F={F}, " \
            f"{n} held rows", {
                "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                "plain_call": "ref.py over all N*K pairs (the layer's "
                              "former tensor code)",
                "library_ms": None,
                "library_call": "none: no PyTorch call gathers, activates "
                                "or combines by a count on the device",
                "held_rows": n, **_bound(nbytes, 0, bf16)}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_time_kernels.py: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.roofline import hw
    # A float32 plain version means float32: no TF32 in its matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)

    def emit(obj):
        print(json.dumps({**obj, "device": smi}), flush=True)

    emit({"card": torch.cuda.get_device_name(0), "sms":
          props.multi_processor_count, "total_memory": props.total_memory,
          "hw_HBM_BYTES": hw.HBM_BYTES, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    _build.load()
    log = (_build.library_path().parent / "nvcc.log").read_text()
    emit({"ptxas": ptxas_stats(log)})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in (_decode_rows, _prefill_rows, _backward_rows, _scan_rows,
                 _pair_rows):
        for row, shape, rec in rows(gen):
            emit({"row": row, "shape": shape, **rec})


if __name__ == "__main__":
    main()
