"""Prove the PyTorch port runs on one NVIDIA GPU: build, check, serve, train,
plan, train on a mesh, run the examples, train on a mesh of processes and
serve a mesh node.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases,
each of which ends the run with a non-zero exit on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: compile every kernel from ``src/repro_torch/kernels/csrc``,
   and report ptxas' registers and spills of every kernel instance;
3. kernels: hold each CUDA kernel (K1 flash-decode, K2 paged
   flash-decode, K3 prefill flash attention, K4 RG-LRU scan, K5 Mamba-1
   selective scan) against its plain PyTorch version on the card at the
   serving path's full-width shapes (phase 7's too: K3 non-causal at
   HuBERT's dh 80 and at the vision cross layers' 128 x 1601, K1 over
   the 1601-slot image memory) and at edge shapes, to a tolerance
   scaled to the output (shown to reject a dropped tile, a scan whose
   state was reset, or one whose output reads the previous state), and
   time kernel, plain version and a library yardstick;
4. parity: full-width Qwen2-1.5B, RecurrentGemma-2B and Falcon-Mamba-7B
   (seeded random weights, fp32 compute) through ``ServeEngine``: greedy
   tokens through the kernels must equal those of the plain PyTorch path
   (Qwen2 flat and paged; RecurrentGemma with a prompt longer than its
   window), and the prefill time per request is timed through both;
   then one bf16 prefill per model at its longest prompt through the
   kernels (median of 3, and the scan kernels' device time in it);
5. serve: ``build_program`` (clients -> batcher -> engine server) on the
   thread launcher, in each config's own bf16: Qwen2 flat and paged,
   RecurrentGemma and Falcon-Mamba flat;
6. fabric: full-width bf16 Qwen2-1.5B through the replicated serve fabric
   (Registry -> Router -> EngineServers): one replica behind the router;
   then two, in a run with the telemetry hub and traced requests, a run
   where replica 0 is killed mid-run, and a paged run that rolls the
   fleet from v0 to v1 of a ``ModelStore`` in the JAX package's layout;
   every request must be served at its length, both replicas must
   retire requests, the kill must fire and the rollout must promote;
7. families: full-width Mixtral-8x7B (MoE) with its depth cut to 4
   layers in fp32, where greedy tokens through K1/K3 must equal the plain
   path's through ``ServeEngine``, and to 16 in bf16, served through
   ``build_program`` (and its decode step timed); the Llama-3.2-Vision-11B
   text decoder through ``generate(memory=...)`` over 1601 seeded patch
   embeddings (fp32 parity at 10 layers, bf16 at its full 40); and
   HuBERT-XLarge's full encoder (48 layers, dh 80) through
   ``forward(embeddings=...)`` over 1500 frames, fp32 hidden states
   through K3 against plain, and one timed bf16 forward;
8. train: full-width Qwen2-1.5B cut to 2 layers, one ``make_grad_fn``
   call on the card against the CPU at fp32 (loss, every gradient leaf,
   then ``apply_updates``); all 28 layers with fp32 master weights, bf16
   compute and remat taking six ``make_train_step`` steps of 8 x 1024
   tokens in two microbatches (step time, tokens/s, MFU, memory peak, a
   profiled step); and ``launch.train.build_program`` (LM100M, two
   learners) on the thread launcher, where the chief is killed after its
   first publish and must resume from the published version, and the
   evaluator scores versions through K3 and agrees with its dense loss;
9. plan: the dry run (``launch.dryrun``) at full config and full shape on
   the 16x16 planning mesh of H100s for the three cells the JAX
   package's own test compiles (qwen2-1.5b train_4k, mixtral-8x7b
   decode_32k, falcon-mamba-7b long_500k), and qwen2-1.5b train_4k on the
   2x16x16 mesh: none may fail; then the estimate against the card on the
   1x1 CUDA mesh: phase 8's train step and a bf16 prefill through K3,
   each traced fake and then run for real with DTensor parameters under
   ``use_sharding``. The counted FLOPs must agree within 1%, the peaks
   within a factor of 2, and the sharded train step's loss must equal
   the unsharded step's;
10. mesh: on a 1x1 CUDA mesh (nccl, a group of one), full-width
   Qwen2-1.5B cut to 4 layers: its fp32 {params, opt, ef} state placed
   by the sharding rules (``ckpt.elastic.reshard``), saved, restored
   with ``restore_elastic(new_mesh=)`` onto a (pod, data, model) mesh
   and with ``restore(shardings=)``, every leaf bit-equal (write and
   read GB/s); ``compress_reduce_pod`` the identity with one pod, and
   ``collective_matmul`` at Qwen2's MLP shape equal to ``torch.matmul``
   to the bit; one LM100M learner with and without the mesh, whose
   losses must be equal to the bit (step times beside each other); and
   phase 8's training program with its learners on the mesh, where the
   chief's respawn must restore onto the mesh;
11. examples: every ``repro_torch.examples`` program on the card, each
   in its own process under its own timeout, all started together:
   quickstart, mapreduce, parameter_server (cached), evolution
   strategies (whose fitness must improve), actor_learner, train_lm
   with ``--mesh 1,1``, and serve_lm at full-width bf16 Qwen2-1.5B,
   flat and paged, every request served at its length;
12. mesh group: one learner at Qwen2-1.5B's width cut to 4 layers, at
   fp32, plain and on a mesh whose group ``sharding.group.MeshGroup``
   starts as the training program does for a mesh of processes (world 1
   over nccl on the card: two ranks cannot share it), whose losses must
   equal the plain learner's within 1e-5 (step times, CUDA peaks), its
   version scored by the training program's evaluator through K3; and
   phase 8's training program at the tiny preset's width on a (2, 1)
   mesh of two gloo processes on the host's CPU (the program rank 0, one
   follower it starts), where the chief's respawn must restore onto the
   mesh;
13. mesh node: a ``MeshWorkerNode`` serving ``MeshService`` (defined in
   this file: ``matmul`` through ``sharding.collective_matmul``, ``score``
   the LM loss with params placed by the sharding rules). On the card, at
   Qwen2-1.5B's width cut to 4 layers in bf16 on 8 x 1024 tokens, through
   the node at (1, 1) and through a ``MeshGroup`` of one over nccl: each
   score through K3 within a bf16 ulp of the dense path's loss, each
   matmul of plain ``torch.matmul``'s (call times, CUDA peaks); on the
   host CPU, the node on a (2, 2) mesh of 4 gloo processes (the node's
   process rank 0, three followers it starts, each re-running this file
   as ``__mp_main__``), whose 8 replies must equal the single-process
   service's within fp32 tolerance, and whose program must end with an
   error naming the rank within 60 s of a follower's kill.

Phase 9 also reads ``scripts/torch_kernel_adjusted.py`` on
falcon-mamba-7b train_4k: started with the smoke in a process of its
own (its traces walk the plain scan step by step for minutes of host
CPU), its kernelizable byte fraction must be above 0 and its adjusted
memory term no larger than the one it scales.

Prints JSON lines; the one before the last is the ``{"kernels": ...}``
record, the last ``{"ok": true, "device": {...}}``. Exits non-zero, and
prints no result, without a CUDA device or outside a checkout of the
repository.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM datasheet figures (NVIDIA): HBM3 bandwidth, and the peak rate
# for the inputs' type: dense bf16 on the tensor cores, fp32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Exponentials: one MUFU.EX2 each, 16 results a clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); the rate is this times the SMs and the card's max SM clock.
MUFU_PER_CLOCK_PER_SM = 16
# Kernel against plain version, both accumulating in fp32. The tolerance
# scales with the output: a bf16 output may differ by a rounding step, so
# |err| <= 2 bf16 ulps at the largest |plain| value of its row (one head's
# output vector, see _compare); a float32 output by summation order only.
# On top, ||err|| / ||plain|| must stay below REL_L2_TOL. The kernels
# phase shows that the check rejects a wrong output (a dropped key tile, a
# scan whose state was reset) and reports by how much.
BF16_ULPS = 2
FP32_TOL = 2e-5
REL_L2_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
L2_FLUSH_BYTES = 64 << 20   # > the 50 MB L2: each timed launch starts cold
# Phase 7's shapes: Llama-3.2-Vision's image memory (patch tokens of its
# vision tower), and a 30-second clip at HuBERT's 50 frames a second.
VISION_T = 1601
HUBERT_S = 1500


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------

def phase_environment() -> dict:
    if os.environ.get("REPRO_FORCE_REF"):
        fail("REPRO_FORCE_REF is set; the port has no such switch and the "
             "smoke must run the kernels")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {"phase": "environment", "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    emit(env)
    # A float32 reference means float32: no TF32 in matmuls or convs.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return env


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    out = Path(_build.library_path())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds,
          "library": str(out.relative_to(ROOT))})
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "nvcc_ptxas.log").write_text(_build.build_log)
    emit({"phase": "ptxas", **_ptxas_stats(_build.build_log)})


def _ptxas_stats(log: str) -> dict:
    """Registers and spill bytes of each kernel instance (K1/K2, K3, K4,
    K5), from ``nvcc -Xptxas -v``, and every ptxas line that names wgmma
    (it warns there when it has to serialize the tensor-core
    instructions)."""
    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([\w$]+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or not re.search(r"flash_tc_kernel|flash_kernel|"
                                     r"decode_kernel|rglru_kernel|"
                                     r"ssm_kernel", name):
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


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of ``fn`` from CUDA events, each launch after an
    L2 flush. A sleep kernel keeps the device busy while the host queues
    the launches, so host overhead stays out of the events."""
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


def _device_ms(fn, iters: int = 20, every: bool = False) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, from a
    ``torch.profiler`` trace, by kernel name (empty if the profiler saw no
    device time): the names ending in ``_kernel``, or ``every`` name
    (PyTorch's kernels and copies too). Back-to-back calls, warm L2: a
    breakdown, not a time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        name = ev.key.split("<")[0].split("::")[-1].strip()
        if us > 0 and (every or name.endswith("_kernel")):
            out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def _bound(bytes_moved: int, flops: int, dtype) -> tuple[float, str]:
    """The least time for the work: bytes over HBM bandwidth against
    operations over the peak rate for the inputs' type (``dtype``)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flat_inputs(gen, B, H, KV, dh, L, dtype, kv_dtype=None, lengths=None):
    kv_dtype = kv_dtype or dtype
    dev = "cuda"
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, L, KV, dh), generator=gen, device=dev).to(kv_dtype)
    v = torch.randn((B, L, KV, dh), generator=gen, device=dev).to(kv_dtype)
    if lengths is None:
        valid = torch.rand((B, L), generator=gen, device=dev) < 0.7
        valid[:, 0] = True
    else:
        valid = (torch.arange(L, device=dev)[None, :]
                 < torch.as_tensor(lengths, device=dev)[:, None])
    return q, k, v, valid


def _paged_inputs(gen, B, H, KV, dh, n, ps, dtype):
    """A pool of B*n+1 pages, a shuffled page table with a shared prefix
    (row 1 repeats row 0's first pages) and trash-page (0) entries."""
    dev = "cuda"
    P = B * n + 1
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    pages = perm[:B * n].reshape(B, n).contiguous()
    if B > 1:
        pages[1, : n // 4] = pages[0, : n // 4]
    pages[:, -1] = 0
    valid = torch.ones((B, n * ps), dtype=torch.bool, device=dev)
    return q, kp, vp, pages, valid


def _compare(out, expect) -> dict:
    """Error of ``out`` against the plain ``expect``, beside the output's
    scale, and the tolerances for ``out``'s dtype (see BF16_ULPS). A bf16
    bound is set row by row over the last dim (one head's output vector):
    2 ulps at that row's largest |plain| value, so a row of small values
    is not judged by the largest value elsewhere in the output."""
    e = expect.float()
    d = (out.float() - e).abs()
    if out.dtype == torch.bfloat16:
        row_max = e.abs().amax(dim=-1, keepdim=True)
        tol = BF16_ULPS * torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    else:
        tol = torch.full_like(e, FP32_TOL)
    # A row whose plain values are all 0 has tol 0: its error must be 0.
    ratio = torch.where(d == 0, torch.zeros_like(d), d / tol)
    worst = int(ratio.argmax())
    norm = e.norm().item()
    return {"max_abs_err": d.max().item(),
            "err_over_tol": ratio.flatten()[worst].item(),
            "tol_at_worst": tol.expand_as(e).flatten()[worst].item(),
            "rel_l2_err": d.norm().item() / norm if norm else
            d.norm().item(), "rel_l2_tol": REL_L2_TOL[out.dtype],
            "out_max_abs": e.abs().max().item(),
            "out_rms": e.pow(2).mean().sqrt().item()}


def _within(c: dict) -> bool:
    return c["err_over_tol"] <= 1 and c["rel_l2_err"] <= c["rel_l2_tol"]


def _check(name, out, expect, errors) -> dict:
    c = _compare(out, expect)
    errors.append({"case": name, **c})
    if not _within(c):
        fail(f"kernel {name}: {c}")
    return c


def _drop_tile(valid: torch.Tensor) -> torch.Tensor:
    """``valid`` with the 32 slots from the middle of the cache masked."""
    wrong = valid.clone()
    mid = valid.shape[1] // 2
    wrong[:, mid:mid + 32] = False
    return wrong


def _rejects(name, wrong, expect, errors, what="one tile dropped") -> dict:
    """Show the check fails a wrong output: ``wrong`` is the plain version
    with ``what`` done to it. Returns by how many times each limit is
    passed."""
    c = _compare(wrong, expect)
    errors.append({"case": f"{name}: plain with {what} (must be rejected)",
                   **c})
    if _within(c):
        fail(f"{name}: the tolerance accepts an output with {what}")
    return {"err_over_tol": c["err_over_tol"],
            "rel_l2_over_tol": c["rel_l2_err"] / c["rel_l2_tol"]}


def _decode_case(gen, B, H, KV, dh, L, q_dtype, lengths, errors) -> dict:
    """K1 against its plain version over a bf16 cache whose row ``b``
    holds ``lengths[b]`` valid slots: the check, a dropped tile rejected,
    the bound and the times. ``inputs`` holds (q, k, v, valid)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    q, k, v, valid = _flat_inputs(gen, B, H, KV, dh, L, q_dtype,
                                  kv_dtype=torch.bfloat16, lengths=lengths)
    out = dec.decode_attention(q, k, v, valid)
    expect = ref.decode_attention(q, k, v, valid)
    name = (f"K1 B={B} H={H} KV={KV} dh={dh} L={L} lengths={lengths} "
            f"q {q_dtype} kv bf16")
    c = _check(name, out, expect, errors)
    margin = _rejects(name, ref.decode_attention(q, k, v, _drop_tile(valid)),
                      expect, errors)
    slots = int(valid.sum())
    nbytes = (slots * KV * dh * 2 * k.element_size() + q.numel()
              * q.element_size() + valid.numel() + out.numel()
              * out.element_size())
    flops = 2 * 2 * H * dh * slots                   # q.k and p.v FMAs
    bound_ms, bound_by = _bound(nbytes, flops, q_dtype)
    if q_dtype == k.dtype:
        mask = valid[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True))
        library_call = "F.scaled_dot_product_attention(enable_gqa=True)"
    else:
        library_ms = None
        library_call = "none: SDPA takes q, k and v in one dtype"
    return {**c, "dropped_tile_over_tol": margin,
            "ms": _time_ms(lambda: dec.decode_attention(q, k, v, valid)),
            "device_ms": _device_ms(lambda: dec.decode_attention(q, k, v,
                                                                 valid)),
            "plain_ms": _time_ms(lambda: ref.decode_attention(q, k, v,
                                                              valid)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops,
            "library_ms": library_ms, "library_call": library_call,
            "shape": dict(B=B, H=H, KV=KV, dh=dh, L=L, lengths=lengths,
                          q_dtype=str(q_dtype).split(".")[1],
                          kv_dtype="bfloat16"),
            "inputs": (q, k, v, valid)}


def phase_kernels() -> list[dict]:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    errors: list[dict] = []
    records = []

    # Edge shapes first (correctness only).
    for dh in (16, 64):
        q, k, v, valid = _flat_inputs(gen, 3, 8, 2, dh, 300, torch.bfloat16)
        _check(f"flat dh={dh} L=300", dec.decode_attention(q, k, v, valid),
               ref.decode_attention(q, k, v, valid), errors)
    q, k, v, valid = _flat_inputs(gen, 3, 4, 4, 32, 1000, torch.float32)
    valid[1] = False                                  # all-invalid row
    out = dec.decode_attention(q, k, v, valid)
    _check("flat fp32 L=1000 empty-row", out,
           ref.decode_attention(q, k, v, valid), errors)
    if not bool((out[1] == 0).all()):
        fail("all-invalid row is not exactly zero")
    q, k, v, valid = _flat_inputs(gen, 2, 12, 2, 128, 777, torch.float32,
                                  kv_dtype=torch.bfloat16)
    _check("flat q fp32 / kv bf16 L=777", dec.decode_attention(q, k, v, valid),
           ref.decode_attention(q, k, v, valid), errors)
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, pages, valid = _paged_inputs(gen, 3, 4, 2, 64, 5, 8, dtype)
        valid[2] = False
        valid[0, 3:17] = False
        out = dec.paged_decode_attention(q, kp, vp, pages, valid)
        _check(f"paged {dtype} ps=8 empty-row", out,
               ref.paged_decode_attention(q, kp, vp, pages, valid), errors)
        if not bool((out[2] == 0).all()):
            fail("paged all-invalid row is not exactly zero")

    # The serving path's full-width shapes. Qwen2-1.5B decode: B=8 rows,
    # 12 query / 2 KV heads, dh=128, a full 2048-slot bf16 cache.
    B, H, KV, dh, L, ps = 8, 12, 2, 128, 2048, 16
    main = _decode_case(gen, B, H, KV, dh, L, torch.bfloat16, [L] * B,
                        errors)
    q, k, v, valid = main.pop("inputs")
    # RecurrentGemma-2B decode over its LOCAL ring: 10 query heads over 1
    # KV head, dh 256, L = min(context, window) = 2048, rows at different
    # fill levels; bf16 as served, and fp32 q over the bf16 ring as in the
    # fp32 parity run.
    others = {}
    for rb, q_dtype in ((1, torch.bfloat16), (3, torch.float32),
                        (8, torch.bfloat16)):
        lengths = [L, 1500, 77, L, 2000, 1024, 300, L][:rb]
        case = _decode_case(gen, rb, 10, 1, 256, L, q_dtype, lengths,
                            errors)
        del case["inputs"]
        others[f"recurrentgemma-2b LOCAL decode B={rb} q {q_dtype}"] = case
    # Llama-3.2-Vision's cross layers decode over the image memory: 32
    # query / 8 KV heads, dh 128, 1601 patch slots, every one valid; bf16
    # q as served, fp32 q as in the fp32 parity run.
    for q_dtype in (torch.bfloat16, torch.float32):
        case = _decode_case(gen, 8, 32, 8, 128, VISION_T, q_dtype,
                            [VISION_T] * 8, errors)
        del case["inputs"]
        others[f"llama-3.2-vision-11b cross decode B=8 L={VISION_T} "
               f"q {q_dtype}"] = case
    # Mixtral-8x7B's bf16 serve decodes over its flat SWA rings: 32 query
    # / 8 KV heads, dh 128, L = min(context, window) = 160 slots, rows at
    # different fills; Llama-3.2-Vision's self-attention layers decode
    # over the same 160-slot cache, its B=2 rows at one fill.
    ctx = FAMILY_PLEN + FAMILY_NEW
    for label, lengths in (
            ("mixtral-8x7b SWA decode", [ctx, FAMILY_PLEN + 17,
                                         FAMILY_PLEN + 1]),
            ("llama-3.2-vision-11b self decode", [FAMILY_PLEN + 9] * 2)):
        case = _decode_case(gen, len(lengths), 32, 8, 128, ctx,
                            torch.bfloat16, lengths, errors)
        del case["inputs"]
        others[f"{label} B={len(lengths)} L={ctx} q bf16"] = case
    records.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:86",
        "launches": None, "launches_by_path": None, **main,
        "bound_rate": "3.35 TB/s (H100 SXM datasheet)",
        "other_shapes": others,
    })

    n, item = L // ps, 2
    flops = 2 * 2 * B * H * L * dh                   # q.k and p.v FMAs
    q, kp, vp, pages, valid = _paged_inputs(gen, B, H, KV, dh, n, ps,
                                            torch.bfloat16)
    out = dec.paged_decode_attention(q, kp, vp, pages, valid)
    expect = ref.paged_decode_attention(q, kp, vp, pages, valid)
    name = "K2 main B=8 H=12 KV=2 dh=128 n*ps=2048 ps=16 bf16"
    c = _check(name, out, expect, errors)
    margin = _rejects(name, ref.paged_decode_attention(
        q, kp, vp, pages, _drop_tile(valid)), expect, errors)
    # Bytes this data needs: each distinct (page, offset) the valid slots
    # reach, read once, plus the table, the mask, q and the output.
    slots = torch.arange(n * ps, device="cuda")
    phys = pages.long()[:, slots // ps] * ps + slots % ps
    distinct = int(torch.unique(phys[valid]).numel())
    nbytes = (distinct * KV * dh * 2 * item + pages.numel() * 4
              + valid.numel() + q.numel() * item + out.numel() * item)
    bound_ms, bound_by = _bound(nbytes, flops, torch.bfloat16)
    kg = kp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    vg = vp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    q4, mask = q[:, :, None, :], valid[:, None, None, :]
    records.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:168",
        "launches": None, "launches_by_path": None, **c,
        "dropped_tile_over_tol": margin,
        "ms": _time_ms(lambda: dec.paged_decode_attention(
            q, kp, vp, pages, valid)),
        "device_ms": _device_ms(lambda: dec.paged_decode_attention(
            q, kp, vp, pages, valid)),
        "plain_ms": _time_ms(lambda: ref.paged_decode_attention(
            q, kp, vp, pages, valid)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "bound_rate": "3.35 TB/s (H100 SXM datasheet)",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask, enable_gqa=True)),
        "library_call": ("F.scaled_dot_product_attention(enable_gqa=True) "
                         "over the pre-gathered pages (gather not timed)"),
        "shape": dict(B=B, H=H, KV=KV, dh=dh, n=n, ps=ps, P=B * n + 1,
                      dtype="bfloat16"),
    })
    records.append(_flash_attention_record(gen, errors))
    records.append(_rglru_scan_record(gen, errors))
    records.append(_ssm_scan_record(gen, errors))
    emit({"phase": "kernels", "checks": errors})
    return records


def _flash_case(gen, B, Sq, Sk, H, KV, dh, causal, window, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q = torch.randn((B, Sq, H, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, dh), generator=gen, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    return (q, k, v), out, ref.flash_attention(q, k, v, causal, window)


def _flash_attention_record(gen, errors) -> dict:
    """K3: edge shapes, then the prefill path's full-width causal shapes
    in bf16 — Qwen2-1.5B (12/2 heads, dh 128), RecurrentGemma-2B's LOCAL
    layers (window 2048, 10/1 heads, dh 256), Mixtral-8x7B (window 4096,
    32/8 heads, dh 128, one prompt of FAMILY_PLEN as the engine prefills
    it), Llama-3.2-Vision's self-attention (32/8 heads, B=2 as
    ``generate`` batches it) and phase 8's evaluator (LM100M: 12/4 heads,
    dh 64, one 8 x 64-token batch) — and phase 12's evaluator in fp32
    (Qwen2-1.5B's heads, one GROUP_B x GROUP_S batch), then phase 7's
    non-causal shapes. The record's numbers are RecurrentGemma's; the
    others stand under ``other_shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    edges = [  # B, Sq, Sk, H, KV, dh, causal, window, dtype
        (2, 1000, 1000, 8, 2, 128, True, None, torch.bfloat16),
        (2, 128, 640, 8, 1, 64, True, 300, torch.bfloat16),
        (1, 300, 1000, 4, 2, 256, True, 130, torch.bfloat16),
        (1, 333, 333, 4, 4, 64, False, None, torch.bfloat16),
        (3, 200, 200, 4, 2, 16, True, 50, torch.float32),
        (1, 500, 777, 6, 3, 64, True, None, torch.float32),
        (1, 260, 260, 2, 1, 256, False, None, torch.float32),
        (2, 200, 333, 4, 2, 80, True, 100, torch.bfloat16),
        (1, 130, 130, 4, 4, 80, True, None, torch.float32),
        (1, 37, VISION_T, 4, 2, 80, False, None, torch.bfloat16),
    ]
    for B, Sq, Sk, H, KV, dh, causal, window, dtype in edges:
        _, out, expect = _flash_case(gen, B, Sq, Sk, H, KV, dh, causal,
                                     window, dtype)
        _check(f"K3 B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} "
               f"causal={causal} window={window} {dtype}", out, expect,
               errors)

    shapes = {}
    bf16, fp32 = torch.bfloat16, torch.float32
    for label, (B, S, H, KV, dh, window, dtype) in {
            "qwen2-1.5b prefill": (1, 1536, 12, 2, 128, None, bf16),
            "recurrentgemma-2b LOCAL prefill": (1, 3072, 10, 1, 256, 2048,
                                                bf16),
            "mixtral-8x7b prefill": (1, FAMILY_PLEN, 32, 8, 128, 4096, bf16),
            "llama-3.2-vision-11b self prefill": (2, FAMILY_PLEN, 32, 8, 128,
                                                  None, bf16),
            "lm100m evaluator": (8, 64, 12, 4, 64, None, bf16),
            "qwen2-1.5b mesh group evaluator": (GROUP_B, GROUP_S, 12, 2, 128,
                                                None, fp32),
    }.items():
        (q, k, v), out, expect = _flash_case(gen, B, S, S, H, KV, dh, True,
                                             window, dtype)
        short = {bf16: "bf16", fp32: "fp32"}[dtype]
        name = (f"K3 main {label} B={B} S={S} H={H} KV={KV} dh={dh} "
                f"window={window} {short}")
        c = _check(name, out, expect, errors)
        ok = ref.visible(S, S, True, window, q.device)
        dropped = ok.clone()
        dropped[:, S // 2:S // 2 + 64] = False
        margin = _rejects(name, ref.masked_attention(q, k, v, dropped),
                          expect, errors,
                          f"keys {S // 2}-{min(S, S // 2 + 64) - 1} dropped")
        pairs = int(ok.sum())
        flops = 4 * B * H * pairs * dh                # q.k and p.v FMAs
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
            * q.element_size()
        bound_ms, bound_by = _bound(nbytes, flops, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None or window >= S:          # the band is causal
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_call = "F.scaled_dot_product_attention(is_causal, enable_gqa)"
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=ok, enable_gqa=True)
            lib_call = ("F.scaled_dot_product_attention(attn_mask=window "
                        "band, enable_gqa)")
        shapes[label] = {
            **c, "dropped_tile_over_tol": margin,
            "ms": _time_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, window=window)),
            "device_ms": _device_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, window=window)),
            "plain_ms": _time_ms(lambda: ref.flash_attention(
                q, k, v, True, window), iters=10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops,
            "visible_pairs_per_head": pairs,
            "library_ms": _time_ms(lib), "library_call": lib_call,
            "shape": dict(B=B, S=S, H=H, KV=KV, dh=dh, window=window,
                          causal=True, dtype=str(dtype).split(".")[1])}
    for label, (B, Sq, Sk, H, KV, dh) in {
            "hubert-xlarge encoder": (1, HUBERT_S, HUBERT_S, 16, 16, 80),
            "llama-3.2-vision-11b cross prefill": (1, 128, VISION_T, 32, 8,
                                                   128),
    }.items():
        for dtype in (torch.bfloat16, torch.float32):
            shapes[f"{label} {str(dtype).split('.')[1]}"] = \
                _flash_non_causal_case(gen, label, B, Sq, Sk, H, KV, dh,
                                       dtype, errors)
    main = shapes.pop("recurrentgemma-2b LOCAL prefill")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:121",
            "launches": None, "launches_by_path": None, **main,
            "bound_rate": ("989 TFLOP/s bf16, 67 TFLOP/s fp32, 3.35 TB/s "
                           "(H100 SXM datasheet)"),
            "other_shapes": shapes}


def _flash_non_causal_case(gen, label, B, Sq, Sk, H, KV, dh, dtype,
                           errors) -> dict:
    """K3 with causal=False and no window (every query sees every key;
    the right alignment of Sq < Sk must not matter) at one of phase 7's
    shapes: the check, a dropped 64-key tile rejected, the bound (every
    one of the Sq x Sk pairs) and the times beside SDPA's."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    (q, k, v), out, expect = _flash_case(gen, B, Sq, Sk, H, KV, dh, False,
                                         None, dtype)
    name = (f"K3 {label} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} dh={dh} "
            f"non-causal {dtype}")
    c = _check(name, out, expect, errors)
    dropped = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    dropped[:, Sk // 2:Sk // 2 + 64] = False
    margin = _rejects(name, ref.masked_attention(q, k, v, dropped), expect,
                      errors, "one 64-key tile dropped")
    flops = 4 * B * H * Sq * Sk * dh                  # q.k and p.v FMAs
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
        * q.element_size()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return {**c, "dropped_tile_over_tol": margin,
            "ms": _time_ms(lambda: fa.flash_attention(q, k, v,
                                                      causal=False)),
            "device_ms": _device_ms(lambda: fa.flash_attention(
                q, k, v, causal=False)),
            "plain_ms": _time_ms(lambda: ref.flash_attention(
                q, k, v, False, None), iters=10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops,
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True)),
            "library_call": "F.scaled_dot_product_attention(enable_gqa), "
                            "no mask",
            "shape": dict(B=B, Sq=Sq, Sk=Sk, H=H, KV=KV, dh=dh,
                          causal=False, dtype=str(dtype).split(".")[1])}


def _rglru_scan_record(gen, errors) -> dict:
    """K4 against its plain loop: ragged S and W, bf16 a/x, and the main
    shape (RecurrentGemma-2B prefill: S=3072, W=2560, fp32 a/x as the
    gates hand them over, non-zero h0); y and h_last both checked, and
    both must be bit-identical to the plain loop's."""
    from repro_torch.kernels import ref, scan_inputs
    from repro_torch.kernels import rglru_scan as rg

    bit_identical = {}
    for B, S, W, dtype in [(2, 5, 2560, torch.float32),
                           (3, 1001, 2501, torch.float32),
                           (2, 777, 2560, torch.bfloat16),
                           (1, 3072, 2560, torch.bfloat16)]:
        a, x, h0 = scan_inputs.rglru(gen, B, S, W, dtype, "cuda")
        (y, h), (ye, he) = rg.rglru_scan(a, x, h0), ref.rglru_scan(a, x, h0)
        name = f"K4 B={B} S={S} W={W} {dtype}"
        _check(f"{name} y", y, ye, errors)
        _check(f"{name} h_last", h, he, errors)
        _bit_identical(f"{name} y", y, ye, bit_identical)
        _bit_identical(f"{name} h_last", h, he, bit_identical)

    B, S, W = 1, 3072, 2560
    a, x, h0 = scan_inputs.rglru(gen, B, S, W, torch.float32, "cuda")
    (y, h), (ye, he) = rg.rglru_scan(a, x, h0), ref.rglru_scan(a, x, h0)
    name = f"K4 main B={B} S={S} W={W} fp32"
    c = _check(f"{name} y", y, ye, errors)
    _check(f"{name} h_last", h, he, errors)
    _bit_identical(f"{name} y", y, ye, bit_identical)
    _bit_identical(f"{name} h_last", h, he, bit_identical)
    half = S // 2
    y1, _ = ref.rglru_scan(a[:, :half], x[:, :half], h0)
    y2, _ = ref.rglru_scan(a[:, half:].contiguous(), x[:, half:].contiguous(),
                           torch.zeros_like(h0))
    margin = _rejects(f"{name} y", torch.cat([y1, y2], dim=1), ye, errors,
                      "h reset to 0 at S/2")
    nbytes = (a.numel() + x.numel() + y.numel()) * 4 + (h0.numel()
                                                        + h.numel()) * 4
    bound_ms, bound_by = _bound(nbytes, 2 * a.numel(), torch.float32)
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:63",
            "launches": None, "launches_by_path": None, **c,
            "h_reset_over_tol": margin, "bit_identical": bit_identical,
            "ms": _time_ms(lambda: rg.rglru_scan(a, x, h0)),
            "plain_ms": _time_ms(lambda: ref.rglru_scan(a, x, h0), iters=5,
                                 warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes,
            "bound_rate": "3.35 TB/s (H100 SXM datasheet)",
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes a "
                            "linear recurrence",
            "shape": dict(B=B, S=S, W=W, dtype="float32", h0="randn"),
            "launch": rg.launch_config(torch.float32, B, W)}


def _ssm_y_from_previous_h(u, delta, A, Bc, Cc, D, h0):
    """The plain scan with one fault: y_t reads h_{t-1}, the state before
    step t's update. The plain scan with D = 0 and C taken one step ahead
    gives z_t = h_t . C_{t+1}, so the faulty y_t is z_{t-1} + D u_t (and
    h0 . C_0 + D u_0 at t = 0)."""
    from repro_torch.kernels import ref
    c_next = torch.cat([Cc[:, 1:], Cc[:, :1]], dim=1).contiguous()
    z, _ = ref.ssm_scan(u.float(), delta, A, Bc, c_next, torch.zeros_like(D),
                        h0)
    first = torch.einsum("bdn,bn->bd", h0, Cc[:, 0])[:, None]
    return (torch.cat([first, z[:, :-1]], dim=1) + D * u.float()).to(u.dtype)


def _bit_identical(name, got, want, record) -> None:
    """Record whether ``got`` equals ``want`` bit for bit; fail if not."""
    record[name] = bool(torch.equal(got, want))
    if not record[name]:
        fail(f"{name} is not bit-identical to the plain loop: max |err| "
             f"{(got - want).abs().max().item()}")


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _ssm_scan_record(gen, errors) -> dict:
    """K5 against its plain loop: N 4 and 8, Di not a multiple of the
    block's channel tile, S of 1, 7 and 1001, B=3, all with non-zero h0;
    then the main shape (Falcon-Mamba-7B prefill: B=1, S=2048, Di=8192,
    N=16) with bf16 u as served and fp32 u as in the fp32 parity run; y
    and h_last checked, and both must be bit-identical to the plain
    loop's. Two wrong scans must be rejected: h reset at S/2, and y_t
    read from h_{t-1}."""
    from repro_torch.kernels import ref, scan_inputs
    from repro_torch.kernels import ssm_scan as ss

    bit_identical = {}
    for B, S, Di, N, dtype in [(1, 1, 8192, 16, torch.bfloat16),
                               (1, 7, 8190, 16, torch.float32),
                               (2, 1001, 1000, 8, torch.bfloat16),
                               (3, 1001, 333, 4, torch.float32),
                               (3, 257, 8192, 16, torch.bfloat16)]:
        args = scan_inputs.ssm(gen, B, S, Di, N, dtype, "cuda")
        (y, h), (ye, he) = ss.ssm_scan(*args), ref.ssm_scan(*args)
        name = f"K5 B={B} S={S} Di={Di} N={N} u {dtype}"
        _check(f"{name} y", y, ye, errors)
        _check(f"{name} h_last", h, he, errors)
        _bit_identical(f"{name} y", y, ye, bit_identical)
        _bit_identical(f"{name} h_last", h, he, bit_identical)

    B, S, Di, N = 1, 2048, 8192, 16
    main, fp32_u = None, None
    for dtype in (torch.float32, torch.bfloat16):
        args = scan_inputs.ssm(gen, B, S, Di, N, dtype, "cuda")
        (y, h), (ye, he) = ss.ssm_scan(*args), ref.ssm_scan(*args)
        name = f"K5 main B={B} S={S} Di={Di} N={N} u {dtype}"
        c = _check(f"{name} y", y, ye, errors)
        _check(f"{name} h_last", h, he, errors)
        _bit_identical(f"{name} y", y, ye, bit_identical)
        _bit_identical(f"{name} h_last", h, he, bit_identical)
        u, delta, A, Bc, Cc, D, h0 = args
        half = S // 2
        y1, _ = ref.ssm_scan(u[:, :half], delta[:, :half], A, Bc[:, :half],
                             Cc[:, :half], D, h0)
        y2, _ = ref.ssm_scan(*(t[:, half:].contiguous()
                               for t in (u, delta)), A,
                             *(t[:, half:].contiguous() for t in (Bc, Cc)),
                             D, torch.zeros_like(h0))
        margins = {
            "h_reset_over_tol": _rejects(
                f"{name} y", torch.cat([y1, y2], dim=1), ye, errors,
                "h reset to 0 at S/2"),
            "y_from_previous_h_over_tol": _rejects(
                f"{name} y", _ssm_y_from_previous_h(*args), ye, errors,
                "y_t read from h_{t-1}")}
        # The least time for the work: u, Δ, B, C, A, D and h0 read once,
        # y and h_last written once, against the operations: one exp per
        # (row, step, channel, state) at the MUFU rate, and six fp32
        # operations (Δ*A, Δ*u*B, the step's multiply and add, h*C and the
        # sum over N) at the fp32 peak.
        elems = B * S * Di * N
        nbytes = ((u.numel() + y.numel()) * u.element_size()
                  + (delta.numel() + 2 * Bc.numel() + A.numel() + D.numel()
                     + h0.numel() + h.numel()) * 4)
        clock = _max_sm_clock_hz()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "exp": elems / (MUFU_PER_CLOCK_PER_SM * sms * clock) * 1e3,
                 "fp32_ops": 6 * elems / PEAK_FLOPS_PER_S[torch.float32]
                 * 1e3}
        bound_ms = max(terms.values())
        timed = {
            **c, **margins,
            "ms": _time_ms(lambda: ss.ssm_scan(*args)),
            "plain_ms": _time_ms(lambda: ref.ssm_scan(*args), iters=5,
                                 warmup=1),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_ms == terms["bytes"] else "operations",
            "bound_terms_ms": terms, "bound_bytes": nbytes,
            "bound_exps": elems, "bound_sm_clock_mhz": clock / 1e6,
            "library_ms": None,
            "library_call": "none: no PyTorch call computes a selective scan",
            "shape": dict(B=B, S=S, Di=Di, N=N,
                          u_dtype=str(dtype).split(".")[1], h0="randn"),
            "launch": ss.launch_config(dtype, N, B, Di)}
        if dtype == torch.bfloat16:
            main = timed
            main["device_ms"] = _device_ms(lambda: ss.ssm_scan(*args))
        else:
            fp32_u = timed
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:75",
            "launches": None, "launches_by_path": None, **main,
            "bit_identical": bit_identical,
            "bound_rate": ("3.35 TB/s, 67 TFLOP/s fp32 (H100 SXM datasheet); "
                           f"{MUFU_PER_CLOCK_PER_SM} exp a clock per SM at "
                           "the max SM clock (CUDA guide, cc 9.0)"),
            "other_shapes": {"falcon-mamba-7b prefill, fp32 u": fp32_u}}


# ---------------------------------------------------------------------------
# 4. full-width parity: the kernels against plain PyTorch, through the engine
# ---------------------------------------------------------------------------

PARITY_TIE = 1e-3        # top-2 margin below which a step is a near-tie
KERNEL_NAMES = ("decode_attention", "paged_decode_attention",
                "flash_attention", "rglru_scan", "ssm_scan")


def _counter_modules():
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import rglru_scan, ssm_scan
    return (decode_attention, flash_attention, rglru_scan, ssm_scan)


def _reset_launches() -> None:
    for mod in _counter_modules():
        mod.reset_launches()


def _read_launches() -> dict:
    run = {}
    for mod in _counter_modules():
        run.update(mod.launches)
    return {name: run[name] for name in KERNEL_NAMES}


def _drive(cfg, params, prompts, **kw) -> tuple:
    """Serve ``prompts`` through one ServeEngine on the card. Returns the
    outputs, the kernel launches of exactly this run and its prefix-cache
    hits."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, device="cuda", **kw)
    _reset_launches()
    futs = [eng.submit(p) for p in prompts]
    steps = 0
    while not all(f.done() for f in futs):
        eng.step()
        steps += 1
        if steps > 20000:
            fail("engine made no progress")
    torch.cuda.synchronize()
    run = _read_launches()
    outs = [f.result() for f in futs]
    hits = eng.stats().get("prefix_cache", {}).get("hits", 0)
    eng.stop()
    return outs, run, hits


def _step_logits(cfg, params, seq, impl: str, context_len: int,
                 memory=None):
    """Logits predicting the token after ``seq`` through the prefill of
    ``seq[:-1]`` (over ``memory`` [1,T,D] for a cross-attention stack)
    and one decode step, both on route ``impl``."""
    from repro_torch.models import transformer
    toks = torch.as_tensor(seq, device="cuda")[None]
    _, state = transformer.prefill(cfg, params, tokens=toks[:, :-1],
                                   memory=memory,
                                   context_len=context_len, impl=impl)
    logits, _ = transformer.decode_step(cfg, params, state, toks[:, -1:],
                                        len(seq) - 1, attn_impl=impl)
    return logits[0, 0].float()


def _compare_tokens(cfg, params, prompts, ref, got, max_new, context_len,
                    label, memories=None) -> int:
    """Every token equal, except at a near-tie of the dense path (top-2
    margin < PARITY_TIE), where that step's flash and dense logits must
    agree within PARITY_TIE and the rest of the request (a different
    context from there on) is not compared. ``memories``: each request's
    frontend memory [1,T,D], for a cross-attention stack. Returns the
    near-tie count."""
    ties = 0
    memories = memories or [None] * len(prompts)
    for p, a, b, mem in zip(prompts, ref, got, memories):
        if a.shape != (len(p) + max_new,) or b.shape != a.shape:
            fail(f"{label}: output shape {b.shape} / {a.shape}")
        if not ((b >= 0) & (b < cfg.vocab_size)).all():
            fail(f"{label}: token out of the vocabulary")
        diff = np.nonzero(a != b)[0]
        if diff.size == 0:
            continue
        seq = a[:diff[0]]
        dense = _step_logits(cfg, params, seq, "dense", context_len, mem)
        flash = _step_logits(cfg, params, seq, "flash", context_len, mem)
        top2 = torch.topk(dense, 2).values
        margin = float(top2[0] - top2[1])
        err = float((flash - dense).abs().max())
        if margin >= PARITY_TIE or err > PARITY_TIE:
            fail(f"{label}: token {diff[0] - len(p)} of a request differs "
                 f"(dense top-2 margin {margin}, |flash-dense| {err})")
        ties += 1
    return ties


def _prefill_ms(cfg, params, prompts, context_len: int) -> list[dict]:
    """Prefill time per request, through the kernels ("flash") and plain
    PyTorch ("dense"): host clock around one B=1 prefill ending in a
    synchronize, median of 3 after a warm-up, in turns."""
    from repro_torch.models import transformer
    rows = []
    for p in prompts:
        toks = torch.as_tensor(p, device="cuda")[None]
        times = {"flash": [], "dense": []}
        for rep in range(4):
            for impl in ("flash", "dense") if rep % 2 else ("dense", "flash"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                transformer.prefill(cfg, params, tokens=toks,
                                    context_len=context_len, impl=impl)
                torch.cuda.synchronize()
                if rep:
                    times[impl].append((time.perf_counter() - t0) * 1e3)
        rows.append({"prompt_len": len(p),
                     **{f"{impl}_ms": sorted(ts)[1]
                        for impl, ts in times.items()}})
    return rows


def _parity_qwen2(cfg, params) -> tuple[dict, dict]:
    ctx, max_new = 2048, 16
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (256, 1536, 700)]
    prompts += [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (100, 300, 1000)]
    common = dict(num_slots=4, context_len=ctx, max_new=max_new)
    paged = dict(common, page_size=16, prefill_chunk=256)
    runs, hits = {}, {}
    ref_flat, _, _ = _drive(cfg, params, prompts, decode_impl="dense",
                            **common)
    ref_paged, _, _ = _drive(cfg, params, prompts, decode_impl="dense",
                             **paged)
    outs, runs["flat sync=8"], _ = _drive(cfg, params, prompts,
                                          decode_impl="flash", **common)
    ties = {"flat sync=8": _compare_tokens(
        cfg, params, prompts, ref_flat, outs, max_new, ctx, "flat")}
    for sync in (1, 8):
        label = f"paged ps=16 chunk=256 sync={sync}"
        outs, runs[label], hits[label] = _drive(
            cfg, params, prompts, decode_impl="flash", sync_every=sync,
            **paged)
        if not hits[label]:
            fail(f"{label}: the shared-prefix prompts got no prefix-cache "
                 "hit")
        ties[label] = _compare_tokens(cfg, params, prompts, ref_paged, outs,
                                      max_new, ctx, label)
    if not runs["flat sync=8"]["decode_attention"]:
        fail("qwen2 flat flash run launched no decode_attention kernel")
    if not runs["flat sync=8"]["flash_attention"]:
        fail("qwen2 flat flash run launched no flash_attention kernel")
    if not runs["paged ps=16 chunk=256 sync=1"]["paged_decode_attention"]:
        fail("paged sync=1 run launched no paged_decode_attention kernel")
    info = {"prompt_lens": [len(p) for p in prompts], "max_new": max_new,
            "context_len": ctx, "near_ties": ties, "prefix_hits": hits,
            "prefill_ms_per_request": _prefill_ms(cfg, params, prompts[:3],
                                                  ctx)}
    return info, runs


def _parity_recurrentgemma(cfg, params) -> tuple[dict, dict]:
    ctx, max_new = 4096, 16
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (512, 1536, 3072)]          # 3072 > window 2048
    common = dict(num_slots=3, context_len=ctx, max_new=max_new)
    ref, _, _ = _drive(cfg, params, prompts, decode_impl="dense", **common)
    outs, run, _ = _drive(cfg, params, prompts, decode_impl="flash", **common)
    ties = _compare_tokens(cfg, params, prompts, ref, outs, max_new, ctx,
                           "recurrentgemma")
    for name in ("decode_attention", "flash_attention", "rglru_scan"):
        if not run[name]:
            fail(f"recurrentgemma flash run launched no {name} kernel")
    info = {"prompt_lens": [len(p) for p in prompts], "max_new": max_new,
            "context_len": ctx, "window": cfg.window,
            "near_ties": {"flat sync=8": ties},
            "prefill_ms_per_request": _prefill_ms(cfg, params, prompts, ctx)}
    return info, {"flat sync=8": run}


def _parity_falcon_mamba(cfg, params) -> tuple[dict, dict]:
    ctx, max_new = 4096, 16
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (512, 1000, 2048)]
    common = dict(num_slots=3, context_len=ctx, max_new=max_new)
    ref, _, _ = _drive(cfg, params, prompts, decode_impl="dense", **common)
    outs, run, _ = _drive(cfg, params, prompts, decode_impl="flash", **common)
    ties = _compare_tokens(cfg, params, prompts, ref, outs, max_new, ctx,
                           "falcon-mamba")
    if run["ssm_scan"] != cfg.num_layers * len(prompts):
        fail(f"falcon-mamba flash run launched ssm_scan {run['ssm_scan']} "
             f"times, not {cfg.num_layers} per prefill")
    info = {"prompt_lens": [len(p) for p in prompts], "max_new": max_new,
            "context_len": ctx, "near_ties": {"flat sync=8": ties},
            "prefill_ms_per_request": _prefill_ms(cfg, params, prompts, ctx)}
    return info, {"flat sync=8": run}


# bf16 prefill, as served: one prompt per model, at its parity phase's
# longest length, through the kernels.
BF16_PREFILL = {"recurrentgemma-2b": 3072, "falcon-mamba-7b": 2048}
SCAN_KERNELS = ("rglru_kernel", "ssm_kernel")


def _bf16_prefill(arch: str, n_tokens: int) -> dict:
    """One B=1 prefill of ``n_tokens`` in the config's own bf16 through
    the kernels: host clock around it ending in a synchronize (median of
    3 after a warm-up), and one profiled run's device time, in all and in
    the scan kernels, so that the scans' share of a served prefill is on
    record."""
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get(arch)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_tokens)
                           .astype(np.int32), device="cuda")[None]

    def run():
        transformer.prefill(cfg, params, tokens=toks, context_len=4096,
                            impl="flash")
    run()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev = _device_ms(run, iters=1, every=True)
    scans = {k: dev[k] for k in SCAN_KERNELS if k in dev}
    total = sum(dev.values())
    del params
    torch.cuda.empty_cache()
    return {"prompt_len": n_tokens, "compute_dtype": cfg.compute_dtype,
            "ms": sorted(times)[1], "ms_runs": times,
            "device_ms_total": total, "scan_device_ms": scans,
            "scan_share_of_device": sum(scans.values()) / total if total
            else None,
            "top_device_ms": dict(sorted(dev.items(), key=lambda kv: -kv[1])
                                  [:8])}


def phase_parity(device_line: str) -> dict:
    """Returns each flash run's launches, by path name."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer

    paths = {}
    for arch, drive in (("qwen2-1.5b", _parity_qwen2),
                        ("recurrentgemma-2b", _parity_recurrentgemma),
                        ("falcon-mamba-7b", _parity_falcon_mamba)):
        cfg = dataclasses.replace(configs.get(arch), compute_dtype="float32")
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=0, device="cuda")
        info, runs = drive(cfg, params)
        del params
        torch.cuda.empty_cache()
        if arch in BF16_PREFILL:
            info["bf16_prefill"] = _bf16_prefill(arch, BF16_PREFILL[arch])
        emit({"phase": "parity", "config": f"{arch} full width, fp32 "
              "compute, seeded random weights", **info, "launches": runs,
              "seconds": time.perf_counter() - t0, "device": device_line})
        paths.update({f"parity {arch} {label}": run
                      for label, run in runs.items()})
    return paths


# ---------------------------------------------------------------------------
# 5. serve: the Launchpad program, full width, bf16
# ---------------------------------------------------------------------------

def phase_serve(device_line: str) -> dict:
    """Returns each run's launches, by path name."""
    import tempfile

    from repro_torch import configs, core as lp
    from repro_torch.launch import serve

    runs = {}
    for arch, page_size, per_client, kernels in (
            ("qwen2-1.5b", None, 4, ("decode_attention", "flash_attention")),
            ("qwen2-1.5b", 16, 4, ("decode_attention", "flash_attention")),
            ("recurrentgemma-2b", None, 2,
             ("decode_attention", "flash_attention", "rglru_scan")),
            ("falcon-mamba-7b", None, 2, ("ssm_scan",))):
        cfg = configs.get(arch)
        n_clients, plen, max_new = 3, 128, 32
        with tempfile.TemporaryDirectory() as tmp:
            summary_path = os.path.join(tmp, "meter.json")
            program = serve.build_program(
                cfg, num_clients=n_clients, requests_per_client=per_client,
                prompt_len=plen, max_new=max_new, page_size=page_size,
                meter_json=summary_path)
            _reset_launches()
            t0 = time.perf_counter()
            lp.launch_and_wait(program, timeout_s=600)
            wall = time.perf_counter() - t0
            run = _read_launches()
            with open(summary_path) as f:
                summary = json.load(f)
        label = f"serve {arch} " + (f"paged ps={page_size}" if page_size
                                    else "flat")
        runs[label] = run
        total = n_clients * per_client
        if summary["count"] != total:
            fail(f"{label}: served {summary['count']} of {total} requests")
        if summary["out_lens"] != [plen + max_new] * total:
            fail(f"{label}: wrong output lengths {summary['out_lens']}")
        for name in kernels:
            if not run[name]:
                fail(f"{label} launched no {name} kernel")
        if cfg.ssm_state and run["ssm_scan"] != total * cfg.num_layers:
            fail(f"{label} launched ssm_scan {run['ssm_scan']} times, not "
                 f"{cfg.num_layers} per request")
        emit({"phase": "serve", "config": f"{arch} full width, bf16, seeded "
              "random weights", "paged": page_size,
              "requests": summary["count"], "prompt_len": plen,
              "max_new": max_new, "p50_ms": summary["p50_ms"],
              "p95_ms": summary["p95_ms"], "mean_ms": summary["mean_ms"],
              "wall_s": wall, "generated_tokens_per_s_wall":
              total * max_new / wall, "launches": run,
              "device": device_line})
        del program
        torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------------------
# 6. fabric: Registry -> Router -> EngineServers, full width, bf16
# ---------------------------------------------------------------------------

FABRIC_CLIENTS, FABRIC_REQUESTS, FABRIC_PLEN, FABRIC_NEW = 3, 4, 128, 32


class _Tee(io.TextIOBase):
    """stdout that also keeps a copy, for the lines the fabric's nodes
    print from their own threads. ``print`` writes its text and its
    newline separately, so another thread's line can start right after
    a line's text: search the copy, do not split it into lines."""

    def __init__(self, out):
        self._out, self._buf, self._lock = out, io.StringIO(), threading.Lock()

    def write(self, text):
        with self._lock:
            self._buf.write(text)
        return self._out.write(text)

    def flush(self):
        self._out.flush()

    def text(self) -> str:
        with self._lock:
            return self._buf.getvalue()


def _fabric_run(cfg, label: str, kernels, replicas: int = 2,
                **kw) -> tuple[dict, dict, str]:
    """One fabric program on the card: counters reset just before the
    launch and read just after. Checks every request was served at its
    length and that each of ``kernels`` was launched. Returns the
    meter's summary (with the wall time), the launches and the printed
    text."""
    from repro_torch import core as lp
    from repro_torch.launch import serve
    total = FABRIC_CLIENTS * FABRIC_REQUESTS
    with tempfile.TemporaryDirectory() as tmp:
        summary_path = os.path.join(tmp, "meter.json")
        program = serve.build_program(
            cfg, num_clients=FABRIC_CLIENTS,
            requests_per_client=FABRIC_REQUESTS, prompt_len=FABRIC_PLEN,
            max_new=FABRIC_NEW, replicas=replicas, routers=1,
            meter_json=summary_path, **kw)
        tee = _Tee(sys.stdout)
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            lp.launch_and_wait(program, timeout_s=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run = _read_launches()
        with open(summary_path) as f:
            summary = json.load(f)
    # The replicas can outlive the program in reference cycles: collect
    # them, so the next run's memory reading starts from a clean card.
    del program
    gc.collect()
    torch.cuda.empty_cache()
    summary["wall_s"] = wall
    if summary["count"] != total:
        fail(f"{label}: served {summary['count']} of {total} requests")
    if summary["out_lens"] != [FABRIC_PLEN + FABRIC_NEW] * total:
        fail(f"{label}: wrong output lengths {summary['out_lens']}")
    for name in kernels:
        if not run[name]:
            fail(f"{label} launched no {name} kernel")
    return summary, run, tee.text()


def _emit_fabric(label, summary, run, device_line, replicas: int = 2,
                 **extra) -> None:
    total = FABRIC_CLIENTS * FABRIC_REQUESTS
    emit({"phase": "fabric", "run": label, "config": "qwen2-1.5b full "
          f"width, bf16, seeded random weights; {replicas} replica"
          f"{'s' if replicas > 1 else ''}, 1 router",
          "requests": summary["count"], "prompt_len": FABRIC_PLEN,
          "max_new": FABRIC_NEW, "p50_ms": summary["p50_ms"],
          "p95_ms": summary["p95_ms"], "mean_ms": summary["mean_ms"],
          "wall_s": summary["wall_s"], "generated_tokens_per_s_wall":
          total * FABRIC_NEW / summary["wall_s"], "launches": run,
          **extra, "device": device_line})


def _store_dir(need_bytes: int) -> str:
    """A fresh temp directory for the model store; fail if its disk has
    less than ``need_bytes`` free."""
    free = shutil.disk_usage(tempfile.gettempdir()).free
    if free < need_bytes:
        fail(f"the rollout's model store needs {need_bytes / 1e9:.1f} GB "
             f"of disk; {tempfile.gettempdir()} has {free / 1e9:.1f} GB "
             "free")
    return tempfile.mkdtemp(prefix="modelstore-")


def _rollout_run(cfg, device_line) -> dict:
    """v0 and v1 (seeds 0 and 1) published as fp32 in the JAX layout,
    then a paged fabric run that rolls the fleet to v1 after 4 served
    requests. Fails unless the rollout promotes and both replicas end on
    v1."""
    from repro_torch.launch import serve
    n_params = cfg.param_count()
    version_bytes = 4 * n_params
    store = _store_dir(int(2.2 * version_bytes))
    try:
        publish_s = []
        for v in (0, 1):
            t0 = time.perf_counter()
            serve.publish_demo_versions(cfg, store, versions=(v,),
                                        device="cuda")
            publish_s.append(time.perf_counter() - t0)
        store_bytes = sum(f.stat().st_size for f in Path(store).rglob("*")
                          if f.is_file())
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated()
        summary, run, text = _fabric_run(
            cfg, "fabric rollout", ("paged_decode_attention",
                                    "flash_attention"),
            page_size=16, store_dir=store, model_version=0, rollout=1,
            rollout_after=4)
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    results = [json.JSONDecoder().raw_decode(text, m.end())[0]
               for m in re.finditer(r"rollout: result ", text)]
    if len(results) != 1:
        fail(f"fabric rollout: expected one rollout result, got {results}")
    result = results[0]
    if result["status"] != "promoted" or \
            "rollout: promoted -> v1" not in text:
        fail(f"fabric rollout: not promoted; verdict {result}")
    versions = result["replica_versions"]
    if len(versions) != 2 or set(versions.values()) != {1}:
        fail(f"fabric rollout: replicas' load()['version'] {versions}")
    restores = {}
    for m in re.finditer(r"store: (\S+) restored v(\d) in ([\d.]+)s \(like "
                         r"([\d.]+)s, read ([\d.]+)s, install ([\d.]+)s\)",
                         text):
        restores.setdefault(f"v{m.group(2)}", {})[m.group(1)] = dict(
            zip(("s", "like_s", "read_s", "install_s"),
                map(float, m.groups()[2:])))
    if len(restores.get("v1", {})) != 2:
        fail(f"fabric rollout: expected two v1 restores, got {restores}")
    per_version = store_bytes / 2
    restore_s = [r["s"] for by in restores.values() for r in by.values()]
    _emit_fabric("rollout", summary, run, device_line, paged=16,
                 rollout={k: result.get(k) for k in
                          ("status", "duration_s", "canary", "replicas",
                           "replica_versions")},
                 store={"bytes": store_bytes, "params": n_params,
                        "publish_s": publish_s,
                        "publish_gb_per_s": [per_version / s / 1e9
                                             for s in publish_s],
                        "restore_s": restores,
                        "restore_gb_per_s": [per_version / s / 1e9
                                             for s in restore_s]},
                 cuda_memory_gb={"before": base_alloc / 1e9,
                                 "peak": peak / 1e9})
    return run


def phase_fabric(device_line: str) -> dict:
    """Returns each run's launches, by path name."""
    from repro_torch import configs
    cfg = configs.get("qwen2-1.5b")
    runs = {}
    # One replica behind the router: the router and registry layers
    # alone, against phase 5's engine behind a batcher.
    summary, run, _ = _fabric_run(
        cfg, "fabric one replica", ("decode_attention", "flash_attention"),
        replicas=1)
    runs["fabric 1 replica qwen2-1.5b flat"] = run
    _emit_fabric("one replica", summary, run, device_line, replicas=1)

    with tempfile.TemporaryDirectory() as tel:
        summary, run, _ = _fabric_run(
            cfg, "fabric", ("decode_attention", "flash_attention"),
            telemetry_dir=tel, trace_every=2)
        for name in ("telemetry.json", "trace.json"):
            if not os.path.getsize(os.path.join(tel, name)):
                fail(f"fabric: the telemetry hub wrote no {name}")
        with open(os.path.join(tel, "telemetry.json")) as f:
            services = json.load(f)["services"]
        with open(os.path.join(tel, "trace.json")) as f:
            n_events = len(json.load(f)["traceEvents"])
    engines = {k: v for k, v in services.items() if "EngineServer" in k}
    routers = {k: v for k, v in services.items() if "Router" in k}
    if len(engines) != 2 or any(e["retired"] < 1 or e["failed"]
                                for e in engines.values()):
        counts = {k: (e["retired"], e["failed"]) for k, e in engines.items()}
        fail("fabric: each replica must retire requests and fail none "
             f"(retired, failed): {counts}")
    for name, r in routers.items():
        if r["failovers"] or r["request_errors"] or r["overloaded"]:
            fail(f"fabric: router {name} reports failures {r}")
    runs["fabric qwen2-1.5b flat"] = run
    _emit_fabric("fabric", summary, run, device_line, trace_events=n_events,
                 engines={k: {c: e[c] for c in (
                     "retired", "steps", "host_syncs", "generated_tokens",
                     "mean_occupancy", "ewma_us_per_token")}
                     for k, e in engines.items()},
                 router={k: {c: r[c] for c in ("completed", "failovers",
                                               "retries", "dispatches")}
                         for k, r in routers.items()})

    summary, run, text = _fabric_run(
        cfg, "fabric failover", ("decode_attention", "flash_attention"),
        kill_after=4)
    if "fault: kill -> target 0 fired" not in text:
        fail("fabric failover: the kill of replica 0 never fired")
    runs["fabric failover qwen2-1.5b flat"] = run
    _emit_fabric("failover", summary, run, device_line, kill_after=4)

    runs["fabric rollout qwen2-1.5b paged ps=16"] = _rollout_run(
        cfg, device_line)
    return runs


# ---------------------------------------------------------------------------
# 7. families: Mixtral-8x7B (MoE), Llama-3.2-Vision-11B (cross-attention),
#    HuBERT-XLarge (audio encoder), full width
# ---------------------------------------------------------------------------

# Mixtral-8x7B is 46.7 B parameters, 93.4 GB in bf16: more than the
# card's 80 GB. Its depth is cut, never its width: 4 layers in fp32 for
# the parity run (24.3 GB), 16 in bf16 for serving (47.0 GB).
MIXTRAL_PARITY_LAYERS, MIXTRAL_SERVE_LAYERS = 4, 16
# Llama-3.2-Vision's parity run keeps two superblocks (4 self + 1 cross
# layer each) in fp32; the bf16 run is the whole 40-layer decoder.
VISION_PARITY_LAYERS = 10
FAMILY_PLEN, FAMILY_NEW = 128, 32
# HuBERT's fp32 hidden states through K3 against the plain path: the two
# differ by the kernel's summation order only (~1e-6 relative per layer,
# and a CPU run of a 48-layer stack with 1e-6 relative noise added to
# every attention output ends 1.2e-6 apart in relative L2), so these
# limits are 100x that and far below a wrong attention output.
HUBERT_REL_L2_TOL, HUBERT_MAX_ABS_TOL = 1e-4, 1e-3


def _family_cfg(arch: str, **kw):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), **kw)


def _collect() -> None:
    """Give the card back what the caller just deleted."""
    gc.collect()
    torch.cuda.empty_cache()


def _decode_step_ms(cfg, params, B: int, steps: int = 10) -> dict:
    """A bf16 prefill of B x FAMILY_PLEN tokens and ``steps`` greedy
    decode steps through the kernels, each on the host clock ending in a
    synchronize, then one profiled step's device time by kernel."""
    from repro_torch.models import transformer
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, FAMILY_PLEN))
                           .astype(np.int32), device="cuda")
    ctx = FAMILY_PLEN + FAMILY_NEW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = transformer.prefill(cfg, params, tokens=toks,
                                        context_len=ctx, impl="flash")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    feed = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t = torch.full((B,), FAMILY_PLEN, dtype=torch.int32, device="cuda")
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = transformer.decode_step(cfg, params, state, feed,
                                                t + i, attn_impl="flash")
        feed = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dev = _device_ms(lambda: transformer.decode_step(
        cfg, params, state, feed, t + steps, attn_impl="flash"), iters=3,
        every=True)
    total = sum(dev.values())
    return {"batch": B, "prefill_ms": prefill_ms,
            "step_ms": sorted(times)[len(times) // 2], "step_ms_runs": times,
            "step_device_ms_total": total,
            "step_top_device_ms": dict(sorted(dev.items(),
                                              key=lambda kv: -kv[1])[:8])}


def _mixtral(device_line: str) -> dict:
    from repro_torch import core as lp
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    paths = {}
    rng = np.random.default_rng(5)

    # fp32 parity through ServeEngine, kernels against plain.
    cfg = _family_cfg("mixtral-8x7b", num_layers=MIXTRAL_PARITY_LAYERS,
                      compute_dtype="float32")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, FAMILY_PLEN).astype(np.int32)
               for _ in range(2)]
    ctx = FAMILY_PLEN + FAMILY_NEW
    common = dict(num_slots=2, context_len=ctx, max_new=FAMILY_NEW)
    ref, _, _ = _drive(cfg, params, prompts, decode_impl="dense", **common)
    outs, run, _ = _drive(cfg, params, prompts, decode_impl="flash",
                          **common)
    ties = _compare_tokens(cfg, params, prompts, ref, outs, FAMILY_NEW, ctx,
                           "mixtral parity")
    for name in ("decode_attention", "flash_attention"):
        if not run[name]:
            fail(f"mixtral parity flash run launched no {name} kernel")
    label = f"families mixtral-8x7b parity {MIXTRAL_PARITY_LAYERS} layers fp32"
    paths[label] = run
    emit({"phase": "families", "run": "mixtral-8x7b parity",
          "config": f"mixtral-8x7b full width, {MIXTRAL_PARITY_LAYERS} of 32 "
          "layers, fp32 compute, seeded random weights",
          "params": cfg.param_count(), "prompt_lens": [len(p) for p in prompts],
          "max_new": FAMILY_NEW, "near_ties": ties, "launches": run,
          "seconds": time.perf_counter() - t0, "device": device_line})
    del params
    _collect()

    # bf16 at 16 layers: the decode step timed, then build_program.
    cfg = _family_cfg("mixtral-8x7b", num_layers=MIXTRAL_SERVE_LAYERS)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    step = _decode_step_ms(cfg, params, B=3)
    del params
    _collect()
    n_clients, per_client = 3, 2
    with tempfile.TemporaryDirectory() as tmp:
        summary_path = os.path.join(tmp, "meter.json")
        program = serve.build_program(
            cfg, num_clients=n_clients, requests_per_client=per_client,
            prompt_len=FAMILY_PLEN, max_new=FAMILY_NEW,
            meter_json=summary_path)
        _reset_launches()
        t0 = time.perf_counter()
        lp.launch_and_wait(program, timeout_s=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run = _read_launches()
        with open(summary_path) as f:
            summary = json.load(f)
    del program
    _collect()
    total = n_clients * per_client
    label = f"families mixtral-8x7b serve {MIXTRAL_SERVE_LAYERS} layers bf16"
    if summary["count"] != total:
        fail(f"{label}: served {summary['count']} of {total} requests")
    if summary["out_lens"] != [FAMILY_PLEN + FAMILY_NEW] * total:
        fail(f"{label}: wrong output lengths {summary['out_lens']}")
    for name in ("decode_attention", "flash_attention"):
        if not run[name]:
            fail(f"{label} launched no {name} kernel")
    paths[label] = run
    emit({"phase": "families", "run": "mixtral-8x7b serve",
          "config": f"mixtral-8x7b full width, {MIXTRAL_SERVE_LAYERS} of 32 "
          "layers, bf16, seeded random weights",
          "params": cfg.param_count(), "requests": summary["count"],
          "prompt_len": FAMILY_PLEN, "max_new": FAMILY_NEW,
          "p50_ms": summary["p50_ms"], "p95_ms": summary["p95_ms"],
          "mean_ms": summary["mean_ms"], "wall_s": wall,
          "generated_tokens_per_s_wall": total * FAMILY_NEW / wall,
          "decode": step, "launches": run, "device": device_line})
    return paths


def _vision(device_line: str) -> dict:
    from repro_torch.models import transformer
    from repro_torch.serve import decode as serve_lib
    paths = {}
    B = 2

    def inputs(cfg, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        prompt = torch.randint(0, cfg.vocab_size, (B, FAMILY_PLEN),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        memory = torch.randn((B, VISION_T, cfg.d_model), generator=gen,
                             device="cuda")
        return prompt, memory

    def check(cfg, out, prompt, label):
        if out.shape != (B, FAMILY_PLEN + FAMILY_NEW):
            fail(f"{label}: output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :FAMILY_PLEN], prompt):
            fail(f"{label}: the prompt was not kept")
        if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"{label}: token out of the vocabulary")

    cfg = _family_cfg("llama-3.2-vision-11b",
                      num_layers=VISION_PARITY_LAYERS,
                      compute_dtype="float32")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device="cuda")
    prompt, memory = inputs(cfg, 6)
    dense = serve_lib.generate(cfg, params, prompt, FAMILY_NEW,
                               memory=memory, attn_impl="dense")
    _reset_launches()
    flash = serve_lib.generate(cfg, params, prompt, FAMILY_NEW,
                               memory=memory, attn_impl="flash")
    torch.cuda.synchronize()
    run = _read_launches()
    label = (f"families llama-3.2-vision-11b parity "
             f"{VISION_PARITY_LAYERS} layers fp32")
    check(cfg, flash, prompt, label)
    ctx = FAMILY_PLEN + FAMILY_NEW
    ties = _compare_tokens(
        cfg, params, [p for p in prompt.cpu().numpy()],
        list(dense.cpu().numpy()), list(flash.cpu().numpy()), FAMILY_NEW,
        ctx, label, memories=[memory[b:b + 1] for b in range(B)])
    for name in ("decode_attention", "flash_attention"):
        if not run[name]:
            fail(f"{label} launched no {name} kernel")
    paths[label] = run
    emit({"phase": "families", "run": "llama-3.2-vision-11b parity",
          "config": f"llama-3.2-vision-11b text decoder, full width, "
          f"{VISION_PARITY_LAYERS} of 40 layers, fp32 compute, seeded "
          "random weights and patch embeddings",
          "params": cfg.param_count(), "batch": B, "memory_tokens": VISION_T,
          "prompt_len": FAMILY_PLEN, "max_new": FAMILY_NEW,
          "near_ties": ties, "launches": run,
          "seconds": time.perf_counter() - t0, "device": device_line})
    del params, memory
    _collect()

    cfg = _family_cfg("llama-3.2-vision-11b")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    prompt, memory = inputs(cfg, 7)
    _reset_launches()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve_lib.generate(cfg, params, prompt, FAMILY_NEW,
                                 memory=memory)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    run = _read_launches()
    label = "families llama-3.2-vision-11b generate 40 layers bf16"
    check(cfg, out, prompt, label)
    for name in ("decode_attention", "flash_attention"):
        if not run[name]:
            fail(f"{label} launched no {name} kernel")
    paths[label] = run
    emit({"phase": "families", "run": "llama-3.2-vision-11b generate",
          "config": "llama-3.2-vision-11b text decoder, full width and "
          "depth (32 self + 8 cross layers), bf16, seeded random weights "
          "and patch embeddings", "params": cfg.param_count(), "batch": B,
          "memory_tokens": VISION_T, "prompt_len": FAMILY_PLEN,
          "max_new": FAMILY_NEW, "generate_s": walls,
          "generated_tokens_per_s": B * FAMILY_NEW / walls[-1],
          "launches": run, "device": device_line})
    del params, memory
    _collect()
    return paths


def _hubert(device_line: str) -> dict:
    from repro_torch.models import transformer
    paths = {}
    cfg = _family_cfg("hubert-xlarge", compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.randn((1, HUBERT_S, cfg.d_model), generator=gen,
                         device="cuda")
    dense, _ = transformer.forward(cfg, params, embeddings=frames,
                                   impl="dense")
    _reset_launches()
    flash, _ = transformer.forward(cfg, params, embeddings=frames,
                                   impl="flash")
    torch.cuda.synchronize()
    run = _read_launches()
    label = "families hubert-xlarge forward 48 layers fp32"
    if run["flash_attention"] != cfg.num_layers:
        fail(f"{label}: {run['flash_attention']} flash_attention launches, "
             f"not one per layer ({cfg.num_layers})")
    logits = transformer.logits_from_hidden(cfg, params, flash)
    if flash.shape != (1, HUBERT_S, cfg.d_model) or \
            logits.shape != (1, HUBERT_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{label}: hidden {tuple(flash.shape)} / logits "
             f"{tuple(logits.shape)} not as expected or not finite")
    err = (flash - dense).abs()
    rel_l2 = (err.norm() / dense.norm()).item()
    max_abs = err.max().item()
    if rel_l2 > HUBERT_REL_L2_TOL or max_abs > HUBERT_MAX_ABS_TOL:
        fail(f"{label}: hidden states through K3 differ from plain: rel L2 "
             f"{rel_l2} (limit {HUBERT_REL_L2_TOL}), max |err| {max_abs} "
             f"(limit {HUBERT_MAX_ABS_TOL})")
    paths[label] = run
    fp32 = {"max_abs_err": max_abs, "rel_l2_err": rel_l2,
            "rel_l2_tol": HUBERT_REL_L2_TOL, "max_abs_tol": HUBERT_MAX_ABS_TOL,
            "hidden_max_abs": dense.abs().max().item()}
    del params, dense, flash, logits
    _collect()

    cfg = _family_cfg("hubert-xlarge")
    params = transformer.init_params(cfg, seed=0, device="cuda")

    def run_bf16():
        return transformer.forward(cfg, params, embeddings=frames)

    _reset_launches()
    run_bf16()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden, _ = run_bf16()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    run = _read_launches()
    label = "families hubert-xlarge forward 48 layers bf16"
    if run["flash_attention"] != 4 * cfg.num_layers:
        fail(f"{label}: {run['flash_attention']} flash_attention launches "
             f"in 4 forwards of {cfg.num_layers} layers")
    if not bool(torch.isfinite(hidden.float()).all()):
        fail(f"{label}: non-finite hidden states")
    paths[label] = run
    dev = _device_ms(run_bf16, iters=1, every=True)
    total = sum(dev.values())
    emit({"phase": "families", "run": "hubert-xlarge forward",
          "config": "hubert-xlarge full width and depth (48 layers, 16 "
          "heads of dh 80), seeded random weights and frame embeddings",
          "params": cfg.param_count(), "frames": HUBERT_S, "fp32": fp32,
          "bf16_forward_ms": sorted(times)[1], "bf16_forward_ms_runs": times,
          "bf16_device_ms_total": total,
          "bf16_flash_attention_device_ms": dev.get("flash_tc_kernel"),
          "bf16_top_device_ms": dict(sorted(dev.items(),
                                            key=lambda kv: -kv[1])[:8]),
          "launches": run, "device": device_line})
    del params, frames
    _collect()
    return paths


def phase_families(device_line: str) -> dict:
    """Returns each run's launches, by path name."""
    return {**_mixtral(device_line), **_vision(device_line),
            **_hubert(device_line)}


# ---------------------------------------------------------------------------
# 8. train: Qwen2-1.5B train steps at full width, and the training program
# ---------------------------------------------------------------------------

# a) device against CPU: full width, depth cut to 2 layers, fp32, TF32 off.
# The loss and gradients differ by summation order only. A gradient leaf
# whose true value is zero (the key bias: a softmax is blind to a shift
# that moves every logit of a row alike) holds rounding residues on both
# devices, so its bound adds 1e-7 of the whole gradient's norm. The AdamW
# update is the same fp32 elementwise arithmetic on both devices (true
# divisions, IEEE sqrt); only the global norm's summation order differs.
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 128
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-5, 1e-4, 1e-7
TRAIN_UPDATE_RTOL = 1e-6
# b) the slice's path: all 28 layers, fp32 master weights, bf16 compute,
# remat, two microbatches of 4 x 1024 tokens, launch/train.py's optimizer.
TRAIN_B, TRAIN_S, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 6
# The first bf16 loss against an fp32 no_grad loss on the same weights
# and batch: bf16 rounds each layer's activations to 8 bits of mantissa.
TRAIN_BF16_LOSS_RTOL = 2e-2
# c) the training program: LM100M, 2 learners, chief killed after its
# first publish. The evaluator's loss through K3 (bf16, P rounded to bf16
# before the value product, as the dense path rounds it) against its
# dense loss on the last version: near ln 32768 = 10.4, two bf16 paths
# that differ in summation order.
PROGRAM_STEPS, PROGRAM_PUBLISH_EVERY = 20, 5
EVAL_ABS_TOL = 1e-2


def _tree_rel(got, want, rtol, floor=0.0, total=None):
    """Per-leaf check: ||got - want|| <= rtol ||want|| + floor * total,
    and the worst ratio of error to ||want||. Leaves in tree order."""
    from repro_torch.train import tree
    worst, floored = 0.0, 0
    for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)):
        a, b = a.double().cpu(), b.double().cpu()
        err, ref = float((a - b).norm()), float(b.norm())
        bound = rtol * ref + floor * (total or 0.0)
        if err > bound:
            fail(f"train: leaf {'/'.join(map(str, path))} off by {err:.3e} "
                 f"(bound {bound:.3e}, norm {ref:.3e})")
        if err > rtol * ref:
            floored += 1
        elif ref:
            worst = max(worst, err / ref)
    return worst, floored


def _train_check(device_line: str) -> None:
    """a) one ``make_grad_fn`` call on the card and on the CPU from the
    same fp32 weights and batch, then ``apply_updates`` on the same
    gradients on both."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree
    from repro_torch.train.train_step import TrainConfig, make_grad_fn
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=TRAIN_CHECK_LAYERS,
                              compute_dtype="float32")
    cpu = transformer.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    gpu = tree.tree_map(lambda t: t.cuda(), cpu)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_CHECK_B, TRAIN_CHECK_S)).astype(np.int32))
    grad_fn = make_grad_fn(cfg, TrainConfig())
    t0 = time.perf_counter()
    loss_c, _, g_c = grad_fn(cpu, {"tokens": toks, "labels": toks})
    cpu_s = time.perf_counter() - t0
    tg = toks.cuda()
    grad_fn(gpu, {"tokens": tg, "labels": tg})           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_g, _, g_g = grad_fn(gpu, {"tokens": tg, "labels": tg})
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    if loss_err > TRAIN_LOSS_RTOL:
        fail(f"train: card loss {float(loss_g)} vs CPU {float(loss_c)}")
    total = float(opt_lib.global_norm(g_c))
    worst, floored = _tree_rel(g_g, g_c, TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR,
                               total)
    ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=6)
    p_c, s_c, m_c = opt_lib.apply_updates(ocfg, cpu, g_c,
                                          opt_lib.init_opt_state(cpu))
    p_g, s_g, m_g = opt_lib.apply_updates(
        ocfg, gpu, tree.tree_map(lambda t: t.cuda(), g_c),
        opt_lib.init_opt_state(gpu))
    upd = {}
    for name, a, b in (("params", p_g, p_c), ("m", s_g["m"], s_c["m"]),
                       ("v", s_g["v"], s_c["v"])):
        upd[name], _ = _tree_rel(a, b, TRAIN_UPDATE_RTOL)
    if float(m_g["lr"]) != float(m_c["lr"]):
        fail(f"train: lr {float(m_g['lr'])} vs {float(m_c['lr'])}")
    emit({"phase": "train", "run": "device vs CPU", "config": "qwen2-1.5b "
          f"full width, {TRAIN_CHECK_LAYERS} layers, fp32, TF32 off, "
          f"B {TRAIN_CHECK_B}, S {TRAIN_CHECK_S}, seeded random weights",
          "loss_card": float(loss_g), "loss_cpu": float(loss_c),
          "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
          "grad_worst_rel_l2": worst, "grad_rtol": TRAIN_GRAD_RTOL,
          "grad_leaves_within_floor": floored,
          "grad_floor_of_total_norm": TRAIN_GRAD_FLOOR,
          "update_worst_rel_l2": upd, "update_rtol": TRAIN_UPDATE_RTOL,
          "grad_fn_s_card": gpu_s, "grad_fn_s_cpu": cpu_s,
          "device": device_line})
    del cpu, gpu, g_c, g_g, p_c, p_g, s_c, s_g
    _collect()


def _model_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """(model FLOPs of one step, FLOPs it executes): 6 N T for the
    products, plus q.k and p.v over the full S x S square (the dense path
    computes it) three times; remat adds a second forward of both."""
    n = cfg.param_count()
    attn_fwd = 2 * 2 * B * S * S * cfg.num_heads * cfg.head_dim \
        * cfg.num_layers
    model = 6 * n * B * S + 3 * attn_fwd
    return model, model + 2 * n * B * S + attn_fwd


def _train_steps(device_line: str) -> None:
    """b) full-width Qwen2-1.5B: six ``make_train_step`` steps."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.models import transformer
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step, to_device)
    import dataclasses
    cfg = configs.get("qwen2-1.5b")
    tc = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                               total_steps=TRAIN_STEPS),
                     num_microbatches=TRAIN_MICRO, remat="full")
    torch.cuda.reset_peak_memory_stats()
    params, opt = make_train_state(cfg, 0, device="cuda")
    state_gb = torch.cuda.memory_allocated() / 1e9
    src = iter(make_source(DataConfig(seq_len=TRAIN_S, batch_size=TRAIN_B,
                                      vocab_size=cfg.vocab_size)))
    batches = [to_device(next(src), "cuda") for _ in range(TRAIN_STEPS)]
    with torch.no_grad():
        ref_loss, _ = transformer.loss_fn(
            dataclasses.replace(cfg, compute_dtype="float32"), params,
            batches[0], impl="dense")
    ref_loss = float(ref_loss)
    _collect()
    probe = params["blocks"][0]["0"]["attn"]["wq"]["kernel"][:8].clone()
    step = make_train_step(cfg, tc)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        fail(f"train: a loss is not finite: {losses}")
    if int(opt["step"]) != TRAIN_STEPS:
        fail(f"train: opt step {int(opt['step'])} after {TRAIN_STEPS} steps")
    moved = float((params["blocks"][0]["0"]["attn"]["wq"]["kernel"][:8]
                   - probe).abs().max())
    if not moved > 0:
        fail("train: the weights did not move")
    first_err = abs(losses[0] - ref_loss) / ref_loss
    if first_err > TRAIN_BF16_LOSS_RTOL:
        fail(f"train: first bf16 loss {losses[0]} vs fp32 {ref_loss}")
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_B * TRAIN_S
    model_flops, executed = _model_flops(cfg, TRAIN_B, TRAIN_S)
    busy = batches[-1]
    dev = _device_ms(lambda: step(params, opt, busy), iters=1, every=True)
    dev_total = sum(dev.values())
    emit({"phase": "train", "run": "qwen2-1.5b train steps", "config":
          f"qwen2-1.5b full width, {cfg.num_layers} layers, fp32 master "
          f"weights ({cfg.param_count() / 1e9:.3f} B), bf16 compute, "
          "remat full, "
          f"B {TRAIN_B} x S {TRAIN_S} in {TRAIN_MICRO} microbatches, "
          "SyntheticLM, AdamW lr 1e-3 warmup 20, seeded random weights",
          "losses": losses, "fp32_nograd_loss": ref_loss,
          "first_loss_rel_err": first_err,
          "first_loss_rtol": TRAIN_BF16_LOSS_RTOL,
          "opt_step": int(opt["step"]), "weights_moved_max_abs": moved,
          "step_s_runs": times, "step_s_median_2_to_6": step_s,
          "tokens_per_s": tokens / step_s,
          "model_tflop_per_step": model_flops / 1e12,
          "executed_tflop_per_step": executed / 1e12,
          "mfu_of_989_tflops": model_flops / step_s / 989e12,
          "state_gb": state_gb, "cuda_peak_gb": peak_gb,
          "profiled_step_device_ms": dev_total,
          "profiled_step_busy_share": dev_total / 1e3 / step_s,
          "profiled_step_top_device_ms": dict(sorted(
              dev.items(), key=lambda kv: -kv[1])[:10]),
          "device": device_line})
    del params, opt, batches, busy, m
    _collect()


_TRAIN_CHAOS: dict = {}


def _chaos_after_publish():
    """A ``ChaosNode`` whose kill fires once the target has published a
    version (its registry load names one), recording the target's step
    then; it then watches the respawned chief's start step."""
    from repro_torch.core.nodes.base import get_current_context
    from repro_torch.train import fabric

    class ChaosAfterPublish(fabric.ChaosNode):
        def __init__(self, registry, schedule):
            super().__init__(registry, schedule)
            self._registry = registry

        @staticmethod
        def _after_live(registry, name, delay_s):
            def pred() -> bool:
                try:
                    live = registry.lookup()["replicas"]
                except Exception:  # noqa: BLE001 - registry not up yet
                    return False
                for r in live:
                    if r["name"] == name and r["load"].get("version"):
                        _TRAIN_CHAOS["kill_step"] = r["load"]["step"]
                        _TRAIN_CHAOS["kill_version"] = r["load"]["version"]
                        _TRAIN_CHAOS["killed_mesh"] = r["load"].get("mesh")
                        return True
                return False
            return pred

        def run(self) -> None:
            super().run()
            ctx = get_current_context()
            while not ctx.should_stop:
                try:
                    for r in self._registry.lookup()["replicas"]:
                        load = r["load"]
                        if r["name"] == "learner-0" and load.get(
                                "start_step"):
                            _TRAIN_CHAOS["restored_start"] = \
                                load["start_step"]
                            _TRAIN_CHAOS["restored_mesh"] = load.get("mesh")
                except Exception:  # noqa: BLE001 - registry stopping
                    pass
                ctx.wait_for_stop(0.05)

    return ChaosAfterPublish


def _train_program(device_line: str, mesh_shape=None, device="cuda",
                   phase: str = "train", cfg=None) -> dict:
    """c) ``launch.train.build_program`` on the thread launcher: LM100M
    (or ``cfg``), 2 learners, the chief killed after its first publish;
    with ``mesh_shape`` the learners' state on that mesh (phase 10 e, and
    phase 12 a on a mesh of processes), where the respawned chief must
    restore onto it. On the card, its evaluator must launch K3. Returns
    its kernel launches."""
    from repro_torch import core as lp
    from repro_torch.ckpt import checkpoint
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as lt
    from repro_torch.models import convert, transformer
    from repro_torch.train import fabric, grad_compression
    cfg = cfg or lt.LM100M
    version_bytes = 4 * 4 * cfg.param_count()       # params, m, v, ef
    store = _store_dir(int(5 * version_bytes))
    timings = {"publish_s": [], "restore_s": []}
    methods = set()
    publish, restore, compress = (checkpoint.ModelStore.publish_version,
                                  fabric.restore_elastic,
                                  grad_compression.compress_tree)
    chaos = lt.ChaosNode

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timings[key].append(time.perf_counter() - t0)
        return wrapper

    def compress_logged(grads, error_state=None, method="int8_ef"):
        methods.add(method)
        return compress(grads, error_state, method)

    _TRAIN_CHAOS.clear()
    checkpoint.ModelStore.publish_version = timed(publish, "publish_s")
    fabric.restore_elastic = timed(restore, "restore_s")
    grad_compression.compress_tree = compress_logged
    lt.ChaosNode = _chaos_after_publish()
    try:
        program = lt.build_program(
            cfg, steps=PROGRAM_STEPS, ckpt_dir=store, learners=2,
            publish_every=PROGRAM_PUBLISH_EVERY, kill_after=0.0,
            registry_ttl_s=3.0, mesh_shape=mesh_shape, device=device)
        tee = _Tee(sys.stdout)
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            lp.launch_and_wait(program, timeout_s=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        run = _read_launches()
    finally:
        checkpoint.ModelStore.publish_version = publish
        fabric.restore_elastic = restore
        grad_compression.compress_tree = compress
        lt.ChaosNode = chaos
    del program
    _collect()
    try:
        ms = checkpoint.ModelStore(store)
        last = ms.latest_version()
        if last != PROGRAM_STEPS:
            fail(f"train program: last version {last}, not {PROGRAM_STEPS}")
        evals = re.findall(r"eval v(\d+) loss: ([0-9.]+)", tee.text())
        if not evals:
            fail("train program: the evaluator scored no version")
        if device == "cuda" and not run["flash_attention"]:
            fail("train program: the evaluator launched no K3")
        if "kill_step" not in _TRAIN_CHAOS:
            fail("train program: the chief was never killed")
        restored = _TRAIN_CHAOS.get("restored_start")
        lost = _TRAIN_CHAOS["kill_step"] - (restored or 0)
        if not restored or lost > PROGRAM_PUBLISH_EVERY:
            fail(f"train program: chief killed at step "
                 f"{_TRAIN_CHAOS['kill_step']} restored from {restored}")
        want_mesh = (None if mesh_shape is None else
                     dict(zip(("data", "model"), mesh_shape)))
        for key in ("killed_mesh", "restored_mesh"):
            if _TRAIN_CHAOS.get(key) != want_mesh:
                fail(f"train program: {key} {_TRAIN_CHAOS.get(key)}, not "
                     f"{want_mesh}")
        like = convert.params_to_numpy(cfg, transformer.init_params(
            cfg, 0, device="cpu", dtype=cfg.param_dtype))
        params = convert.params_from_numpy(
            cfg, ms.load_version(last, like={"params": like})["params"],
            device)
        data_cfg = DataConfig(seq_len=64, batch_size=8,
                              vocab_size=cfg.vocab_size, seed=999)
        batch = next(iter(make_source(data_cfg)))
        ev = lt.Evaluator(store, cfg, data_cfg, device=device)
        k3, dense = ev.score(params, batch), ev.score(params, batch,
                                                      impl="dense")
        if abs(k3 - dense) > EVAL_ABS_TOL:
            fail(f"train program: evaluator loss through K3 {k3} vs dense "
                 f"{dense}")
        store_gb = sum(f.stat().st_size for f in Path(store).rglob("*")
                       if f.is_file()) / 1e9
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"phase": phase,
          "run": "training program" + (
              "" if mesh_shape is None else f" on a {mesh_shape} mesh"),
          "config":
          f"{cfg.name} ({cfg.param_count() / 1e6:.1f} M, bf16 compute, fp32 "
          f"master weights), 2 learners, {PROGRAM_STEPS} steps of 16 x 64 "
          f"tokens, publish every {PROGRAM_PUBLISH_EVERY}, chief killed "
          "after its first publish, registry TTL 3 s",
          "learner_mesh": want_mesh,
          "restored_mesh": _TRAIN_CHAOS.get("restored_mesh"),
          "wall_s": wall, "steps_per_s_wall": PROGRAM_STEPS / wall,
          "last_version": last, "kill_step": _TRAIN_CHAOS["kill_step"],
          "restored_from": restored, "steps_lost": lost,
          "publish_s": timings["publish_s"],
          "restore_s": timings["restore_s"],
          "version_gb": version_bytes / 1e9, "store_gb_at_end": store_gb,
          "wire_strategies": sorted(methods),
          "evals": [[int(v), float(x)] for v, x in evals],
          "last_version_loss_k3": k3, "last_version_loss_dense": dense,
          "eval_abs_tol": EVAL_ABS_TOL, "launches": run, "runs_on": device,
          "device": device_line})
    del params
    _collect()
    return run


def phase_train(device_line: str) -> dict:
    """Returns the training program's launches, by path name."""
    _train_check(device_line)
    _train_steps(device_line)
    return {"train program lm100m": _train_program(device_line)}


# ---------------------------------------------------------------------------
# 9. plan: the dry run, and its estimate against the card
# ---------------------------------------------------------------------------

# (arch, shape, production mesh, with the depth probe): the cells the JAX
# package's test compiles (tests/test_distributed.py), and one on two pods.
PLAN_CELLS = (("qwen2-1.5b", "train_4k", "single", True),
              ("mixtral-8x7b", "decode_32k", "single", True),
              ("falcon-mamba-7b", "long_500k", "single", True),
              ("qwen2-1.5b", "train_4k", "multi", False))
PLAN_FLOPS_RTOL = 1e-2          # counted FLOPs: estimate vs the card
PLAN_PEAK_RATIO = (0.5, 2.0)    # estimated / measured peak memory
PREFILL_S = 1536


def _dry_run(device_line: str) -> None:
    """a) the dry run's cells at full config and shape."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import hw
    emit({"phase": "plan", "run": "hbm", "hw_HBM_BYTES": hw.HBM_BYTES,
          "card_total_memory": torch.cuda.get_device_properties(0)
          .total_memory, "device": device_line})
    for arch, shape, mesh, probes in PLAN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, with_probes=probes)
        rec["wall_s"] = time.perf_counter() - t0
        print(dryrun.summary_line(mesh, rec), flush=True)
        print(rec.pop("traceback", ""), file=sys.stderr, flush=True)
        emit({"phase": "plan", "run": "dry run", **rec,
              "device": device_line})
        if rec["status"] == "error":
            fail(f"plan: {arch} {shape} on {mesh}: {rec['error']}")
        if rec["status"] != "ok":
            fail(f"plan: {arch} {shape} was {rec['status']}")


# The kernel-adjusted roofline (scripts/torch_kernel_adjusted.py) of a
# cell whose memory term the plain scan dominates. Its 1- and
# 2-superblock traces walk the scan's 4096 steps a layer in 8
# microbatches under fake tensors: minutes of host CPU, so the script
# starts with the smoke, in a session of its own, and phase 9 reads it.
KA_CELL = ("falcon-mamba-7b", "train_4k")
KA_WAIT_S = 900.0                # from its start to phase 9's read


def _start_kernel_adjusted() -> dict:
    """Start ``torch_kernel_adjusted.py`` on ``KA_CELL``; it is killed
    when the smoke exits."""
    import atexit
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    result = Path(tempfile.mkdtemp(prefix="kernel-adjusted-")) / "ka.json"
    log = open(out / "kernel_adjusted.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "torch_kernel_adjusted.py"),
         *KA_CELL, "--json", str(result)], stdout=log,
        stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"))

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    atexit.register(stop)
    return {"proc": proc, "result": result, "t0": time.monotonic(),
            "log": out / "kernel_adjusted.log"}


def _kernel_adjusted(job: dict, device_line: str) -> None:
    """The kernel-adjusted memory term of ``KA_CELL``: the fraction
    of a superblock's bytes that the kernels keep on chip must be above
    0, and the adjusted memory term no larger than the one it scales."""
    proc = job["proc"]
    try:
        waited = time.monotonic()
        proc.wait(timeout=max(KA_WAIT_S - (waited - job["t0"]), 1.0))
    except subprocess.TimeoutExpired:
        fail(f"plan: torch_kernel_adjusted.py on {KA_CELL} ran over "
             f"{KA_WAIT_S} s")
    if proc.returncode != 0:
        fail(f"plan: torch_kernel_adjusted.py exited {proc.returncode}: "
             f"{job['log'].read_text()[-2000:]}")
    r = json.loads(job["result"].read_text())
    emit({"phase": "plan", "run": "kernel-adjusted roofline "
          "(scripts/torch_kernel_adjusted.py), started with the smoke",
          **r, "wall_s": time.monotonic() - job["t0"],
          "waited_s": time.monotonic() - waited, "device": device_line})
    if not r["fraction"] > 0:
        fail(f"plan: kernel-adjusted fraction {r['fraction']} on {KA_CELL}")
    if not r["memory_s_adjusted"] <= r["memory_s"]:
        fail(f"plan: adjusted memory term {r['memory_s_adjusted']} above "
             f"{r['memory_s']}")


def _place(tree, mesh):
    """Each tensor of ``tree`` as a DTensor on the 1x1 mesh, placed by
    the rules, sharing its storage."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import param_sharding
    from repro_torch.train import tree as tree_lib
    return tree_lib.tree_map(
        lambda t, sh: DTensor.from_local(t, mesh, sh[1], run_check=False)
        if t.is_cuda else t, tree, param_sharding(tree, mesh))


def _estimate_vs_card(label, cfg, shape, plan, mesh, run_real,
                      device_line) -> dict:
    """Trace the cell fake on ``mesh``, then ``run_real()`` on the card:
    its counted FLOPs and its peak beside the estimate's."""
    from repro_torch.launch import cells
    from repro_torch.roofline import hw
    t0 = time.perf_counter()
    cell = cells.build_cell(cfg, shape, mesh, plan=plan)
    est = cells.trace_cell(cell, mesh)
    trace_s = time.perf_counter() - t0
    real = run_real()
    rel = abs(real["flops"] - est.cost.flops) / est.cost.flops
    ratio = est.peak_bytes / real["peak_bytes"]
    rec = {"phase": "plan", "run": f"estimate vs card: {label}",
           "est_flops": est.cost.flops, "card_flops": real["flops"],
           "flops_rel_err": rel, "flops_rtol": PLAN_FLOPS_RTOL,
           "est_peak_gb": est.peak_bytes / 1e9,
           "est_argument_gb": est.argument_bytes / 1e9,
           "card_peak_gb": real["peak_bytes"] / 1e9,
           "peak_ratio_est_over_card": ratio,
           "peak_ratio_bounds": PLAN_PEAK_RATIO,
           "est_memory_s": est.cost.bytes_accessed / hw.HBM_BW,
           "trace_s": trace_s, **real.get("extra", {}),
           "device": device_line}
    emit(rec)
    if rel > PLAN_FLOPS_RTOL:
        fail(f"plan: {label}: card FLOPs {real['flops']} vs estimate "
             f"{est.cost.flops}")
    if not PLAN_PEAK_RATIO[0] <= ratio <= PLAN_PEAK_RATIO[1]:
        fail(f"plan: {label}: estimated peak {est.peak_bytes} vs card "
             f"{real['peak_bytes']}")
    return rec


def _plan_train(mesh, device_line) -> None:
    """b-i) phase 8's train step: estimate, then the card."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import cells
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline.analysis import cost_of
    from repro_torch.sharding import use_sharding
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (TrainConfig, make_train_state,
                                              make_train_step, to_device)
    cfg = configs.get("qwen2-1.5b")
    shape = ShapeConfig("train_8x1024", "train", TRAIN_S, TRAIN_B)
    plan = cells.CellPlan(num_microbatches=TRAIN_MICRO, remat="full")
    step = make_train_step(cfg, TrainConfig(
        optimizer=OptimizerConfig(), num_microbatches=TRAIN_MICRO,
        remat="full"))

    def run_real():
        """The sharded step timed from a clean card (its peak), then
        counted, then the unsharded step on the same inputs."""
        params, opt = make_train_state(cfg, 0, device="cuda")
        src = iter(make_source(DataConfig(seq_len=TRAIN_S,
                                          batch_size=TRAIN_B,
                                          vocab_size=cfg.vocab_size)))
        batch = to_device(next(src), "cuda")
        dp, do = _place(params, mesh), _place(opt, mesh)
        db = _place(batch, mesh)
        ctx = cells.sharding_ctx(mesh)
        _collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_sharding(ctx):
            out = step(dp, do, db)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del out
        _collect()
        with use_sharding(ctx):
            out, rec = cost_of(step, (dp, do, db))
        sharded_loss = float(out[2]["loss"].full_tensor())
        del out
        _collect()
        _, _, m = step(params, opt, batch)          # unsharded
        plain_loss = float(m["loss"])
        del m, dp, do, db, params, opt, batch
        _collect()
        if sharded_loss != plain_loss:
            fail(f"plan: sharded train loss {sharded_loss} vs unsharded "
                 f"{plain_loss}")
        return {"flops": rec.cost.flops, "peak_bytes": peak,
                "extra": {"loss_sharded": sharded_loss,
                          "loss_unsharded": plain_loss,
                          "card_first_sharded_step_s": step_s,
                          "card_state_gb_before_step": base / 1e9}}

    _estimate_vs_card(f"qwen2-1.5b train B {TRAIN_B} x S {TRAIN_S}, "
                      f"{TRAIN_MICRO} microbatches, remat, fp32 master, "
                      "bf16 compute", cfg, shape, plan, mesh, run_real,
                      device_line)


def _plan_prefill(mesh, device_line) -> dict:
    """b-ii) a bf16 prefill through K3: estimate, then the card."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import cells
    from repro_torch.models import transformer
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline.analysis import cost_of
    from repro_torch.serve import decode as serve_lib
    from repro_torch.sharding import use_sharding
    cfg = configs.get("qwen2-1.5b")
    shape = ShapeConfig("prefill_1536", "prefill", PREFILL_S, 1)
    fn = serve_lib.make_prefill(cfg, context_len=PREFILL_S,
                                impl=cells.ROUTE)
    launched = {}

    def run_real():
        params = _place(transformer.init_params(cfg, 0, device="cuda",
                                                dtype=torch.bfloat16), mesh)
        rng = np.random.default_rng(9)
        toks = _place(torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, PREFILL_S)).astype(np.int32)).cuda(),
            mesh)
        ctx = cells.sharding_ctx(mesh)
        k3.reset_launches()
        with use_sharding(ctx), torch.no_grad():
            out, rec = cost_of(lambda p, t: fn(p, t), (params, toks))
        launched["k3"] = k3.launches["flash_attention"]
        del out
        _collect()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_sharding(ctx), torch.no_grad():
            out = fn(params, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del out, params, toks
        _collect()
        return {"flops": rec.cost.flops, "peak_bytes": peak,
                "extra": {"card_prefill_s": wall,
                          "k3_launches_counted_run": launched["k3"]}}

    rec = _estimate_vs_card(f"qwen2-1.5b bf16 prefill B 1 x S {PREFILL_S} "
                            "through K3", cfg, shape, None, mesh, run_real,
                            device_line)
    if launched["k3"] != cfg.num_layers:
        fail(f"plan: the prefill launched K3 {launched['k3']} times, not "
             f"once a layer")
    return rec


def phase_plan(device_line: str, kernel_adjusted: dict) -> dict:
    """Returns K3's launches in the sharded prefill, by path name."""
    from repro_torch.launch.mesh import make_local_mesh
    _dry_run(device_line)
    _kernel_adjusted(kernel_adjusted, device_line)
    mesh = make_local_mesh()                      # 1x1, nccl
    _plan_train(mesh, device_line)
    _reset_launches()
    _plan_prefill(mesh, device_line)
    launches = _read_launches()
    import torch.distributed as dist
    dist.destroy_process_group()
    return {"plan prefill (DTensor, 1x1 mesh)": launches}


# ---------------------------------------------------------------------------
# 10. mesh training: the elastic restore, the pod reduce, the collective
#     matmul and the mesh learners, on a 1x1 CUDA mesh
# ---------------------------------------------------------------------------

# a) Qwen2-1.5B's full width, its depth cut to 4 layers: its {params,
# opt, ef} state in fp32 (~6.7 GB) saved from one mesh, restored onto a
# mesh of other axis names.
MESH_LAYERS = 4
# c) the collective matmul at Qwen2's MLP shape: B 8 x S 1024, D 1536 ->
# F 8960, bf16.
CM_B, CM_S, CM_D, CM_F = 8, 1024, 1536, 8960
# d) one LM100M learner with and without a mesh, the same seed and data.
MESH_LEARNER_STEPS = 6


def _mesh_state(cfg) -> dict:
    """{params, opt, ef} on the card in fp32: the seeded init's weights,
    and seeded moments and residual (a restore of zeros must not pass)."""
    from repro_torch.models import transformer
    from repro_torch.train import tree
    params = transformer.init_params(cfg, 0, device="cuda",
                                     dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(10)

    def noise(positive=False):
        def one(t):
            x = torch.randn(t.shape, generator=gen, device="cuda")
            return x.abs_() if positive else x
        return tree.tree_map(one, params)

    return {"params": params,
            "opt": {"m": noise(), "v": noise(positive=True),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "ef": noise()}


def _on_mesh_bit_equal(label, got, want, mesh) -> int:
    """Every leaf of ``got`` a DTensor on ``mesh`` at the rules'
    placements whose full value equals ``want``'s leaf to the bit.
    Returns the leaf count."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import (path_str, placements,
                                            spec_for_path)
    from repro_torch.train import tree
    n = 0
    for (path, a), b in zip(tree.leaves_with_path(got), tree.leaves(want)):
        name = path_str(path)
        if not isinstance(a, DTensor) or a.device_mesh is not mesh:
            fail(f"mesh: {label}: {name} is not on the mesh")
        if tuple(a.placements) != placements(
                mesh, spec_for_path(name, tuple(b.shape), mesh)):
            fail(f"mesh: {label}: {name} placed {a.placements}")
        full = a.full_tensor()
        if full.dtype != b.dtype or not torch.equal(full, b.to(full.device)):
            fail(f"mesh: {label}: {name} differs from the original")
        n += 1
    if n != len(tree.leaves(want)):
        fail(f"mesh: {label}: {n} leaves of {len(tree.leaves(want))}")
    return n


def _mesh_restore(device_line: str) -> None:
    """a) place, save, restore onto ("pod", "data", "model"); b) restore
    with ``shardings=``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.ckpt import checkpoint
    from repro_torch.ckpt.elastic import reshard, restore_elastic
    from repro_torch.sharding.compat import make_mesh
    from repro_torch.sharding.rules import param_sharding
    from repro_torch.train import tree
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=MESH_LAYERS)
    state = _mesh_state(cfg)
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(state))
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    store = _store_dir(int(1.2 * nbytes))
    try:
        d = os.path.join(store, "state")
        t0 = time.perf_counter()
        placed = reshard(state, mesh)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        _on_mesh_bit_equal("reshard", placed, state, mesh)
        t0 = time.perf_counter()
        checkpoint.save(placed, d)
        write_s = time.perf_counter() - t0
        del placed
        t0 = time.perf_counter()
        got = restore_elastic(d, like=state, new_mesh=mesh3)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        n = _on_mesh_bit_equal("restore_elastic", got, state, mesh3)
        del got
        _collect()
        t0 = time.perf_counter()
        got = checkpoint.restore(d, like=state,
                                 shardings=param_sharding(state, mesh))
        torch.cuda.synchronize()
        read2_s = time.perf_counter() - t0
        _on_mesh_bit_equal("restore(shardings=)", got, state, mesh)
        del got
        disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                   if f.is_file())
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "mesh", "run": "elastic restore", "config":
          f"qwen2-1.5b full width, {MESH_LAYERS} layers "
          f"({cfg.param_count() / 1e6:.1f} M), fp32 params, seeded "
          "moments and residual; saved from a 1x1 (data, model) CUDA "
          "mesh, restored onto 1x1x1 (pod, data, model) and with "
          "shardings= onto 1x1; read right after the write (page cache)",
          "leaves": n, "state_gb": nbytes / 1e9, "disk_gb": disk / 1e9,
          "reshard_s": reshard_s, "write_s": write_s,
          "write_gb_per_s": nbytes / write_s / 1e9,
          "restore_elastic_s": read_s,
          "restore_elastic_gb_per_s": nbytes / read_s / 1e9,
          "restore_shardings_s": read2_s,
          "restore_shardings_gb_per_s": nbytes / read2_s / 1e9,
          "bit_equal": True, "device": device_line})
    del state
    _collect()


def _mesh_collectives(device_line: str) -> None:
    """c) the pod reduce is the identity without a second pod; the
    collective matmul equals ``torch.matmul`` to the bit at TP 1."""
    from repro_torch.sharding.collective_matmul import collective_matmul
    from repro_torch.sharding.compat import make_mesh
    from repro_torch.train.grad_compression import compress_reduce_pod
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    grads = {"w": torch.randn((CM_D, CM_F), generator=gen, device="cuda")}
    for m in (mesh, mesh3):
        for method in ("int8_ef", "bf16"):
            red, err = compress_reduce_pod(grads, None, m, method=method)
            if red is not grads or err is not None:
                fail(f"mesh: compress_reduce_pod on {tuple(m.shape)} "
                     f"{method} is not the identity")
    x = torch.randn((CM_B, CM_S, CM_D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = torch.randn((CM_D, CM_F), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * CM_D ** -0.5
    y = collective_matmul(x, w, mesh)
    ref = torch.matmul(x, w)
    if y.shape != ref.shape or not torch.equal(y.full_tensor(), ref):
        fail("mesh: collective_matmul differs from torch.matmul")
    cm_ms = _time_ms(lambda: collective_matmul(x, w, mesh), iters=20)
    mm_ms = _time_ms(lambda: torch.matmul(x, w), iters=20)
    flops = 2 * CM_B * CM_S * CM_D * CM_F
    emit({"phase": "mesh", "run": "pod reduce and collective matmul",
          "config": f"compress_reduce_pod on 1x1 and 1x1x1 CUDA meshes "
          f"(int8_ef, bf16): identity; collective_matmul B {CM_B} x S "
          f"{CM_S}, D {CM_D} -> F {CM_F}, bf16, 1x1 mesh",
          "pod_reduce_identity": True, "matmul_bit_equal": True,
          "collective_matmul_ms": cm_ms, "torch_matmul_ms": mm_ms,
          "bound_ms": max(flops / PEAK_FLOPS_PER_S[torch.bfloat16],
                          2 * (x.numel() + w.numel() + ref.numel())
                          / HBM_BYTES_PER_S) * 1e3,
          "device": device_line})
    del x, w, y, ref, grads
    _collect()


def _mesh_learner(device_line: str) -> None:
    """d) one LM100M learner through ``launch.train.build_program``,
    without and with a 1x1 mesh: each step's loss must be equal to the
    bit; each chief step timed to a synchronize."""
    from repro_torch import core as lp
    from repro_torch.launch import train as lt
    from repro_torch.train import fabric
    cfg = lt.LM100M
    runs = {}
    step = fabric.LearnerWorker._chief_step
    for mesh_shape in (None, (1, 1)):
        rec = []

        def timed(self, ctx, rec=rec):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepped = step(self, ctx)
            torch.cuda.synchronize()
            if stepped:
                rec.append((self._step, self._loss,
                            time.perf_counter() - t0))
            return stepped

        store = _store_dir(int(4 * 4 * cfg.param_count() * 1.5))
        fabric.LearnerWorker._chief_step = timed
        try:
            program = lt.build_program(
                cfg, steps=MESH_LEARNER_STEPS, ckpt_dir=store,
                learners=1, publish_every=MESH_LEARNER_STEPS,
                with_eval=False, mesh_shape=mesh_shape, device="cuda")
            lp.launch_and_wait(program, timeout_s=600)
        finally:
            fabric.LearnerWorker._chief_step = step
            shutil.rmtree(store, ignore_errors=True)
        if [r[0] for r in rec] != list(range(1, MESH_LEARNER_STEPS + 1)):
            fail(f"mesh learner {mesh_shape}: steps {[r[0] for r in rec]}")
        runs[mesh_shape] = rec
        del program
        _collect()
    plain = [r[1] for r in runs[None]]
    meshed = [r[1] for r in runs[(1, 1)]]
    if plain != meshed or not all(np.isfinite(plain)):
        fail(f"mesh learner: losses {meshed} on the mesh vs {plain}")
    emit({"phase": "mesh", "run": "learner with and without a mesh",
          "config": f"lm100m ({cfg.param_count() / 1e6:.1f} M), one "
          f"learner, {MESH_LEARNER_STEPS} steps of 16 x 64 tokens, seed 0, "
          "wire chosen by size, plain vs a 1x1 (data, model) CUDA mesh",
          "losses": plain, "losses_bit_equal": True,
          "step_s_plain": [r[2] for r in runs[None]],
          "step_s_mesh": [r[2] for r in runs[(1, 1)]],
          # step 1 warms up; the last step publishes the version
          "step_s_median_2_to_5_plain":
              float(np.median([r[2] for r in runs[None]][1:-1])),
          "step_s_median_2_to_5_mesh":
              float(np.median([r[2] for r in runs[(1, 1)]][1:-1])),
          "device": device_line})


def phase_mesh(device_line: str) -> dict:
    """Returns the mesh training program's launches, by path name."""
    import torch.distributed as dist
    _mesh_restore(device_line)
    _mesh_collectives(device_line)
    _mesh_learner(device_line)
    run = _train_program(device_line, mesh_shape=(1, 1), phase="mesh")
    dist.destroy_process_group()
    return {"train program lm100m, 1x1 mesh": run}


# ---------------------------------------------------------------------------
# 11. the examples, each in a process of its own
# ---------------------------------------------------------------------------

# Runs ``repro_torch.examples.<name>.main(argv)`` and prints the kernel
# launches of the run as its last line.
_EXAMPLE_DRIVER = """
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import (decode_attention, flash_attention,
                                 rglru_scan, ssm_scan)
mods = (decode_attention, flash_attention, rglru_scan, ssm_scan)
for m in mods:
    m.reset_launches()
importlib.import_module("repro_torch.examples." + sys.argv[2]).main(
    sys.argv[3:])
import torch
torch.cuda.synchronize()
run = {}
for m in mods:
    run.update(m.launches)
print("LAUNCHES " + json.dumps(run), flush=True)
"""
EXAMPLE_TIMEOUT_S = 300


def _examples(tmp: str) -> list[tuple]:
    """(label, module, argv, check(stdout) -> error or None)."""
    ckpt = os.path.join(tmp, "train_lm")
    meters = {k: os.path.join(tmp, f"serve_{k}.json")
              for k in ("flat", "paged")}

    def has(text):
        return lambda out: None if text in out else f"no {text!r}"

    def improves(out):
        first = re.search(r"gen +0: mean fitness +(-?[0-9.]+)", out)
        final = re.search(r"final fitness at mean: (-?[0-9.]+)", out)
        if not (first and final):
            return "no fitness lines"
        if not float(final.group(1)) > float(first.group(1)):
            return f"fitness {final.group(1)} after {first.group(1)}"
        return None

    def trained(out):
        from repro_torch.ckpt.checkpoint import CheckpointManager
        last = CheckpointManager(ckpt).latest_step()
        return None if last == 12 else f"last step {last}, not 12"

    def served(key):
        def check(out):
            with open(meters[key]) as f:
                summary = json.load(f)
            if summary["count"] != 6 or summary["out_lens"] != [16] * 6:
                return f"served {summary['count']}: {summary['out_lens']}"
            return None
        return check

    serve = ["--full", "--clients", "2", "--requests", "3"]
    return [
        ("quickstart", "quickstart", [], has("total 190")),
        ("mapreduce", "mapreduce", [], has("word total: 420 (expected 420)")),
        ("parameter_server cached", "parameter_server",
         ["--mode", "cached", "--requesters", "4", "--seconds", "1"],
         has("total QPS")),
        ("evolution_strategies", "evolution_strategies",
         ["--evaluators", "6", "--generations", "15"], improves),
        ("actor_learner", "actor_learner", ["--actors", "2", "--steps", "20"],
         has("chief done: step=20")),
        ("train_lm --mesh 1,1", "train_lm",
         ["--preset", "tiny", "--steps", "12", "--mesh", "1,1",
          "--publish-every", "4", "--ckpt-dir", ckpt], trained),
        ("serve_lm flat", "serve_lm",
         serve + ["--meter-json", meters["flat"]], served("flat")),
        ("serve_lm paged ps=16", "serve_lm",
         serve + ["--page-size", "16", "--meter-json", meters["paged"]],
         served("paged")),
    ]


def phase_examples(device_line: str) -> dict:
    """Every example on the card at small arguments, all started
    together, each under its own timeout. Returns the launches of each
    run that launched a kernel, by path name."""
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        cases = _examples(tmp)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE_DRIVER, str(SRC), mod, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp) for _, mod, argv, _ in cases]
        try:
            outs = [p.communicate(timeout=EXAMPLE_TIMEOUT_S) for p in procs]
        except subprocess.TimeoutExpired:
            fail("examples: a run outlived its timeout of "
                 f"{EXAMPLE_TIMEOUT_S} s")
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for (label, mod, argv, check), p, (out, err) in zip(cases, procs,
                                                              outs):
            if p.returncode != 0:
                print(err[-4000:], file=sys.stderr, flush=True)
                fail(f"examples: {label} exited {p.returncode}")
            problem = check(out)
            if problem:
                fail(f"examples: {label}: {problem}")
            run = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
            run = {name: run[name] for name in KERNEL_NAMES}
            if any(run.values()):
                paths[f"example {label}"] = run
            emit({"phase": "examples", "run": label,
                  "argv": ["python", "-m", f"repro_torch.examples.{mod}",
                           *argv], "launches": run, "device": device_line})
    if not paths.get("example serve_lm paged ps=16", {}).get(
            "paged_decode_attention"):
        fail("examples: serve_lm --page-size launched no K2")
    if not paths.get("example serve_lm flat", {}).get("decode_attention"):
        fail("examples: serve_lm launched no K1")
    emit({"phase": "examples", "run": "all", "wall_s": wall,
          "device": device_line})
    return paths


# ---------------------------------------------------------------------------
# 12. the mesh group: a training mesh across processes
# ---------------------------------------------------------------------------

# Two ranks cannot share the one card: NCCL refuses it, and gloo's
# functional collectives, which DTensor calls, crash on CUDA tensors
# (scripts/torch_probe_gloo_cuda.py). So the card runs the group at world
# 1 over nccl, started as the program starts a mesh of processes (a
# TCPStore, rank 0, no follower), and the 2-rank program runs as gloo
# processes on the host's CPU.
# b) Qwen2-1.5B's width cut to MESH_LAYERS, one learner, fp32 compute.
GROUP_STEPS, GROUP_B, GROUP_S = 4, 8, 1024
GROUP_LOSS_RTOL = 1e-5


def _group_learner(device_line: str) -> dict:
    """b) one learner on the card, plain and on a (1, 1) mesh whose group
    ``MeshGroup`` starts: each step's loss within ``GROUP_LOSS_RTOL``,
    each chief step timed to a synchronize, the CUDA peak of each run;
    then the training program's evaluator scores the mesh learner's
    version through K3 against dense. Returns that path's launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.ckpt.checkpoint import ModelStore
    from repro_torch.core.discovery import Registry
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as lt
    from repro_torch.models import convert, transformer
    from repro_torch.train import fabric
    from repro_torch.sharding.group import MeshGroup
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=MESH_LAYERS,
                              compute_dtype="float32")
    task = lt.LMTask(cfg, TrainConfig(optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=20, total_steps=GROUP_STEPS)), "cuda")
    data_cfg = DataConfig(seq_len=GROUP_S, batch_size=GROUP_B,
                          vocab_size=cfg.vocab_size)
    fcfg = fabric.FabricConfig(total_steps=GROUP_STEPS, batch_size=GROUP_B,
                               publish_every=GROUP_STEPS)
    step = fabric.LearnerWorker._chief_step
    runs, peaks = {}, {}
    group = None
    for label in ("plain", "group"):
        rec = []

        def timed(self, ctx, rec=rec):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepped = step(self, ctx)
            torch.cuda.synchronize()
            if stepped:
                rec.append((self._step, self._loss,
                            time.perf_counter() - t0))
            return stepped

        store = _store_dir(int(4 * 4 * cfg.param_count() * 1.5))
        src = iter(make_source(data_cfg))
        fabric.LearnerWorker._chief_step = timed
        torch.cuda.reset_peak_memory_stats()
        try:
            if label == "group":
                t0 = time.perf_counter()
                group = MeshGroup((1, 1), ("data", "model"), "cuda")
                group_start_s = time.perf_counter() - t0
                backend = str(torch.distributed.get_backend())
                _reset_launches()
            learner = fabric.LearnerWorker(
                task, lambda: next(src), store, Registry(), fcfg,
                device="cuda", mesh=None if group is None else group.mesh,
                group=group)
            worker = threading.Thread(target=learner.run, daemon=True)
            worker.start()
            deadline = time.monotonic() + 600
            while not learner.load()["done"] and time.monotonic() < deadline:
                time.sleep(0.05)
            learner.retire()
            worker.join(timeout=60)
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() / 1e9
            if label == "group":
                ms = ModelStore(store)
                like = convert.params_to_numpy(cfg, transformer.init_params(
                    cfg, 0, device="cpu", dtype=cfg.param_dtype))
                params = convert.params_from_numpy(cfg, ms.load_version(
                    ms.latest_version(), like={"params": like})["params"],
                    "cuda")
                batch = next(iter(make_source(
                    dataclasses.replace(data_cfg, seed=999))))
                ev = lt.Evaluator(store, cfg, data_cfg, device="cuda")
                k3 = ev.score(params, batch)
                torch.cuda.synchronize()
                run = _read_launches()
                dense = ev.score(params, batch, impl="dense")
                del params
        finally:
            fabric.LearnerWorker._chief_step = step
            shutil.rmtree(store, ignore_errors=True)
            if group is not None:
                group.close()
        if [r[0] for r in rec] != list(range(1, GROUP_STEPS + 1)):
            fail(f"mesh group learner {label}: steps {[r[0] for r in rec]}")
        runs[label] = rec
        del learner
        _collect()
    plain = [r[1] for r in runs["plain"]]
    meshed = [r[1] for r in runs["group"]]
    if not (all(np.isfinite(plain)) and np.allclose(
            meshed, plain, rtol=GROUP_LOSS_RTOL, atol=0)):
        fail(f"mesh group learner: losses {meshed} on the group vs {plain}")
    if not run["flash_attention"]:
        fail("mesh group learner: the evaluator launched no K3")
    if abs(k3 - dense) > EVAL_ABS_TOL:
        fail(f"mesh group learner: evaluator loss through K3 {k3} vs dense "
             f"{dense}")
    emit({"phase": "mesh group", "run": "learner on a mesh group of one "
          "against plain", "config": f"qwen2-1.5b full width, "
          f"{MESH_LAYERS} layers ({cfg.param_count() / 1e6:.1f} M), fp32 "
          f"params and compute, one learner, {GROUP_STEPS} steps of "
          f"{GROUP_B} x {GROUP_S} tokens, wire chosen by size; plain vs a "
          "(data 1, model 1) mesh whose group MeshGroup started (TCPStore, "
          "nccl, rank 0, no follower); then its version scored by the "
          "training program's evaluator through K3 and dense",
          "runs_on": "cuda", "group_backend": backend,
          "group_start_s": group_start_s,
          "losses_plain": plain, "losses_group": meshed,
          "loss_max_rel": float(np.max(np.abs(np.array(meshed)
                                              / np.array(plain) - 1))),
          "loss_rtol": GROUP_LOSS_RTOL,
          "step_s_plain": [r[2] for r in runs["plain"]],
          "step_s_group": [r[2] for r in runs["group"]],
          "cuda_peak_gb_plain": peaks["plain"],
          "cuda_peak_gb_group": peaks["group"],
          "version_loss_k3": k3, "version_loss_dense": dense,
          "eval_abs_tol": EVAL_ABS_TOL, "launches": run,
          "device": device_line})
    return run


def phase_mesh_group(device_line: str) -> dict:
    """b) a learner on a mesh group of one on the card; a) the training
    program (2 learners, the chief killed) on a (2, 1) mesh of two gloo
    processes on the host's CPU, at the tiny preset's width. Returns the
    launches of b)'s path."""
    from repro_torch.launch import train as lt
    run = _group_learner(device_line)
    _train_program(device_line, mesh_shape=(2, 1), device="cpu",
                   phase="mesh group", cfg=lt.LM_TINY)
    return {"mesh group learner qwen2-1.5b 4 layers, evaluator": run}


# ---------------------------------------------------------------------------
# 13. mesh node: MeshWorkerNode over a mesh of ranks, one controller
# ---------------------------------------------------------------------------

# a) on the host CPU: a (2, 2) mesh of 4 gloo processes, the tiny preset's
# width at 2 layers, fp32; each reply within fp32 tolerance of the
# unsharded single-process service's. b) on the card: Qwen2-1.5B's width
# cut to MESH_LAYERS, bf16, 8 x 1024 tokens, through the node at (1, 1)
# and through a MeshGroup of one over nccl.
NODE_SHAPE = (2, 2)
NODE_B, NODE_S = 8, 1024
NODE_REQUESTS = 8                # alternately matmul and score
NODE_FP32_TOL = 1e-5             # |got - want| / max|want|; loss relative
NODE_BF16_TOL = 2.0 ** -7        # one bf16 ulp at the value, relative
NODE_KILL_S = 60.0               # a follower's death to the program's error


class MeshService:
    """Phase 13's service: ``matmul`` runs ``sharding.collective_matmul``
    with its weight column-sharded over "model", ``score`` the LM loss of
    a model whose params the sharding rules place on the mesh. Weights
    from ``seed``; without a mesh, plain tensors on ``device``."""

    def __init__(self, cfg, seed: int, w_shape, mesh=None, device="cpu"):
        from repro_torch.models import layers, transformer
        from repro_torch.sharding.rules import (Spec, distribute,
                                                param_sharding, placements)
        self._cfg, self._mesh = cfg, mesh
        self._device = torch.device(mesh.device_type if mesh is not None
                                    else device)
        dtype = layers.to_dtype(cfg.compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        w = (torch.randn(w_shape, generator=gen) / w_shape[0] ** 0.5).to(
            self._device, dtype)
        params = transformer.init_params(cfg, seed, device=self._device,
                                         dtype=dtype)
        if mesh is None:
            self._w, self._params = w, params
        else:
            self._w = distribute({"w": w}, {"w": (mesh, placements(
                mesh, Spec(None, "model")))})["w"]
            self._params = distribute(params, param_sharding(params, mesh))

    def matmul(self, x):
        from repro_torch.sharding.collective_matmul import collective_matmul
        x = torch.from_numpy(np.asarray(x)).to(self._device, self._w.dtype)
        y = (torch.matmul(x, self._w) if self._mesh is None else
             collective_matmul(x, self._w, self._mesh).full_tensor())
        return y.float().cpu().numpy()

    def score(self, tokens, impl: str = "auto") -> float:
        from repro_torch.launch import cells
        from repro_torch.models import transformer
        from repro_torch.sharding import use_sharding
        from repro_torch.sharding.rules import distribute
        t = torch.from_numpy(np.asarray(tokens)).to(self._device)
        batch = {"tokens": t, "labels": t}
        with torch.no_grad():
            if self._mesh is None:
                return float(transformer.loss_fn(self._cfg, self._params,
                                                 batch, impl=impl)[0])
            with use_sharding(cells.sharding_ctx(self._mesh)):
                loss, _ = transformer.loss_fn(
                    self._cfg, self._params,
                    distribute(batch, cells.batch_shardings(self._mesh,
                                                            batch)),
                    impl=impl)
                return float(loss.full_tensor())


class _NodeClient:
    """Sends ``requests`` to the node, keeps each reply and its wall time
    in ``out`` (a namespace: a node's dict and list arguments arrive as
    copies), then ``then(out)`` (by default: stop the program)."""

    def __init__(self, svc, requests, out, then=None):
        self._svc, self._requests, self._out = svc, requests, out
        self._then = then

    def run(self):
        from repro_torch import core as lp
        for method, arg in self._requests:
            t0 = time.perf_counter()
            self._out.replies.append(getattr(self._svc, method)(arg))
            self._out.call_s.append(time.perf_counter() - t0)
        (self._then or (lambda out: lp.stop_program()))(self._out)


def _replies():
    import types
    return types.SimpleNamespace(replies=[], call_s=[])


def _node_requests(cfg, B: int, S: int, D: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [("matmul", rng.standard_normal((B, S, D)).astype(np.float32))
            if i % 2 == 0 else
            ("score", rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)) for i in range(n)]


def _node_program(cfg, w_shape, requests, resources, then=None):
    from repro_torch import core as lp
    out = _replies()
    p = lp.Program("mesh-node")
    with p.group("svc"):
        svc = p.add_node(lp.MeshWorkerNode(MeshService, cfg, 0, w_shape))
    with p.group("client"):
        p.add_node(lp.PyNode(_NodeClient, svc, requests, out, then))
    return p, {"svc": resources}, out


def _call_medians(requests, call_s) -> dict:
    """Each method's median call time after its first call (the first
    matmul also waits for the node to come up)."""
    by = {}
    for (method, _), t in zip(requests, call_s):
        by.setdefault(method, []).append(t)
    return {m: float(np.median(ts[1:])) for m, ts in by.items()}


def _replies_within(got, want, tol: float) -> float:
    """The worst relative error of ``got`` against ``want``; fails above
    ``tol``."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if isinstance(w, float):
            err = abs(g - w) / abs(w)
        else:
            err = float(np.abs(g - w).max() / np.abs(w).max())
        if not np.isfinite(err) or err > tol:
            fail(f"mesh node: a reply is {err} off the plain service's "
                 f"(tolerance {tol})")
        worst = max(worst, err)
    return worst


def _node_on_host(device_line: str) -> None:
    """a) the (2, 2) node of 4 gloo processes on the host CPU: 8 replies
    against the single-process service; then a follower killed."""
    import dataclasses

    from repro_torch import core as lp
    from repro_torch.core.nodes import mesh as mesh_node
    from repro_torch.launch import train as lt
    cfg = dataclasses.replace(lt.LM_TINY, num_layers=2,
                              compute_dtype="float32")
    D, F = cfg.d_model, 2 * cfg.d_model
    requests = _node_requests(cfg, 4, 16, D, NODE_REQUESTS, seed=1)
    res = {"mesh": NODE_SHAPE, "axes": ("data", "model"), "device": "cpu"}
    t0 = time.perf_counter()
    p, resources, out = _node_program(cfg, (D, F), requests, res)
    lp.launch_and_wait(p, resources=resources, timeout_s=300)
    wall = time.perf_counter() - t0
    plain = MeshService(cfg, 0, (D, F))
    worst = _replies_within(out.replies, [
        getattr(plain, m)(a) for m, a in requests], NODE_FP32_TOL)

    killed = {}

    def kill_follower(_out):
        killed["pid"] = mesh_node.current_group().pids[0]
        killed["t"] = time.monotonic()
        os.kill(killed["pid"], signal.SIGKILL)
        lp.get_current_context().wait_for_stop()

    p, resources, _ = _node_program(cfg, (D, F), requests[:2], res,
                                    then=kill_follower)
    error = None
    try:
        lp.launch_and_wait(p, resources=resources, timeout_s=300)
    except lp.ProgramTestError as exc:
        error = repr(exc.__cause__)
        raised_s = time.monotonic() - killed["t"]
    if error is None or "mesh rank 1" not in error:
        fail(f"mesh node: a killed follower ended the program with {error}")
    if raised_s > NODE_KILL_S:
        fail(f"mesh node: the program ended {raised_s} s after the kill")
    emit({"phase": "mesh node", "run": "a) MeshWorkerNode on a (2, 2) mesh "
          "of 4 gloo processes on the host CPU against the single-process "
          "service, then a follower killed", "config": "tiny preset width, "
          f"2 layers, fp32; matmul [4, 16, {D}] x [{D}, {F}]",
          "requests": NODE_REQUESTS, "wall_s": wall, "call_s": out.call_s,
          "worst_rel_err": worst, "tolerance": NODE_FP32_TOL,
          "kill_error": error, "kill_to_error_s": raised_s,
          "device": device_line})


def _node_on_card(device_line: str) -> dict:
    """b) the service at Qwen2-1.5B's width on the card: through the node
    at (1, 1), then on a MeshGroup of one over nccl; each route's K3
    launches, the loss through K3 against the dense path at bf16, the
    matmul against plain, each call's wall time and the CUDA peak."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import core as lp
    from repro_torch.core.nodes import mesh as mesh_node
    from repro_torch.sharding.group import MeshGroup
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              num_layers=MESH_LAYERS,
                              compute_dtype="bfloat16")
    D, F = cfg.d_model, cfg.d_ff
    requests = _node_requests(cfg, NODE_B, NODE_S, D, 6, seed=2)
    routes, paths = {}, {}
    for route in ("node (1, 1)", "group of one"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if route == "node (1, 1)":
            p, resources, out = _node_program(
                cfg, (D, F), requests, {"mesh": (1, 1), "device": "cuda"})
            _reset_launches()
            lp.launch_and_wait(p, resources=resources, timeout_s=600)
            torch.cuda.synchronize()
            run = _read_launches()
            dist.destroy_process_group()
        else:
            group = MeshGroup((1, 1), ("data", "model"), "cuda")
            try:
                obj, svc = mesh_node.control(group, "svc", MeshService,
                                             (cfg, 0, (D, F)))
                out = _replies()
                _reset_launches()
                _NodeClient(svc, requests, out, then=lambda o: None).run()
                torch.cuda.synchronize()
                run = _read_launches()
                backend = str(dist.get_backend())
                mesh_node.release(obj)
                del obj, svc
            finally:
                group.close()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not run["flash_attention"]:
            fail(f"mesh node {route}: score launched no K3")
        routes[route] = {"wall_s": wall, "call_s": out.call_s,
                         "call_s_median": _call_medians(requests, out.call_s),
                         "cuda_peak_gb": peak, "launches": run,
                         "replies": out.replies}
        paths[f"mesh node {route}: qwen2-1.5b width, {MESH_LAYERS} layers, "
              "score"] = run
        _collect()
    plain = MeshService(cfg, 0, (D, F), device="cuda")
    want = [plain.matmul(a) if m == "matmul" else plain.score(a, "dense")
            for m, a in requests]
    del plain
    _collect()
    for route, r in routes.items():
        r["worst_rel_err"] = _replies_within(r.pop("replies"), want,
                                             NODE_BF16_TOL)
    emit({"phase": "mesh node", "run": "b) the service through "
          "MeshWorkerNode at (1, 1) on the card, then on a MeshGroup of one "
          "(nccl); score through K3 against the dense path",
          "config": f"qwen2-1.5b full width, {MESH_LAYERS} layers "
          f"({cfg.param_count() / 1e6:.1f} M), bf16; matmul [{NODE_B}, "
          f"{NODE_S}, {D}] x [{D}, {F}]; score {NODE_B} x {NODE_S} tokens",
          "group_backend": backend, "tolerance": NODE_BF16_TOL,
          "losses_dense": [w for w in want if isinstance(w, float)],
          "routes": routes, "device": device_line})
    return paths


def phase_mesh_node(device_line: str) -> dict:
    """b) on the card, then a) on the host CPU. Returns b)'s launches, by
    path."""
    paths = _node_on_card(device_line)
    _node_on_host(device_line)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))

    env = phase_environment()
    kernel_adjusted = _start_kernel_adjusted()
    phase_build()
    records = phase_kernels()
    # Launches on the main path: the engine runs of phases 4-7, the
    # training programs of phases 8 and 10 and the mesh group's learner
    # and evaluator of phase 12, the sharded prefill of phase 9, the
    # examples of phase 11 and the mesh node's two routes of phase 13,
    # each path's counters reset just
    # before its run and read just after. ``launches`` is their sum;
    # ``launches_by_path`` splits it.
    paths = {**phase_parity(env["nvidia_smi"]),
             **phase_serve(env["nvidia_smi"]),
             **phase_fabric(env["nvidia_smi"]),
             **phase_families(env["nvidia_smi"]),
             **phase_train(env["nvidia_smi"]),
             **phase_plan(env["nvidia_smi"], kernel_adjusted),
             **phase_mesh(env["nvidia_smi"]),
             **phase_examples(env["nvidia_smi"]),
             **phase_mesh_group(env["nvidia_smi"]),
             **phase_mesh_node(env["nvidia_smi"])}
    for r in records:
        r["launches_by_path"] = {path: run[r["name"]]
                                 for path, run in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if not r["launches"]:
            fail(f"{r['name']} was never launched on the main path")
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
