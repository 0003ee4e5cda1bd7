"""Prove the PyTorch port runs on one NVIDIA GPU: build, check, serve.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. Phases,
each of which ends the run with a non-zero exit on failure:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: compile every kernel from ``src/repro_torch/kernels/csrc``;
3. kernels: hold each CUDA kernel against its plain PyTorch version on
   the card at the serving path's full-width shapes and at edge shapes,
   to a tolerance scaled to the output (shown to reject a dropped
   tile), and time kernel, plain version and a library yardstick;
4. parity: full-width Qwen2-1.5B (seeded random weights, fp32 compute)
   through ``ServeEngine``: greedy tokens from the flash-decode kernels
   must equal those of the dense attention path, flat and paged;
5. serve: ``build_program`` (clients -> batcher -> engine server) on the
   thread launcher, in the config's own bf16, flat and paged.

Prints JSON lines; the one before the last is the ``{"kernels": ...}``
record, the last ``{"ok": true, "device": {...}}``. Exits non-zero, and
prints no result, without a CUDA device or outside a checkout of the
repository.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM datasheet figures (NVIDIA): HBM3 bandwidth, and the fp32 rate
# outside the tensor cores (the kernels do their FMAs in fp32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Kernel against plain version, both accumulating in fp32. The tolerance
# scales with the output: a bf16 output may differ by a rounding step, so
# |err| <= 2 bf16 ulps at the largest |plain| value; a float32 output by
# summation order only. On top, ||err|| / ||plain|| must stay below
# REL_L2_TOL. At the main shapes a 32-slot tile dropped from one row
# gives a relative error of ~0.05 and a max |err| ~10x the ulp bound; the
# kernels phase shows that the check rejects such an output.
BF16_ULPS = 2
FP32_TOL = 2e-5
REL_L2_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
L2_FLUSH_BYTES = 64 << 20   # > the 50 MB L2: each timed launch starts cold


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


def _device_ms(fn, iters: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, from a
    ``torch.profiler`` trace, by kernel name (empty if the profiler saw no
    device time). Back-to-back calls, warm L2: a breakdown, not a time."""
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
        if us > 0 and name.endswith("_kernel"):
            out[name] = us / iters / 1e3
    return out


def _bound(bytes_moved: int, flops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
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
    scale, and the tolerances for ``out``'s dtype (see BF16_ULPS)."""
    e = expect.float()
    d = out.float() - e
    scale = e.abs().max().item()
    if out.dtype == torch.bfloat16:
        tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7) \
            if scale > 0 else 0.0
    else:
        tol = FP32_TOL
    norm = e.norm().item()
    return {"max_abs_err": d.abs().max().item(), "tol": tol,
            "rel_l2_err": d.norm().item() / norm if norm else
            d.norm().item(), "rel_l2_tol": REL_L2_TOL[out.dtype],
            "out_max_abs": scale, "out_rms": e.pow(2).mean().sqrt().item()}


def _within(c: dict) -> bool:
    return c["max_abs_err"] <= c["tol"] and c["rel_l2_err"] <= c["rel_l2_tol"]


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


def _rejects(name, wrong, expect, errors) -> None:
    """Show the check fails a wrong output: ``wrong`` is the plain version
    with one 32-slot tile dropped from the mask."""
    c = _compare(wrong, expect)
    errors.append({"case": f"{name}: plain with one tile dropped "
                   "(must be rejected)", **c})
    if _within(c):
        fail(f"{name}: the tolerance accepts an output with a tile dropped")


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

    # The serving path's full-width shapes: Qwen2-1.5B decode, B=8 rows,
    # 12 query / 2 KV heads, dh=128, a 2048-slot bf16 cache.
    B, H, KV, dh, L, ps = 8, 12, 2, 128, 2048, 16
    item = 2
    flops = 2 * 2 * B * H * L * dh                   # q.k and p.v FMAs
    q, k, v, valid = _flat_inputs(gen, B, H, KV, dh, L, torch.bfloat16,
                                  lengths=[L] * B)
    out = dec.decode_attention(q, k, v, valid)
    expect = ref.decode_attention(q, k, v, valid)
    name = "K1 main B=8 H=12 KV=2 dh=128 L=2048 bf16"
    c = _check(name, out, expect, errors)
    _rejects(name, ref.decode_attention(q, k, v, _drop_tile(valid)), expect,
             errors)
    nbytes = (int(valid.sum()) * KV * dh * 2 * item + q.numel() * item
              + valid.numel() + out.numel() * item)
    bound_ms, bound_by = _bound(nbytes, flops)
    mask = valid[:, None, None, :]
    q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    records.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:86",
        "launches": None, "launches_by_path": None, **c,
        "ms": _time_ms(lambda: dec.decode_attention(q, k, v, valid)),
        "device_ms": _device_ms(lambda: dec.decode_attention(q, k, v,
                                                             valid)),
        "plain_ms": _time_ms(lambda: ref.decode_attention(q, k, v, valid)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_bytes": nbytes, "bound_rate": "3.35 TB/s (H100 SXM datasheet)",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)),
        "library_call": "F.scaled_dot_product_attention(enable_gqa=True)",
        "shape": dict(B=B, H=H, KV=KV, dh=dh, L=L, dtype="bfloat16"),
    })

    n = L // ps
    q, kp, vp, pages, valid = _paged_inputs(gen, B, H, KV, dh, n, ps,
                                            torch.bfloat16)
    out = dec.paged_decode_attention(q, kp, vp, pages, valid)
    expect = ref.paged_decode_attention(q, kp, vp, pages, valid)
    name = "K2 main B=8 H=12 KV=2 dh=128 n*ps=2048 ps=16 bf16"
    c = _check(name, out, expect, errors)
    _rejects(name, ref.paged_decode_attention(q, kp, vp, pages,
                                              _drop_tile(valid)),
             expect, errors)
    # Bytes this data needs: each distinct (page, offset) the valid slots
    # reach, read once, plus the table, the mask, q and the output.
    slots = torch.arange(n * ps, device="cuda")
    phys = pages.long()[:, slots // ps] * ps + slots % ps
    distinct = int(torch.unique(phys[valid]).numel())
    nbytes = (distinct * KV * dh * 2 * item + pages.numel() * 4
              + valid.numel() + q.numel() * item + out.numel() * item)
    bound_ms, bound_by = _bound(nbytes, flops)
    kg = kp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    vg = vp[pages.long()].reshape(B, n * ps, KV, dh).transpose(1, 2)
    q4, mask = q[:, :, None, :], valid[:, None, None, :]
    records.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:168",
        "launches": None, "launches_by_path": None, **c,
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
    emit({"phase": "kernels", "checks": errors})
    return records


# ---------------------------------------------------------------------------
# 4. full-width parity: flash-decode kernels against dense attention
# ---------------------------------------------------------------------------

PARITY_TIE = 1e-3        # top-2 margin below which a step is a near-tie


def _drive(cfg, params, prompts, **kw) -> tuple:
    """Serve ``prompts`` through one ServeEngine on the card. Returns the
    outputs, the kernel launches of exactly this run and its prefix-cache
    hits."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, device="cuda", **kw)
    dec.reset_launches()
    futs = [eng.submit(p) for p in prompts]
    steps = 0
    while not all(f.done() for f in futs):
        eng.step()
        steps += 1
        if steps > 20000:
            fail("engine made no progress")
    torch.cuda.synchronize()
    run = dict(dec.launches)
    outs = [f.result() for f in futs]
    hits = eng.stats().get("prefix_cache", {}).get("hits", 0)
    eng.stop()
    return outs, run, hits


def _step_logits(cfg, params, seq, impl: str, context_len: int):
    """Logits predicting the token after ``seq`` through one decode step
    (attention leaf ``impl``) over the prefill state of ``seq[:-1]``."""
    from repro_torch.models import transformer
    toks = torch.as_tensor(seq, device="cuda")[None]
    _, state = transformer.prefill(cfg, params, tokens=toks[:, :-1],
                                   context_len=context_len)
    logits, _ = transformer.decode_step(cfg, params, state, toks[:, -1:],
                                        len(seq) - 1, attn_impl=impl)
    return logits[0, 0].float()


def _compare_tokens(cfg, params, prompts, ref, got, max_new, context_len,
                    label) -> int:
    """Every token equal, except at a near-tie of the dense path (top-2
    margin < PARITY_TIE), where that step's flash and dense logits must
    agree within PARITY_TIE and the rest of the request (a different
    context from there on) is not compared. Returns the near-tie count."""
    ties = 0
    for p, a, b in zip(prompts, ref, got):
        if a.shape != (len(p) + max_new,) or b.shape != a.shape:
            fail(f"{label}: output shape {b.shape} / {a.shape}")
        if not ((b >= 0) & (b < cfg.vocab_size)).all():
            fail(f"{label}: token out of the vocabulary")
        diff = np.nonzero(a != b)[0]
        if diff.size == 0:
            continue
        seq = a[:diff[0]]
        dense = _step_logits(cfg, params, seq, "dense", context_len)
        flash = _step_logits(cfg, params, seq, "flash", context_len)
        top2 = torch.topk(dense, 2).values
        margin = float(top2[0] - top2[1])
        err = float((flash - dense).abs().max())
        if margin >= PARITY_TIE or err > PARITY_TIE:
            fail(f"{label}: token {diff[0] - len(p)} of a request differs "
                 f"(dense top-2 margin {margin}, |flash-dense| {err})")
        ties += 1
    return ties


def phase_parity() -> dict:
    """Returns each flash run's launches, by path name."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get("qwen2-1.5b"),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, seed=0, device="cuda")
    ctx, max_new = 2048, 16
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (256, 1536, 700)]
    prompts += [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, n).astype(np.int32)]) for n in (100, 300, 1000)]
    common = dict(num_slots=4, context_len=ctx, max_new=max_new)
    paged = dict(common, page_size=16, prefill_chunk=256)
    t0 = time.perf_counter()
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
    emit({"phase": "parity", "config": "qwen2-1.5b full width, fp32 compute,"
          " seeded random weights", "requests": len(prompts),
          "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
          "near_ties": ties, "launches": runs, "prefix_hits": hits,
          "seconds": time.perf_counter() - t0})
    if not runs["flat sync=8"]["decode_attention"]:
        fail("flat flash run launched no decode_attention kernel")
    if not runs["paged ps=16 chunk=256 sync=1"]["paged_decode_attention"]:
        fail("paged sync=1 run launched no paged_decode_attention kernel")
    del params
    torch.cuda.empty_cache()
    return {f"parity {label}": run for label, run in runs.items()}


# ---------------------------------------------------------------------------
# 5. serve: the Launchpad program, full width, bf16
# ---------------------------------------------------------------------------

def phase_serve(device_line: str) -> dict:
    """Returns each run's launches, by path name."""
    import tempfile

    from repro_torch import configs, core as lp
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.launch import serve

    cfg = configs.get("qwen2-1.5b")
    n_clients, per_client, plen, max_new = 3, 4, 128, 32
    runs = {}
    for page_size in (None, 16):
        with tempfile.TemporaryDirectory() as tmp:
            summary_path = os.path.join(tmp, "meter.json")
            program = serve.build_program(
                cfg, num_clients=n_clients, requests_per_client=per_client,
                prompt_len=plen, max_new=max_new, page_size=page_size,
                meter_json=summary_path)
            dec.reset_launches()
            t0 = time.perf_counter()
            lp.launch_and_wait(program, timeout_s=600)
            wall = time.perf_counter() - t0
            run = dict(dec.launches)
            with open(summary_path) as f:
                summary = json.load(f)
        runs["serve paged ps=16" if page_size else "serve flat"] = run
        total = n_clients * per_client
        if summary["count"] != total:
            fail(f"served {summary['count']} of {total} requests")
        if summary["out_lens"] != [plen + max_new] * total:
            fail(f"wrong output lengths {summary['out_lens']}")
        if not run["decode_attention"]:
            fail("serve run launched no decode_attention kernel")
        emit({"phase": "serve", "paged": page_size, "config":
              "qwen2-1.5b full width, bf16, seeded random weights",
              "requests": summary["count"], "prompt_len": plen,
              "max_new": max_new, "p50_ms": summary["p50_ms"],
              "p95_ms": summary["p95_ms"], "mean_ms": summary["mean_ms"],
              "wall_s": wall, "generated_tokens_per_s_wall":
              total * max_new / wall, "launches": run,
              "device": device_line})
    return runs


# ---------------------------------------------------------------------------

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
    phase_build()
    records = phase_kernels()
    # Launches on the main path: the engine runs of phases 4-5, each
    # path's counters reset just before its run and read just after.
    # ``launches`` is their sum; ``launches_by_path`` splits it.
    paths = {**phase_parity(), **phase_serve(env["nvidia_smi"])}
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
