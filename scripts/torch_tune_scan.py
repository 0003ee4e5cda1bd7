"""Time the selective-scan kernel (K5) and the RG-LRU scan kernel (K4) at
the prefill shapes of PERF.md, and copies of their sources with one
constant changed:

    python3 scripts/torch_tune_scan.py

Needs a CUDA card and the CUDA toolkit. Prints JSON lines, each with the
card; every time is ``torch_time_kernels.time_ms``'s (the median of 50
CUDA-event timings, each launch after a 64 MB L2 flush):

- "rglru": K4's time and launch at fp32 and bf16 a/x.
- "scaling": K5 at Di 4096, 8192 and 16384 (time in proportion to the
  work: bound by throughput; flat: by the latency of a block).
- "variant": a copy of one kernel source with one constant changed
  (built into ``build/repro_torch/tune_scan/``), timed through the
  wrapper beside the repository's build in turns (repo, variant, repo)
  at each shape, with the variant's launch, its ptxas registers and
  spills, and whether its output has the same bits. The constants in the
  sources come from these lines: K5's lanes per channel (``LANES``), its
  steps a group and chunk length, K4's producer warps.
- "sass": from ``cuobjdump -sass``, the instructions of K5's step loop
  (the loop that holds one group's exponentials, no barrier) per
  element, their mix, and their issue floor at the card's max SM clock
  (4 warp instructions a clock per SM), for the repository's build and
  each lanes variant, at N 16 with bf16 u.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# First: it puts the checkout's src/ on sys.path.
from torch_time_kernels import nvidia_smi, time_ms

from repro_torch.kernels import _build, scan_inputs
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssm_scan as ss

# label: B, S, Di, N, u dtype (Falcon-Mamba-7B's prefill, then N 8 and 4)
SSM_SHAPES = {
    "K5 falcon-mamba-7b prefill bf16 u": (1, 2048, 8192, 16, torch.bfloat16),
    "K5 falcon-mamba-7b prefill fp32 u": (1, 2048, 8192, 16, torch.float32),
    "K5 N=8 bf16 u": (1, 2048, 8192, 8, torch.bfloat16),
    "K5 N=4 bf16 u": (1, 2048, 8192, 4, torch.bfloat16),
}
# label: B, S, W, dtype (RecurrentGemma-2B's prefill)
RGLRU_SHAPES = {
    "K4 recurrentgemma-2b prefill fp32": (1, 3072, 2560, torch.float32),
    "K4 recurrentgemma-2b prefill bf16": (1, 3072, 2560, torch.bfloat16),
}
# name: source, the text in the repo's source, what the variant has
VARIANTS = {
    "K5 2 lanes a channel": ("ssm_scan.cu", "constexpr int LANES = 4;",
                             "constexpr int LANES = 2;"),
    "K5 8 lanes a channel": ("ssm_scan.cu", "constexpr int LANES = 4;",
                             "constexpr int LANES = 8;"),
    "K5 16 steps a group": ("ssm_scan.cu", "G = K >= 8 ? 4 : 8;",
                            "G = K >= 8 ? 8 : 16;"),
    "K5 128-step chunks": ("ssm_scan.cu", "constexpr int STEPS = 64;",
                           "constexpr int STEPS = 128;"),
    "K4 1 producer warp": ("rglru_scan.cu", "constexpr int PRODUCERS = 2;",
                           "constexpr int PRODUCERS = 1;"),
    "K4 4 producer warps": ("rglru_scan.cu", "constexpr int PRODUCERS = 2;",
                            "constexpr int PRODUCERS = 4;"),
}
# The instance whose step loop "sass" counts (u dtype, N) and its kernel
# in cuobjdump's listing.
SASS_SHAPE = (torch.bfloat16, 16)
SASS_KERNEL = re.compile(r"\S*ssm_kernelI13__nv_bfloat16Li16EE")


def _build_variants() -> dict:
    """Each variant's source alone, compiled into its own library (all at
    once); returns name -> (library bound as the repo's, its path, nvcc's
    report)."""
    out = {}
    for name, (fname, old, new) in VARIANTS.items():
        text = (_build.CSRC / fname).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in {fname}")
        d = _build.BUILD_ROOT / "tune_scan" / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / fname).write_text(text.replace(old, new))
        out[name] = d
    # One thread per variant: compile_sources waits on its own nvcc.
    with ThreadPoolExecutor(len(out)) as pool:
        logs = dict(zip(out, pool.map(
            lambda n: _build.compile_sources([out[n] / VARIANTS[n][0]],
                                             out[n], out[n] / "lib.so"),
            out)))
    return {name: (_build.bind_like(ctypes.CDLL(str(d / "lib.so"))),
                   d / "lib.so", logs[name])
            for name, d in out.items()}


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of each scan kernel in an nvcc report,
    keyed by its mangled name from the kernel's name on
    (``ssm_kernelI13__nv_bfloat16Li16`` is ``ssm_kernel<bf16, 16>``)."""
    stats, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for .*?((?:ssm|rglru)_kernel\w*?)"
                      r"E+v", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if name and m:
            stats.setdefault(name, {})["spill_bytes"] = int(m.group(1)) \
                + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            stats.setdefault(name, {})["registers"] = int(m.group(1))
    return stats


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _sass(lib_path: Path, launch: dict, sms: int, clock_hz: float) -> dict:
    """The step loop of the library's K5 instance at ``SASS_SHAPE``,
    whose launch (lanes, steps a group) is ``launch``."""
    tool = shutil.which("cuobjdump") or str(
        Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent
        / "cuobjdump")
    listing = subprocess.run([tool, "-sass", str(lib_path)],
                             capture_output=True, text=True, check=True,
                             timeout=300).stdout
    fns = [fn for fn in re.split(r"\n\s*Function : ", listing)
           if SASS_KERNEL.match(fn)]
    if len(fns) != 1:
        raise RuntimeError(f"{lib_path}: {len(fns)} kernels match "
                           f"{SASS_KERNEL.pattern}")
    L, G = launch["lanes"], launch["group_steps"]
    K = SASS_SHAPE[1] // L
    ins = []
    for addr, text in _SASS_LINE.findall(fns[0]):
        text = re.sub(r"^@!?U?P\w+\s+", "", text)
        ins.append((int(addr, 16), text.split()[0] if text else "", text))
    loop = None
    for addr, op, text in ins:
        t = re.search(r"0x([0-9a-f]+)", text[3:]) if op == "BRA" else None
        if not t or int(t.group(1), 16) > addr:
            continue
        body = [o.split(".")[0] for b, o, _ in ins
                if int(t.group(1), 16) <= b <= addr]
        if body.count("MUFU") == G * K and "BAR" not in body \
                and (loop is None or len(body) < len(loop)):
            loop = body
    if loop is None:
        raise RuntimeError(f"{lib_path}: no loop with {G * K} MUFU and no "
                           f"barrier in the K5 instance (L={L}, G={G})")
    mix: dict = {}
    for o in loop:
        mix[o] = mix.get(o, 0) + 1
    per_elem = len(loop) / (G * K)
    B, S, Di, N, _ = SSM_SHAPES["K5 falcon-mamba-7b prefill bf16 u"]
    return {"lanes": L, "group_steps": G, "loop_instructions": len(loop),
            "per_element": per_elem,
            "issue_floor_ms": B * S * Di * N * per_elem
            / (4 * 32 * sms * clock_hz) * 1e3,
            "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1])[:10])}


def main() -> None:
    smi = nvidia_smi("name,power.limit")
    clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def emit(kind, **kw):
        print(json.dumps({"kind": kind, "device": smi, **kw}), flush=True)

    rg_args = {label: scan_inputs.rglru(gen, B, S, W, dt, "cuda")
               for label, (B, S, W, dt) in RGLRU_SHAPES.items()}
    for label, (B, S, W, dtype) in RGLRU_SHAPES.items():
        args = rg_args[label]
        emit("rglru", shape=label,
             ms=time_ms(lambda: rg.rglru_scan(*args)),
             launch=rg.launch_config(dtype, B, W))
    rows = {}
    for Di in (4096, 8192, 16384):
        args = scan_inputs.ssm(gen, 1, 2048, Di, 16, torch.bfloat16, "cuda")
        rows[Di] = time_ms(lambda: ss.ssm_scan(*args))
    emit("scaling", shape="K5 B=1 S=2048 N=16 bf16 u", ms_by_di=rows)

    ssm_args = {label: scan_inputs.ssm(gen, B, S, Di, N, dt, "cuda")
                for label, (B, S, Di, N, dt) in SSM_SHAPES.items()}
    variants = _build_variants()
    dtype, N = SASS_SHAPE
    sass_libs = {"repo": (_build.library_path(),
                          ss.launch_config(dtype, N, 1, 8192))}
    for name, (lib, path, log) in variants.items():
        if VARIANTS[name][0] == "ssm_scan.cu":
            calls = {label: (lambda a=a: ss.ssm_scan(*a))
                     for label, a in ssm_args.items()}
            config = lambda: {label: ss.launch_config(dt, n, B, Di)
                              for label, (B, S, Di, n, dt)
                              in SSM_SHAPES.items()}
        else:
            calls = {label: (lambda a=a: rg.rglru_scan(*a))
                     for label, a in rg_args.items()}
            config = lambda: {label: rg.launch_config(dt, B, W)
                              for label, (B, S, W, dt)
                              in RGLRU_SHAPES.items()}
        out = {}
        for label, call in calls.items():
            want = call()
            repo_ms = [time_ms(call)]
            with _build.library(lib):
                got = call()
                variant_ms = time_ms(call)
            repo_ms.append(time_ms(call))
            out[label] = {"repo_ms": repo_ms, "variant_ms": variant_ms,
                          "same_bits": all(torch.equal(g, w)
                                           for g, w in zip(got, want))}
        with _build.library(lib):
            launch = config()
            if name.endswith("lanes a channel"):
                sass_libs[name] = (path, ss.launch_config(dtype, N, 1, 8192))
        emit("variant", variant=name, change=VARIANTS[name][1:],
             by_shape=out, launch=launch, ptxas=_ptxas(log))
    for name, (path, launch) in sass_libs.items():
        emit("sass", build=name, **_sass(path, launch, sms, clock))


if __name__ == "__main__":
    main()
