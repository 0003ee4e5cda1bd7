"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``*.cu`` under ``csrc/`` compiles, at first use, into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): one ``nvcc -c`` per source, all started together, then one
link. The output lives under ``build/repro_torch/<hash>/`` at the
root of the checkout, keyed on a hash of the sources and the compiler
flags, so changed sources rebuild and unchanged ones load straight away.
A lock (in-process and on the file system) serializes the first build:
the engine thread and the main thread may both reach it.

Only the sources in the repository are compiled; there is no
prebuilt-kernel package and no fallback when the build fails.

The conventions every wrapper shares with the C interface live here too:
dtype codes, the return code check, and the refusal to hand autograd a
tensor whose gradient the kernels do not compute.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# The C interface's dtype codes.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Set by the build that produced the loaded library (None if it loaded a
# library an earlier process built): seconds taken and nvcc's report.
build_seconds: Optional[float] = None
build_log: str = ""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def _run(procs: list) -> str:
    """Wait for every (command, Popen), then raise for the first that
    failed: no compiler outlives the build."""
    done = []
    for cmd, proc in procs:
        out = "".join(proc.communicate())
        done.append((cmd, proc.returncode, out))
    for cmd, rc, out in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return "".join(out for _, _, out in done)


def _spawn(cmd: list) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def compile_sources(srcs: list, include: Path, out: Path) -> str:
    """Compile the ``.cu`` files ``srcs`` (headers from ``include``) into
    the shared library ``out``: one ``nvcc -c`` per source, all started
    together, then one link. Returns nvcc's report (``-Xptxas -v``)."""
    tag = f".tmp{os.getpid()}"
    objs = [out.parent / f"{Path(p).stem}{tag}.o" for p in srcs]
    tmp = out.with_suffix(tag)
    log = _run([_spawn([_nvcc(), *NVCC_FLAGS, "-I", str(include), "-c",
                        "-o", str(o), str(p)])
                for p, o in zip(srcs, objs)])
    log += _run([_spawn([_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                         *map(str, objs)])])
    for o in objs:
        o.unlink()
    os.replace(tmp, out)                    # atomic: readers never see half
    return log


def _compile(out: Path) -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    log = compile_sources([p for p in _sources() if p.suffix == ".cu"], CSRC,
                          out)
    build_seconds = time.perf_counter() - t0
    build_log = log
    (out.parent / "nvcc.log").write_text(build_log)


def check_rc(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def launch_config(fn, keys: tuple, *args) -> dict:
    """Call a ``repro_*_config`` entry point ``fn`` (its arguments but
    the output array), which writes the launch its kernel's entry point
    makes for the same arguments, one int per name in ``keys``."""
    out = (ctypes.c_int * len(keys))()
    check_rc(fn(*args, out), fn.__name__)
    return dict(zip(keys, out))


def require_device(what: str, t: torch.Tensor) -> None:
    """Only the CPU (the plain version) and CUDA (the kernel) have an
    implementation: a tensor elsewhere raises before it reaches the
    kernel's custom op, whose fake would otherwise answer for it."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for {t.device}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The inference entry points have no backward pass, as the JAX
    package's Pallas kernels have none (its training runs XLA's attention
    and scans): an output built by them would carry no gradient, so raise
    instead. Training reaches attention through the differentiable
    ``flash_attention.flash_attention_train`` (``impl="train"``) and the
    scans through their plain route."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward pass (nor has the JAX package's "
            "kernel); train with impl=\"train\" or \"dense\", or call it "
            "under torch.no_grad() or on inputs that need no gradient")


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread- and process-safe)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out.parent / "lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if not out.exists():
                _compile(out)
        lib = ctypes.CDLL(str(out))
        _bind(lib)
        _lib = lib
    return _lib


@contextlib.contextmanager
def library(lib: ctypes.CDLL):
    """Within the block, every wrapper launches from ``lib`` (a build of
    changed sources whose entry points are bound with ``bind_like``), not
    from the repository's library: how ``scripts/torch_tune_scan.py``
    times a variant through the wrappers."""
    global _lib
    base = load()
    with _lock:
        _lib = lib
    try:
        yield lib
    finally:
        with _lock:
            _lib = base


def bind_like(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Bind each entry point ``lib`` has as the repository's library binds
    it (a variant may hold only some of the sources)."""
    base = load()
    # ctypes keeps each function it looked up in the library's __dict__,
    # and _bind looked up every entry point.
    for name, ref in vars(base).items():
        if name.startswith("repro_") and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_decode_attention.argtypes = [
        I, I, I,                      # q dtype, kv dtype, dh
        P, P, P, P,                   # q, k, v, valid
        P, P, P, P, P,                # out, m, l, acc scratch, counters
        I, I, I, I,                   # B, H, KV, L
        I, I, F,                      # split_len, n_splits, sm_scale
        P]                            # stream
    lib.repro_decode_attention.restype = I
    lib.repro_paged_decode_attention.argtypes = [
        I, I, I,                      # q dtype, kv dtype, dh
        P, P, P, P, P,                # q, k pages, v pages, pages, valid
        P, P, P, P, P,                # out, m, l, acc scratch, counters
        I, I, I, I, I,                # B, H, KV, ps, n_log
        I, I, F,                      # split_len, n_splits, sm_scale
        P]                            # stream
    lib.repro_paged_decode_attention.restype = I
    for name in ("repro_flash_attention_f32", "repro_flash_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [
            I,                        # dh
            P, P, P, P,               # q, k, v, out
            I, I, I, I, I,            # B, Sq, Sk, H, KV
            I, I, F,                  # causal, window, sm_scale
            P]                        # stream
        fn.restype = I
    lib.repro_flash_attention_bf16_lse.argtypes = [
        I,                            # dh
        P, P, P, P, P,                # q, k, v, out, lse
        I, I, I, I, I,                # B, Sq, Sk, H, KV
        I, I, F,                      # causal, window, sm_scale
        P]                            # stream
    lib.repro_flash_attention_bf16_lse.restype = I
    lib.repro_flash_attention_bwd_bf16.argtypes = [
        I,                            # dh
        P, P, P, P, P, P,             # q, k, v, out, dout, lse
        P, P, P, P, P,                # delta, dq, dk, dv, part scratch
        I, I, I, I, I,                # B, Sq, Sk, H, KV
        I, I, F, I,                   # causal, window, sm_scale, splits
        P]                            # stream
    lib.repro_flash_attention_bwd_bf16.restype = I
    lib.repro_rglru_scan.argtypes = [
        I,                            # dtype
        P, P, P, P, P,                # a, x, h0, y, h_last
        I, I, I,                      # B, S, W
        P]                            # stream
    lib.repro_rglru_scan.restype = I
    lib.repro_rglru_scan_config.argtypes = [
        I, I, I,                      # dtype, B, W
        P]                            # int[6] out
    lib.repro_rglru_scan_config.restype = I
    lib.repro_ssm_scan.argtypes = [
        I, I,                         # u dtype, N
        P, P, P, P, P, P, P,          # u, delta, A, B, C, D, h0
        P, P,                         # y, h_last
        I, I, I,                      # B, S, Di
        P]                            # stream
    lib.repro_ssm_scan.restype = I
    lib.repro_ssm_scan_config.argtypes = [
        I, I, I, I,                   # u dtype, N, B, Di
        P]                            # int[8] out
    lib.repro_ssm_scan_config.restype = I
    lib.repro_moe_gather.argtypes = [
        I, P, P, P, I, P,             # dtype, x, tok, ends, H, out
        I, I, P]                      # M, D, stream
    lib.repro_moe_swiglu.argtypes = [
        I, P, P, I, P,                # dtype, ab, ends, H, h
        I, I, P]                      # M, F, stream
    lib.repro_moe_swiglu_bwd.argtypes = [
        I, P, P, P, I, P,             # dtype, dh, ab, ends, H, dab
        I, I, P]                      # M, F, stream
    lib.repro_moe_combine.argtypes = [
        I, P, P, P, P, I, P,          # dtype, ye, gate, pos, ends, H, y
        I, I, I, I, P]                # M, N, K, D, stream
    lib.repro_moe_combine_bwd.argtypes = [
        I, P, P, P, P, P, I,          # dtype, dy, ye, gate, pos, ends, H
        P, P,                         # dye, dgate
        I, I, I, I, P]                # M, N, K, D, stream
    for name in ("repro_moe_gather", "repro_moe_swiglu",
                 "repro_moe_swiglu_bwd", "repro_moe_combine",
                 "repro_moe_combine_bwd"):
        getattr(lib, name).restype = I


if __name__ == "__main__":
    # python -m repro_torch.kernels._build: time the build as load() runs
    # it (one nvcc per source, all at once, then a link) against a single
    # nvcc call over every source, in turns (single, parallel, parallel,
    # single), each into a fresh directory under build/.
    import json
    srcs = [str(p) for p in _sources() if p.suffix == ".cu"]
    times: dict = {"single": [], "parallel": []}
    for i, how in enumerate(("single", "parallel", "parallel", "single")):
        out = BUILD_ROOT / "timing" / f"{how}{i}" / LIB_NAME
        shutil.rmtree(out.parent, ignore_errors=True)
        out.parent.mkdir(parents=True)
        t0 = time.perf_counter()
        if how == "parallel":
            _compile(out)
        else:
            _run([_spawn([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                          "-o", str(out), *srcs])])
        times[how].append(time.perf_counter() - t0)
    shutil.rmtree(BUILD_ROOT / "timing")
    print(json.dumps({"build_seconds": times, "sources": len(srcs)}))
