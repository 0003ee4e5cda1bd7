"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``*.cu`` under ``csrc/`` compiles, at first use, into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The output lives under ``build/repro_torch/<hash>/`` at the
root of the checkout, keyed on a hash of the sources and the compiler
flags, so changed sources rebuild and unchanged ones load straight away.
A lock (in-process and on the file system) serializes the first build:
the engine thread and the main thread may both reach it.

Only the sources in the repository are compiled; there is no
prebuilt-kernel package and no fallback when the build fails.
"""

from __future__ import annotations

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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _compile(out: Path) -> None:
    global build_seconds, build_log
    srcs = [str(p) for p in _sources() if p.suffix == ".cu"]
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                    # atomic: readers never see half
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    (out.parent / "nvcc.log").write_text(build_log)


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


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_decode_attention.argtypes = [
        I, I, I,                      # q dtype, kv dtype, dh
        P, P, P, P,                   # q, k, v, valid
        P, P, P, P,                   # out, m, l, acc scratch
        I, I, I, I,                   # B, H, KV, L
        I, I, F,                      # split_len, n_splits, sm_scale
        P]                            # stream
    lib.repro_decode_attention.restype = I
    lib.repro_paged_decode_attention.argtypes = [
        I, I, I,                      # q dtype, kv dtype, dh
        P, P, P, P, P,                # q, k pages, v pages, pages, valid
        P, P, P, P,                   # out, m, l, acc scratch
        I, I, I, I, I,                # B, H, KV, ps, n_log
        I, I, F,                      # split_len, n_splits, sm_scale
        P]                            # stream
    lib.repro_paged_decode_attention.restype = I
