"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per ``.cu`` file, all started together, then linked into one
shared library with a plain C interface, loaded with ``ctypes``. The library
name carries a hash of the sources and flags, so a changed source rebuilds
and a checkout with nothing built builds itself. The build directory is
``build/kernels`` at the repository root (listed in ``.gitignore``).

Every C entry returns ``cudaGetLastError()`` after its launches; ``check``
raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C entry -> argument types (see each .cu file's extern "C" block)
_SIGNATURES = {
    "ftcf_quant_matmul_gemv": [P, P, P, P, I, I, I, I, I, I, P, I, I, P, P, P],
    "ftcf_quant_matmul_gemm": [P, P, P, P, I, I, I, I, P, I, I, P, I, I, I, I, P],
    "ftcf_quant_matmul_w4_gemv": [P, P, P, P, I, I, I, I, I, I, I, P, I, I, P, I, P, P],
    "ftcf_quant_matmul_w4_gemm": [P, P, P, P, I, I, I, I, I, P, I, I, P, I, I, I, I, I, P],
    "ftcf_fused_proj_down": [I, I, P, P, P, I, I, I, P, P, P, I, I, I, I, I, P, I, P, P, P,
                             P],
    "ftcf_gemv_ncat": [I, I, I, I, P, P, P, I, I, I, P, I, I, P, P,
                       P, P, P, I, I, I, P, I, I, P, P, P],
    "ftcf_gemm_ncat": [I, I, I, I, P, P, P, I, P, I, I, P, P, P, P, I, P, I, I, P, I, I, I, I,
                       P],
    "ftcf_flash_decode": [P, P, P, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, F, P],
    "ftcf_flash_decode_paged": [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, I, F, P],
    "ftcf_flash_decode_beam": [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, I, F, P],
    "ftcf_flash_chunk_paged": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P],
    "ftcf_prefill_flash": [P, P, P, P, P, I, I, I, I, I, F, P],
    "ftcf_prefill_flash_f32": [P, P, P, P, P, P, I, I, I, I, I, F, P],
    "ftcf_prefill_flash_bwd_dkv": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    "ftcf_prefill_flash_bwd_dq": [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    "ftcf_sliding_window": [P, P, P, P, P, I, I, I, I, I, I, P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register/spill report) of this process's build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libftcf_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source in parallel, then one link. ``build_log`` gives
    each source's compile time and ptxas report."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cu, _ = _sources()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{c.stem}.o" for c in cu]
    logs_f = [o.with_suffix(".out") for o in objs]
    t0 = time.perf_counter()
    procs = []
    for c, o, log_f in zip(cu, objs, logs_f):
        with open(log_f, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(o), str(c)],
                stdout=f, stderr=subprocess.STDOUT))
    secs = {}  # each source's compile time: the longest bounds the build
    while len(secs) < len(procs):
        for i, p in enumerate(procs):
            if i not in secs and p.poll() is not None:
                secs[i] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = [f"== {c.name} ({secs[i]:.1f} s)\n{log_f.read_text()}"
            for i, (c, log_f) in enumerate(zip(cu, logs_f))]
    failed = [c.name for c, p in zip(cu, procs) if p.returncode != 0]
    tmp = BUILD_DIR / f"{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        failed = ["link"] if link.returncode != 0 else []
    build_log = "\n".join(logs)
    for o in objs + logs_f:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(build_log)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    """Raise on an input the kernel does not take (never falls back)."""
    if not cond:
        raise ValueError(msg)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
