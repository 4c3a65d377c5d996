"""Build and load the port's hand-written kernels.

CUDA C++ (`csrc/*.cu`) is compiled by `nvcc` for `sm_90a`, one process per
source, all started together, then linked into one shared library with a
plain C interface, loaded with `ctypes`.  The library's file
name carries a hash of the sources, so an edit rebuilds and an unchanged
tree reuses the build.  Triton kernels compile on first launch into a cache
that is also kept under `_build/`.  Nothing builds at import time: the first
kernel call does.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
CUDA_SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "short_kv_attention.cu",
                "packed_attention.cu", "packed_attention_stream.cu", "layernorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points (all return a cudaError_t)
_SIGNATURES = {
    "bya_flash_attention_flat": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    "bya_flash_layout_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    "bya_flash_bwd": [_I, *[_P] * 18, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "bya_short_kv_layout": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "bya_short_kv_attention_combined_flat": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                             _I, _I, _F, _P],
    "bya_short_kv_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "bya_tiny_seq_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "bya_tiny_seq_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "bya_tiny_seq_attention_stream": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "bya_tiny_seq_attention_stream_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                          _P],
    "bya_layernorm_fwd": [_P, _P, _P, _P, _I, _I, _F, _P],
    "bya_layernorm_bwd_blocks": [_I, _I, _P],
    "bya_layernorm_bwd": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_cuda() -> Path:
    """Compile the CUDA sources (if this tree's build is missing) and return
    the library path.  Each source compiles in its own `nvcc` process, all
    at once; the compilers' per-kernel register and shared-memory reports,
    and each source's seconds, are kept beside the library in `nvcc.log`."""
    srcs = [CSRC_DIR / s for s in CUDA_SOURCES]
    digest = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = BUILD_DIR / f"libbya_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]

    def compile_one(src: Path, obj: Path) -> tuple:
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        return src.name, proc.stdout, proc.returncode, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        logs = list(pool.map(compile_one, srcs, objs))
    (BUILD_DIR / "nvcc.log").write_text(
        "".join(f"== {name} (exit {rc}, {secs:.1f} s)\n{out}" for name, out, rc, secs in logs))
    failed = [(name, out) for name, out, rc, _ in logs if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name}:\n{out[-4000:]}" for name, out in failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_cuda()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def import_triton() -> None:
    """Import triton with its compile cache under `_build/triton`."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton  # noqa: F401  (present on the GPU machine only)
