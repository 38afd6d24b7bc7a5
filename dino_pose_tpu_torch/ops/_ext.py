"""Build and bind the hand-written CUDA kernels (ops/csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``dino_pose_tpu_torch/build/``
(listed in .gitignore). The library name carries a hash of the sources, so an
edited source is rebuilt and a stale library is never loaded. Nothing here
runs when the package is imported: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "build"
_SOURCES = ("block_kernels.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dp_gemm_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "dp_attention_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "dp_fused_block": ([_P] * 20 + [_I] * 5 + [_F, _P], _I),
    "dp_fused_attn_part": ([_P] * 10 + [_I] * 4 + [_F, _P], _I),
    "dp_fused_mlp_part": ([_P] * 10 + [_I] * 3 + [_F, _P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libdp_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(_CSRC / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if verbose or proc.returncode != 0:
        print(proc.stdout + proc.stderr, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
