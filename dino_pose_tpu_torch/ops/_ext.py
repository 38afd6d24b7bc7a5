"""Build and bind the hand-written CUDA kernels (ops/csrc/*.cu).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``dino_pose_tpu_torch/build/``
(listed in .gitignore): one ``nvcc`` per source, all started together, then
one link. The library name carries a hash of every file under ``csrc/``, so
an edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs when the package is imported: the CPU tests import every
module on a machine without ``nvcc``.

``LAUNCHES`` counts the launches of each wrapper's kernels (``ops/block.py``,
``ops/attention.py``, ``ops/convffn.py``, ``ops/dwconv.py`` and
``ops/layernorm.py`` add to it), so that a run can show that its path went
through them.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent.parent / "build"
_SOURCES = ("block_kernels.cu", "flash_kernels.cu", "convffn_kernels.cu", "dwconv_kernels.cu",
            "layernorm_kernels.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

LAUNCHES: dict[str, int] = {
    "fused_block": 0, "fused_attn_part": 0, "fused_mlp_part": 0, "fused_mlp_dx": 0,
    "fused_block_train": 0, "fused_mlp_bwd": 0, "fused_attn_bwd": 0,
    # dinov2-large's halves at the weight-streamed kernels' rounding points.
    "fused_attn_part_stream": 0, "fused_mlp_part_stream": 0,
    # The trainable streamed halves of dinov2-base and -large: the MLP half
    # that also saves h2, and the two halves' backward chains.
    "fused_mlp_part_stream_train": 0, "fused_mlp_bwd_stream": 0, "fused_attn_bwd_stream": 0,
    # The streamed attention kernels: a forward launch (flash_fwd_kernel) and
    # a backward pair (flash_bwd_dq_kernel + flash_bwd_dkv_kernel), counted
    # inside the chains above and by the standalone ``flash_attention``.
    "flash_fwd": 0, "flash_bwd": 0,
    # The resident attention kernels of block_kernels.cu: a forward launch
    # (attn_fwd_kernel) and a backward pair (attn_bwd_dq_kernel +
    # attn_bwd_dkv_kernel), counted inside the chains where S is within the
    # resident route and by packed_attention / packed_attention_bwd.
    "attn_fwd": 0, "attn_bwd": 0,
    # FastViT's ConvFFN past its depthwise conv (convffn_kernel<false, ..>)
    # and its backward (convffn_kernel<true, ..> + convffn_bwd_reduce_kernel).
    "fused_convffn": 0, "fused_convffn_bwd": 0,
    # FastViT's opt-in arms: the ConvFFN with the block residual (the same
    # forward kernel, res operand), the stride-1 depthwise conv
    # (dw_kernel<K, DW>), and the combine + conv segment forward and backward
    # (dw_kernel<K, COMBINE>, dw_kernel<K, COMBINE_BWD> + dw_sums_reduce_kernel).
    "fused_convffn_res": 0, "fused_dw_conv": 0, "fused_combine_dw": 0,
    "fused_combine_dw_bwd": 0,
    # One tensor-parallel shard's halves (a launch per shard) and the LoRA
    # layer's partial dx, and the gated final LayerNorm (ln_fwd_kernel).
    "fused_attn_part_partial": 0, "fused_mlp_part_partial": 0, "fused_mlp_partial_dx": 0,
    "fused_layernorm": 0,
    # The chains' GEMMs (forward, backward dx, weight gradient), LayerNorm
    # rows and attention step alone (ops/block.py fused_gemm, fused_gemm_nt,
    # fused_gemm_tn, ln_rows, packed_attention, packed_attention_bwd): what
    # the card tests and chip_smoke.py hold and time; no path calls them.
    "fused_gemm": 0, "fused_gemm_nt": 0, "fused_gemm_tn": 0, "ln_rows": 0,
    "packed_attention": 0, "packed_attention_bwd": 0,
}

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dp_gemm_plan": ([_I, _I], _I),
    "dp_gemm": ([_P] * 7 + [_I] * 4 + [_P], _I),
    "dp_gemm_nt": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "dp_gemm_tn": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "dp_packed_attention": ([_P] * 2 + [_I] * 5 + [_P], _I),
    "dp_packed_attention_bwd": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "dp_ln_rows": ([_P] * 4 + [_I] * 2 + [_F, _P], _I),
    "dp_flash_forward": ([_I, _I], _I),
    "dp_flash_backward": ([_I, _I], _I),
    "dp_attention_keys": ([_I, _I], _I),
    "dp_fused_block": ([_P] * 20 + [_I] * 5 + [_F, _P], _I),
    "dp_fused_attn_part": ([_P] * 10 + [_I] * 4 + [_F, _P], _I),
    "dp_fused_mlp_part": ([_P] * 10 + [_I] * 3 + [_F, _P], _I),
    "dp_fused_attn_part_stream": ([_P] * 10 + [_I] * 4 + [_F, _P], _I),
    "dp_fused_mlp_part_stream": ([_P] * 10 + [_I] * 3 + [_F, _P], _I),
    "dp_fused_mlp_part_stream_train": ([_P] * 11 + [_I] * 3 + [_F, _P], _I),
    "dp_fused_mlp_dx": ([_P] * 13 + [_I] * 3 + [_F, _P], _I),
    "dp_fused_mlp_bwd": ([_P] * 24 + [_I] * 5 + [_F, _P], _I),
    "dp_fused_mlp_bwd_stream": ([_P] * 24 + [_I] * 5 + [_F, _P], _I),
    "dp_fused_attn_bwd": ([_P] * 26 + [_I] * 6 + [_F, _P], _I),
    "dp_fused_attn_bwd_stream": ([_P] * 24 + [_I] * 6 + [_F, _P], _I),
    "dp_flash_fwd": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
    "dp_flash_bwd": ([_P] * 8 + [_I] * 4 + [_F, _P], _I),
    "dp_flash_fwd_rows": ([_I], _I),
    "dp_convffn_smem": ([_I] * 11, ctypes.c_longlong),
    "dp_convffn_fwd": ([_P] * 15 + [_I] * 5 + [_F] + [_I] * 10 + [_P, _I, _P], _I),
    "dp_convffn_bwd": ([_P] * 17 + [_I] * 5 + [_F] + [_I] * 12 + [_P], _I),
    "dp_dw_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    "dp_dw_occupancy": ([_I] * 4 + [ctypes.c_longlong], _I),
    "dp_dw_conv": ([_P] * 4 + [_I, _P], _I),
    "dp_combine_dw": ([_P] * 10, _I),
    "dp_combine_dw_bwd": ([_P] * 13, _I),
    "dp_fused_attn_part_partial": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
    "dp_fused_mlp_part_partial": ([_P] * 8 + [_I] * 3 + [_F, _P], _I),
    "dp_fused_mlp_partial_dx": ([_P] * 11 + [_I] * 3 + [_F, _P], _I),
    "dp_layernorm": ([_P] * 4 + [_I] * 3 + [_F, _P], _I),
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
    for path in sorted(_CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"libdp_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(jobs: dict[str, list[str]], verbose: bool) -> None:
    """Run the commands (by label) side by side; raise if any fails.
    ``verbose`` prints each command's output and the seconds it took."""
    def run(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(run, jobs.values()))
    failed = []
    for (label, cmd), (proc, seconds) in zip(jobs.items(), done):
        if verbose or proc.returncode != 0:
            print(proc.stdout, flush=True)
        if verbose:
            print(f"nvcc {label}: {seconds:.1f} s", flush=True)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    if failed:
        raise RuntimeError("; ".join(failed))


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the sources unless a library of the same hash exists."""
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f"{tag}.{pathlib.Path(s).stem}.o" for s in _SOURCES]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    _run_all({s: [_nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(_CSRC / s)]
              for s, o in zip(_SOURCES, objs)}, verbose)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all({"link": [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]},
             verbose)
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = res
            _LIB = handle
    return _LIB


def stream(index: int) -> int:
    """The raw handle of PyTorch's current CUDA stream on device ``index``:
    ``torch.cuda.current_stream(index).cuda_stream`` without building a
    Stream object (a host cost the small launches notice)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
