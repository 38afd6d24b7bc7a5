"""The card a run uses, the caches it keeps in the checkout, and the check
that no JAX module was loaded.

Every cache of a run sits at a fixed path inside the checkout, so that only
a cell's first run there builds: the program's kernel library in
``dino_pose_tpu_torch/build/`` (fixed by the program), and Triton's,
PyTorch's extension and CUDA's JIT caches under ``.posebench/cache/``.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dino_pose_tpu")


def use_checkout_caches(checkout: pathlib.Path) -> pathlib.Path:
    """Point every build and kernel cache at a fixed directory in the
    checkout; returns the run directory ``.posebench/`` (traces go there)."""
    run_dir = checkout / ".posebench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(run_dir / "cache" / sub)
    # Libraries that would load JAX by themselves stay off it.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    return run_dir


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def require_cards(n: int):
    """The CUDA cards this cell needs, or SystemExit: there is no fallback to
    the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("posebench: no CUDA device; the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"posebench: the cell needs {n} cards, {torch.cuda.device_count()} found")
    return torch.device("cuda:0")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def describe(device, count: int, peak_bytes: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": peak_bytes, "power_limit_w": power_limit_w()}


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the modules loaded in this process), the
    top-level names that are JAX's or the JAX package's, compared whole:
    ``dino_pose_tpu_torch`` is not one."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
