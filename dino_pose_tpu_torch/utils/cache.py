"""The kernel library as the CLIs' persistent compile cache (counterpart of
dino_pose_tpu/utils/cache.py).

The JAX package persists compiled XLA executables across processes so that
a CLI does not recompile its programs on every run. The port compiles only
with ``nvcc``, and ``ops/_ext.py`` already keeps that library under
``dino_pose_tpu_torch/build/``, keyed by a hash of every source: it persists
across processes by construction. :func:`enable_persistent_cache` keeps
JAX's name and idempotence, and every CLI calls it first, as JAX's do.
"""

from __future__ import annotations

import torch

from dino_pose_tpu_torch.ops import _ext


def enable_persistent_cache() -> None:
    """With a card, build the kernel library (or load it if it is built)
    once, so that a CLI pays ``nvcc`` before its first timed call and not
    inside it; later calls return at once. Without a card it does nothing:
    nothing is compiled for the CPU. Adds no environment variable and no
    directory."""
    if torch.cuda.is_available():
        _ext.lib()
