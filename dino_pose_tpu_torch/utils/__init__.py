"""Observability utilities: profiler traces, step timing, NaN debugging."""

from dino_pose_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    enable_nan_checks,
    trace,
)
