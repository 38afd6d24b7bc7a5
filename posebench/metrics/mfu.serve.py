"""Model FLOPs a second (posebench/flops: the forward, and for a train step
the backward the trainable leaves need; nothing recomputed) over the
traced run's window outside its profiled stretch, as a share of the H100's
dense bf16 peak: the profiler's cost stays out of it."""

from posebench.flops import PEAK_FLOPS
from posebench.harness.readers import of_kind


def read(summary: dict):
    if not of_kind(summary, "serve") or not summary["kernels"]:
        return None
    return 100.0 * summary["flops_per_s"] / PEAK_FLOPS
