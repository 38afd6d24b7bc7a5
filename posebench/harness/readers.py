"""Helpers the per-layer metric readers share. A reader takes the traced
stretch's summary (``harness/trace.summarise`` plus what the traffic adds:
``kind``, ``items`` (the batch of each profiled step or request), ``shape``,
``finetune``, ``size``, ``flops_per_s``, ``peak_window_bytes``, ``latencies_ms``,
``program_kernels``) and returns a number, or None where the stretch holds
nothing for it to read."""

from __future__ import annotations

from posebench.flops import bound_s
from posebench.harness.trace import base_name


def roofline(summary: dict, names, work) -> float | None:
    """100 x the least time of ``work`` (FLOPs, bytes) pairs over the
    seconds the stretch's kernels whose base name is in ``names`` ran; None
    where none of them ran."""
    seconds = sum(s for n, s in summary["kernels"] if base_name(n) in set(names))
    if seconds <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in work) / seconds


def of_kind(summary: dict, kind: str) -> bool:
    return summary.get("kind") == kind
