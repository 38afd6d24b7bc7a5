"""Median latency of the window's requests outside the traced stretch,
host clock around ``predict``."""

import statistics

from posebench.harness.readers import of_kind


def read(summary: dict):
    if not of_kind(summary, "serve") or not summary["latencies_ms"]:
        return None
    return statistics.median(summary["latencies_ms"])
