"""Peak device memory allocated in the window (reset at its start), GiB."""

from posebench.harness.readers import of_kind


def read(summary: dict):
    if not of_kind(summary, "train") or not summary["peak_window_bytes"]:
        return None
    return summary["peak_window_bytes"] / 2**30
