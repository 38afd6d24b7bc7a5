"""Share of the stretch in which no device operation ran: 1 - busy / wall."""

from posebench.harness.readers import of_kind


def read(summary: dict):
    if not of_kind(summary, "train") or not summary["kernels"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
