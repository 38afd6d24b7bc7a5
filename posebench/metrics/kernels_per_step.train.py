"""Device kernels a train step launches: the stretch's kernels over its steps."""

from posebench.harness.readers import of_kind


def read(summary: dict):
    if not of_kind(summary, "train") or not summary["kernels"]:
        return None
    return len(summary["kernels"]) / len(summary["items"])
