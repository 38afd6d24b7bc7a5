"""Share of the stretch's kernel time spent in kernels the program does not
build from its own CUDA sources (PyTorch's elementwise kernels, cuDNN,
cuBLAS, the optimizer)."""

from posebench.harness.readers import of_kind
from posebench.harness.trace import base_name


def read(summary: dict):
    if not of_kind(summary, "train"):
        return None
    total = sum(s for _, s in summary["kernels"])
    if total <= 0:
        return None
    own = summary["program_kernels"]
    return 100.0 * sum(s for n, s in summary["kernels"] if base_name(n) not in own) / total
