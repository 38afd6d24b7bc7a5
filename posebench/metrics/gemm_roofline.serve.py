"""The GEMM core's share of its roofline: the least time of the block
products the stretch needed (posebench/flops.gemm_work) over the device
time of the program's GEMM kernels."""

from posebench.flops import gemm_work
from posebench.harness.readers import of_kind, roofline

KERNELS = ("gemm_kernel", "gemm_nt_kernel", "gemm_tn_kernel")


def read(summary: dict):
    if not of_kind(summary, "serve"):
        return None
    work = [w for b in summary["items"]
            for w in gemm_work(summary["shape"], summary["finetune"], b, summary["size"],
                               train=summary["kind"] == "train")]
    return roofline(summary, KERNELS, work)
