"""The streamed attention pair's share of its roofline in a train step: the
least time of the attention core the steps needed (forward in every layer,
backward in the trainable ones; posebench/flops.attention_work) over the
device time of the flash kernels."""

from posebench.flops import attention_work
from posebench.harness.readers import of_kind, roofline

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(summary: dict):
    if not of_kind(summary, "train"):
        return None
    work = []
    for b in summary["items"]:
        fwd, bwd = attention_work(summary["shape"], summary["finetune"], b, summary["size"], True)
        work += fwd + bwd
    return roofline(summary, KERNELS, work)
