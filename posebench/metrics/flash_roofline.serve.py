"""The streamed attention forward's share of its roofline in serving: the
least time of every layer's attention core over the requests' images
(posebench/flops.attention_work) over the device time of the flash forward."""

from posebench.flops import attention_work
from posebench.harness.readers import of_kind, roofline

KERNELS = ("flash_fwd_kernel",)


def read(summary: dict):
    if not of_kind(summary, "serve"):
        return None
    work = [w for b in summary["items"]
            for w in attention_work(summary["shape"], {}, b, summary["size"], False)[0]]
    return roofline(summary, KERNELS, work)
