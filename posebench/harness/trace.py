"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` capture
of a fixed number of steps or requests, written as a Chrome trace, and the
summary the per-layer metric readers read.

On the card the profiler records the device's activity and the CUDA
runtime calls only: recording every host operator as well costs some tens
of microseconds a launch, which would make the host, not the card, pace a
step of a thousand launches. The stretch starts after a ``synchronize``
and ends with one, so the card is idle at both ends; its window runs from
the first runtime call to the end of the last device operation (on the
CPU, where there is no device, the host span ``posebench.window``). The
summary holds the device operations (kernels, copies, sets) with their
times, the window's length, the device's busy time (the union of those
intervals), and the longest idle gaps named by the runtime call the host
was in at their middle and the device operation that ended them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import pathlib
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
SPAN = "posebench.window"
_KERNEL_DECL = re.compile(r"__global__\b[^;{]*?\b(\w+_kernel)\s*[(<]", re.S)


def program_kernels(csrc: pathlib.Path) -> frozenset[str]:
    """Names of the kernels the program builds from its own CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_KERNEL_DECL.findall(path.read_text()))
    return frozenset(names)


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::gemm_kernel<2, 128, 0>(CUtensorMap_st, ...)``
    -> ``gemm_kernel``."""
    name = kernel.replace("(anonymous namespace)", "")
    m = re.match(r"\s*(?:void\s+)?([\w:]+)", name)
    return m.group(1).split("::")[-1] if m else kernel


@contextlib.contextmanager
def capture(path: pathlib.Path, sync):
    """Profile the body as the stretch; write the Chrome trace to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    path.parent.mkdir(parents=True, exist_ok=True)
    sync()
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            yield
            sync()
    prof.export_chrome_trace(str(path))


def summarise(path: pathlib.Path, top: int = 10) -> dict:
    """The stretch's device operations, busy and window seconds, and the
    breakdown (top device operations by time, longest idle gaps)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and e.get("name") != SPAN),
                  key=lambda e: e["ts"])
    spans = [e for e in events if e.get("name") == SPAN]
    if spans:
        lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    else:
        lo = min(e["ts"] for e in host + dev)
        hi = max(e["ts"] + e["dur"] for e in host + dev)
    kernels = [(e["name"], e["dur"] * 1e-6) for e in dev if e["cat"] == "kernel"]
    merged = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    by_time: dict[str, float] = {}
    for e in dev:
        by_time[e["name"]] = by_time.get(e["name"], 0.0) + e["dur"] * 1e-6
    starts = [e["ts"] for e in dev]

    def named(a: float, b: float) -> str:
        mid = (a + b) / 2
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        doing = min(inside, key=lambda e: e["dur"])["name"] if inside else "between host calls"
        i = bisect.bisect_left(starts, b)
        after = base_name(dev[i]["name"]) if i < len(dev) else "the window's end"
        return f"{doing} -> {after}"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "kernels": kernels,
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy,
        "breakdown": {
            "device_ops": [[n[:200], s] for n, s in sorted(by_time.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[named(a, b)[:200], (b - a) * 1e-6] for a, b in longest],
        },
    }
