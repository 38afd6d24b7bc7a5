"""Tracing / profiling / debugging (counterpart of
dino_pose_tpu/utils/profiling.py).

- :func:`trace` — a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace into a directory.
- :class:`StepTimer` — splits an input-bound training loop into *host wait*
  (time blocked on the data iterator) vs step time, the first question for
  any throughput regression.
- :func:`enable_nan_checks` — autograd's anomaly mode, the closest torch form
  of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host + device trace: ``with trace('/tmp/prof'): step(...)``.

    Writes ``trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``) into ``logdir``; the card's activity is recorded
    when one is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_checks(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on (or off) for the process.

    It differs from JAX's ``jax_debug_nans``: that re-runs any primitive
    whose output holds a NaN, forward or backward, and raises at it. Anomaly
    mode checks the outputs of every backward function and raises at the
    first NaN there, naming the forward operation (with its traceback) that
    built it; a NaN made in a forward that no backward reaches, such as an
    eval forward, is not caught. It slows every backward."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Input-wait vs step accounting for one epoch.

    Usage::

        timer = StepTimer()
        for batch in timer.iter(loader):
            with timer.step():
                state, stats = train_step(state, batch, ...)
        timer.drain(device)
        print(timer.summary())

    Steps launch their kernels asynchronously; the *measured* step time is
    the host's time to issue them unless the loop blocks, so the summary also
    reports the epoch's trailing drain (``torch.cuda.synchronize`` on the
    step's device). If ``input_wait`` dominates, the host pipeline is the
    bottleneck (raise loader workers / prefetch).
    """

    def __init__(self):
        self.input_wait = 0.0
        self.step_time = 0.0
        self.drain_time = 0.0
        self.steps = 0

    def iter(self, iterable):
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.input_wait += time.perf_counter() - t0
            yield batch

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.step_time += time.perf_counter() - t0
        self.steps += 1

    def drain(self, device: torch.device | str) -> None:
        """Wait for the work queued on ``device`` (nothing to wait for on
        the CPU)."""
        t0 = time.perf_counter()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.drain_time += time.perf_counter() - t0

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "input_wait_s": round(self.input_wait, 4),
            "dispatch_s": round(self.step_time, 4),
            "drain_s": round(self.drain_time, 4),
            "input_bound": self.input_wait > (self.step_time + self.drain_time),
        }
