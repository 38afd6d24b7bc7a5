"""Traffic kind ``serve_closed``: one client in a closed loop behind the
program's serving entry point, ``serve.make_predictor``.

Each request is a (b, 3, size, size) f32 host array of decoded, normalised
frames, b drawn from ``min_batch``..``max_batch`` in shuffled rounds (every
seed sends the same sizes, in another order), its frames a seeded slice of a
pool of ``frames``. A request is timed from the call of ``predict`` to the
host arrays it returns; the next is sent when it returns. A request that
raises counts as failed, and as missing every latency limit.

Set-up builds the model (no adapter, every block frozen), loads the seeded
weights and sends each batch size ``WARMUP_ROUNDS`` times. Once the window
has closed, a sample of the answered requests drawn from the seed
(``sample`` of them, and ``sample_longest`` more among those of the largest
size) is compared with the plain reference on the same frames.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from posebench.flops import model_flops
from posebench.harness import compare, data, trace
from posebench.harness.program import check_widths, program_config, sync
from posebench.reference import model as R
from posebench.reference import spec as S
from posebench.reference.steps import decode

WARMUP_ROUNDS = 2


class _Reservoir:
    """A uniform sample of ``k`` items from a stream (Algorithm R), seeded."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


class Session:
    """One cell's predictor, requests and sample. ``fault``:
    ``"altered_answer"`` alters each answer where the model produces it."""

    kind = "serve"

    def __init__(self, cell, seed: int, device: torch.device, fault: str | None = None):
        from dino_pose_tpu_torch.models.registry import create_model_from_config
        from dino_pose_tpu_torch.serve import make_predictor

        tr = cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), device
        self.shape = S.ModelShape.from_config(cell.config)
        self.size = int(tr["input_size"])
        model = create_model_from_config(program_config(cell, {}), seed=self.seed, device=device,
                                         pretrained=False)
        check_widths(model, self.shape)
        model.load_state_dict(data.weights(self.shape, {}, self.seed, device), strict=True)
        if fault == "altered_answer":
            forward = model.forward

            def altered(*args, **kwargs):
                hm, z = forward(*args, **kwargs)
                return hm.roll(1, dims=1), z
            model.forward = altered
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        self.model = model
        self.predict = make_predictor(model, device)
        self.frames = data.request_frames(int(tr["frames"]), self.size, self.seed, device)
        lo, hi = int(tr["min_batch"]), int(tr["max_batch"])
        self.lo, self.hi = lo, hi
        self.sizes, self.offsets = [], []
        self.size_rng = np.random.default_rng([self.seed % 2**63, 4])
        self.offset_rng = np.random.default_rng([self.seed % 2**63, 5])
        self.sample_rng = np.random.default_rng([self.seed % 2**63, 6])
        for _ in range(WARMUP_ROUNDS):
            for b in range(lo, hi + 1):
                self.predict(self.frames[:b])
        sync(device)

    def _request(self, j: int) -> np.ndarray:
        """Request ``j``'s frames. Sizes come in shuffled rounds of
        lo..hi, drawn as the window reaches them, so that every seed sends
        the same sizes in another order; each request's first frame is a
        seeded offset into the pool."""
        while j >= len(self.sizes):
            round_ = [int(b) for b in self.size_rng.permutation(np.arange(self.lo, self.hi + 1))]
            self.sizes += round_
            self.offsets += [int(o) for o in self.offset_rng.integers(
                0, len(self.frames) - self.hi + 1, len(round_))]
        o = self.offsets[j]
        return self.frames[o:o + self.sizes[j]]

    def window(self, seconds: float, trace_path=None) -> dict:
        tr = self.cell.traffic
        dev = self.device
        profile = int(tr["profile_requests"]) if trace_path else 0
        sample = _Reservoir(int(tr["sample"]), self.sample_rng)
        longest = _Reservoir(int(tr["sample_longest"]), self.sample_rng)
        lat, failed, images, j = [], 0, 0, 0
        traced: list[int] = []
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def serve_one():
            nonlocal failed, images, j
            req = self._request(j)
            t = time.perf_counter()
            try:
                out = self.predict(req)
            except RuntimeError:
                failed += 1
                lat.append(math.inf)
            else:
                lat.append((time.perf_counter() - t) * 1e3)
                images += len(req)
                sample.offer((j, out))
                if len(req) == self.hi:
                    longest.offer((j, out))
            j += 1

        traced_s = 0.0
        t0 = time.perf_counter()
        while j < 2 + profile or time.perf_counter() - t0 < seconds:
            if profile and j == 2:
                t1 = time.perf_counter()
                with trace.capture(trace_path, lambda: sync(dev)):
                    for _ in range(profile):
                        traced.append(j)
                        serve_one()
                traced_s = time.perf_counter() - t1
                continue
            serve_one()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        self.sampled = sorted({jj: out for jj, out in sample.items + longest.items}.items())
        ordered = sorted(lat)
        p95 = ordered[min(len(ordered) - 1, math.ceil(0.95 * len(ordered)) - 1)]
        summary = None
        if profile:
            summary = trace.summarise(trace_path)
            items = [self.sizes[t] for t in traced]
            skip = set(traced)
            untraced = [x for i, x in enumerate(lat) if i not in skip]
            outside = [self.sizes[i] for i in range(j) if i not in skip]
            summary.update(kind="serve", items=items, shape=self.shape, finetune={},
                           size=self.size, peak_window_bytes=peak, latencies_ms=untraced,
                           flops_per_s=sum(model_flops(self.shape, {}, b, self.size, train=False)
                                           for b in outside) / (wall - traced_s))
        return {"metrics": {"serve_img_per_s": images / wall, "serve_p95_ms": p95},
                "attempted": j, "failed": failed, "peak_window_bytes": peak, "summary": summary}

    def release(self) -> None:
        self.model = self.predict = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32") -> list:
        """The plain model's (keypoints, z, heatmaps) of each sampled request."""
        if self.device.type == "cuda":
            R.f32_mode()
        W = data.weights(self.shape, {}, self.seed, self.device)
        model = R.PoseModel(W, self.shape, {}, R.Precision(precision))
        out = []
        with torch.no_grad():
            for j, _ in self.sampled:
                x = torch.from_numpy(np.ascontiguousarray(self._request(j))).to(self.device)
                hm, z = model.forward(x)
                out.append((decode(hm, self.size), z, hm))
        return out

    def served(self) -> list:
        """The sampled answers as tensors on the run's device."""
        return [tuple(torch.from_numpy(a).to(self.device) for a in out) for _, out in self.sampled]

    def check(self) -> dict:
        return compare.serve_gaps(self.served(), self.reference("f32"), self.size)
