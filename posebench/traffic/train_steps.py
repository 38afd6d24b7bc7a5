"""Traffic kind ``train_steps``: fine-tune steps of the program's production
train step, back to back, on batches staged on the card.

Parameters (the cell's mix, ``mixes/<traffic>.json``): ``finetune``
(``{"use_lora": true}`` or ``{"unfreeze_last_n_layers": N}``),
``input_size``, ``batch_size``, ``lr``, ``weight_decay``, ``profile_steps``
(the traced stretch). Every cell cycles ``POOL`` distinct seeded batches through the step and warms up
``WARMUP_STEPS`` steps after the three checked ones.

Set-up builds one train state and one wrapped step
(``train/step.prepare_batch(make_train_step(...))``, targets rendered and
pixels cast in the step), drives it from the seed through its first three
steps on three different batches and keeps what the check reads: each
step's stats, the first gradient's norm of every trainable leaf (from
AdamW's first moment after one step) and the leaves after step 3. The
window then runs the same object. Nothing is read back to the host inside
the window; it closes with ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import gc
import time

import torch

from posebench.flops import model_flops
from posebench.harness import compare, data, trace
from posebench.harness.program import check_widths, program_config, sync
from posebench.reference import model as R
from posebench.reference import spec as S
from posebench.reference.steps import train_steps

CHECKED_STEPS = 3
WARMUP_STEPS = 3
POOL = 4
BETA1 = 0.9


class Session:
    """One cell's program, data and readings. ``fault`` plants a fault in
    the timed path (for the harness's own tests and the control's fault
    readings): ``"unchanged_state"`` or ``"half_batch"``."""

    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device, fault: str | None = None):
        from dino_pose_tpu_torch.core.precision import policy_for_device
        from dino_pose_tpu_torch.models.registry import create_model_from_config
        from dino_pose_tpu_torch.train.state import create_train_state
        from dino_pose_tpu_torch.train.step import make_train_step, prepare_batch

        tr = cell.traffic
        self.cell, self.seed, self.device = cell, int(seed), device
        self.shape = S.ModelShape.from_config(cell.config)
        self.finetune = dict(tr["finetune"])
        self.size, self.batch, self.lr = int(tr["input_size"]), int(tr["batch_size"]), float(tr["lr"])
        config = program_config(cell, self.finetune)
        model = create_model_from_config(config, seed=self.seed, device=device, pretrained=False)
        check_widths(model, self.shape)
        model.load_state_dict(data.weights(self.shape, self.finetune, self.seed, device), strict=True)
        state, optimizer, partition = create_train_state(model, config,
                                                         weight_decay=float(tr["weight_decay"]))
        self.trainable = S.trainable(self.shape, self.finetune)
        if partition != frozenset(self.trainable):
            raise ValueError("the program trains other leaves than the configuration states: "
                             f"{sorted(partition ^ frozenset(self.trainable))[:4]}")
        step = prepare_batch(make_train_step(model, optimizer, partition),
                             device_targets=(self.size, self.shape.heatmap),
                             compute_dtype=policy_for_device(device).compute_dtype)
        self.step = _planted(step, fault, model, optimizer)
        self.batches = data.train_batches(POOL, self.batch, self.size,
                                          self.shape.keypoints, self.seed, device)
        self.model, self.optimizer, self.state = model, optimizer, state

        params = dict(model.named_parameters())
        stats = []
        for t in range(CHECKED_STEPS):
            self.state, st = self.step(self.state, self.batches[t], self.lr, self.seed)
            stats.append(st)
            if t == 0:
                grad1 = {n: (optimizer.state[params[n]]["exp_avg"] / (1 - BETA1)
                             if params[n] in optimizer.state else torch.zeros_like(params[n]))
                         for n in self.trainable}
        after = {n: params[n].detach().clone() for n in self.trainable}
        for t in range(CHECKED_STEPS, CHECKED_STEPS + WARMUP_STEPS):
            self.state, _ = self.step(self.state, self.batches[t % POOL], self.lr, self.seed)
        sync(device)
        self.readings = {
            "steps": [{k: float(st[k]) for k in compare.STAT_KEYS} for st in stats],
            "grad1": compare.leaf_norms(grad1),
            "grad1_t": grad1,
        }
        self._after = after
        self.step_flops = model_flops(self.shape, self.finetune, self.batch, self.size, train=True)

    def window(self, seconds: float, trace_path=None) -> dict:
        """Steps for ``seconds``; with ``trace_path``, steps 2 to 2 +
        ``profile_steps`` of the window traced."""
        dev, n, nb = self.device, 0, len(self.batches)
        profile = int(self.cell.traffic["profile_steps"]) if trace_path else 0
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        traced_s = 0.0
        t0 = time.perf_counter()
        while n < 2 + profile or time.perf_counter() - t0 < seconds:
            if profile and n == 2:
                t1 = time.perf_counter()
                with trace.capture(trace_path, lambda: sync(dev)):
                    for _ in range(profile):
                        self.state, _ = self.step(self.state, self.batches[n % nb], self.lr, self.seed)
                        n += 1
                traced_s = time.perf_counter() - t1
                continue
            self.state, _ = self.step(self.state, self.batches[n % nb], self.lr, self.seed)
            n += 1
        sync(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        summary = None
        if profile:
            summary = trace.summarise(trace_path)
            summary.update(kind="train", items=[self.batch] * profile, shape=self.shape,
                           finetune=self.finetune, size=self.size, peak_window_bytes=peak,
                           flops_per_s=(n - profile) * self.step_flops / (wall - traced_s))
        return {"metrics": {"train_img_per_s": n * self.batch / wall}, "attempted": n,
                "failed": 0, "peak_window_bytes": peak, "summary": summary}

    def release(self) -> None:
        """Free the program's state; keep the checked batches and readings,
        and the leaves' change over the checked steps."""
        self.model = self.optimizer = self.state = self.step = None
        self.batches = self.batches[:CHECKED_STEPS]
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        start = data.weights(self.shape, self.finetune, self.seed, self.device)
        self.readings["change"] = {n: float((self._after[n] - start[n]).double().norm())
                                   for n in self.trainable}
        self._after = start = None

    def reference(self, precision: str = "f32") -> dict:
        """The readings of the plain step, from the same weights, batches
        and dropout draws, in ``precision``."""
        if self.device.type == "cuda":
            R.f32_mode()
        W = data.weights(self.shape, self.finetune, self.seed, self.device)
        tr = self.cell.traffic
        out = train_steps(W, self.shape, self.finetune, self.batches, self.trainable,
                          seed=self.seed, lr=self.lr, weight_decay=float(tr["weight_decay"]),
                          size=self.size, precision=R.Precision(precision))
        return {"steps": out["steps"], "grad1": compare.leaf_norms(out["grad1"]),
                "grad1_t": out["grad1"],
                "change": {n: float((W[n] - out["start"][n]).double().norm()) for n in self.trainable}}

    def check(self) -> dict:
        return compare.train_gaps(self.readings, self.reference("f32"))


def _planted(step, fault: str | None, model, optimizer):
    """The train step, or the step with ``fault`` planted in it."""
    if fault is None:
        return step
    if fault == "half_batch":
        def half(state, batch, *rest):
            b = batch["image"].shape[0] // 2
            return step(state, {k: v[:b] for k, v in batch.items()}, *rest)
        return half
    if fault == "unchanged_state":
        def unchanged(state, batch, *rest):
            with torch.no_grad():
                saved = [p.detach().clone() for p in model.parameters()]
            opt_state = {p: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                         for p, s in optimizer.state.items()}
            weight, count = state.loss_weight, state.step
            state, stats = step(state, batch, *rest)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            optimizer.state.clear()
            optimizer.state.update(opt_state)
            state.loss_weight, state.step = weight, count
            return state, stats
        return unchanged
    raise ValueError(f"unknown fault {fault!r}")
