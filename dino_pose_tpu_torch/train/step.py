"""Train and eval steps (counterpart of dino_pose_tpu/train/step.py).

    state, optimizer, partition = create_train_state(model, config_model)
    step = prepare_batch(make_train_step(model, optimizer, partition),
                         device_targets=(224, 48), compute_dtype=torch.bfloat16)
    state, stats = step(state, batch, lr, seed)

One train step: heatmap targets rendered on the device from the (B, K, 3)
keypoints, pixels cast to the compute dtype, the train-mode forward
(BatchNorm on batch statistics, dropout), the masked losses, the dynamic
loss weights, backward and one AdamW step. ``stats`` holds 0-d device
tensors under the JAX step's keys; nothing is read back to the host.

Dropout randomness: the JAX step folds the step number into its key. Here a
device ``torch.Generator`` is seeded from (seed, step) by
:func:`step_generator`; the bits differ from JAX's, so parity tests run with
dropout off.

Across processes (a data axis of the recorded mesh spanning ranks, see
``core/distributed``) each rank runs the step on its shard of the global
batch and the step is the global batch's: the loss weights update from the
all-reduced global kp and z losses before the balanced loss is formed, each
rank backpropagates its part of the global loss, the trainable gradients
are summed over the data group before AdamW, and dropout masks are the
rank's rows of the global batch's. ``stats`` then hold the global values,
the same on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.data.heatmaps import render_heatmaps
from dino_pose_tpu_torch.data.warp import WARP_KEYS, warp_batch
from dino_pose_tpu_torch.train import weighting
from dino_pose_tpu_torch.train.losses import keypoint_loss, z_loss
from dino_pose_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one step: seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(step)) % 2**63)


def _global(kp: torch.Tensor, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The global kp and z losses from this rank's parts: summed over the
    data group, detached (one all-reduce); the parts themselves without a
    data axis."""
    if distributed.data_axis() is None:
        return kp, z
    return distributed.data_sum(torch.stack([kp.detach(), z.detach()])).unbind()


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    partition: frozenset[str],
    *,
    kernels: bool = True,
) -> Callable:
    """``train_step(state, batch, lr, seed) -> (state, stats)``. ``batch``
    holds device tensors: ``image`` (B, 3, H, W), ``2d_heatmaps``
    (B, K, hs, hs), ``2d_keypoints`` (B, K, 3), ``z_coords`` (B, K).
    ``kernels=False`` runs the blocks through their plain versions."""
    trainable = frozenset(n for n, p in model.named_parameters() if p.requires_grad)
    if trainable != partition:
        raise ValueError(
            "the model's requires_grad flags differ from the partition: "
            f"{sorted(trainable ^ partition)[:4]}"
        )
    device = next(model.parameters()).device
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: dict, lr: float, seed: int):
        generator = step_generator(seed, state.step, device)
        confidence = batch["2d_keypoints"][..., 2]
        model.train()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        pred_hm, pred_z = model(batch["image"], kernels=kernels, generator=generator)
        # This rank's parts of the global losses (the losses themselves in
        # one process); the weights update from the global values.
        kp_l = keypoint_loss(pred_hm, batch["2d_heatmaps"], confidence)
        z_l = z_loss(pred_z, batch["z_coords"], confidence)
        kp_g, z_g = _global(kp_l, z_l)
        lw = weighting.update(state.loss_weight, kp_g, z_g)
        loss = weighting.balanced_loss(lw, kp_l, z_l)
        loss.backward()
        # A trainable parameter that this input does not reach (the heads'
        # second upsampling stage, from a 24x24 patch grid up) gets a zero
        # gradient, as every trainable leaf does in the JAX step, so that
        # AdamW still decays it and counts the step.
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        distributed.all_reduce_grads(params)
        optimizer.step()

        kp_c, z_c = weighting.loss_contributions(lw, kp_g.detach(), z_g.detach())
        state.step += 1
        state.loss_weight = lw
        stats = {
            "loss": weighting.balanced_loss(lw, kp_g.detach(), z_g.detach()),
            "kp_loss": kp_g.detach(),
            "z_loss": z_g.detach(),
            "kp_contrib": kp_c,
            "z_contrib": z_c,
            "weight": lw.weight,
        }
        return state, stats

    return train_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """``eval_step(state, batch) -> dict``: eval-mode forward (running BN
    statistics, no dropout) and the validation loss ``kp + weight * z``.
    An optional (B,) ``sample_valid`` mask drops padded samples. Across
    processes the losses are the global batch's (the ranks' parts summed)
    and the predictions this rank's."""

    def eval_step(state: TrainState, batch: dict) -> dict:
        sample_valid = batch.get("sample_valid")
        confidence = batch["2d_keypoints"][..., 2]
        model.eval()
        with torch.inference_mode():
            pred_hm, pred_z = model(batch["image"])
            kp_l, z_l = _global(
                keypoint_loss(pred_hm, batch["2d_heatmaps"], confidence, sample_valid),
                z_loss(pred_z, batch["z_coords"], confidence, sample_valid))
            loss = weighting.validation_loss(state.loss_weight, kp_l, z_l)
        return {"loss": loss, "kp_loss": kp_l, "z_loss": z_l,
                "pred_heatmaps": pred_hm, "pred_z": pred_z}

    return eval_step


def prepare_batch(
    step_fn: Callable,
    device_targets: tuple[int, int] | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Callable:
    """Wrap a step: warp a device-warp batch's canvases into its pixels
    (``data/warp.warp_batch``, on the canvases' device), render the heatmap
    targets from ``2d_keypoints`` on the device
    (``device_targets=(input_size, heatmap_size)``) and cast the pixels to
    ``compute_dtype`` (bf16 on the card); targets and losses stay f32. A
    device-warp batch carries no targets, so it needs ``device_targets``."""

    def wrapped(state, batch, *rest):
        batch = dict(batch)
        if "canvas" in batch:
            if device_targets is None:
                raise ValueError(
                    "device_warp batches require device_targets=(input, "
                    "heatmap) so targets render in-step"
                )
            batch["image"] = warp_batch(
                *(batch.pop(k) for k in WARP_KEYS), model_input=device_targets[0]
            )
        if device_targets is not None:
            input_size, heatmap_size = device_targets
            batch["2d_heatmaps"] = render_heatmaps(
                batch["2d_keypoints"], height=input_size, width=input_size,
                heatmap_size=heatmap_size,
            )
        if compute_dtype is not None:
            batch["image"] = batch["image"].to(compute_dtype)
        return step_fn(state, batch, *rest)

    return wrapped
