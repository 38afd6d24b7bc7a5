"""Checkpoint save/load in the reference's ``.pth`` format (counterpart of
dino_pose_tpu/io/checkpoint.py).

The metadata schema is the reference checkpoint subsystem's, as the JAX
package writes it: epoch, losses, ``loss_weight``, all three configs,
``model_architecture``; ``load_model_smart`` rebuilds the architecture from
the checkpoint alone and ``get_model_info`` reads the metadata only.

``.pth`` is the port's native format. ``model_state_dict`` holds f32 tensors
under the reference torch keys (the port's modules carry them, so the file
loads into them and into the JAX package's ``load_model_smart`` alike), with
the BatchNorm ``num_batches_tracked`` counts beside them. What resume needs
rides in the same file: ``optimizer_state_dict`` is AdamW's own state dict
(the reference schema's key; the JAX package writes ``{}`` there), and
``step``, ``loss_weight_state`` and ``scheduler_state_dict`` sit beside it.
A ``.pth`` written by the JAX package therefore resumes its weights, epoch,
loss weight and scheduler, and starts AdamW's moments at zero. flax's
``.msgpack`` is the JAX package's own format and is refused.

Under a multi-process launch only the primary writes (``save_checkpoint``
returns at once on the other ranks, the async writer included), and
``latest_checkpoint`` is the primary's answer, broadcast: on a filesystem
the ranks do not share, theirs could differ.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import torch
from torch import nn

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.models import registry
from dino_pose_tpu_torch.train.schedule import PlateauState
from dino_pose_tpu_torch.train.weighting import LossWeightState

# Reference class names, used in checkpoint metadata so that the reference's
# 'LoRA' in class_name detection keeps working.
_REFERENCE_CLASS_NAMES = {
    ("dinov2", False): "Dinov2PoseModel",
    ("dinov2", True): "Dinov2PoseModelLoRA",
    ("fastvit", False): "FastVitPoseModel",
    ("fastvit", True): "FastVitPoseModelLoRA",
}


def model_family(model: nn.Module) -> str:
    return registry.BACKBONE_REGISTRY[model.model_name].family


def reference_class_name(model: nn.Module) -> str:
    return _REFERENCE_CLASS_NAMES[(model_family(model), _uses_lora(model))]


def _uses_lora(model: nn.Module) -> bool:
    return bool(model.config_model.get("use_lora", False))


def _enhanced_config_model(model: nn.Module, config_model: dict) -> dict:
    cfg = dict(config_model)
    cfg["model_class"] = reference_class_name(model)
    cfg["model_type"] = "lora" if _uses_lora(model) else "standard"
    cfg["model_family"] = model_family(model)
    return cfg


def _architecture(model: nn.Module) -> dict:
    return {
        "class_name": reference_class_name(model),
        "num_keypoints": model.num_keypoints,
        "backbone": model.model_name,
        "heatmap_size": model.heatmap_size,
    }


def _host(obj):
    """A copy on the host of every tensor in a nest of dicts, lists and
    tuples; other leaves as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


class AsyncCheckpointWriter:
    """Non-blocking checkpoint saves for the training loop.

    :func:`save_checkpoint` copies the parameters, the optimizer state and
    the loss-weight state to host memory on the caller's thread before it
    returns: AdamW updates the parameters and its moments in place, so the
    next step would otherwise change what is being written. Serialization
    and disk IO run on one worker thread, in save order.

    ``wait()`` drains pending writes and re-raises the first failure; the
    trainer calls it before finishing.
    """

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: list[cf.Future] = []

    def submit(self, fn, *args, **kwargs) -> None:
        # Surface an already-failed earlier write now rather than at wait().
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()
        self._pending.append(self._pool.submit(fn, *args, **kwargs))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        errors = []
        for f in pending:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — gather, then re-raise
                errors.append(e)
        if len(errors) == 1:
            raise errors[0]
        if errors:
            raise RuntimeError(
                f"{len(errors)} checkpoint writes failed; first: {errors[0]!r}"
            ) from errors[0]


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def _require_pth(path: str) -> None:
    if not path.endswith(".pth"):
        raise ValueError(
            f"{path}: the port reads and writes .pth checkpoints only "
            "(.msgpack is the JAX package's flax format)"
        )


def save_checkpoint(
    save_path: str | os.PathLike,
    model: nn.Module,
    *,
    state=None,
    epoch: int = 0,
    train_loss: float = 0.0,
    valid_loss: float = 0.0,
    config_training: dict | None = None,
    config_preproc: dict | None = None,
    scheduler: PlateauState | None = None,
    loss_weight: float | None = None,
    async_writer: AsyncCheckpointWriter | None = None,
) -> None:
    """Save ``model`` (and, with ``state``, a ``train.state.TrainState``'s
    optimizer, step and loss-weight state) to a ``.pth`` file.

    Every tensor is copied to the host before this returns; with
    ``async_writer`` the file is written on its thread (call
    ``async_writer.wait()`` before relying on it). ``loss_weight`` overrides
    the scalar ``loss_weight`` field; with a ``state`` it defaults to the
    best-validation weight, as the reference saves it, else 0.1. Only the
    primary process writes: elsewhere this returns at once."""
    path = os.fspath(save_path)
    _require_pth(path)
    if not distributed.is_primary():
        return
    state_dict = {
        k: v.detach().to("cpu", torch.float32 if v.is_floating_point() else v.dtype, copy=True)
        for k, v in model.state_dict().items()
    }
    if loss_weight is None:
        loss_weight = float(state.loss_weight.best_weight) if state is not None else 0.1
    checkpoint = {
        "epoch": int(epoch),
        "model_state_dict": state_dict,
        "optimizer_state_dict": _host(state.optimizer.state_dict()) if state is not None else {},
        "train_loss": float(train_loss),
        "valid_loss": float(valid_loss),
        "loss_weight": float(loss_weight),
        "config_model": _enhanced_config_model(model, model.config_model),
        "config_training": dict(config_training or {}),
        "config_preproc": dict(config_preproc or {}),
        "model_architecture": _architecture(model),
    }
    if state is not None:
        checkpoint["step"] = int(state.step)
        checkpoint["loss_weight_state"] = _host(dataclasses.asdict(state.loss_weight))
    if scheduler is not None:
        checkpoint["scheduler_state_dict"] = scheduler.state_dict()
    if async_writer is not None:
        async_writer.submit(_write, checkpoint, path)
    else:
        _write(checkpoint, path)
    print(f"Saved checkpoint to {path}")


def _write(checkpoint: dict, path: str) -> None:
    # Atomic: a kill mid-save must not leave a truncated .pth behind.
    tmp = f"{path}.tmp"
    torch.save(checkpoint, tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def load_checkpoint(path: str | os.PathLike) -> dict:
    """Read a ``.pth`` checkpoint into a plain dict, tensors on the CPU,
    with torch's weights-only unpickler (tensors and plain containers: what
    the port and the JAX package write; no code in the file runs)."""
    path = os.fspath(path)
    _require_pth(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _model_from_ckpt_config(ckpt: dict) -> dict:
    if "config_model" in ckpt:
        return dict(ckpt["config_model"])
    if "model_architecture" in ckpt:
        arch = ckpt["model_architecture"]
        return {
            "model_name": arch["backbone"],
            "num_keypoints": arch["num_keypoints"],
            "output_heatmap_size": arch["heatmap_size"],
            "use_lora": "LoRA" in arch["class_name"],
        }
    raise ValueError("Checkpoint missing model configuration")


def load_weights(model: nn.Module, state_dict: dict) -> tuple[list[str], list[str]]:
    """Load a reference-schema state dict into ``model`` non-strictly;
    returns the (missing, unexpected) keys, BatchNorm's
    ``num_batches_tracked`` left out of both (the JAX package writes them
    as 0, and older files may lack them)."""
    result = model.load_state_dict(state_dict, strict=False)

    def keep(keys):
        return [k for k in keys if not k.endswith("num_batches_tracked")]

    return keep(result.missing_keys), keep(result.unexpected_keys)


def load_model_smart(
    model_path: str,
    eval_mode: bool = True,
    *,
    ckpt: dict | None = None,
    device: str | torch.device | None = None,
) -> nn.Module:
    """Build a model from a ``.pth`` checkpoint, a registry name or a family
    name, on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``).

    A checkpoint rebuilds its architecture from the embedded config and loads
    its weights non-strictly, reporting missing or unexpected keys;
    registry/family names build a fresh model, its dinov2 backbone from the
    local DINOv2 cache where it has the weights (``pretrained``, as JAX's).
    ``ckpt`` lets a caller that already read the file skip a second read.
    The model comes back in eval mode, or train mode with
    ``eval_mode=False``."""
    dev = resolve_device(device)
    if os.path.isfile(model_path) and model_path.endswith((".pth", ".msgpack")):
        print(f"Loading model from checkpoint: {model_path}")
        ckpt = ckpt if ckpt is not None else load_checkpoint(model_path)
        # The checkpoint's weights replace the backbone's: no cache is read.
        model = registry.create_model_from_config(_model_from_ckpt_config(ckpt), device=dev,
                                                  pretrained=False)
        missing, unexpected = load_weights(model, ckpt["model_state_dict"])
        if missing:
            print(f"Warning: Missing keys in checkpoint: {missing}")
        if unexpected:
            print(f"Warning: Unexpected keys in checkpoint: {unexpected}")
        print(f"Loaded weights from epoch {ckpt.get('epoch', 'unknown')}")
    elif registry.is_supported_backbone(model_path) or registry.is_family_name(model_path):
        actual = registry.resolve_model_name(model_path)
        if registry.is_family_name(model_path):
            print(f"Using family '{model_path}' -> default model: {actual}")
        else:
            print(f"Creating new model with registered backbone: {actual}")
        config_model = dict(registry.BACKBONE_REGISTRY[actual].default_config)
        config_model["model_name"] = actual
        model = registry.create_model_from_config(config_model, device=dev)
    else:
        raise ValueError(
            f"Invalid model path: {model_path}. Expected a .pth file, family "
            f"name {list(registry.FAMILY_DEFAULTS)}, or supported backbone model "
            "name."
        )
    return model.eval() if eval_mode else model.train()


def restore_train_state(ckpt: dict, state, scheduler: PlateauState):
    """Resume the optimizer, step, loss-weight and scheduler state a
    checkpoint carries into ``state`` (a fresh ``TrainState`` of the loaded
    model). Returns ``(state, scheduler, start_epoch)``; an empty
    ``optimizer_state_dict`` (a JAX-written file) leaves AdamW fresh."""
    if ckpt.get("optimizer_state_dict"):
        state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    if "loss_weight_state" in ckpt:
        device = state.loss_weight.weight.device
        state.loss_weight = LossWeightState(
            **{k: torch.as_tensor(v).to(device) for k, v in ckpt["loss_weight_state"].items()}
        )
    if "step" in ckpt:
        state.step = int(ckpt["step"])
    if "scheduler_state_dict" in ckpt:
        scheduler = PlateauState.from_state_dict(
            {**scheduler.state_dict(), **ckpt["scheduler_state_dict"]}
        )
    return state, scheduler, int(ckpt.get("epoch", 0))


def get_model_info(model_path: str) -> dict:
    """Checkpoint metadata without building the model."""
    path = os.fspath(model_path)
    if not os.path.isfile(path) or not path.endswith(".pth"):
        raise ValueError(f"Invalid checkpoint path: {model_path}")
    ckpt = load_checkpoint(path)
    info = {
        "epoch": ckpt.get("epoch", "unknown"),
        "train_loss": ckpt.get("train_loss", "unknown"),
        "valid_loss": ckpt.get("valid_loss", "unknown"),
        "loss_weight": ckpt.get("loss_weight", "unknown"),
    }
    if "config_model" in ckpt:
        config = ckpt["config_model"]
        info.update(
            {
                "model_type": config.get("model_type", "unknown"),
                "backbone": config.get("model_name", "unknown"),
                "family": config.get("model_family", "unknown"),
                "num_keypoints": config.get("num_keypoints", "unknown"),
                "use_lora": config.get("use_lora", False),
                "heatmap_size": config.get("output_heatmap_size", "unknown"),
            }
        )
    if "model_architecture" in ckpt:
        arch = ckpt["model_architecture"]
        info.update({"class_name": arch.get("class_name", "unknown"), "architecture": arch})
    return info


def latest_checkpoint(checkpoint_dir: str | os.PathLike) -> str | None:
    """Most recent ``.pth`` checkpoint in a directory (auto-resume). Under a
    multi-process launch the primary's answer, broadcast: every rank must
    call it."""
    if distributed.world_size() > 1:
        latest = _latest(checkpoint_dir) if distributed.is_primary() else None
        return distributed.broadcast_string(latest)
    return _latest(checkpoint_dir)


def _latest(checkpoint_dir) -> str | None:
    try:
        files = [
            os.path.join(checkpoint_dir, f)
            for f in os.listdir(checkpoint_dir)
            if f.endswith(".pth")
        ]
    except FileNotFoundError:
        return None
    return max(files, key=os.path.getmtime) if files else None
