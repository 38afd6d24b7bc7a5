"""The training loop: epochs, validation, PCKh-gated checkpointing, metrics
(counterpart of dino_pose_tpu/train/loop.py).

The control flow is the reference trainer's, as the JAX package's ``fit``
runs it: an initial PCKh baseline, per-epoch train + validation passes,
ReduceLROnPlateau on the validation loss, best-weight tracking, PCKh-gated
checkpoint saves every ``save_freq`` epochs, a final save and a loss plot.
Underneath:

- one train step, ``train/step.prepare_batch(make_train_step(...))``, with
  the kernels on; Gaussian heatmap targets rendered on the device inside it,
  and device-warp batches (``config_training["device_warp"]``) warped there;
- the dynamic loss-weighting EMA kept on the device (no per-step host
  syncs): the epoch's statistics come back to the host once, at its end;
- the threaded host input pipeline with prefetch (``data/dataset.py``);
- structured CSV metrics (loss components, weight, lr, PCKh, images/sec,
  input wait) next to the checkpoints, in the JAX package's columns.

Validation batches are *augmented and shuffled*, as the reference builds its
val loader through the same ``create_dataloaders``; short tail batches are
zero-padded to the batch size and masked out of the loss.

Across processes (``torchrun``, or JAX's or SLURM's launch variables, see
``core/distributed.py``) every rank trains one model over the global batch
``config_training["batch_size"]``, as JAX's ``fit`` does: each rank loads
its data shard of both loaders (``batch_size / dp`` a step), the step
all-reduces what the global batch's step needs (``train/step.py``), the
PCKh evaluation splits the images over the ranks, and only the primary
writes the metrics, checkpoints and the loss plot. Resume is the primary's:
it resolves the checkpoint, a rank without the file builds a placeholder,
a digest guard checks that every rank's state has one structure, and the
primary's state is broadcast.

Departures from the JAX loop: checkpoints are ``.pth`` only (the native
format, with the optimizer state inside, so a ``.pth`` resumes AdamW too);
the persistent compilation cache has no counterpart (the kernels build once
into ``dino_pose_tpu_torch/build/``); ``tqdm`` and ``matplotlib`` are used
when they import; the mesh is data-parallel across processes: a model axis
that spans ranks raises (``ROADMAP.md``), while ``mesh=MeshSpec(1, tp)`` in
one process trains on the one-card tensor-parallel route.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.core.device import resolve_device
from dino_pose_tpu_torch.core.mesh import MeshSpec, create_mesh
from dino_pose_tpu_torch.core.precision import policy_for_device
from dino_pose_tpu_torch.data.dataset import create_dataloaders, pad_batch
from dino_pose_tpu_torch.io import checkpoint as ck
from dino_pose_tpu_torch.models import registry
from dino_pose_tpu_torch.ops import dispatch
from dino_pose_tpu_torch.train import weighting
from dino_pose_tpu_torch.train.evaluate import compute_pckh_dataset
from dino_pose_tpu_torch.train.schedule import PlateauState, plateau_step
from dino_pose_tpu_torch.train.state import create_train_state
from dino_pose_tpu_torch.train.step import make_eval_step, make_train_step, prepare_batch
from dino_pose_tpu_torch.utils.profiling import StepTimer, enable_nan_checks, trace

class MetricsWriter:
    """Append-only CSV metrics log."""

    FIELDS = [
        "epoch", "train_loss", "train_kp_loss", "train_z_loss",
        "val_loss", "val_kp_loss", "val_z_loss", "weight", "lr",
        "images_per_sec", "input_wait_s", "pckh_2d", "pckh_3d",
    ]

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.DictWriter(f, self.FIELDS).writeheader()

    def write(self, row: dict) -> None:
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, self.FIELDS, extrasaction="ignore").writerow(
                {k: row.get(k, "") for k in self.FIELDS}
            )


def _epoch_mean(per_step: list[dict]) -> dict:
    """One host transfer for a whole epoch of step statistics."""
    if not per_step:
        return {}
    keys = list(per_step[0])
    host = torch.stack([torch.stack([s[k].float() for k in keys]) for s in per_step]).cpu().numpy()
    return {k: float(np.mean(host[:, i])) for i, k in enumerate(keys)}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _progress_bar(enabled: bool, total: int, desc: str):
    if not enabled:
        return None
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm(total=total, desc=desc, leave=False)


def fit(
    config_dataset: dict,
    config_training: dict,
    config_preproc: dict,
    config_model: dict,
    *,
    device: str | torch.device | None = None,
    mesh: MeshSpec | None = None,
    export_pth: bool = True,
    progress: bool = True,
    num_epochs: int | None = None,
) -> dict[str, Any]:
    """Train a pose model end to end on ``device`` (default ``cuda``, this
    rank's card under a launch; raises without a card unless
    ``device="cpu"``); returns the history dict.

    Under a multi-process launch (``core/distributed.py``) every rank calls
    this and trains one model over the global batch ``config_training
    ["batch_size"]``; an incomplete launch raises. ``mesh`` (default: every
    process a data shard) is the ``('data', 'model')`` mesh: in one process
    ``MeshSpec(1, tp)`` trains on the one-card tensor-parallel route; a
    model axis across ranks raises. The mesh is recorded for this call only
    (``ops/dispatch.scoped``).

    Checkpoints go to ``config_training["checkpoint_dir"]`` as ``.pth``
    files; ``export_pth`` is kept for the JAX signature and has nothing to
    skip here, where ``.pth`` is the native format. ``config_model
    ["load_model"]`` names a ``.pth`` to start from; without it the latest
    ``.pth`` in the checkpoint directory is resumed
    (``config_training["auto_resume"]``, on by default). ``num_epochs``
    overrides ``config_training["num_epochs"]``, the epoch to stop at."""
    distributed.maybe_initialize_distributed(device)
    dev = resolve_device(device)
    with dispatch.scoped():
        return _fit(config_dataset, config_training, config_preproc, config_model, dev=dev,
                    mesh=mesh, progress=progress, num_epochs=num_epochs)


def _fit(config_dataset: dict, config_training: dict, config_preproc: dict,
         config_model: dict, *, dev: torch.device, mesh: MeshSpec | None, progress: bool,
         num_epochs: int | None) -> dict[str, Any]:
    world = distributed.world_size()
    if world > 1 and mesh is not None and mesh.tp > 1:
        raise NotImplementedError(
            f"fit trains data-parallel across processes; a model axis across ranks "
            f"({mesh}) is left for later (ROADMAP.md, Queue 1 item 8)"
        )
    grid = create_mesh(mesh, device=dev)
    checkpoint_dir = config_training["checkpoint_dir"]
    os.makedirs(checkpoint_dir, exist_ok=True)
    # batch_size is the GLOBAL batch; each data shard loads its slice.
    batch_size = int(config_training["batch_size"])
    if batch_size % grid.data_size:
        raise ValueError(f"batch_size={batch_size} must divide evenly over "
                         f"{grid.data_size} data shards")
    local_batch = batch_size // grid.data_size
    shard = world > 1
    workers = config_training.get("multiprocessing_num", 4)
    name = f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""
    print(f"Using device: {dev}{name}, mesh {grid}"
          + (f" across {world} processes" if shard else ""))

    print(f"Creating dataloader for {config_dataset['train_images_dir']}...")
    device_warp = bool(config_training.get("device_warp", False))
    train_loader = create_dataloaders(
        config_preproc, config_model,
        images_dir_path=config_dataset["train_images_dir"],
        annotation_json_path=config_dataset["train_annotation_json"],
        batch_size=local_batch, num_workers=workers,
        render_targets=False,  # targets render on the device inside the step
        device_warp=device_warp, shard_by_process=shard,
    )
    val_loader = None
    if config_dataset.get("val_images_dir") and config_dataset.get("val_annotation_json"):
        print(f"Creating dataloader for {config_dataset['val_images_dir']}...")
        val_loader = create_dataloaders(
            config_preproc, config_model,
            images_dir_path=config_dataset["val_images_dir"],
            annotation_json_path=config_dataset["val_annotation_json"],
            batch_size=local_batch, num_workers=workers,
            render_targets=False,
            # Evaluate every sample: the short tail batch is padded to the
            # batch size and masked via 'sample_valid'.
            drop_last=False, shard_by_process=shard,
        )
        if len(val_loader) == 0:
            print(
                "Warning: validation dataset is empty — no validation loss, "
                "LR plateau scheduling, or PCKh-gated checkpointing will run."
            )
            val_loader = None

    # Model: fresh, loaded from a checkpoint, or auto-resumed from the latest
    # checkpoint in checkpoint_dir (the primary's, broadcast).
    print(f"Creating model {config_model['model_name']}...")
    seed = int(config_training.get("seed", 0))
    load_path = config_model.get("load_model") or ""
    auto_resumed = False
    if not load_path and config_training.get("auto_resume", True):
        latest = ck.latest_checkpoint(checkpoint_dir)
        if latest:
            print(f"Auto-resuming from latest checkpoint: {latest}")
            load_path, auto_resumed = latest, True
    resume_ckpt = None
    if load_path.endswith((".pth", ".msgpack")) and not (
            auto_resumed and shard and not os.path.isfile(load_path)):
        resume_ckpt = ck.load_checkpoint(load_path)
        model = ck.load_model_smart(load_path, eval_mode=False, ckpt=resume_ckpt, device=dev)
    elif load_path.endswith((".pth", ".msgpack")):
        # A filesystem the ranks do not share: this rank never saw the
        # primary's file. A placeholder, which reads no cache; the broadcast
        # below replaces it.
        print("Checkpoint not on this host's filesystem; will receive resumed state "
              "from the primary process.")
        model = registry.create_model_from_config(config_model, seed=seed, device=dev,
                                                  pretrained=False)
    else:
        model = registry.create_model_from_config(config_model, seed=seed, device=dev)
    state, optimizer, partition = create_train_state(
        model, model.config_model, weight_decay=config_training.get("weight_decay", 1e-6))
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"Trainable parameters: {trainable:,}")
    if resume_ckpt is not None:
        state.loss_weight = weighting.LossWeightState.create(
            float(resume_ckpt.get("loss_weight", 0.1)), device=dev)

    # Async checkpointing (config_training['async_checkpoint']=True): the
    # tensors are copied to the host at the save, the file written on a
    # thread. Off by default, as the reference saves synchronously.
    ckpt_writer = ck.AsyncCheckpointWriter() if config_training.get("async_checkpoint") else None
    scheduler = PlateauState(
        lr=float(config_training["learning_rate"]),
        factor=float(config_training.get("lr_factor", 0.7)),
        patience=int(config_training.get("lr_patience", 3)),
        min_lr=float(config_training.get("min_lr", 1e-6)),
    )
    start_epoch = 0
    if resume_ckpt is not None:
        state, scheduler, start_epoch = ck.restore_train_state(resume_ckpt, state, scheduler)
        print(f"Resumed at epoch {start_epoch}, step {state.step}")
    if shard and load_path:
        # A placeholder is built from this run's config while the primary
        # restored the checkpoint's own: check that the structures agree
        # before the broadcast, which would otherwise fail opaquely or hang.
        distributed.check_same_structure(
            distributed.state_description(model, optimizer),
            "resume: the train state (the run's config does not match the checkpoint "
            "the primary restored, e.g. model_name or the LoRA settings changed)")
        # Every rank bit-identical to the primary's resumed state. A fresh
        # start needs no broadcast: the seeded init is the same everywhere.
        state.loss_weight, sync = distributed.broadcast_state(
            model, optimizer, state.loss_weight,
            [start_epoch, state.step, scheduler.lr, scheduler.best, scheduler.num_bad_epochs])
        start_epoch, state.step = int(sync[0]), int(sync[1])
        scheduler = dataclasses.replace(scheduler, lr=sync[2], best=sync[3],
                                        num_bad_epochs=int(sync[4]))
    if start_epoch:
        # Continue the loaders' per-epoch RNG streams instead of replaying
        # epochs 0..start_epoch-1's orders and augmentation draws.
        train_loader.set_epoch(start_epoch)
        if val_loader is not None:
            val_loader.set_epoch(start_epoch)

    device_targets = (model.input_size, model.heatmap_size)
    compute_dtype = policy_for_device(dev).compute_dtype
    train_step = prepare_batch(make_train_step(model, optimizer, partition),
                               device_targets=device_targets, compute_dtype=compute_dtype)
    eval_step = prepare_batch(make_eval_step(model),
                              device_targets=device_targets, compute_dtype=compute_dtype)
    metrics = (MetricsWriter(os.path.join(checkpoint_dir, "metrics.csv"))
               if distributed.is_primary() else None)
    if config_training.get("debug_nans"):
        enable_nan_checks()

    # Per epoch: losses, seconds, images/s and the StepTimer's split (input
    # wait, step dispatch, the closing drain); per PCKh evaluation (the
    # baseline first): (2D, 3D) and seconds; per save: seconds.
    history: dict[str, Any] = {"train_loss": [], "val_loss": [], "epoch_seconds": [],
                               "images_per_sec": [], "input_wait_s": [], "dispatch_s": [],
                               "drain_s": [], "pckh": [], "pckh_seconds": [],
                               "save_seconds": []}

    def run_pckh():
        t0 = time.perf_counter()
        out = compute_pckh_dataset(
            model, config_dataset["val_images_dir"], config_dataset["val_annotation_json"],
            batch_size=local_batch, num_workers=workers)
        history["pckh_seconds"].append(time.perf_counter() - t0)
        history["pckh"].append(out)
        return out

    def save(name, epoch):
        t0 = time.perf_counter()
        ck.save_checkpoint(
            os.path.join(checkpoint_dir, f"{name}.pth"), model, state=state, epoch=epoch,
            train_loss=train_loss, valid_loss=val_loss, config_training=config_training,
            config_preproc=config_preproc, scheduler=scheduler, async_writer=ckpt_writer)
        history["save_seconds"].append(time.perf_counter() - t0)

    best_pckh_2d = best_pckh_3d = 0.0
    if val_loader is not None:
        best_pckh_2d, best_pckh_3d = run_pckh()
        print(f"Starting training with PCKh (2D): {best_pckh_2d:.4f}, "
              f"PCKh (3D): {best_pckh_3d:.4f}")

    total_epochs = num_epochs if num_epochs is not None else config_training["num_epochs"]
    train_loss = val_loss = 0.0
    for epoch in range(start_epoch, total_epochs):
        # ---- train ----
        t0 = time.perf_counter()
        per_step = []
        images = 0
        timer = StepTimer()
        bar = _progress_bar(progress, len(train_loader), f"Epoch {epoch + 1} Training")
        profile_dir = config_training.get("profile_dir") if epoch == start_epoch else None
        with trace(profile_dir) if profile_dir else contextlib.nullcontext():
            for i, batch in enumerate(timer.iter(train_loader)):
                with timer.step():
                    state, stats = train_step(state, _to_device(batch, dev), scheduler.lr, seed)
                per_step.append(stats)
                images += len(batch["2d_keypoints"]) * grid.data_size  # the global batch
                if bar is not None:
                    bar.update(1)
                    if (i + 1) % 10 == 0:
                        bar.set_postfix({k: f"{float(stats[k]):.6f}"
                                         for k in ("loss", "kp_loss", "z_loss", "weight")})
            timer.drain(dev)
        if profile_dir:
            print(f"Profiler trace written to {profile_dir}")
        if bar is not None:
            bar.close()
        train_stats = _epoch_mean(per_step)
        elapsed = time.perf_counter() - t0
        images_per_sec = images / elapsed if elapsed > 0 else 0.0
        train_loss = train_stats.get("loss", 0.0)
        history["train_loss"].append(train_loss)
        history["epoch_seconds"].append(elapsed)
        history["images_per_sec"].append(images_per_sec)
        history["input_wait_s"].append(timer.input_wait)
        history["dispatch_s"].append(timer.step_time)
        history["drain_s"].append(timer.drain_time)
        print(
            f"Epoch {epoch + 1} - Loss: {train_loss:.4f}, "
            f"Keypoint Loss: {train_stats.get('kp_loss', 0.0):.4f}, "
            f"3D Loss: {train_stats.get('z_loss', 0.0):.4f}, "
            f"Elapsed Time: {elapsed:.2f}s ({images_per_sec:.1f} img/s)"
        )

        # ---- validation ----
        val_stats = {}
        if val_loader is not None:
            per_step = []
            for batch in val_loader:
                batch, valid = pad_batch(batch, local_batch)
                batch["sample_valid"] = valid.astype(np.float32)
                out = eval_step(state, _to_device(batch, dev))
                per_step.append({k: out[k] for k in ("loss", "kp_loss", "z_loss")})
            val_stats = _epoch_mean(per_step)
            val_loss = val_stats.get("loss", 0.0)
            history["val_loss"].append(val_loss)
            print(
                f"Validation - Loss: {val_loss:.4f}, "
                f"Keypoint Loss: {val_stats.get('kp_loss', 0.0):.4f}, "
                f"3D Loss: {val_stats.get('z_loss', 0.0):.4f}"
            )
            scheduler = plateau_step(scheduler, val_loss)
            state.loss_weight = weighting.update_best(
                state.loss_weight, torch.tensor(val_loss, dtype=torch.float32, device=dev))

        row = {
            "epoch": epoch + 1,
            "train_loss": train_loss,
            "train_kp_loss": train_stats.get("kp_loss", ""),
            "train_z_loss": train_stats.get("z_loss", ""),
            "val_loss": val_stats.get("loss", ""),
            "val_kp_loss": val_stats.get("kp_loss", ""),
            "val_z_loss": val_stats.get("z_loss", ""),
            "weight": train_stats.get("weight", ""),
            "lr": scheduler.lr,
            "images_per_sec": round(images_per_sec, 2),
            "input_wait_s": timer.summary()["input_wait_s"],
        }

        # ---- PCKh-gated checkpointing ----
        if (epoch + 1) % config_training["save_freq"] == 0 and val_loader is not None:
            p2d, p3d = run_pckh()
            print(f"Epoch {epoch + 1} - PCKh (2D): {p2d:.4f}, PCKh (3D): {p3d:.4f}")
            row["pckh_2d"], row["pckh_3d"] = round(p2d, 6), round(p3d, 6)
            if p2d > best_pckh_2d or p3d > best_pckh_3d:
                # epoch + 1 = COMPLETED epochs, as in the final save: resume
                # starts at this index.
                save(f"best_model_{epoch + 1}", epoch + 1)
            best_pckh_2d = max(best_pckh_2d, p2d)
            best_pckh_3d = max(best_pckh_3d, p3d)
        if metrics is not None:
            metrics.write(row)

    # ---- final save + loss plot ----
    save("final_model", total_epochs)
    if ckpt_writer is not None:
        ckpt_writer.wait()  # files must exist before fit returns
    _plot_losses(history, checkpoint_dir)
    print("Training complete!")
    history.update(state=state, model=model, best_pckh_2d=best_pckh_2d,
                   best_pckh_3d=best_pckh_3d)
    return history


def _plot_losses(history: dict, checkpoint_dir: str) -> None:
    if not distributed.is_primary():
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure(figsize=(10, 5))
    plt.plot(history["train_loss"], label="Train Loss")
    if history["val_loss"]:
        plt.plot(history["val_loss"], label="Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend()
    plt.title("Training and Validation Losses")
    plt.savefig(os.path.join(checkpoint_dir, "loss_plot.png"))
    plt.close()
