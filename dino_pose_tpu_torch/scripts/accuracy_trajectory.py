"""Accuracy-trajectory harness (counterpart of scripts/accuracy_trajectory.py).

Overfits a pose model (default: dinov2-small, 24 keypoints, LoRA r=8,
spatial-aware heads) on a small synthetic COCO dataset whose pose is a
function of visible coloured blobs, and records the PCKh@0.5 (2D, z) and
PCK@0.2-bbox trajectory. It shows that the whole loop (targets rendered on
the device, masked losses, dynamic loss weighting, the plateau schedule held
at a constant learning rate, PCKh-gated checkpointing) and the kernels under
it optimise the right objective over hundreds of steps: PCK@0.2 must reach
~1.0 and PCKh@0.5 climb towards it.

    python -m dino_pose_tpu_torch.scripts.accuracy_trajectory [--epochs 150] [--out DIR]
        [--model timm/fastvit_t8.apple_in1k] [--device cpu]

Runs on the card (``--device cuda``, the default; raises without one) unless
``--device cpu`` is given. Record: ``DIR/ckpt/metrics.csv`` (+ the loss plot
where matplotlib imports) and ``DIR/trajectory.json`` with the JAX script's
keys (``final_metrics``, ``train_loss``, ``val_loss``, ``config``), the
loop's PCKh history (``pckh_history``) and, on the card, the card's name and
power limit as ``nvidia-smi`` reports them (``card``).

As in the JAX script, the preprocessing update names ``is_flipped``, which no
config reads (the flip switch is ``is_flipping``): horizontal flips stay on,
as they were in the recorded runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np

K = 24


def make_dataset(root: str, n_images: int, seed: int = 0) -> None:
    """Synthetic COCO-format dataset: textured 256² images whose 24
    keypoints are saturated blobs, one colour per keypoint index, around a
    canonical central pose with per-image jitter; z is a function of the
    keypoint index. The same ``n_images`` and ``seed`` write the same bytes
    as the JAX script's ``make_dataset`` (the same numpy draws, PIL encode
    and JSON)."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(seed)
    # A canonical skeleton keeps every image's top-neck distance (the PCKh
    # threshold's scale) sane, and central, where the evaluation's crop
    # frame and the training crop agree best.
    canon = np.zeros((K, 2))
    canon[:, 0] = rng.uniform(-55, 55, K)
    canon[:, 1] = rng.uniform(-55, 55, K)
    canon[0] = (0, -55)   # TOP
    canon[1] = (0, -25)   # NECK
    canon_z = rng.uniform(-40, 40, K)
    # One saturated colour per keypoint index: the pose is a function of
    # visible content, which a random frozen backbone can localise.
    hues = np.linspace(0.0, 1.0, K, endpoint=False)
    colors = np.stack(
        [
            255 * np.clip(np.abs(((hues * 6 + s) % 6) - 3) - 1, 0, 1)
            for s in (0, 4, 2)
        ],
        axis=1,
    ).astype(np.uint8)
    images, annotations = [], []
    for i in range(n_images):
        w = h = 256  # square: the crop offset (256 - 224) // 2 is exact
        base = rng.integers(0, 64, (32, 32, 3), dtype=np.uint8)  # dim backdrop
        img = np.asarray(
            Image.fromarray(base).resize((w, h), Image.BICUBIC), dtype=np.uint8
        ).copy()
        center = np.array([w / 2, h / 2]) + rng.uniform(-20, 20, 2)
        pose = center + canon + rng.normal(0, 6, (K, 2))  # per-image jitter
        pose[:, 0] = pose[:, 0].clip(8, w - 8)
        pose[:, 1] = pose[:, 1].clip(8, h - 8)
        yy, xx = np.mgrid[0:h, 0:w]
        for j in range(K):
            blob = (xx - pose[j, 0]) ** 2 + (yy - pose[j, 1]) ** 2 <= 36
            img[blob] = colors[j]
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.jpg"), quality=90)
        kps = np.concatenate([pose, np.full((K, 1), 2.0)], axis=1)
        images.append({"id": i, "file_name": f"{i}.jpg", "width": w, "height": h})
        annotations.append(
            {
                "id": i,
                "image_id": i,
                "num_keypoints": K,
                "keypoints": kps.reshape(-1).tolist(),
                "keypoints_z": (canon_z + rng.normal(0, 2, K)).tolist(),
            }
        )
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)


def trajectory_configs(data_dir: str, ckpt_dir: str, *, model: str, epochs: int,
                       batch_size: int, lr: float, save_freq: int):
    """The protocol's four config dicts: the port's defaults with train =
    val set, the geometric augmentations off (as the JAX script names
    them), a constant learning rate (``min_lr = lr``: the plateau
    schedule would otherwise decay it on the overfit's early val-loss
    plateau and freeze learning) and no auto-resume."""
    from dino_pose_tpu_torch.config import get_default_configs

    config_dataset, config_training, config_preproc, config_model = get_default_configs()
    images, ann = os.path.join(data_dir, "images"), os.path.join(data_dir, "ann.json")
    config_dataset.update(train_images_dir=images, train_annotation_json=ann,
                          val_images_dir=images, val_annotation_json=ann)
    config_preproc.update(
        is_scale=False, is_rotate=False, is_flipped=False, is_occultation=False,
        pre_crop=False,
    )
    config_training.update(
        batch_size=batch_size, num_epochs=epochs, learning_rate=lr, save_freq=save_freq,
        checkpoint_dir=ckpt_dir, multiprocessing_num=2, auto_resume=False, min_lr=lr,
    )
    config_model.update(model_name=model)
    return config_dataset, config_training, config_preproc, config_model


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--n-images", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--save-freq", type=int, default=10, help="PCKh eval cadence")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "accuracy_trajectory"))
    ap.add_argument("--data", default=None, help="reuse an existing dataset dir")
    ap.add_argument(
        "--model", default="facebook/dinov2-small",
        help="backbone (e.g. timm/fastvit_t8.apple_in1k for the FastViT family)",
    )
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    """Make the dataset (unless it exists), train, evaluate ``final_model.pth``
    and write ``trajectory.json``; returns the record with the loop's
    history under ``"history"`` (not written)."""
    args = build_parser().parse_args(argv)
    from dino_pose_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    data_dir = args.data or os.path.join(args.out, "data")
    if not os.path.exists(os.path.join(data_dir, "ann.json")):
        make_dataset(data_dir, args.n_images)
    ckpt_dir = os.path.join(args.out, "ckpt")

    from dino_pose_tpu_torch.io import checkpoint as ck
    from dino_pose_tpu_torch.train.evaluate import compute_pckh_dataset
    from dino_pose_tpu_torch.train.loop import fit

    configs = trajectory_configs(data_dir, ckpt_dir, model=args.model, epochs=args.epochs,
                                 batch_size=args.batch_size, lr=args.lr,
                                 save_freq=args.save_freq)
    config_dataset, config_model = configs[0], configs[3]
    history = fit(*configs, device=dev, progress=False, export_pth=False)

    # The final full-metric pass (adds PCK@0.2-bbox, which the loop's gate omits).
    model = ck.load_model_smart(os.path.join(ckpt_dir, "final_model.pth"), device=dev)
    full = compute_pckh_dataset(model, config_dataset["val_images_dir"],
                                config_dataset["val_annotation_json"], return_all=True)
    evals = [0] + [e for e in range(1, args.epochs + 1) if e % args.save_freq == 0]
    record = {
        "final_metrics": {k: float(v) for k, v in full.items()},
        "train_loss": history["train_loss"],
        "val_loss": history["val_loss"],
        "config": {
            "model": config_model["model_name"], "lora": True,
            "epochs": args.epochs, "batch_size": args.batch_size,
            "lr": args.lr, "n_images": args.n_images,
        },
        "pckh_history": [{"epoch": e, "pckh_2d": float(p2d), "pckh_3d": float(p3d)}
                         for e, (p2d, p3d) in zip(evals, history["pckh"])],
    }
    if dev.type == "cuda":
        record["card"] = card_line()
    with open(os.path.join(args.out, "trajectory.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("FINAL:", json.dumps(record["final_metrics"]))
    print(f"Record written to {args.out} (metrics.csv lives in {ckpt_dir})")
    return {**record, "history": history}


if __name__ == "__main__":
    main()
