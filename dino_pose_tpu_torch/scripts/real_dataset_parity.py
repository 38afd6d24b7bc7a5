"""One-command real-dataset parity harness (counterpart of
scripts/real_dataset_parity.py).

The reference's accuracy target ("PCK@0.2 parity") needs the custom
24-keypoint COCO dataset with ``keypoints_z``. Given it (and optionally a
checkpoint trained by the reference), this runs the reference protocol,
train (unless ``--eval-only``) then evaluate, on the card:

    python -m dino_pose_tpu_torch.scripts.real_dataset_parity \
        --train-images DIR --train-ann FILE --val-images DIR --val-ann FILE \
        [--reference-checkpoint best_model.pth] [--eval-only] [--epochs N] \
        [--model NAME] [--device cpu]

and writes ``parity_report.json`` and ``parity_report.md`` with PCKh@0.5
(2D), PCKh@0.5 (z) and PCK@0.2-bbox over the val set for the checkpoint
trained here (``final_model.pth``) or given by ``--checkpoint`` and, with
``--reference-checkpoint``, the same metrics of the reference's ``.pth``
(loaded natively: the port's modules carry the reference's key names) side
by side, with their difference. Checkpoints are ``.pth``; ``.msgpack`` (the
JAX package's format) is refused. ``--synthetic-dry-run`` writes the
coloured-blob dataset of ``accuracy_trajectory.make_dataset`` (32 images)
and drives the whole path on it for at most 2 epochs.

Runs on the card (``--device cuda``, the default; raises without one) unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def evaluate_checkpoint(ckpt_path: str, val_images: str, val_ann: str,
                        batch_size: int = 32, *, device=None) -> dict:
    """The reference evaluation protocol on one ``.pth`` checkpoint."""
    from dino_pose_tpu_torch.io import checkpoint as ck
    from dino_pose_tpu_torch.train.evaluate import compute_pckh_dataset

    model = ck.load_model_smart(ckpt_path, device=device)
    metrics = compute_pckh_dataset(
        model, val_images, val_ann, batch_size=batch_size, return_all=True
    )
    return {k: float(v) for k, v in metrics.items()}


def run(args) -> dict:
    from dino_pose_tpu_torch.config import get_default_configs
    from dino_pose_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    report: dict = {"dataset": {"val_images": args.val_images, "val_ann": args.val_ann}}

    config_dataset, config_training, config_preproc, config_model = get_default_configs()
    config_model.update(model_name=args.model)

    trained_ckpt = None
    if not args.eval_only:
        from dino_pose_tpu_torch.train.loop import fit

        config_dataset.update(
            train_images_dir=args.train_images,
            train_annotation_json=args.train_ann,
            val_images_dir=args.val_images,
            val_annotation_json=args.val_ann,
        )
        config_training.update(
            batch_size=args.batch_size,
            num_epochs=args.epochs,
            checkpoint_dir=args.out_dir,
            save_freq=max(1, min(args.epochs, config_training.get("save_freq", 10))),
            multiprocessing_num=args.num_workers,
            auto_resume=False,
        )
        if args.resume:
            config_model.update(load_model=args.resume)
        history = fit(
            config_dataset, config_training, config_preproc, config_model,
            device=dev, progress=False,
        )
        report["train"] = {
            "epochs": args.epochs,
            "final_train_loss": history["train_loss"][-1] if history["train_loss"] else None,
            "final_val_loss": history["val_loss"][-1] if history["val_loss"] else None,
        }
        trained_ckpt = os.path.join(args.out_dir, "final_model.pth")

    if trained_ckpt:
        print(f"[parity] evaluating framework-trained checkpoint {trained_ckpt}")
        report["framework"] = evaluate_checkpoint(
            trained_ckpt, args.val_images, args.val_ann, args.batch_size, device=dev
        )
    elif args.checkpoint:
        print(f"[parity] evaluating checkpoint {args.checkpoint}")
        report["framework"] = evaluate_checkpoint(
            args.checkpoint, args.val_images, args.val_ann, args.batch_size, device=dev
        )

    if args.reference_checkpoint:
        print(f"[parity] evaluating reference checkpoint {args.reference_checkpoint}")
        report["reference"] = evaluate_checkpoint(
            args.reference_checkpoint, args.val_images, args.val_ann, args.batch_size,
            device=dev
        )
        if "framework" in report:
            report["delta"] = {
                k: report["framework"][k] - report["reference"][k]
                for k in report["framework"]
                if k in report["reference"]
            }
    return report


def write_report(report: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1)

    rows = sorted(
        {k for side in ("framework", "reference") for k in report.get(side, {})}
    )
    lines = ["# Real-dataset parity report", ""]
    if "train" in report:
        t = report["train"]
        lines += [
            f"Trained {t['epochs']} epochs — final train loss "
            f"{t['final_train_loss']}, val loss {t['final_val_loss']}.", "",
        ]
    if rows:
        header = "| metric | framework |"
        sep = "|---|---|"
        if "reference" in report:
            header += " reference | delta |"
            sep += "---|---|"
        lines += [header, sep]
        for k in rows:
            row = f"| {k} | {report.get('framework', {}).get(k, '—')} |"
            if "reference" in report:
                row += (
                    f" {report.get('reference', {}).get(k, '—')} |"
                    f" {report.get('delta', {}).get(k, '—')} |"
                )
            lines.append(row)
    with open(os.path.join(out_dir, "parity_report.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[parity] report written to {out_dir}/parity_report.{{json,md}}")
    print(json.dumps({k: v for k, v in report.items() if k != "dataset"}, indent=1))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-images")
    ap.add_argument("--train-ann")
    ap.add_argument("--val-images")
    ap.add_argument("--val-ann")
    ap.add_argument("--model", default="facebook/dinov2-small")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-workers", type=int, default=4)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "real_dataset_parity"))
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate --checkpoint / --reference-checkpoint")
    ap.add_argument("--checkpoint", help="checkpoint of this framework to evaluate (.pth)")
    ap.add_argument("--reference-checkpoint",
                    help="reference-trained .pth for side-by-side parity")
    ap.add_argument("--resume", help="checkpoint to fine-tune from")
    ap.add_argument("--synthetic-dry-run", action="store_true",
                    help="generate the synthetic dataset and drive the whole "
                         "harness on it (no real dataset needed)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, run the protocol and write the report; returns it."""
    ap = build_parser()
    args = ap.parse_args(argv)
    from dino_pose_tpu_torch.core.device import resolve_device

    resolve_device(args.device)  # refuse before writing anything
    if args.synthetic_dry_run:
        from dino_pose_tpu_torch.scripts.accuracy_trajectory import make_dataset

        data_dir = os.path.join(args.out_dir, "data")
        if not os.path.exists(os.path.join(data_dir, "ann.json")):
            make_dataset(data_dir, n_images=32)
        args.train_images = args.val_images = os.path.join(data_dir, "images")
        args.train_ann = args.val_ann = os.path.join(data_dir, "ann.json")
        args.epochs = min(args.epochs, 2)
    if not (args.val_images and args.val_ann):
        ap.error("--val-images/--val-ann are required (or --synthetic-dry-run)")
    if not args.eval_only and not (args.train_images and args.train_ann):
        ap.error("--train-images/--train-ann are required unless --eval-only")

    report = run(args)
    write_report(report, args.out_dir)
    return report


if __name__ == "__main__":
    main()
