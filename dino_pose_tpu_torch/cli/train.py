"""Training CLI (counterpart of dino_pose_tpu/cli/train.py).

    python -m dino_pose_tpu_torch.cli.train [--config_file FILE] [--num_epochs N]
    torchrun --nproc_per_node=8 -m dino_pose_tpu_torch.cli.train [...]

The given Python file's ``get_default_configs()`` is loaded; the default is
the port's own ``dino_pose_tpu_torch/configs/config.py`` (the repository's
``config/config.py`` imports the JAX package). Training runs on the card
(``train/loop.fit``) and raises without one. Under a multi-process launch
(torchrun's, JAX's or SLURM's variables, ``core/distributed.py``) each rank
runs this same command, on its own card, and together they train one
model over the global batch ``batch_size``; no flag is needed.
``--no_pth_export`` is parsed for the JAX CLI's flags and changes nothing:
``.pth`` is the port's native checkpoint format, so there is no second file
to skip.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_CONFIG_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "config.py"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train DINOv2 pose model")
    parser.add_argument(
        "--config_file",
        type=str,
        default=DEFAULT_CONFIG_FILE,
        help="model training config file",
    )
    parser.add_argument(
        "--num_epochs", type=int, default=None,
        help="override config_training['num_epochs']",
    )
    parser.add_argument(
        "--no_pth_export", action="store_true",
        help="accepted for the JAX CLI's flags; .pth is the native format, so nothing is skipped",
    )
    return parser


def main(argv=None) -> dict:
    """Parse ``argv``, load the config file and run ``fit``; returns its
    history."""
    args = build_parser().parse_args(argv)
    from dino_pose_tpu_torch.config import load_config_file
    from dino_pose_tpu_torch.train.loop import fit

    config_dataset, config_training, config_preproc, config_model = load_config_file(
        args.config_file
    )
    return fit(
        config_dataset,
        config_training,
        config_preproc,
        config_model,
        export_pth=not args.no_pth_export,
        num_epochs=args.num_epochs,
    )


if __name__ == "__main__":
    main()
