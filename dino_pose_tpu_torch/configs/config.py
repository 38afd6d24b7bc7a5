"""Default training configuration of the port (reference-schema 4-dict format).

The same settings as the repository's ``config/config.py``, written against
the port's own ``config`` module (that file imports the JAX package's).
``python -m dino_pose_tpu_torch.cli.train`` loads this file unless
``--config_file`` names another; any Python file defining
``get_default_configs() -> (dataset, training, preproc, model)`` works.
"""

from dino_pose_tpu_torch.config import Config, DatasetConfig, as_dicts


def get_default_configs():
    cfg = Config()
    cfg.dataset = DatasetConfig(
        train_images_dir="data/pose/train/images",
        train_annotation_json="data/pose/train/annotation.json",
        val_images_dir="data/pose/valid/images",
        val_annotation_json="data/pose/valid/annotation.json",
    )
    cfg.training.checkpoint_dir = "checkpoints/dinov2_hg_skip"
    return as_dicts(cfg)
