"""Configuration system (the port's own copy of dino_pose_tpu/config.py).

The public schema is four plain dicts — ``config_dataset``, ``config_training``,
``config_preproc``, ``config_model`` — with the exact key names of the reference
project's ``config/config.py``, so user config files written for it work
unchanged. Internally they are typed dataclasses; the dicts are views produced
by :func:`as_dicts`.

:func:`load_config_file` imports the given Python file and uses its
``get_default_configs``. A file that only returns the four dicts loads
unchanged; the port's default file is ``dino_pose_tpu_torch/configs/config.py``
(the repository's ``config/config.py`` imports the JAX package's config).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from typing import Any, Tuple

ConfigDicts = Tuple[dict, dict, dict, dict]


@dataclasses.dataclass
class DatasetConfig:
    train_images_dir: str = ""
    train_annotation_json: str = ""
    val_images_dir: str = ""
    val_annotation_json: str = ""


@dataclasses.dataclass
class PreprocConfig:
    pre_crop: bool = True
    is_scale: bool = True
    random_resize_min: float = 0.7
    random_resize_max: float = 1.3
    is_rotate: bool = True
    rotate_min_degree: float = -45.0
    rotate_max_degree: float = 45.0
    is_flipping: bool = True
    is_resize_shortest_edge: bool = True
    is_crop: bool = True
    is_occultation: bool = True
    # Present in the reference schema but never read there (sigma is fixed at
    # 15px); kept for schema compatibility. The heatmaps use the fixed sigma.
    heatmap_std: float = 0.5


@dataclasses.dataclass
class TrainingConfig:
    batch_size: int = 32
    learning_rate: float = 3e-5
    weight_decay: float = 1e-6
    num_epochs: int = 100
    multiprocessing_num: int = 4
    save_freq: int = 10
    checkpoint_dir: str = "checkpoints"


@dataclasses.dataclass
class ModelConfig:
    model_name: str = "facebook/dinov2-small"
    load_model: str = ""
    num_keypoints: int = 24
    unfreeze_last_n_layers: int = 4
    use_lora: bool = True
    lora_rank: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.1
    output_heatmap_size: int = 48


@dataclasses.dataclass
class Config:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    preproc: PreprocConfig = dataclasses.field(default_factory=PreprocConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)


def as_dicts(cfg: Config) -> ConfigDicts:
    """Render a :class:`Config` into the reference 4-dict schema (same order)."""
    return (
        dataclasses.asdict(cfg.dataset),
        dataclasses.asdict(cfg.training),
        dataclasses.asdict(cfg.preproc),
        dataclasses.asdict(cfg.model),
    )


def _filtered(cls, d: dict) -> Any:
    """Build dataclass ``cls`` from dict ``d``, ignoring unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def from_dicts(
    config_dataset: dict,
    config_training: dict,
    config_preproc: dict,
    config_model: dict,
) -> Config:
    """Parse the reference 4-dict schema into a typed :class:`Config`.

    Unknown keys are ignored (forward compatibility with user config files).
    """
    return Config(
        dataset=_filtered(DatasetConfig, config_dataset),
        training=_filtered(TrainingConfig, config_training),
        preproc=_filtered(PreprocConfig, config_preproc),
        model=_filtered(ModelConfig, config_model),
    )


def get_default_configs() -> ConfigDicts:
    """Default configuration in the reference 4-dict schema."""
    return as_dicts(Config())


def load_config_file(path: str | None) -> ConfigDicts:
    """Load configs from a Python file exposing ``get_default_configs()``.

    Falls back to the built-in defaults when ``path`` is empty/missing.
    """
    if not path:
        return get_default_configs()
    p = pathlib.Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"Config file not found: {path}")
    spec = importlib.util.spec_from_file_location("user_config", p)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    return module.get_default_configs()
