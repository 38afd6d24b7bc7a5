"""What the harness needs to know of the program under test
(``dino_pose_tpu_torch``): the ``config_model`` its registry builds from,
and the check that the model it built has the configuration's widths."""

from __future__ import annotations

import torch

from posebench.reference import spec as S


def program_config(cell, finetune: dict) -> dict:
    lora = cell.config["lora"]
    return {"model_name": cell.config["program"]["model_name"],
            "num_keypoints": cell.config["pose"]["num_keypoints"],
            "output_heatmap_size": cell.config["pose"]["heatmap_size"],
            "use_lora": bool(finetune.get("use_lora", False)),
            "unfreeze_last_n_layers": int(finetune.get("unfreeze_last_n_layers", 0)),
            "lora_rank": lora["rank"], "lora_alpha": lora["alpha"], "lora_dropout": lora["dropout"]}


def check_widths(model, shape: S.ModelShape) -> None:
    """The built model has the configuration's published widths."""
    vit = model.vit
    got = (vit.hidden_size, vit.num_layers, vit.num_heads, vit.mlp_ratio, vit.patch_size,
           vit.pos_grid, model.num_keypoints, model.heatmap_size)
    want = (shape.hidden, shape.layers, shape.heads, shape.mlp_ratio, shape.patch,
            shape.pos_grid, shape.keypoints, shape.heatmap)
    if got != want:
        raise ValueError(f"the program built {got}, the configuration states {want}")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
