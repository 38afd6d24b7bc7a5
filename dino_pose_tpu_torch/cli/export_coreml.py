"""Export checkpoints for the CoreML/iOS deployment path (counterpart of
dino_pose_tpu/cli/export_coreml.py).

    python -m dino_pose_tpu_torch.cli.export_coreml -c CKPT.pth -o OUT(.pth|.mlpackage)

The reference exports by tracing its torch model with coremltools. This
tool writes the checkpoint in the reference's exact state-dict schema
(``io/checkpoint.save_checkpoint``, carrying epoch, losses, configs and loss
weight across), whose keys satisfy the reference exporter's family
detection, so the unmodified reference exporter converts it.
``-o model.mlpackage`` writes ``model.pth`` and prints the one command left
to run; nothing here imports coremltools.

The self-check forward runs in the device's compute dtype (bf16 on the
card, where the kernel wrappers refuse f32; f32 on the CPU), where JAX's
runs f32 zeros.

``detect_model_family`` reads the family and configuration from a bare
state dict's keys (family from key names, backbone size from the cls_token
width, LoRA rank from adapter shapes).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def detect_model_family(state_dict: dict) -> tuple[str, dict]:
    """Family + config from raw state-dict keys (reference heuristics)."""
    keys = list(state_dict.keys())
    key_str = " ".join(keys)
    config: dict = {"num_keypoints": 24, "heatmap_size": 48}

    is_lora = any(t in key_str for t in ("lora_A", "lora_B", ".lora.", "lora_dropout"))
    is_dinov2 = any(
        t in key_str for t in ("backbone.embeddings", "backbone.encoder", "backbone.layernorm")
    )
    is_fastvit = any(
        t in key_str for t in ("backbone.patch_embed", "backbone.stages", "backbone.norm")
    )

    if is_dinov2:
        dim = None
        for k in keys:
            if "backbone.embeddings.cls_token" in k:
                dim = int(np.asarray(state_dict[k]).shape[-1])
                break
        backbone = {384: "facebook/dinov2-small", 768: "facebook/dinov2-base",
                    1024: "facebook/dinov2-large"}.get(dim, "facebook/dinov2-small")
        config["backbone"] = backbone
        if is_lora:
            rank = 8
            for k in keys:
                if k.endswith("lora_A"):
                    rank = int(np.asarray(state_dict[k]).shape[-1])
                    break
                if "lora_A.weight" in k:
                    rank = int(np.asarray(state_dict[k]).shape[0])
                    break
            config.update({"lora_rank": rank, "lora_alpha": 16, "lora_dropout": 0.1})
            return "dinov2_lora", config
        config["unfreeze_last_n_layers"] = 0
        return "dinov2", config

    if is_fastvit:
        config["backbone"] = "fastvit_t8.apple_in1k"
        if is_lora:
            config.update({"lora_rank": 8, "lora_alpha": 16, "lora_dropout": 0.1})
            return "fastvit_lora", config
        return "fastvit", config

    return "unknown", config


def export(checkpoint_path: str, output_path: str, *, device=None) -> str:
    """Export ``checkpoint_path`` (a ``.pth``, or a registry or family name)
    for CoreML; returns the path written. ``device`` defaults to ``cuda``."""
    from dino_pose_tpu_torch.io import checkpoint as ck

    src = ck.load_checkpoint(checkpoint_path) if os.path.isfile(checkpoint_path) else {}
    model = ck.load_model_smart(checkpoint_path, ckpt=src or None, device=device)

    if output_path.endswith(".mlpackage"):
        # The .mlpackage conversion traces a torch module of the reference
        # with coremltools: write the reference-schema .pth and hand it to
        # the unmodified reference exporter (docs/EXPORT_COREML.md).
        pth_path = output_path[: -len(".mlpackage")] + ".pth"
        _write_pth(model, src, pth_path)
        print(
            f"Wrote the reference-schema checkpoint to {pth_path}.\n"
            "Finish with the reference exporter (needs coremltools + the "
            "torch reference):\n"
            f"  python export_coreml.py -c {pth_path} -o {output_path}\n"
            "Full recipe: docs/EXPORT_COREML.md"
        )
        return pth_path

    return _write_pth(model, src, output_path)


def _write_pth(model, src_ckpt: dict, output_path: str) -> str:
    from dino_pose_tpu_torch.io import checkpoint as ck
    from dino_pose_tpu_torch.serve import device_pixels

    lw = src_ckpt.get("loss_weight")
    ck.save_checkpoint(
        output_path,
        model,
        epoch=int(src_ckpt.get("epoch", 0)),
        train_loss=float(src_ckpt.get("train_loss", 0.0)),
        valid_loss=float(src_ckpt.get("valid_loss", 0.0)),
        config_training=dict(src_ckpt.get("config_training", {})),
        config_preproc=dict(src_ckpt.get("config_preproc", {})),
        loss_weight=float(lw) if lw is not None else None,
    )
    # Self-check like the reference: a forward pass and its output shapes
    # before the file is handed over.
    dev = next(model.parameters()).device
    x = device_pixels(np.zeros((1, 3, model.input_size, model.input_size), np.float32), dev)
    with torch.inference_mode():
        hm, z = model(x)
    print(f"Self-check forward: heatmaps {tuple(hm.shape)}, depths {tuple(z.shape)}")
    return output_path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export pose checkpoint for CoreML")
    parser.add_argument("-c", "--checkpoint", type=str, required=True,
                        help="Input checkpoint (.pth)")
    parser.add_argument("-o", "--output", type=str, required=True,
                        help="Output path (.pth interchange or .mlpackage)")
    return parser


def main(argv=None, *, device=None) -> str:
    """Parse ``argv`` and export; returns the path written."""
    from dino_pose_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    return export(args.checkpoint, args.output, device=device)


if __name__ == "__main__":
    main()
