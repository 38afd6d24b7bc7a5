"""Model information CLI (counterpart of dino_pose_tpu/cli/model_info.py).

    python -m dino_pose_tpu_torch.cli.model_info (--checkpoint FILE | --backbones |
                                                  --families | --list-checkpoints [DIR])

The JAX CLI's flags and printed text. It builds no model and touches no
device. ``--list-checkpoints`` lists ``.pth`` and ``.msgpack`` files, as
JAX's does; ``--checkpoint`` reads ``.pth`` only (the port refuses flax's
``.msgpack``: "Could not read checkpoint: ...", exit 1).
"""

from __future__ import annotations

import argparse
import os
import sys


def print_families() -> None:
    from dino_pose_tpu_torch.models import registry

    print("Model Families Overview:")
    print("=" * 60)
    for family_name, data in registry.list_families().items():
        info = data["info"]
        print(f"\n{family_name.upper()} Family")
        print(f"   Description: {info.get('description', 'No description available')}")
        print(f"   Features: {', '.join(info.get('features', []))}")
        print(f"   Available sizes: {', '.join(info.get('available_sizes', []))}")
        print(f"   Default model: {data['default']}")
        print(f"   Total models: {len(data['models'])}")
        print("   Models in this family:")
        for model in data["models"]:
            entry = registry.BACKBONE_REGISTRY[model]
            kp = entry.default_config.get("num_keypoints", 24)
            print(f"     - {model} | LoRA: yes | Keypoints: {kp}")


def print_backbones() -> None:
    from dino_pose_tpu_torch.io.checkpoint import _REFERENCE_CLASS_NAMES
    from dino_pose_tpu_torch.models import registry

    print("Supported Backbone Models:")
    print("=" * 60)
    for family_name, data in registry.list_families().items():
        info = data["info"]
        print(f"\n{family_name.upper()} Family:")
        if info.get("description"):
            print(f"   {info['description']}")
        print(f"   Default: '{family_name}' -> {data['default']}")
        print()
        for model_name, entry in registry.get_family_models(family_name).items():
            # A family registered at run time has no reference class name.
            cls = _REFERENCE_CLASS_NAMES.get((family_name, False), "(custom)")
            kp = entry.default_config.get("num_keypoints", 24)
            print(
                f"  - {model_name:<34} | Class: {cls:<18} | LoRA: yes | Keypoints: {kp}"
            )


def print_checkpoint_info(path: str) -> bool:
    from dino_pose_tpu_torch.io.checkpoint import get_model_info

    try:
        info = get_model_info(path)
    except Exception as e:  # noqa: BLE001 — CLI surface, report and fail
        print(f"Could not read checkpoint: {e}")
        return False
    print(f"Checkpoint: {path}")
    print("=" * 60)
    for k, v in info.items():
        if k == "architecture":
            print("  architecture:")
            for ak, av in v.items():
                print(f"    {ak}: {av}")
        else:
            print(f"  {k}: {v}")
    return True


def list_checkpoints(directory: str) -> None:
    print(f"Checkpoints under {directory}:")
    found = False
    for root, _, files in os.walk(directory):
        for f in sorted(files):
            if f.endswith((".pth", ".msgpack")):
                found = True
                full = os.path.join(root, f)
                size = os.path.getsize(full) / 1e6
                print(f"  {full} ({size:.1f}MB)")
    if not found:
        print("  (none found)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Model Information Tool")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--checkpoint", "-c", type=str,
                       help="Path to checkpoint file (.pth/.msgpack) to analyze")
    group.add_argument("--backbones", "-b", action="store_true",
                       help="List all supported backbone models")
    group.add_argument("--families", "-f", action="store_true",
                       help="Show information about model families")
    group.add_argument("--list-checkpoints", "-l", type=str, nargs="?",
                       const="checkpoints", metavar="DIR",
                       help="List checkpoint files in directory (default: checkpoints)")
    return parser


def main(argv=None) -> None:
    from dino_pose_tpu_torch.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            print(f"Checkpoint file not found: {args.checkpoint}")
            sys.exit(1)
        if not print_checkpoint_info(args.checkpoint):
            sys.exit(1)
    elif args.backbones:
        print_backbones()
    elif args.families:
        print_families()
    elif args.list_checkpoints:
        list_checkpoints(args.list_checkpoints)


if __name__ == "__main__":
    main()
