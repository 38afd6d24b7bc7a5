"""Command-line entry points of the port (``python -m dino_pose_tpu_torch.cli.<name>``)."""
