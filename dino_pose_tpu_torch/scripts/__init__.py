"""The port's accuracy harnesses, each the counterpart of the script of the
same name under the repository's ``scripts/``
(``python -m dino_pose_tpu_torch.scripts.<name>``)."""
