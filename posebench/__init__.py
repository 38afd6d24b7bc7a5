"""posebench: the benchmark of the PyTorch and CUDA pose port
(``dino_pose_tpu_torch``) on NVIDIA H100 cards. See README.md."""
