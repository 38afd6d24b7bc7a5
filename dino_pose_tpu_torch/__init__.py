"""dino_pose_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of dino_pose_tpu.

The package mirrors ``dino_pose_tpu``'s module names so that each counterpart
is found at the same path. It imports ``torch`` and never JAX or the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.

What this package covers so far: dinov2 + LoRA pose inference (the serving
path) — the ViT backbone with the three fused block kernels
(``ops/block.py`` over ``ops/csrc/block_kernels.cu``), the spatial-aware
heads, heatmap decode, preprocessing, the weight carry from the JAX package's
variables (``io/convert.py``) and ``serve.make_predictor``.
"""

__version__ = "0.1.0"
