"""dino_pose_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of dino_pose_tpu.

The package mirrors ``dino_pose_tpu``'s module names so that each counterpart
is found at the same path. It imports ``torch`` and never JAX or the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise.

What this package covers: dinov2 and FastViT pose serving
(``serve.make_predictor``) and fine-tuning (``train/step.py``) on the hand-written
Hopper kernels of ``ops/csrc/``, the weight carry from the JAX package's
variables (``io/convert.py``), and the training entry point
(``python -m dino_pose_tpu_torch.cli.train`` → ``train/loop.fit``: the COCO
data pipeline, ``.pth`` checkpoints with resume, PCKh evaluation), and the
other five CLIs (``cli.demo``, ``cli.model_info``, ``cli.benchmark_model``,
``cli.compare_models``, ``cli.export_coreml``) with ``viz``. Still to come:
multi-process (``ROADMAP.md`` Queue 1).
"""

__version__ = "0.1.0"
