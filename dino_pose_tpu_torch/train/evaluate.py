"""Dataset-level PCKh evaluation, batched, with the decode on the device
(counterpart of dino_pose_tpu/train/evaluate.py).

The reference protocol: for every image, preprocess -> forward -> decode
keypoints scaled to the *original* image size -> PCKh@0.5 against the raw
annotation keypoints; z-PCKh on the un-normalised z predictions; the
per-image mean of both.

Images are preprocessed by a thread pool, batched, and forward + decode +
metrics run on the model's device per batch; two scalars per image return to
the host. Under a data axis across ranks (``core/distributed.data_axis``)
each rank evaluates the strided slice ``range(data_rank, n, dp)`` with a
rank-local forward (no mesh, as ``dispatch.local()`` scopes it), and the
metric sums are all-reduced once at the end; ``last_eval_info`` records how
many images this rank evaluated.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dino_pose_tpu_torch.core import distributed

from dino_pose_tpu_torch.core.precision import policy_for_device
from dino_pose_tpu_torch.data.coco import CocoPoseAnnotations, image_path
from dino_pose_tpu_torch.data.preprocess import create_preprocessor
from dino_pose_tpu_torch.ops import dispatch
from dino_pose_tpu_torch.ops.decode import decode_heatmaps
from dino_pose_tpu_torch.train.metrics import pck_bbox, pckh_2d, pckh_z

METRICS = ("pckh", "pckh_z", "pck_bbox", "pckh_fc", "pck_bbox_fc")

# The last evaluation's image counts: ``local_images`` (this rank's) and
# ``total_images`` (the dataset's).
last_eval_info: dict = {}


def _eval_batch(model: nn.Module, images, sizes, frames, target_kps, target_z3d,
                crop: int) -> dict:
    """One forward + decode + metrics pass; every input a tensor on the
    model's device, ``images`` in its compute dtype.

    sizes: (B, 2) f32 original (W, H) per image — decode happens in
    normalised [0,1] coordinates and is scaled per sample, so mixed-size
    datasets evaluate in one fixed-shape batch.

    Two 2-D protocols are reported side by side:

    - reference protocol (``pckh``/``pck_bbox``): ``norm * (W, H)`` — the
      decoded crop-frame coordinates scaled straight to the original image,
      as the reference does. When the preprocessor's shortest-edge resize +
      centre crop is not a pure resize this skews the coordinate frame; kept
      as the parity number.
    - frame-consistent (``pckh_fc``/``pck_bbox_fc``): the decoded crop
      coordinates mapped through the preprocessor's actual geometry —
      ``(norm * crop + crop_offset) * (W / new_w, H / new_h)`` per axis,
      ``frames = (off_x, off_y, W/new_w, H/new_h)`` per sample, the offset
      the integer one the preprocessor crops at.

    z-PCKh is frame-independent, so it has no ``_fc`` variant.
    """
    heatmaps, pred_z = model(images)
    norm = decode_heatmaps(heatmaps, (1.0, 1.0))
    pred_kps = norm * sizes[:, None, :]
    pred_fc = (norm * crop + frames[:, None, :2]) * frames[:, None, 2:]
    return {
        "pckh": pckh_2d(pred_kps, target_kps),
        "pckh_z": pckh_z(pred_z, target_z3d, target_kps),
        "pck_bbox": pck_bbox(pred_kps, target_kps),
        "pckh_fc": pckh_2d(pred_fc, target_kps),
        "pck_bbox_fc": pck_bbox(pred_fc, target_kps),
    }


def crop_frame(proc, width: int, height: int) -> np.ndarray:
    """The frame-consistent mapping of one image: ``(off_x, off_y,
    width / new_w, height / new_h)``, the crop offset in the resized frame
    (the integer ``(new - crop) // 2`` the preprocessor crops at) and the
    per-axis resized -> original scale."""
    new_w, new_h = proc.resize_size(width, height)
    return np.asarray([(new_w - proc.crop) // 2, (new_h - proc.crop) // 2,
                       width / new_w, height / new_h], np.float32)


def compute_pckh_dataset(
    model: nn.Module,
    images_dir_path,
    annotation_json_path,
    *,
    batch_size: int = 32,
    num_workers: int = 4,
    return_all: bool = False,
) -> tuple[float, float] | dict:
    """Mean 2-D PCKh@0.5 and z-PCKh@0.5 over a COCO-format dataset, on the
    model's device in its compute dtype (bf16 on the card).

    Returns ``(pckh_2d, pckh_z)`` like the reference, or the full metric dict
    (including PCK@0.2-bbox and the frame-consistent protocol) with
    ``return_all=True``. The model is left in eval mode."""
    from PIL import Image

    coco = CocoPoseAnnotations(annotation_json_path)
    proc = create_preprocessor(model.model_name)
    device = next(model.parameters()).device
    dtype = policy_for_device(device).compute_dtype

    def load(idx: int):
        rec = coco[idx]
        img = Image.open(image_path(images_dir_path, rec)).convert("RGB")
        return (proc(img)["pixel_values"][0], np.asarray(img.size, np.float32),
                crop_frame(proc, *img.size), rec.keypoints, rec.keypoints_z)

    sums = dict.fromkeys(METRICS, 0.0)
    n_total = len(coco)
    axis = distributed.data_axis()
    # A strided slice: ranks differ by at most one image and so may count
    # different batches, which is safe because the forward below is local;
    # every rank reaches the one all-reduce at the end exactly once.
    indices = list(range(axis.rank, n_total, axis.size)) if axis else list(range(n_total))
    model.eval()
    with (dispatch.local(), cf.ThreadPoolExecutor(max(1, num_workers)) as pool,
          torch.inference_mode()):
        for start in range(0, len(indices), batch_size):
            rows = list(pool.map(load, indices[start:start + batch_size]))
            n = len(rows)

            def stack(i):
                xs = [r[i] for r in rows]
                xs += [np.zeros_like(xs[0])] * (batch_size - n)
                return torch.from_numpy(np.stack(xs)).to(device)

            out = _eval_batch(model, stack(0).to(dtype), *(stack(i) for i in range(1, 5)),
                              crop=proc.crop)
            host = torch.stack([out[k][:n] for k in METRICS]).cpu().numpy()
            for k, v in zip(METRICS, host):
                sums[k] += float(np.sum(v))

    if axis is not None:
        total = torch.tensor([sums[k] for k in METRICS], dtype=torch.float64,
                             device=distributed.collective_device())
        dist.all_reduce(total, group=axis.group)
        sums = dict(zip(METRICS, total.tolist()))
    last_eval_info.clear()
    last_eval_info.update(local_images=len(indices), total_images=n_total)
    means = {k: v / n_total for k, v in sums.items()}
    if return_all:
        return means
    return means["pckh"], means["pckh_z"]
