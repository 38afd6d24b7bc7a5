"""Pose dataset + host input pipeline with threaded prefetch (counterpart of
dino_pose_tpu/data/dataset.py; the same seed gives the same batches).

Sample contract of the reference ``PoseDataset.__getitem__``: a dict with

- ``image``          (3, S, S) float32 preprocessed pixels
- ``2d_heatmaps``    (K, hs, hs) float32 Gaussian targets
- ``2d_keypoints``   (K, 3) float32 post-augmentation keypoints
- ``z_coords``       (K,) float32 normalised z

The augmentation geometry and the image chain run on the host (PIL,
vectorised numpy, ``data/augment.py``). The heatmap targets render either
on the host (``render_targets=True``, ``data/heatmaps.render_heatmaps_host``)
or on the device inside the train step from the keypoints
(``render_targets=False``: the loader omits ``2d_heatmaps`` and
``train/step.prepare_batch`` renders them). With ``device_warp=True`` a
sample carries a letterboxed uint8 canvas and the warp's affines instead of
``image``; ``prepare_batch`` warps them on the device (``data/warp.py``).

The loader is a thread-pooled prefetcher, not torch's fork-worker
``DataLoader``: decode/augment of the next batches overlaps device work, and
batches are yielded as stacked numpy arrays. Under a multi-process launch
each rank loads its data shard of every epoch's order
(``shard_by_process=True``: the shard is the rank's data coordinate of the
recorded mesh, ``core/distributed.data_shard``; ranks of one model group
load the same slice), as the JAX package's loader shards by process.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Iterator

import numpy as np

from dino_pose_tpu_torch.core import distributed
from dino_pose_tpu_torch.data import keypoints as kp_math
from dino_pose_tpu_torch.data import warp as W
from dino_pose_tpu_torch.data.augment import AugmentParams, augment_image_host, build_chain
from dino_pose_tpu_torch.data.coco import CocoPoseAnnotations, image_path
from dino_pose_tpu_torch.data.heatmaps import render_heatmaps_host
from dino_pose_tpu_torch.data.preprocess import create_preprocessor


class PoseDataset:
    """COCO-format single-person pose dataset (reference contract)."""

    def __init__(
        self,
        images_dir_path,
        annotation_json_path,
        image_processor,
        num_model_keypoints: int,
        config_preproc: dict | None,
        config_model: dict,
        transform: bool = True,
        render_targets: bool = True,
        device_warp: bool = False,
        seed: int = 0,
    ):
        self.images_dir_path = images_dir_path
        self.image_processor = image_processor
        self.config_preproc = config_preproc
        self.config_model = config_model
        self.transform = transform
        self.render_targets = render_targets
        self.device_warp = device_warp
        self.seed = seed
        self.epoch = 0
        if device_warp:
            if not (
                transform
                and config_preproc
                and config_preproc.get("is_crop")
                and config_preproc.get("is_resize_shortest_edge")
            ):
                raise ValueError(
                    "device_warp requires the standard augmentation chain "
                    "(transform with is_resize_shortest_edge + is_crop)"
                )
            if render_targets:
                raise ValueError("device_warp implies render_targets=False")

        self.coco = CocoPoseAnnotations(annotation_json_path)
        self.num_keypoints = self.coco.num_keypoints
        if num_model_keypoints != self.num_keypoints:
            raise ValueError(
                f"Number of model keypoints ({num_model_keypoints}) does not "
                f"match number of keypoints in annotations ({self.num_keypoints})"
            )
        print(
            f"Loaded dataset with {len(self.coco)} images and "
            f"{self.num_keypoints} keypoints"
        )

    def __len__(self) -> int:
        return len(self.coco)

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation RNG stream (new draws every epoch)."""
        self.epoch = epoch

    def load_image(self, idx: int):
        from PIL import Image

        rec = self.coco[idx]
        return Image.open(image_path(self.images_dir_path, rec)).convert("RGB")

    def __getitem__(self, idx: int) -> dict:
        rec = self.coco[idx]
        img = self.load_image(idx)
        kps = rec.keypoints.astype(np.float64).copy()
        z3d = rec.keypoints_z.astype(np.float64).copy()

        spec = None
        if self.transform and self.config_preproc:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, idx])
            )
            params = AugmentParams.draw(rng, self.config_preproc)
            spec, kps, z3d = build_chain(
                kps,
                z3d,
                img.size,
                params,
                self.config_preproc,
                target_size=self.image_processor.crop,
            )
            if self.device_warp:
                return self._device_warp_sample(img, spec, kps, z3d)
            img = augment_image_host(img, spec, self.config_preproc)
        else:
            kps = kps.astype(np.float32)
            z3d = z3d.astype(np.float32)

        z_coords = kp_math.normalize_z_np(kps, z3d)
        sample = {
            "image": self.image_processor(img)["pixel_values"][0],
            "2d_keypoints": kps.astype(np.float32),
            "z_coords": z_coords.astype(np.float32),
        }
        if self.render_targets:
            hs = int(self.config_model["output_heatmap_size"])
            sample["2d_heatmaps"] = render_heatmaps_host(kps, img.size, hs)
        return sample

    def _device_warp_sample(self, img, spec, kps, z3d) -> dict:
        """Fast path: one host letterbox; the warp runs on device in-step."""
        canvas, canvas_scale = W.letterbox_canvas(img)
        wspec = W.chain_affine(
            spec,
            img.size,
            canvas_scale,
            model_input=self.image_processor.crop,
            shortest_edge=self.image_processor.shortest_edge,
        )
        z_coords = kp_math.normalize_z_np(kps, z3d)
        return {
            "canvas": canvas,
            "affine": wspec.affine,
            "pad_color": wspec.pad_color,
            "src_wh": np.array([wspec.src_w, wspec.src_h], np.float32),
            "occ": wspec.occ,
            "f3_affine": wspec.f3_affine,
            "f2_affine": wspec.f2_affine,
            "frame": wspec.frame,
            "2d_keypoints": kps.astype(np.float32),
            "z_coords": z_coords.astype(np.float32),
        }


def _collate(samples: list[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Thread-pooled, shuffling, prefetching batch iterator.

    ``drop_last=True`` keeps batch shapes static; evaluation uses
    ``drop_last=False`` plus :func:`pad_batch`.
    """

    def __init__(
        self,
        dataset: PoseDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 0,
        prefetch_batches: int = 2,
        shard_by_process: bool = False,
    ):
        """``shard_by_process=True`` gives each data shard a disjoint
        (epoch-rotating) slice of the dataset: the shuffle seed is shared,
        so the slices never overlap, and the shards are equal, padded with
        the epoch's leading indices, so that every rank counts the same
        batches."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.shard_by_process = shard_by_process
        self._epoch = 0
        self._lock = threading.Lock()

    def _shard_info(self) -> tuple[int, int]:
        return distributed.data_shard() if self.shard_by_process else (0, 1)

    def set_epoch(self, epoch: int) -> None:
        """Fast-forward the per-epoch RNG streams (shuffle order + the
        dataset's augmentation draws) — auto-resume must continue the
        stream at ``start_epoch``, not replay epochs 0..N."""
        with self._lock:
            self._epoch = epoch

    def __len__(self) -> int:
        _, nshards = self._shard_info()
        n = -(-len(self.dataset) // nshards)  # ceil: shards are padded equal
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        with self._lock:
            epoch = self._epoch
            self._epoch += 1
        self.dataset.set_epoch(epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).shuffle(order)
        rank, nshards = self._shard_info()
        if nshards > 1:
            # Equal shards keep every rank's batch count the same (each step
            # runs collectives, and unequal counts would hang them); the pad
            # repeats the epoch's leading indices (at most nshards - 1 of
            # them, torch DistributedSampler's policy), so every sample is
            # seen.
            per = -(-len(order) // nshards)
            if per * nshards > len(order):
                order = np.concatenate([order, order[: per * nshards - len(order)]])
            order = order[rank * per : (rank + 1) * per]
        if self.drop_last:
            order = order[: len(order) - len(order) % self.batch_size]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            window: list[list[cf.Future]] = []
            bi = 0
            # Keep prefetch_batches batches' worth of samples in flight.
            while bi < len(batches) or window:
                while bi < len(batches) and len(window) <= self.prefetch_batches:
                    window.append(
                        [pool.submit(self.dataset.__getitem__, int(i)) for i in batches[bi]]
                    )
                    bi += 1
                futures = window.pop(0)
                yield _collate([f.result() for f in futures])


def pad_batch(batch: dict, batch_size: int) -> tuple[dict, np.ndarray]:
    """Zero-pad a short batch to ``batch_size``; returns (batch, valid_mask)."""
    n = len(next(iter(batch.values())))
    valid = np.zeros(batch_size, bool)
    valid[:n] = True
    if n == batch_size:
        return batch, valid
    padded = {
        k: np.concatenate(
            [v, np.zeros((batch_size - n, *v.shape[1:]), v.dtype)]
        )
        for k, v in batch.items()
    }
    return padded, valid


def create_dataloaders(
    config_preproc: dict,
    config_model: dict,
    images_dir_path,
    annotation_json_path,
    batch_size: int = 8,
    num_workers: int = 4,
    *,
    shuffle: bool = True,
    transform: bool = True,
    drop_last: bool = True,
    render_targets: bool = True,
    device_warp: bool = False,
    seed: int = 0,
    shard_by_process: bool = False,
) -> DataLoader:
    """The reference data loader's factory shape: a :class:`PoseDataset`
    with the backbone's preprocessor behind a :class:`DataLoader`."""
    from dino_pose_tpu_torch.models.registry import resolve_model_name

    actual_model_name = resolve_model_name(config_model["model_name"])
    image_processor = create_preprocessor(actual_model_name)
    dataset = PoseDataset(
        images_dir_path=images_dir_path,
        annotation_json_path=annotation_json_path,
        image_processor=image_processor,
        num_model_keypoints=config_model["num_keypoints"],
        config_preproc=config_preproc,
        config_model=config_model,
        transform=transform,
        render_targets=render_targets and not device_warp,
        device_warp=device_warp,
        seed=seed,
    )
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        num_workers=num_workers,
        drop_last=drop_last,
        seed=seed,
        shard_by_process=shard_by_process,
    )
