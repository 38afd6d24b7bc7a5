"""Minimal COCO-keypoints annotation reader, no pycocotools (the port's own
copy of dino_pose_tpu/data/coco.py).

Covers exactly what the pose pipeline needs from the COCO schema, with the
reference data loader's semantics: images indexed by id, per-image
annotations, one person per image (the first annotation with
``num_keypoints > 0``), mandatory ``keypoints_z``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import numpy as np


@dataclasses.dataclass
class PoseRecord:
    image_id: int
    file_name: str
    keypoints: np.ndarray      # (K, 3) float32: x, y, visibility
    keypoints_z: np.ndarray    # (K,) float32 annotation-space z
    width: int = 0
    height: int = 0


class CocoPoseAnnotations:
    """Parsed annotation file; iteration order follows the images list."""

    def __init__(self, annotation_json_path: str | os.PathLike):
        with open(annotation_json_path) as f:
            data = json.load(f)

        anns_by_image: dict[int, list[dict]] = {}
        for ann in data.get("annotations", []):
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

        self.records: list[PoseRecord] = []
        self.num_keypoints = 0
        for img in data.get("images", []):
            anns = [
                a for a in anns_by_image.get(img["id"], [])
                if a.get("num_keypoints", 0) > 0
            ]
            if not anns:
                raise ValueError(
                    f"No annotations found for image {img.get('file_name')}"
                )
            ann = anns[0]  # first person, like the reference
            kps = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            if "keypoints_z" not in ann:
                raise ValueError(
                    f"No 3d keypoints found for image {img.get('file_name')}"
                )
            z = np.asarray(ann["keypoints_z"], np.float32)
            # Validate at LOAD time: a mixed-K annotation file (e.g. a
            # 17-kp COCO person among 24-kp records) would otherwise
            # surface epochs later as an opaque np.stack/broadcast error
            # in whatever batch the odd sample lands in.
            if self.num_keypoints and kps.shape[0] != self.num_keypoints:
                raise ValueError(
                    f"Inconsistent keypoint count in {img.get('file_name')}: "
                    f"{kps.shape[0]} vs {self.num_keypoints} in earlier records"
                )
            if z.shape[0] != kps.shape[0]:
                raise ValueError(
                    f"keypoints_z length {z.shape[0]} != keypoint count "
                    f"{kps.shape[0]} for image {img.get('file_name')}"
                )
            self.num_keypoints = kps.shape[0]
            self.records.append(
                PoseRecord(
                    image_id=img["id"],
                    file_name=img["file_name"],
                    keypoints=kps,
                    keypoints_z=z,
                    width=img.get("width", 0),
                    height=img.get("height", 0),
                )
            )
        if not self.records:
            raise ValueError(f"Empty annotation file: {annotation_json_path}")

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> PoseRecord:
        return self.records[idx]


def image_path(images_dir: str | os.PathLike, record: PoseRecord) -> pathlib.Path:
    return pathlib.Path(images_dir) / record.file_name
