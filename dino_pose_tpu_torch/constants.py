"""Keypoint schema (the port's own copy of dino_pose_tpu/constants.py).

The 24-keypoint custom skeleton, the horizontal-flip index permutation, the
skeleton link table used for visualisation, and the anthropometric
center-of-mass weights used by the z-coordinate normalisation; the reference
schema's semantics (its ``src/utils.py`` and the augmentation's keypoint
enum), laid out as index arrays instead of per-point Python loops.
"""

from __future__ import annotations

import enum

import numpy as np

NUM_KEYPOINTS = 24


class KeyPoints(enum.IntEnum):
    """Indices of the 24 predicted keypoints (plus two derived points)."""

    TOP = 0
    NECK = 1
    RIGHT_SHOULDER = 2
    RIGHT_ELBOW = 3
    RIGHT_WRIST = 4
    LEFT_SHOULDER = 5
    LEFT_ELBOW = 6
    LEFT_WRIST = 7
    RIGHT_HIP = 8
    RIGHT_KNEE = 9
    RIGHT_ANKLE = 10
    LEFT_HIP = 11
    LEFT_KNEE = 12
    LEFT_ANKLE = 13
    NOSE = 14
    RIGHT_EYE = 15
    RIGHT_EAR = 16
    LEFT_EYE = 17
    LEFT_EAR = 18
    SPINE = 19
    RIGHT_FINGER = 20
    RIGHT_TOE = 21
    LEFT_FINGER = 22
    LEFT_TOE = 23
    # Derived points (never predicted, used by some visualisations).
    STERNUM = 24
    SACRUM = 25


# Alias matching the augmentation-side enum naming of the reference.
CocoPart = KeyPoints

# FLIP_PERM[i] = index of the keypoint that keypoint slot i receives when the
# image is mirrored horizontally: left/right limbs swap, mid-line points map to
# themselves. new_keypoints[i] = old_keypoints[FLIP_PERM[i]] (with x -> W - x).
FLIP_PERM = np.array(
    [
        KeyPoints.TOP,
        KeyPoints.NECK,
        KeyPoints.LEFT_SHOULDER,
        KeyPoints.LEFT_ELBOW,
        KeyPoints.LEFT_WRIST,
        KeyPoints.RIGHT_SHOULDER,
        KeyPoints.RIGHT_ELBOW,
        KeyPoints.RIGHT_WRIST,
        KeyPoints.LEFT_HIP,
        KeyPoints.LEFT_KNEE,
        KeyPoints.LEFT_ANKLE,
        KeyPoints.RIGHT_HIP,
        KeyPoints.RIGHT_KNEE,
        KeyPoints.RIGHT_ANKLE,
        KeyPoints.NOSE,
        KeyPoints.LEFT_EYE,
        KeyPoints.LEFT_EAR,
        KeyPoints.RIGHT_EYE,
        KeyPoints.RIGHT_EAR,
        KeyPoints.SPINE,
        KeyPoints.LEFT_FINGER,
        KeyPoints.LEFT_TOE,
        KeyPoints.RIGHT_FINGER,
        KeyPoints.RIGHT_TOE,
    ],
    dtype=np.int32,
)

# Anthropometric weights used to place the body center of mass from per-joint z
# coordinates (z normalisation subtracts the weighted sum), as the
# reference's ``src/utils.py`` has them.
COM_WEIGHTS = np.array(
    [
        0.081,      # TOP (head)
        0.0,        # NECK
        0.140042,   # RIGHT_SHOULDER (upper arm + trunk share)
        0.019204,   # RIGHT_ELBOW (forearm)
        0.015004,   # RIGHT_WRIST (hand)
        0.140042,   # LEFT_SHOULDER
        0.019204,   # LEFT_ELBOW
        0.015004,   # LEFT_WRIST
        0.18095,    # RIGHT_HIP (thigh + pelvis share)
        0.067334,   # RIGHT_KNEE (shank)
        0.036966,   # RIGHT_ANKLE (foot)
        0.18095,    # LEFT_HIP
        0.067334,   # LEFT_KNEE
        0.036966,   # LEFT_ANKLE
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ],
    dtype=np.float64,
)

# Skeleton link table for visualisation: (from_idx, to_idx, colour).
SKELETON_LINKS = (
    (KeyPoints.TOP, KeyPoints.NECK, "yellow"),
    (KeyPoints.NECK, KeyPoints.RIGHT_SHOULDER, "yellow"),
    (KeyPoints.RIGHT_SHOULDER, KeyPoints.RIGHT_ELBOW, "yellow"),
    (KeyPoints.RIGHT_ELBOW, KeyPoints.RIGHT_WRIST, "yellow"),
    (KeyPoints.NECK, KeyPoints.LEFT_SHOULDER, "yellow"),
    (KeyPoints.LEFT_SHOULDER, KeyPoints.LEFT_ELBOW, "yellow"),
    (KeyPoints.LEFT_ELBOW, KeyPoints.LEFT_WRIST, "yellow"),
    (KeyPoints.NECK, KeyPoints.SPINE, "pink"),
    (KeyPoints.SPINE, KeyPoints.RIGHT_HIP, "pink"),
    (KeyPoints.RIGHT_HIP, KeyPoints.RIGHT_KNEE, "pink"),
    (KeyPoints.RIGHT_KNEE, KeyPoints.RIGHT_ANKLE, "pink"),
    (KeyPoints.SPINE, KeyPoints.LEFT_HIP, "pink"),
    (KeyPoints.LEFT_HIP, KeyPoints.LEFT_KNEE, "pink"),
    (KeyPoints.LEFT_KNEE, KeyPoints.LEFT_ANKLE, "pink"),
    (KeyPoints.TOP, KeyPoints.NOSE, "green"),
    (KeyPoints.NOSE, KeyPoints.RIGHT_EYE, "green"),
    (KeyPoints.RIGHT_EYE, KeyPoints.RIGHT_EAR, "green"),
    (KeyPoints.NOSE, KeyPoints.LEFT_EYE, "green"),
    (KeyPoints.LEFT_EYE, KeyPoints.LEFT_EAR, "green"),
    (KeyPoints.RIGHT_WRIST, KeyPoints.RIGHT_FINGER, "blue"),
    (KeyPoints.RIGHT_ANKLE, KeyPoints.RIGHT_TOE, "blue"),
    (KeyPoints.LEFT_WRIST, KeyPoints.LEFT_FINGER, "blue"),
    (KeyPoints.LEFT_ANKLE, KeyPoints.LEFT_TOE, "blue"),
)


def skeleton_definition() -> list[list[int]]:
    """Skeleton as a list of [from, to] index pairs (COCO-style)."""
    return [[int(a), int(b)] for a, b, _ in SKELETON_LINKS]


# Joint-angle definitions (the reference's KeyPointConnections.angles):
# each row is
# (first_start, first_end, second_start, second_end); axis references use
# sentinels AXIS_ORIGIN with AXIS_X / AXIS_Y as the second segment.
AXIS_ORIGIN, AXIS_X, AXIS_Y = -1, -2, -3

JOINT_ANGLES = (
    (KeyPoints.LEFT_SHOULDER, KeyPoints.LEFT_HIP, AXIS_ORIGIN, AXIS_Y),
    (KeyPoints.RIGHT_SHOULDER, KeyPoints.RIGHT_HIP, AXIS_ORIGIN, AXIS_Y),
    (KeyPoints.LEFT_SHOULDER, KeyPoints.RIGHT_SHOULDER, AXIS_ORIGIN, AXIS_X),
    (KeyPoints.LEFT_HIP, KeyPoints.RIGHT_HIP, AXIS_ORIGIN, AXIS_X),
    (KeyPoints.LEFT_KNEE, KeyPoints.LEFT_HIP, KeyPoints.LEFT_HIP, KeyPoints.LEFT_SHOULDER),
    (KeyPoints.RIGHT_KNEE, KeyPoints.RIGHT_HIP, KeyPoints.RIGHT_HIP, KeyPoints.RIGHT_SHOULDER),
    (KeyPoints.LEFT_ANKLE, KeyPoints.LEFT_KNEE, KeyPoints.LEFT_KNEE, KeyPoints.LEFT_HIP),
    (KeyPoints.RIGHT_ANKLE, KeyPoints.RIGHT_KNEE, KeyPoints.RIGHT_KNEE, KeyPoints.RIGHT_HIP),
    (KeyPoints.LEFT_ELBOW, KeyPoints.LEFT_SHOULDER, KeyPoints.LEFT_SHOULDER, KeyPoints.LEFT_HIP),
    (KeyPoints.RIGHT_ELBOW, KeyPoints.RIGHT_SHOULDER, KeyPoints.RIGHT_SHOULDER, KeyPoints.RIGHT_HIP),
    (KeyPoints.LEFT_WRIST, KeyPoints.LEFT_ELBOW, KeyPoints.LEFT_ELBOW, KeyPoints.LEFT_SHOULDER),
    (KeyPoints.RIGHT_WRIST, KeyPoints.RIGHT_ELBOW, KeyPoints.RIGHT_ELBOW, KeyPoints.RIGHT_SHOULDER),
)


def joint_angles(keypoints) -> "np.ndarray":
    """Angles (radians) between each JOINT_ANGLES segment pair.

    keypoints: (..., K, 2+) array. Axis sentinels compare against the image
    x/y unit vectors. Vectorised over leading dims.
    """
    kps = np.asarray(keypoints, np.float32)[..., :2]

    def seg(start, end):
        if start == AXIS_ORIGIN:
            unit = np.array([1.0, 0.0], np.float32) if end == AXIS_X else np.array(
                [0.0, 1.0], np.float32
            )
            return np.broadcast_to(unit, kps.shape[:-2] + (2,))
        return kps[..., end, :] - kps[..., start, :]

    out = []
    for fs, fe, ss, se in JOINT_ANGLES:
        a = seg(fs, fe)
        b = seg(ss, se)
        dot = np.sum(a * b, axis=-1)
        na = np.linalg.norm(a, axis=-1)
        nb = np.linalg.norm(b, axis=-1)
        cos = np.clip(dot / np.maximum(na * nb, 1e-8), -1.0, 1.0)
        out.append(np.arccos(cos))
    return np.stack(out, axis=-1)
