"""Keypoint-aware augmentation chain (the port's own copy of
dino_pose_tpu/data/augment.py: the same seed draws the same chain).

The geometry is *exactly* the reference pipeline (ordered, config-gated:
pre-crop -> random scale -> rotation -> flip -> resize-shortest-edge(+pad) ->
top-left crop -> occlusion, the reference's ``data_augmentation.py``) —
including its idiosyncrasies, reproduced deliberately for trained-model
parity:

- every coordinate step adds the reference's +0.5 offsets;
- rotation transforms invisible (v=0) points too;
- the occlusion guard is inverted, so a patch is blacked out with p = 0.7;
- intermediate sizes use the same int() roundings.

All randomness is drawn per sample on the host (:class:`AugmentParams`)
and the keypoint/z math runs here in vectorised numpy; the *image* is
produced either by the exact host path (:func:`augment_image_host`, PIL ops
mirroring the reference) or by the fused device warp (``data/warp.py``) that
composes the whole chain plus the model preprocessor into one bilinear
resample. Both consume the same
:class:`ChainSpec`, so targets are identical in either mode.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dino_pose_tpu_torch.constants import FLIP_PERM


@dataclasses.dataclass
class AugmentParams:
    """All random draws for one sample (image-size independent)."""

    scale_w: float = 1.0
    scale_h: float = 1.0
    degrees: float = 0.0
    flip: bool = False
    pad_color: tuple[int, int, int] = (0, 0, 0)
    occlude: bool = False
    occ_wfrac: float = 0.0      # width fraction (already x max_ratio)
    occ_xfrac: float = 0.0      # position fraction
    occ_hfrac: float = 0.0
    occ_yfrac: float = 0.0

    @classmethod
    def draw(cls, rng: np.random.Generator, cfg: dict) -> "AugmentParams":
        p = cls()
        if cfg.get("is_scale", False):
            p.scale_w = float(rng.uniform(cfg["random_resize_min"], cfg["random_resize_max"]))
            p.scale_h = float(rng.uniform(cfg["random_resize_min"], cfg["random_resize_max"]))
        if cfg.get("is_rotate", False):
            p.degrees = float(rng.uniform(cfg["rotate_min_degree"], cfg["rotate_max_degree"]))
        if cfg.get("is_flipping", False):
            p.flip = bool(rng.random() >= 0.5)
        if cfg.get("is_resize_shortest_edge", False):
            p.pad_color = tuple(int(c) for c in rng.integers(0, 256, 3))
        if cfg.get("is_occultation", False):
            # Inverted guard in the reference: occlude unless rand < 0.3.
            p.occlude = bool(rng.random() >= 0.3)
            p.occ_wfrac = float(0.5 * rng.random())
            p.occ_xfrac = float(rng.random())
            p.occ_hfrac = float(0.5 * rng.random())
            p.occ_yfrac = float(rng.random())
        return p


@dataclasses.dataclass
class ChainSpec:
    """Resolved geometry of one augmented sample (all sizes concrete ints).

    Frames: F0 original -> F1 crop rect -> F2 random-scaled ->
    F3 rotated/flipped (same size as F2) -> F4 resize+pad -> F5 top-left crop
    (model input frame, where heatmap targets live).
    """

    crop_x0: int
    crop_y0: int
    crop_w: int
    crop_h: int
    scaled_w: int
    scaled_h: int
    degrees: float
    flip: bool
    resize_scale: float
    resized_w: int
    resized_h: int
    pad_x: int
    pad_y: int
    pad_color: tuple[int, int, int]
    out_size: int
    occ_rect: tuple[int, int, int, int] | None  # x0, x1, y0, y1 in F5


def _precrop_rect(kps: np.ndarray, width: int, height: int) -> tuple[int, int, int, int]:
    """3x keypoint-bbox crop rect (x0, y0, w, h). Reference pre_crop_image."""
    xs = kps[:, 0]
    ys = kps[:, 1]
    vx = xs[xs > 0]
    vy = ys[ys > 0]
    if vx.size == 0 or vy.size == 0:
        # Degenerate annotation (no positive-coordinate keypoints): fall
        # back to the full image. The reference crashes on these
        # (vx.max() of an empty array); one bad sample must not kill a
        # multi-epoch run.
        return 0, 0, width, height
    x_extent = vx.max() - vx.min()
    y_extent = vy.max() - vy.min()
    if max(x_extent, y_extent) <= 0:
        # Single visible keypoint (or all coincident): a 3x-bbox crop has
        # zero area and the resize chain would divide by zero downstream.
        return 0, 0, width, height
    new_extent = 3 * max(x_extent, y_extent)
    x_pad = (new_extent - x_extent) / 2.0
    y_pad = (new_extent - y_extent) / 2.0
    x0 = int(max(vx.min() - x_pad, 0))
    x1 = int(min(vx.max() + x_pad, width))
    y0 = int(max(vy.min() - y_pad, 0))
    y1 = int(min(vy.max() + y_pad, height))
    return x0, y0, x1 - x0, y1 - y0


def _crop_kps(kps: np.ndarray, x0: float, y0: float, w: float, h: float) -> np.ndarray:
    """Shift keypoints into a crop; out-of-rect points become (0, 0, 0)."""
    out = np.zeros((kps.shape[0], 3), kps.dtype)
    inside = ~(
        (kps[:, 0] < x0)
        | (kps[:, 0] > x0 + w)
        | (kps[:, 1] < y0)
        | (kps[:, 1] > y0 + h)
    )
    out[inside, 0] = kps[inside, 0] - x0
    out[inside, 1] = kps[inside, 1] - y0
    out[inside, 2] = kps[inside, 2]
    return out


def build_chain(
    kps: np.ndarray,
    z: np.ndarray,
    image_size: tuple[int, int],
    params: AugmentParams,
    cfg: dict,
    target_size: int = 224,
) -> tuple[ChainSpec, np.ndarray, np.ndarray]:
    """Resolve the full geometric chain and transform keypoints/z through it.

    Returns (spec, final_kps, final_z); the spec drives the image warp (host
    or device).
    """
    kps = np.asarray(kps, np.float64).copy()
    z = np.asarray(z, np.float64).copy()
    width, height = image_size

    # F1: pre-crop
    if cfg.get("pre_crop", False):
        x0, y0, w1, h1 = _precrop_rect(kps, width, height)
        kps = _crop_kps(kps, x0, y0, w1, h1)
    else:
        x0 = y0 = 0
        w1, h1 = width, height

    # F2: random scale
    if cfg.get("is_scale", False):
        sw, sh = params.scale_w, params.scale_h
        w2, h2 = int(w1 * sw), int(h1 * sh)
        out = np.zeros_like(kps)
        out[:, 0] = kps[:, 0] * sw + 0.5
        out[:, 1] = kps[:, 1] * sh + 0.5
        out[:, 2] = kps[:, 2]
        kps = out
        z = z * math.sqrt(sw * sh)
    else:
        w2, h2 = w1, h1

    # F3: rotation about the (w2/2, h2/2) centre — applied to all points.
    degrees = params.degrees if cfg.get("is_rotate", False) else 0.0
    if cfg.get("is_rotate", False):
        ang = -degrees / 180.0 * math.pi
        ox, oy = w2 / 2.0, h2 / 2.0
        qx = math.cos(ang) * (kps[:, 0] - ox) - math.sin(ang) * (kps[:, 1] - oy) + ox
        qy = math.sin(ang) * (kps[:, 0] - ox) + math.cos(ang) * (kps[:, 1] - oy) + oy
        kps = np.stack([qx + 0.5, qy + 0.5, kps[:, 2]], axis=1)

    # flip
    flip = params.flip if cfg.get("is_flipping", False) else False
    if flip:
        kps = np.stack(
            [w2 - kps[FLIP_PERM, 0], kps[FLIP_PERM, 1], kps[FLIP_PERM, 2]], axis=1
        )
        z = z[FLIP_PERM]

    # F4: resize shortest edge to target + centre-pad if short
    if cfg.get("is_resize_shortest_edge", False):
        scale = float(target_size) / float(min(w2, h2))
        if h2 < w2:
            newh, neww = target_size, int(scale * w2 + 0.5)
        else:
            newh, neww = int(scale * h2 + 0.5), target_size
        pw = ph = 0
        if neww < target_size or newh < target_size:
            pw = max(0, (target_size - neww) // 2)
            ph = max(0, (target_size - newh) // 2)
        kps = np.stack(
            [kps[:, 0] * scale + 0.5 + pw, kps[:, 1] * scale + 0.5 + ph, kps[:, 2]],
            axis=1,
        )
        z = z * scale
    else:
        scale = 1.0
        neww, newh = w2, h2
        pw = ph = 0

    # F5: top-left crop to the model input square
    if cfg.get("is_crop", False):
        kps = _crop_kps(kps, 0, 0, target_size, target_size)
        out_w = out_h = target_size
    elif pw or ph:
        out_w, out_h = max(neww, target_size), max(newh, target_size)
    else:
        out_w, out_h = neww, newh

    # Occlusion rectangle (image-only; drawn in the F5 frame)
    occ = None
    if cfg.get("is_occultation", False) and params.occlude:
        ow, oh = out_w, out_h
        x_start = int((1 - params.occ_wfrac) * params.occ_xfrac * ow)
        x_end = int(x_start + params.occ_wfrac * ow)
        y_start = int((1 - params.occ_hfrac) * params.occ_yfrac * oh)
        y_end = int(y_start + params.occ_hfrac * oh)
        occ = (x_start, x_end, y_start, y_end)

    spec = ChainSpec(
        crop_x0=x0,
        crop_y0=y0,
        crop_w=w1,
        crop_h=h1,
        scaled_w=w2,
        scaled_h=h2,
        degrees=degrees,
        flip=flip,
        resize_scale=scale,
        resized_w=neww,
        resized_h=newh,
        pad_x=pw,
        pad_y=ph,
        pad_color=params.pad_color,
        out_size=target_size,
        occ_rect=occ,
    )
    return spec, kps.astype(np.float32), z.astype(np.float32)


# ---------------------------------------------------------------------------
# Host (PIL) image path — reference-exact
# ---------------------------------------------------------------------------

def augment_image_host(image, spec: ChainSpec, cfg: dict):
    """Apply the resolved chain to a PIL image exactly like the reference."""
    from PIL import Image, ImageOps

    img = image
    if cfg.get("pre_crop", False):
        img = img.crop(
            (spec.crop_x0, spec.crop_y0, spec.crop_x0 + spec.crop_w, spec.crop_y0 + spec.crop_h)
        )
    if cfg.get("is_scale", False):
        img = img.resize((spec.scaled_w, spec.scaled_h))
    if cfg.get("is_rotate", False):
        img = img.rotate(spec.degrees)
    if spec.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if cfg.get("is_resize_shortest_edge", False):
        img = img.resize((spec.resized_w, spec.resized_h))
        if spec.pad_x or spec.pad_y:
            new_size = (
                max(spec.resized_w, spec.out_size),
                max(spec.resized_h, spec.out_size),
            )
            img = ImageOps.pad(img, new_size, color=spec.pad_color)
    if cfg.get("is_crop", False):
        img = img.crop((0, 0, spec.out_size, spec.out_size))
    if spec.occ_rect is not None:
        arr = np.array(img)
        x0, x1, y0, y1 = spec.occ_rect
        arr[y0:y1, x0:x1, :] = 0
        img = Image.fromarray(arr)
    return img
