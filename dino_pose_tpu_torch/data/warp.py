"""Fused on-device augmentation warp, the fast input path (counterpart of
dino_pose_tpu/data/warp.py).

The host path produces each training image through a chain of PIL
operations — crop, resize, rotate, flip, resize+pad, crop, occlude — plus the
preprocessor's resize+crop+normalise: seven sequential host resamples per
sample. This module replaces all of it with ONE gather per output pixel, on
the batch's device:

1. The host decodes the JPEG and letterboxes it once onto a fixed-size
   canvas (:func:`letterbox_canvas`, a single PIL resize).
2. :func:`chain_affine` composes the whole geometric chain (including the
   preprocessor's shortest-edge-256 -> center-crop-224 zoom) into a single
   2x3 affine mapping model-input pixels to canvas pixels, plus the masks
   that PIL would have produced (pad colour in the letterbox margins, black
   outside the rotated source, occlusion rectangle).
3. :func:`warp_batch` bilinearly samples the canvases at the transformed
   coordinates, applies the masks and normalises: the (B, 3, S, S) float32
   input, computed by plain torch ops where the tensors lie (the JAX
   package computes it in XLA, not in a Pallas kernel).

Keypoint/z targets are untouched: they come from ``data/augment.build_chain``
either way. Pixels differ from the PIL chain at interpolation level (one
resample instead of seven), so this path is an opt-in speed mode
(``config_training["device_warp"]``), not the parity default. The PIL-parity
fixes stay: rotation black-fill in the rotation-source frame, the flip at
``w - 1 - x`` and the bilinear weights from the clipped corner at the edge.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dino_pose_tpu_torch.data.augment import ChainSpec
from dino_pose_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

CANVAS = 512  # fixed letterbox canvas size (host -> device transfer shape)

# A device-warp batch's fields, in warp_batch's argument order.
WARP_KEYS = ("canvas", "affine", "pad_color", "src_wh", "occ", "f3_affine", "f2_affine", "frame")


@dataclasses.dataclass
class WarpSpec:
    """Per-sample device-warp inputs (all fixed-shape numerics)."""

    affine: np.ndarray       # (2, 3): output (x, y, 1) -> canvas (x, y)
    pad_color: np.ndarray    # (3,) float32 0-255
    src_w: float             # valid canvas extent (letterboxed image size)
    src_h: float
    occ: np.ndarray          # (4,) x0, x1, y0, y1 in output pixels (or -1s)
    f3_affine: np.ndarray    # (2, 3): output -> F3 (resized, pre-pad) frame
    f2_affine: np.ndarray    # (2, 3): output -> F2 (rotation-source) frame
    frame: np.ndarray        # (3,) [scaled_w, scaled_h, rot_deg]


def _compose(*mats: np.ndarray) -> np.ndarray:
    out = np.eye(3)
    for m in mats:
        m3 = np.eye(3)
        m3[:2] = m
        out = out @ m3
    return out[:2]


def _translate(tx, ty):
    return np.array([[1, 0, tx], [0, 1, ty]], np.float64)


def _scale(sx, sy):
    return np.array([[sx, 0, 0], [0, sy, 0]], np.float64)


def chain_affine(
    spec: ChainSpec,
    image_size: tuple[int, int],
    canvas_scale: tuple[float, float],
    model_input: int,
    shortest_edge: int,
) -> WarpSpec:
    """Compose the inverse augmentation chain into one affine.

    Maps model-input pixel centres (after the processor's
    shortest-edge/center-crop zoom) back to canvas coordinates.
    """
    # Processor geometry on the out_size x out_size augmented image:
    # resize shortest edge -> shortest_edge, center crop model_input.
    proc_scale = spec.out_size / float(shortest_edge)
    crop_off = (shortest_edge - model_input) / 2.0

    # model pixel -> F5 (augmented image) coordinates
    to_f5 = _compose(
        _scale(proc_scale, proc_scale), _translate(crop_off, crop_off)
    )
    # F5 -> F4 (same frame; top-left crop) -> remove pad -> F3 (resized)
    to_f3 = _compose(
        _scale(1.0 / spec.resize_scale, 1.0 / spec.resize_scale),
        _translate(-spec.pad_x, -spec.pad_y),
    )
    # F3 -> unflip -> unrotate about centre -> F2
    mats = [to_f5, to_f3]
    if spec.flip:
        # PIL FLIP_LEFT_RIGHT mirrors pixel INDICES: x -> w - 1 - x in the
        # integer-centre convention warp_batch samples with (w - x would
        # shift every flipped image one pixel against the host chain).
        mats.append(
            np.array([[-1, 0, spec.scaled_w - 1], [0, 1, 0]], np.float64)
        )
    if spec.degrees:
        ang = math.radians(spec.degrees)
        ox, oy = spec.scaled_w / 2.0, spec.scaled_h / 2.0
        c, s = math.cos(ang), math.sin(ang)
        # PIL.Image.rotate(deg) samples output pixel q from input coordinate
        # R(+deg)(q - centre) + centre (verified empirically vs PIL); the
        # keypoint math applies the forward R(-deg), consistently.
        mats.append(
            _compose(
                _translate(ox, oy),
                np.array([[c, -s, 0], [s, c, 0]], np.float64),
                _translate(-ox, -oy),
            )
        )
    # Intermediate-frame affines for the mask geometry (both frames are
    # scaled_w x scaled_h): F3 = resized image before padding — model
    # pixels mapping outside it sit in the PIL pad margins; F2 = the
    # rotation SOURCE coordinate — PIL rotate fills black where it exits
    # the frame. The canvas-level bounds check cannot express either
    # (out-of-crop/rotated-away coordinates can still land on real image
    # content inside the canvas).
    f3_affine = _compose(*reversed(mats[:2]))
    f2_affine = _compose(*reversed(mats))

    # F2 -> unscale -> F1 -> un-crop -> F0 (original image)
    mats.append(_scale(spec.crop_w / max(spec.scaled_w, 1), spec.crop_h / max(spec.scaled_h, 1)))
    mats.append(_translate(spec.crop_x0, spec.crop_y0))
    # F0 -> canvas
    mats.append(_scale(canvas_scale[0], canvas_scale[1]))
    # Each entry of ``mats`` maps frame N -> N+1 in list order (to_f5 first,
    # canvas scale last); ``_compose`` applies its LAST argument first, so
    # the list must be reversed to compose in application order.
    affine = _compose(*reversed(mats))

    occ = np.full(4, -1.0, np.float32)
    if spec.occ_rect is not None:
        # Occlusion is drawn in the F5 frame; model pixel m sits at
        # f5 = proc_scale * (m + crop_off), so f5 -> m = f5 / s - crop_off.
        x0, x1, y0, y1 = spec.occ_rect
        occ = np.array(
            [
                x0 / proc_scale - crop_off,
                x1 / proc_scale - crop_off,
                y0 / proc_scale - crop_off,
                y1 / proc_scale - crop_off,
            ],
            np.float32,
        )

    w0, h0 = image_size
    pad_color = (
        np.asarray(spec.pad_color, np.float32)
        if (spec.pad_x or spec.pad_y)
        else np.full(3, -1.0, np.float32)  # sentinel: no padding applied
    )
    return WarpSpec(
        affine=affine.astype(np.float32),
        pad_color=pad_color,
        src_w=w0 * canvas_scale[0],
        src_h=h0 * canvas_scale[1],
        occ=occ,
        f3_affine=f3_affine.astype(np.float32),
        f2_affine=f2_affine.astype(np.float32),
        frame=np.array(
            [spec.scaled_w, spec.scaled_h, spec.degrees], np.float32
        ),
    )


def letterbox_canvas(image, canvas: int = CANVAS):
    """Host: one resize of a PIL image onto a (canvas, canvas) uint8 array.

    Returns (array, (sx, sy)) with original->canvas scale factors.
    """
    from PIL import Image

    w0, h0 = image.size
    scale = min(canvas / w0, canvas / h0, 1.0)
    nw, nh = max(1, int(round(w0 * scale))), max(1, int(round(h0 * scale)))
    resized = image.resize((nw, nh), Image.BILINEAR) if (nw, nh) != (w0, h0) else image
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[:nh, :nw] = np.asarray(resized, np.uint8)[..., :3]
    return out, (nw / w0, nh / h0)




def _apply_affine(aff: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """(B, 2, 3) affines at the (S, S) pixel grid -> two (B, S, S) maps."""
    a = aff[:, :, :, None, None]
    return (a[:, 0, 0] * gx + a[:, 0, 1] * gy + a[:, 0, 2],
            a[:, 1, 0] * gx + a[:, 1, 1] * gy + a[:, 1, 2])


def _inside(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x, y (B, S, S) within [0, w-1] x [0, h-1], w and h (B,)."""
    w = w[:, None, None]
    h = h[:, None, None]
    return (x >= 0.0) & (x <= w - 1.0) & (y >= 0.0) & (y <= h - 1.0)


def warp_batch(
    canvases: torch.Tensor,    # (B, C, C, 3) uint8
    affines: torch.Tensor,     # (B, 2, 3)
    pad_colors: torch.Tensor,  # (B, 3)
    src_wh: torch.Tensor,      # (B, 2) valid letterbox extent
    occs: torch.Tensor,        # (B, 4)
    f3_affines: torch.Tensor,  # (B, 2, 3) output -> F3 (resized, pre-pad) frame
    f2_affines: torch.Tensor,  # (B, 2, 3) output -> F2 (rotation-source) frame
    frames: torch.Tensor,      # (B, 3) [scaled_w, scaled_h, rot_deg]
    *,
    model_input: int = 224,
) -> torch.Tensor:
    """One gather + mask + normalise on the canvases' device: returns
    (B, 3, S, S) float32, S = ``model_input``."""
    dev = canvases.device
    f32 = [t.to(dev, torch.float32) for t in
           (affines, pad_colors, src_wh, occs, f3_affines, f2_affines, frames)]
    affines, pad_colors, src_wh, occs, f3_affines, f2_affines, frames = f32
    b, size = canvases.shape[0], canvases.shape[1]
    xs = torch.arange(model_input, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")  # gx: x coordinate, gy: y

    cx, cy = _apply_affine(affines, gx, gy)
    xi = torch.clamp(torch.floor(cx).to(torch.int64), 0, size - 2)
    yi = torch.clamp(torch.floor(cy).to(torch.int64), 0, size - 2)
    # Fractions from the CLIPPED corner: a coordinate of exactly size-1 then
    # weights the true pixel (fx=1) instead of repeating column size-2.
    # Out-of-range coordinates can extrapolate, but every such pixel is
    # masked below.
    fx = (cx - xi.float())[..., None]
    fy = (cy - yi.float())[..., None]
    bi = torch.arange(b, device=dev)[:, None, None]

    def gather(yy, xx):
        return canvases[bi, yy, xx].float()  # (B, S, S, 3)

    pix = (
        gather(yi, xi) * (1 - fx) * (1 - fy)
        + gather(yi, xi + 1) * fx * (1 - fy)
        + gather(yi + 1, xi) * (1 - fx) * fy
        + gather(yi + 1, xi + 1) * fx * fy
    )
    zero = torch.zeros((), device=dev)

    # outside the letterboxed source -> black
    inside = _inside(cx, cy, src_wh[:, 0], src_wh[:, 1])
    pix = torch.where(inside[..., None], pix, zero)

    # PIL parity masks in the frames where PIL paints them (the canvas-level
    # bounds cannot express either: out-of-crop or rotated-away coordinates
    # still land on real content in the canvas):
    # 1. rotate fills BLACK where the rotation-source coordinate exits the
    #    (scaled_w, scaled_h) frame (rotation runs before padding, so inside
    #    F3 only);
    # 2. resize+pad paints PAD COLOUR wherever the model pixel maps outside
    #    the resized image (the pad margins).
    fw, fh, rot = frames[:, 0], frames[:, 1], frames[:, 2]
    in_f3 = _inside(*_apply_affine(f3_affines, gx, gy), fw, fh)
    in_f2 = _inside(*_apply_affine(f2_affines, gx, gy), fw, fh)
    rot_black = (rot != 0.0)[:, None, None] & in_f3 & ~in_f2
    pix = torch.where(rot_black[..., None], zero, pix)
    pad_used = torch.all(pad_colors >= 0.0, dim=-1)[:, None, None, None]
    pix = torch.where((~in_f3[..., None]) & pad_used, pad_colors[:, None, None, :], pix)

    # occlusion rectangle (model-pixel frame)
    o = occs[:, :, None, None]
    occ = (gx >= o[:, 0]) & (gx < o[:, 1]) & (gy >= o[:, 2]) & (gy < o[:, 3])
    pix = torch.where(occ[..., None], zero, pix)

    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    pix = (pix / 255.0 - mean) / std
    return pix.permute(0, 3, 1, 2).contiguous()
