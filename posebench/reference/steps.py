"""The plain training step and serving path around :mod:`model`: heatmap
targets, the two losses, the dynamic loss weight, AdamW, and heatmap decode.

Each follows the reference training script's semantics:
- targets: per visible keypoint, exp(-d^2 / 2 sigma^2) (sigma 15) inside a
  square window of half-width sqrt(2 * 1.6052) * sigma on the full image,
  then OpenCV's INTER_CUBIC resize to the heatmap size (here as the two
  separable resize matrices, computed in float64);
- heatmap loss: the squared error weighted by exp(-error) (the weight taken
  as a constant), masked to keypoints of visibility 2, mean over all
  elements; z loss: L1 of the masked predictions, mean over (B, K);
- loss weight: EMA (0.9) averages of both losses, the objective
  kp / kp_avg + z / z_avg, the weight EMA'd (0.1) toward kp / z in [1e-3, 10];
- AdamW (0.9, 0.999, eps 1e-8), decoupled weight decay; a trainable leaf the
  loss does not reach takes a zero gradient;
- decode: argmax, then the value-weighted centroid of the 5 x 5 window
  around it at half-pixel centres, scaled to the input size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from posebench.reference.model import PoseModel, dropout_draws, step_generator

SIGMA = 15.0
WINDOW = math.sqrt(2 * 1.6052) * SIGMA


def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    near = ((a + 2) * t - (a + 3)) * t * t + 1
    far = ((a * t - 5 * a) * t + 8 * a) * t - 4 * a
    return np.where(t <= 1, near, np.where(t < 2, far, 0.0))


def cubic_resize(src: int, dst: int) -> np.ndarray:
    """(dst, src) float64 matrix of OpenCV's INTER_CUBIC 1-D resize:
    half-pixel centres, A = -0.75, replicated border, source coordinate and
    tap weights rounded to float32 as OpenCV computes them."""
    i = np.arange(dst, dtype=np.float64)
    sx = ((i + 0.5) * (src / dst) - 0.5).astype(np.float32)
    x0 = np.floor(sx)
    frac = (sx - x0).astype(np.float32)
    m = np.zeros((dst, src))
    for tap in range(4):
        w = _cubic(frac.astype(np.float64) - (tap - 1)).astype(np.float32).astype(np.float64)
        cols = np.clip(x0.astype(np.int64) + tap - 1, 0, src - 1)
        np.add.at(m, (np.arange(dst), cols), w)
    return m


def render_targets(kps: torch.Tensor, size: int, heatmap: int) -> torch.Tensor:
    """(B, K, 3) keypoints on a size x size image -> (B, K, hm, hm) f32."""
    k = kps.double()
    r = torch.as_tensor(cubic_resize(size, heatmap), device=k.device)
    xs = torch.arange(size, dtype=torch.float64, device=k.device)

    def gauss(c):
        lo = torch.floor(torch.clamp(c - WINDOW, min=0.0))
        hi = torch.floor(torch.clamp(c + WINDOW, max=float(size)))
        g = torch.exp(-((xs - c[..., None]) ** 2) / (2 * SIGMA ** 2))
        return g * ((xs >= lo[..., None]) & (xs < hi[..., None])), lo, hi

    gx, xlo, xhi = gauss(k[..., 0])
    gy, ylo, yhi = gauss(k[..., 1])
    valid = (k[..., 0] >= 0) & (k[..., 1] >= 0) & (k[..., 2] != 0) & (xlo < xhi) & (ylo < yhi)
    hm = (gy @ r.t())[..., :, None] * (gx @ r.t())[..., None, :]
    return (hm * valid[..., None, None]).float()


def keypoint_loss(pred, target, vis):
    mask = (vis > 1).float()[..., None, None]
    diff = (pred - target).square()
    return (torch.exp(-diff.detach()) * diff * mask).mean()


def z_loss(pred, target, vis):
    mask = (vis > 1).float()
    return (pred * mask - target * mask).abs().mean()


class LossWeight:
    def __init__(self, device):
        self.weight = torch.tensor(0.1, device=device)
        self.kp_avg = self.z_avg = None

    def update(self, kp, z):
        kp, z = kp.detach(), z.detach()
        self.kp_avg = kp if self.kp_avg is None else 0.9 * self.kp_avg + 0.1 * kp
        self.z_avg = z if self.z_avg is None else 0.9 * self.z_avg + 0.1 * z
        self.weight = torch.clamp(0.9 * self.weight + 0.1 * (kp + 1e-8) / (z + 1e-8), 1e-3, 10.0)

    def objective(self, kp, z):
        return kp / (self.kp_avg + 1e-8) + z / (self.z_avg + 1e-8)


class AdamW:
    def __init__(self, lr: float, weight_decay: float):
        self.lr, self.wd, self.t = lr, weight_decay, 0
        self.m: dict = {}
        self.v: dict = {}

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for n, p in params.items():
            g = grads[n]
            m = self.m.get(n, torch.zeros_like(p)) * 0.9 + 0.1 * g
            v = self.v.get(n, torch.zeros_like(p)) * 0.999 + 0.001 * g * g
            self.m[n], self.v[n] = m, v
            with torch.no_grad():
                p.mul_(1 - self.lr * self.wd)
                p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + 1e-8))


def first_grad_layer(model: PoseModel, finetune: dict) -> int:
    """The lowest layer whose forward needs autograd."""
    if finetune.get("use_lora"):
        return min(model.adapters)
    return model.s.layers - int(finetune.get("unfreeze_last_n_layers", 0))


def train_steps(W: dict, shape, finetune: dict, batches: list, trainable: list, *, seed: int,
                lr: float, weight_decay: float, size: int, precision) -> dict:
    """Run ``len(batches)`` train steps from the weights ``W`` (updated in
    place) and return, per step, ``kp_loss``, ``z_loss``, ``loss`` and
    ``weight``; the first step's gradient of every trainable leaf
    (``grad1``); the leaves before the first step (``start``)."""
    model = PoseModel(W, shape, finetune, precision)
    first = first_grad_layer(model, finetune)
    params = {n: W[n] for n in trainable}
    start = {n: p.detach().clone() for n, p in params.items()}
    opt, lw = AdamW(lr, weight_decay), LossWeight(next(iter(params.values())).device)
    out = {"steps": [], "start": start}
    for t, batch in enumerate(batches):
        for p in params.values():
            p.requires_grad_(True)
        kps, img = batch["2d_keypoints"], batch["image"]
        device = img.device
        draws = dropout_draws(step_generator(seed, t, device), device, img.shape[0],
                              (size // shape.patch) ** 2 + 1, shape, bool(finetune.get("use_lora")))
        target = render_targets(kps, size, shape.heatmap)
        hm, z = model.forward(img, train=True, first_grad=first, masks=draws)
        vis = kps[..., 2]
        kp_l, z_l = keypoint_loss(hm, target, vis), z_loss(z, batch["z_coords"], vis)
        lw.update(kp_l, z_l)
        loss = lw.objective(kp_l, z_l)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(params.items(), got)}
        for p in params.values():
            p.requires_grad_(False)
        if t == 0:
            out["grad1"] = {n: g.detach().clone() for n, g in grads.items()}
        opt.step(params, grads)
        out["steps"].append({"kp_loss": kp_l.item(), "z_loss": z_l.item(),
                             "loss": lw.objective(kp_l, z_l).item(),
                             "weight": lw.weight.item()})
        del hm, z, loss, got, grads
    return out


def decode(hm: torch.Tensor, size: int) -> torch.Tensor:
    """(B, K, h, w) heatmaps -> (B, K, 2) keypoints in pixels of a size x
    size input."""
    b, k, h, w = hm.shape
    idx = hm.reshape(b, k, h * w).argmax(-1)
    return centroid(hm, idx, size)


def centroid(hm: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """The 5 x 5 value-weighted centroid of ``hm`` around the flat cells
    ``idx`` (B, K), in pixels of a size x size input."""
    b, k, h, w = hm.shape
    cy, cx = (idx // w)[..., None, None], (idx % w)[..., None, None]
    rows = torch.arange(h, device=hm.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=hm.device).view(1, 1, 1, w)
    win = torch.where(((rows - cy).abs() <= 2) & ((cols - cx).abs() <= 2), hm, torch.zeros_like(hm))
    total = win.sum((-2, -1))
    x = ((cols + 0.5) * win).sum((-2, -1)) / total
    y = ((rows + 0.5) * win).sum((-2, -1)) / total
    return torch.stack([x / w * size, y / h * size], dim=-1)
