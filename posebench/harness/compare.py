"""The numbers that decide ``correct``, from the readings of two sides: the
program (or, for the control, the reference in fp8 put in its place) and
the float32 reference. Each is a gap that reads 0 where the two agree.

Training (three steps from the same weights, batches and dropout draws):
- ``loss_gap``: over the three steps and the step's ``kp_loss``,
  ``z_loss``, ``loss`` and ``weight``, the largest |a - r| / |r|;
- ``grad_gap``: over the trainable leaves, the largest gap between the two
  norms of the first step's gradient, |‖g‖ - ‖g_r‖| / max(‖g_r‖, the
  median leaf's ‖g_r‖);
- ``grad_err``: the same of the norm of their difference, ‖g - g_r‖ /
  max(‖g_r‖, the median leaf's ‖g_r‖): norms move little under rounding
  that is random from element to element, the difference does not;
- ``change_gap``: the same of the leaves' change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam).

Serving (the sampled requests, through the same weights):
- ``hm_gap``: the largest ‖hm - hm_r‖ / ‖hm_r‖ of a request's heatmaps;
- ``z_gap``: the same of its z;
- ``peak_gap``: over every keypoint of every image, how far below the
  reference heatmap's peak its value at the served argmax lies, as a share
  of that heatmap's range;
- ``kp_gap``: the median, over every keypoint whose reference window is
  well posed, of the distance in heatmap cells between the served keypoint
  and the reference heatmap's centroid around the served argmax (the
  decode's window, read on the reference). Not the largest distance nor
  the root mean square: a few windows that are barely well posed swing
  those from seed to seed, in the program and in the control. Well posed: the window's sum is at least
  half the sum of its absolute values; with seeded weights a heatmap can
  change sign near its peak, and a centroid over a window that sums to
  nearly 0 moves without bound under any rounding.
"""

from __future__ import annotations

import statistics

import torch

from posebench.reference.steps import centroid

TRAIN_NUMBERS = ("loss_gap", "grad_gap", "grad_err", "change_gap")
SERVE_NUMBERS = ("hm_gap", "z_gap", "peak_gap", "kp_gap")
STAT_KEYS = ("kp_loss", "z_loss", "loss", "weight")


def worst(values) -> float:
    """The largest of ``values``; infinite where one is not a number (a
    plain ``max`` would pass over a NaN)."""
    values = [float(v) for v in values]
    return float("inf") if any(v != v for v in values) else max(values)


def train_gaps(side: dict, ref: dict) -> dict:
    """``side``/``ref``: {"steps": [{stat: float}], "grad1": {leaf: norm},
    "grad1_t": {leaf: tensor}, "change": {leaf: norm}}."""
    loss = worst(abs(a[k] - r[k]) / abs(r[k]) for a, r in zip(side["steps"], ref["steps"])
                 for k in STAT_KEYS)
    g_ref = ref["grad1"]
    g_med = statistics.median(g_ref.values())
    grad = worst(abs(side["grad1"][n] - g) / max(g, g_med) for n, g in g_ref.items())
    err = worst(float((side["grad1_t"][n].double() - ref["grad1_t"][n].double()).norm())
                / max(g, g_med) for n, g in g_ref.items())
    moving = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moving)
    change = worst(abs(side["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
                   for n in moving)
    return {"loss_gap": loss, "grad_gap": grad, "grad_err": err, "change_gap": change}


def serve_gaps(served: list, ref: list, size: int) -> dict:
    """``served``/``ref``: per request (keypoints (b, K, 2), z (b, K),
    heatmaps (b, K, h, w)) as tensors on one device."""
    gaps = {n: [] for n in SERVE_NUMBERS}
    kp_dist = []
    for (kp, z, hm), (_, z_r, hm_r) in zip(served, ref):
        gaps["hm_gap"].append((hm - hm_r).norm() / hm_r.norm())
        gaps["z_gap"].append((z - z_r).norm() / z_r.norm())
        b, k, h, w = hm.shape
        idx = hm.reshape(b, k, h * w).argmax(-1)
        flat = hm_r.reshape(b, k, h * w)
        top, low = flat.amax(-1), flat.amin(-1)
        at = flat.gather(-1, idx[..., None])[..., 0]
        gaps["peak_gap"].append(((top - at) / (top - low)).max())
        dist = (kp - centroid(hm_r, idx, size)).norm(dim=-1) / (size / w)
        dist = torch.where(torch.isfinite(dist), dist, float("inf"))
        posed = well_posed(hm_r, idx)
        kp_dist.append(dist[posed])
    gaps = {n: worst(torch.stack(v).tolist()) for n, v in gaps.items() if v}
    gaps["kp_gap"] = worst([torch.cat(kp_dist).median()])
    return {n: gaps[n] for n in SERVE_NUMBERS}


def well_posed(hm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, K) bools: the 5 x 5 window of ``hm`` around the flat cells
    ``idx`` sums to at least half the sum of its absolute values."""
    b, k, h, w = hm.shape
    cy, cx = (idx // w)[..., None, None], (idx % w)[..., None, None]
    rows = torch.arange(h, device=hm.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=hm.device).view(1, 1, 1, w)
    inside = ((rows - cy).abs() <= 2) & ((cols - cx).abs() <= 2)
    win = torch.where(inside, hm, torch.zeros_like(hm))
    return win.sum((-2, -1)).abs() >= 0.5 * win.abs().sum((-2, -1))


def leaf_norms(tensors: dict) -> dict:
    return {n: float(t.detach().double().norm()) for n, t in tensors.items()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a number
    that is not finite, or has no limit yet, fails."""
    out = {n: {"value": v, "limit": limits.get(n)} for n, v in numbers.items()}
    ok = all(v == v and limits.get(n) is not None and v <= limits[n] for n, v in numbers.items())
    return ok, out
