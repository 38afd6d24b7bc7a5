"""Weights and inputs made from ``--seed``, on the run's device, in a few
large draws from one ``torch.Generator``: the same seed gives the same
tensors, and both the program and the reference are handed them.

Weights follow ``reference/spec.parameters`` (float32, the type the program
keeps its parameters in). Training batches follow the loader's contract:
f32 normalised pixels, (B, K, 3) keypoints with visibility in {0, 1, 2},
(B, K) z; no heatmap targets (the step renders them). Serving requests are
(b, 3, H, W) f32 host arrays of normalised frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from posebench.reference import spec as S

_MIX = 0x9E3779B97F4A7C15


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one named use (``stream``) of the run seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream * _MIX) % 2**63)


def weights(shape: S.ModelShape, finetune: dict, seed: int, device) -> dict:
    """Every tensor of the model's state dict, drawn from ``seed``: one
    uniform and one normal draw over all tensors, then each slice scaled."""
    params = S.parameters(shape, finetune)
    gen = generator(seed, 1, device)
    n_u = sum(math.prod(s) for _, s, init in params if init[0] in "ur")
    n_n = sum(math.prod(s) for _, s, init in params if init[0] == "n")
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, i_n = {}, 0, 0
    for name, shp, init in params:
        k = math.prod(shp)
        if init[0] == "u":
            t = (uni[iu:iu + k] * 2 - 1) * init[1]
            iu += k
        elif init[0] == "r":
            t = uni[iu:iu + k] * (init[2] - init[1]) + init[1]
            iu += k
        elif init[0] == "n":
            t = nor[i_n:i_n + k] * init[1]
            i_n += k
        elif name.endswith("num_batches_tracked"):
            t = torch.zeros((), dtype=torch.long, device=device)
        else:
            t = torch.full((k,), float(init[1]), device=device)
        out[name] = t.reshape(shp)
    return out


def train_batches(n: int, batch: int, size: int, keypoints: int, seed: int, device) -> list[dict]:
    """``n`` distinct loader-contract batches (every row differs)."""
    gen = generator(seed, 2, device)
    img = torch.randn((n, batch, 3, size, size), generator=gen, device=device)
    xy = torch.rand((n, batch, keypoints, 2), generator=gen, device=device) * (size - 44) + 20
    u = torch.rand((n, batch, keypoints), generator=gen, device=device)
    vis = torch.where(u < 0.8, 2.0, torch.where(u < 0.9, 1.0, 0.0))
    z = torch.randn((n, batch, keypoints), generator=gen, device=device)
    kps = torch.cat([xy, vis[..., None]], dim=-1)
    return [{"image": img[i], "2d_keypoints": kps[i].contiguous(), "z_coords": z[i]}
            for i in range(n)]


def request_frames(frames: int, size: int, seed: int, device) -> np.ndarray:
    """A pool of ``frames`` normalised (3, size, size) frames, host f32."""
    gen = generator(seed, 3, device)
    return torch.randn((frames, 3, size, size), generator=gen, device=device).cpu().numpy()

