"""The streamed attention kernels' decomposition, on the CPU.

``flash_fwd_kernel``, ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``
(dino_pose_tpu_torch/ops/csrc/flash_kernels.cu) are run here as their tile
plan does the arithmetic, in plain PyTorch at f32: 64-key tiles over
operands zero-filled past S (as TMA lands them), the forward's first pass
keeping each row's max and its sum of exp2(s*scale*log2e - m*log2e),
rescaled as the max moves, the second pass P = exp2(...) * (1/l) against V;
the backward's dq pass summing rowsum(P * dP) into stats row 2 and dq = (P *
(dP - rowsum)) K * scale, and the dkv pass walking 64-query tiles per key
tile with P^T and dS^T rebuilt from the (m*log2e, 1/l, rowsum) triples;
keys >= S masked to P = 0. It must match ``flash_math`` / ``flash_bwd_math``
and JAX's ``flash_attention`` vjp, run in interpret mode as
tests/test_torch_attention.py runs it, to 1e-5 of each output's largest
magnitude (f32 sums in another order). The kernels' shared memory is held
by static_asserts in the source, their tensor maps and launches by the card
tests of tests/test_torch_cuda.py.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.ops import attention as tattention

jattention = importlib.import_module("dino_pose_tpu.ops.attention")

TOL = 1e-5
LOG2E = 1.4426950408889634


def _padded(*tensors):
    """The operands as TMA lands them: rows past S zero-filled to whole
    64-row tiles; and the tiles' (start, end) rows."""
    s = tensors[0].shape[2]
    sp = -(-s // 64) * 64
    return ([torch.nn.functional.pad(t, (0, 0, 0, sp - s)) for t in tensors],
            [(t, t + 64) for t in range(0, sp, 64)])


def _tiled_fwd(q, k, v, scale):
    """flash_fwd_kernel's arithmetic in f32: (o, stats rows 0 and 1)."""
    b, h, s, dh = q.shape
    c = scale * LOG2E
    (q, k, v), tiles = _padded(q, k, v)
    valid = torch.arange(k.shape[2]) < s  # keys >= S: masked
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    for k0, k1 in tiles:
        sc = (q @ k[:, :, k0:k1].transpose(-1, -2)).masked_fill(~valid[k0:k1], -math.inf)
        mnew = torch.maximum(m, sc.amax(-1))
        l = l * torch.exp2((m - mnew) * c) + torch.exp2(sc * c - (mnew * c)[..., None]).sum(-1)
        m = mnew
    mc, rl = m * c, 1.0 / l
    o = torch.zeros_like(q)
    for k0, k1 in tiles:
        p = torch.exp2((q @ k[:, :, k0:k1].transpose(-1, -2)) * c - mc[..., None]) * rl[..., None]
        o += p.masked_fill(~valid[k0:k1], 0.0) @ v[:, :, k0:k1]
    return o[:, :, :s], torch.stack([m * scale, l], 2)[..., :s]


def _tiled_bwd(q, k, v, do, stats, scale):
    """flash_bwd_dq_kernel then flash_bwd_dkv_kernel in f32, through stats
    row 2: (dq, dk, dv, rowsum)."""
    b, h, s, dh = q.shape
    c = scale * LOG2E
    (q, k, v, do), tiles = _padded(q, k, v, do)
    valid = torch.arange(k.shape[2]) < s
    # A query row past S reads m = 0 and 1/l = 0 (so P = 0): the kernels'
    # statistics of rows they never write.
    pad = (0, k.shape[2] - s)
    mc = torch.nn.functional.pad(stats[:, :, 0] * LOG2E, pad)
    rl = torch.nn.functional.pad(1.0 / stats[:, :, 1], pad)

    def probs(sc, mrow, rrow):
        return torch.exp2(sc * c - mrow) * rrow

    rs = torch.zeros(q.shape[:3])
    for k0, k1 in tiles:
        p = probs(q @ k[:, :, k0:k1].transpose(-1, -2), mc[..., None], rl[..., None])
        p = p.masked_fill(~valid[k0:k1], 0.0)
        rs += (p * (do @ v[:, :, k0:k1].transpose(-1, -2))).sum(-1)
    dq = torch.zeros_like(q)
    for k0, k1 in tiles:
        p = probs(q @ k[:, :, k0:k1].transpose(-1, -2), mc[..., None], rl[..., None])
        ds = p.masked_fill(~valid[k0:k1], 0.0) * ((do @ v[:, :, k0:k1].transpose(-1, -2))
                                                   - rs[..., None])
        dq += ds @ k[:, :, k0:k1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0, k1 in tiles:  # a dkv block's key tile
        kt, vt = k[:, :, k0:k1], v[:, :, k0:k1]
        for q0, q1 in tiles:  # its walk over the query tiles
            pt = probs(kt @ q[:, :, q0:q1].transpose(-1, -2), mc[:, :, None, q0:q1],
                       rl[:, :, None, q0:q1])
            dst = pt * ((vt @ do[:, :, q0:q1].transpose(-1, -2)) - rs[:, :, None, q0:q1])
            dv[:, :, k0:k1] += pt @ do[:, :, q0:q1]
            dk[:, :, k0:k1] += dst @ q[:, :, q0:q1]
    return dq[:, :, :s] * scale, dk[:, :, :s] * scale, dv[:, :, :s], rs[..., :s]


# (B, H, S, dh): one tile, a ragged second tile (S = 65, 130), three ragged
# tiles at head width 32, and a single key.
DECOMP_SHAPES = [(2, 2, 64, 32), (1, 3, 65, 64), (2, 2, 130, 64), (1, 2, 200, 32), (2, 2, 1, 64)]


@pytest.fixture(scope="module")
def cases():
    """Each shape's seeded f32 inputs and JAX's outputs, computed once."""
    out = {}
    for shape in DECOMP_SHAPES:
        rng = np.random.default_rng(sum(shape))
        q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
        scale = shape[-1] ** -0.5
        o, vjp = jax.vjp(lambda *a: jattention.flash_attention(*a, scale),
                         *(jnp.asarray(t) for t in (q, k, v)))
        grads = vjp(jnp.asarray(g))
        out[shape] = ((q, k, v, g), scale, [np.asarray(t) for t in (o, *grads)])
    return out


def _close(got: torch.Tensor, want, what: str) -> None:
    want = torch.as_tensor(np.array(want))
    err = (got - want).abs().max().item()
    assert err <= TOL * max(want.abs().max().item(), 1e-30), (what, err)


@pytest.mark.parametrize("shape", DECOMP_SHAPES, ids=lambda t: "x".join(map(str, t)))
def test_decomposition_matches_plain_and_jax(cases, shape):
    (q, k, v, g), scale, jax_out = cases[shape]
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    o, stats = _tiled_fwd(tq, tk, tv, scale)
    dq, dk, dv, rs = _tiled_bwd(tq, tk, tv, tg, stats, scale)
    plain = (tattention.flash_math(tq, tk, tv, scale),
             *tattention.flash_bwd_math(tq, tk, tv, tg, scale))
    for name, got, want, from_jax in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), plain, jax_out):
        _close(got, want, f"{name} vs plain")
        _close(got, from_jax, f"{name} vs JAX")
    # Stats row 2 is rowsum(P * dP) = rowsum(dO * O) in exact arithmetic.
    _close(rs, (tg * plain[0]).sum(-1), "rowsum")
