"""The ConvFFN kernels' host side and decomposition, on the CPU.

``convffn_plan`` (dino_pose_tpu_torch/ops/convffn.py) chooses each launch of
``convffn_kernel<BWD, NWG, NSW, LANES>``: it must exist as an instance, fit
shared memory (``convffn_smem``, the kernel's ``make_layout``), cover every
output slice, and size the backward's partial sets. It is checked at every
fastvit_t8, fastvit_sa12 and fastvit_ma36 stage shape (ma36 through
``pad_widths``' multiples of 16) at batch 1, 8, 32 and 128, ranks 1 and 8,
on a 132-SM card (the forward's H split where the row tiles would fill
less than half of it), and cached per shape.

The kernels' decomposition is then run in plain PyTorch at f32 (no
rounding): 64-row tiles, 64-column chunks of H, the rank zero-padded to the
n8 products' 8 columns and the k16 steps' 16 rows, dg as the K-concatenated
[df | du2b] @ [W2^T ; A2^T], dm's du1b @ A1^T added to its accumulator,
per-tile partial sets in the kernel's layout (dB1 and dB2 unscaled) summed
in order with s applied after the sum. It must match ``convffn_math`` and
``convffn_bwd_math`` to 1e-5 of each output's largest magnitude (f32 sums in
another order) and JAX's Pallas ConvFFN kernels, run in interpret mode as
tests/test_torch_convffn.py runs them, to 2e-5.
"""

import numpy as np
import pytest
import torch

from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu_torch.ops import convffn as tconvffn
from test_torch_convffn import _inputs, _jax_vjp, _run_both

SMS = 132
# (model, C, H, S at 256²), C and H as the kernels take them (ma36 padded).
STAGES = [
    ("t8", 48, 144, 4096), ("t8", 96, 288, 1024), ("t8", 192, 576, 256), ("t8", 384, 1152, 64),
    ("sa12", 64, 256, 4096), ("sa12", 128, 512, 1024), ("sa12", 256, 1024, 256),
    ("sa12", 512, 2048, 64),
    ("ma36", 80, 304, 4096), ("ma36", 160, 608, 1024), ("ma36", 304, 1216, 256),
    ("ma36", 608, 2432, 64),
]
TOL = 1e-5


@pytest.mark.parametrize("bwd", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
@pytest.mark.parametrize("stage", STAGES, ids=lambda t: f"{t[0]}-C{t[1]}")
def test_plan_fits_and_covers_every_stage(stage, batch, bwd):
    _, c, h, s = stage
    for r in (1, 8):
        m = batch * s
        plan = tconvffn.convffn_plan(bwd, m, c, h, r, SMS)
        nc, nch, tiles = -(-c // 64), -(-h // 64), -(-m // 64)
        assert (bwd, plan.nwg, plan.nsw, plan.lanes) in tconvffn.INSTANCES
        assert plan.nwg == 1 or plan.lanes == 1
        assert plan.smem == tconvffn.convffn_smem(bwd, c, h, r, plan.nwg, plan.lanes, plan.tb,
                                                  plan.rs, plan.dfr, plan.lres, plan.persist)
        assert plan.smem <= tconvffn._SMEM_LIMIT
        # Every 64-column output slice is held by some pass and warpgroup.
        assert plan.passes * plan.nwg * plan.nsw >= nc > (plan.passes - 1) * plan.nwg * plan.nsw
        if plan.resident:
            assert plan.passes == 1 and not plan.dfr and plan.rs == nch * nc * (3 if bwd else 2)
        else:
            assert plan.rs in (4, 6, 8)
        assert not plan.dfr or (bwd and plan.lanes == 1)
        groups = -(-tiles // plan.lanes)
        ng = -(-nch // plan.nwg)
        if plan.splits > 1:
            # The forward's H split: chunk groups [split * cpg, ...) cover H once,
            # on a card that the row tiles alone would fill less than half.
            assert not bwd and 2 * groups <= SMS and not plan.resident
            assert plan.splits * plan.cpg >= ng > (plan.splits - 1) * plan.cpg
            assert plan.blocks == groups * plan.splits <= SMS
        elif not bwd or plan.persist:
            assert plan.cpg >= ng and plan.blocks == min(groups, SMS)
        else:
            assert plan.blocks == groups
        assert not plan.persist or (bwd and groups > SMS)
        assert plan.sets == (plan.blocks * plan.lanes if plan.persist else tiles)
        assert plan.tb == 1 or groups > SMS


def test_plan_is_cached_per_shape():
    tconvffn.convffn_plan.cache_clear()
    first = tconvffn.convffn_plan(True, 128 * 4096, 48, 144, 8, SMS)
    assert tconvffn.convffn_plan(True, 128 * 4096, 48, 144, 8, SMS) is first
    assert tconvffn.convffn_plan.cache_info().hits == 1


def test_smem_counts_each_region():
    base = dict(bwd=True, c=128, h=512, r=8, nwg=1, lanes=1, tb=1, rs=4, dfr=False, lres=False,
                persist=False)
    smem = tconvffn.convffn_smem(**base)
    # A second tile buffer: m and df, 2 boxes each at C = 128; a ring slot.
    assert tconvffn.convffn_smem(**{**base, "tb": 2}) - smem == 4 * 8192 + 16
    assert tconvffn.convffn_smem(**{**base, "rs": 5}) - smem == 8192 + 16
    # df through the ring: one tile buffer holds m only.
    assert smem - tconvffn.convffn_smem(**{**base, "dfr": True}) == 2 * 8192
    # The partial set, rounded up to 1 KB: 2C + 2R(C + H) floats.
    pf = tconvffn.partial_floats(128, 512, 8)
    assert tconvffn.convffn_smem(**{**base, "persist": True}) - smem == -(-pf * 4 // 1024) * 1024
    # Every chunk's rank tiles resident (8 chunks: 17 KB) in place of the
    # warpgroup's 3 KB.
    assert tconvffn.convffn_smem(**{**base, "lres": True}) - smem == (17 - 3) * 1024


def test_partial_floats_is_the_gradient_layout():
    c, h, r = 48, 144, 8
    grads = tconvffn.ConvFFNGrads(inv=torch.zeros(c), shift=torch.zeros(c), a1=torch.zeros(c, r),
                                  b1l=torch.zeros(r, h), a2=torch.zeros(h, r), b2l=torch.zeros(r, c))
    assert tconvffn.partial_floats(c, h, r) == sum(t.numel() for t in grads)


def _pad(t: torch.Tensor, rows: int = 0, cols: int = 0) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cols, 0, rows))


def _rank_operands(p: tconvffn.ConvFFNParams):
    """The rank factors as the kernel's tiles hold them: the n8 products'
    operands zero-padded to 8 rank columns, the k16 steps' to 16 rows."""
    r = p.a1.shape[1]
    return (_pad(p.a1, cols=8 - r), _pad(p.b1l, rows=16 - r), _pad(p.a2, cols=8 - r),
            _pad(p.b2l, rows=16 - r), _pad(p.m1, cols=8 - r), _pad(p.m2, cols=8 - r))


def _tiles(m: int):
    return [slice(t, min(t + 64, m)) for t in range(0, m, 64)]


def _tiled_fwd(y, p, s_lora):
    """The forward kernel's decomposition in f32: per 64-row tile, u1 (n8),
    then per 64-column chunk h with its own l1 (k16, rank rows to 16), g,
    u2 += g @ A2 (n8) and out += g @ W2; then the up-term u2b @ B2 (k16)."""
    b, sq, c = y.shape
    h = p.w1.shape[1]
    a1, b1l, a2, b2l, m1, m2 = _rank_operands(p)
    rows = torch.arange(b * sq) // sq
    m = (y.reshape(-1, c) * p.inv + p.shift)
    out = torch.empty_like(m)
    for t in _tiles(b * sq):
        u1 = _pad((m[t] @ a1) * m1[rows[t]], cols=8)
        acc, u2 = torch.zeros(m[t].shape[0], c), torch.zeros(m[t].shape[0], 8)
        for j in range(0, h, 64):
            ch = slice(j, min(j + 64, h))
            g = torch.nn.functional.gelu(m[t] @ p.w1[:, ch] + p.b1[ch] + (u1 @ b1l[:, ch]) * s_lora)
            u2 += g @ a2[ch]
            acc += g @ p.w2[ch]
        out[t] = acc + p.b2 + (_pad(u2 * m2[rows[t]], cols=8) @ b2l) * s_lora
    return out.reshape(b, sq, c)


def _tiled_bwd(y, df, p, s_lora):
    """The backward kernel's decomposition in f32: per tile du2 (n8), per
    chunk h, dg = [df | du2b] @ [W2^T ; A2^T] in one product, dh, u2, du1
    and the chunk's dA2, dB1^T; dm += du1b @ A1^T after the walk; each
    tile's partial set in the kernel's layout (dB1, dB2 unscaled), the sets
    summed in order and s applied to dB1 and dB2 after the sum."""
    b, sq, c = y.shape
    h, r = p.w1.shape[1], p.a1.shape[1]
    a1, b1l, a2, b2l, m1, m2 = _rank_operands(p)
    rows = torch.arange(b * sq) // sq
    yf, dff = y.reshape(-1, c), df.reshape(-1, c)
    m = yf * p.inv + p.shift
    dy = torch.empty_like(m)
    n = tconvffn.partial_floats(c, h, r)
    off_a1, off_b1 = 2 * c, 2 * c + c * r
    off_a2, off_b2 = off_b1 + r * h, off_b1 + 2 * r * h
    sets = []
    for t in _tiles(b * sq):
        part = torch.zeros(n)
        k1, k2 = m1[rows[t]], m2[rows[t]]
        u1 = _pad((m[t] @ a1) * k1, cols=8)
        du2 = _pad((dff[t] @ b2l[:8].t()) * s_lora * k2, cols=8)
        dm, u2, du1 = torch.zeros(m[t].shape[0], c), torch.zeros(m[t].shape[0], 8), 0.0
        for j in range(0, h, 64):
            ch = slice(j, min(j + 64, h))
            hh = m[t] @ p.w1[:, ch] + p.b1[ch] + (u1 @ b1l[:, ch]) * s_lora
            g = torch.nn.functional.gelu(hh)
            dg = torch.cat([dff[t], du2], 1) @ torch.cat([p.w2[ch].t(), _pad(a2[ch], cols=8).t()])
            dh = dg * tconvffn._gelu_grad(hh)
            u2 = u2 + g @ a2[ch]
            du1 = du1 + dh @ b1l[:8, ch].t()
            part[off_a2:off_b2].view(h, r)[ch] = (g.t() @ du2[:, :8])[:, :r]
            part[off_b1:off_a2].view(r, h)[:, ch] = (dh.t() @ u1[:, :8]).t()[:r]
            dm += dh @ p.w1[:, ch].t()
        du1b = _pad(du1 * s_lora * k1, cols=8)
        u2b = u2 * k2
        dm += du1b @ _pad(a1, cols=8).t()
        dy[t] = dm * p.inv
        part[:c], part[c:2 * c] = (dm * yf[t]).sum(0), dm.sum(0)
        part[off_a1:off_b1] = (m[t].t() @ du1b[:, :8])[:, :r].reshape(-1)
        part[off_b2:] = (dff[t].t() @ u2b).t()[:r].reshape(-1)
        sets.append(part)
    total = torch.zeros(n)
    for part in sets:  # the reduce kernel's order
        total += part
    total[off_b1:off_a2] *= s_lora
    total[off_b2:] *= s_lora
    shapes = ((c,), (c,), (c, r), (r, h), (h, r), (r, c))
    sizes = [int(np.prod(shape)) for shape in shapes]
    grads = tconvffn.ConvFFNGrads(*(g.view(shape) for g, shape in zip(total.split(sizes), shapes)))
    return dy.reshape(b, sq, c), grads


def _close(got: torch.Tensor, want: torch.Tensor, tol: float = TOL) -> bool:
    return float((got - want).abs().max()) <= tol * max(float(want.abs().max()), 1e-30)


def _torch_params(p: dict) -> tconvffn.ConvFFNParams:
    return tconvffn.ConvFFNParams(**{k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("rank", [1, 4, 8, 0])
@pytest.mark.parametrize("s", [64, 49], ids=["S64", "S49-ragged"])
def test_tiled_forward_matches_plain_and_jax_f32(s, rank, monkeypatch):
    y, p = _inputs(s, rank, seed=100 + s + rank)
    tp = _torch_params(p)
    got = _tiled_fwd(torch.from_numpy(y), tp, 4.0)
    assert _close(got, tconvffn.convffn_math(torch.from_numpy(y), tp, 4.0))
    _, jax_out = _run_both(y, p, torch.float32, monkeypatch)
    assert _close(got, torch.from_numpy(np.array(jax_out)), 2 * TOL)


@pytest.mark.parametrize("rank", [1, 4, 8, 0])
@pytest.mark.parametrize("s", [64, 49], ids=["S64", "S49-ragged"])
def test_tiled_backward_matches_plain_and_jax_f32(s, rank, monkeypatch):
    y, p = _inputs(s, rank, seed=200 + s + rank)
    df = np.random.default_rng(s + rank).standard_normal(y.shape).astype(np.float32)
    tp = _torch_params(p)
    yt, dft = torch.from_numpy(y), torch.from_numpy(df)
    dy, grads = _tiled_bwd(yt, dft, tp, 4.0)
    want_dy, want = tconvffn.convffn_bwd_math(yt, dft, tp, 4.0)
    assert _close(dy, want_dy)
    for name in tconvffn.ConvFFNGrads._fields:
        assert _close(getattr(grads, name), getattr(want, name)), name
    jdy, jgrads = _jax_vjp(y, df, p, jconvffn.jnp.float32, monkeypatch)
    assert _close(dy, torch.from_numpy(np.array(jdy)), 2 * TOL)
    for name in ("inv", "shift", "a1", "b1l", "a2", "b2l"):
        assert _close(getattr(grads, name), torch.from_numpy(np.array(jgrads[name])), 2 * TOL), name
