"""The RepMixer-combine + depthwise-conv pair kernels' host side and
decomposition, on the CPU.

``_plan`` (dino_pose_tpu_torch/ops/dwconv.py) chooses each launch of
``pair_kernel<K, BWD>`` (ops/csrc/dwconv_kernels.cu): it must exist as an
instance (k = 3 or 7, C a multiple of 8 after the wrapper's padding), fit
shared memory (``_pair_smem``, the kernel's ``PairLayout``; the card tests
hold it against ``dp_pair_smem``), cover every output pixel once, take the
deepest TMA ring that fits, and size the backward's sums' slots (one a
block). It is checked at fastvit_t8's stage 0 and 1 shapes at 256², batch
1, 8, 32 and 128, k = 3 and 7, at the ragged (48, 24) and (96, 56) shapes and
at C = 76 and 20 (padded to 80 and 24), on a 132-SM card, and cached per
shape.

The kernels' decomposition is then run in plain PyTorch at f32: items of
(sample, band, column tile, channel group) walked by persistent blocks,
TMA-style boxes of two input rows zero-filled outside the tensor, the
combine, the mask of pixels outside the image, the conv from an f32 ring of
rows, and the backward's per-thread sums added by slot within a block and
by block in order. It must match ``combine_dw_math`` and
``combine_dw_bwd_math`` (x2 bit-equal, the rest to 1e-5 of each output's
largest magnitude: the same f32 products summed in another order) and
JAX's Pallas kernels, run in interpret mode as tests/test_torch_dwconv.py
runs them, at H <= 16 or a multiple of 16 (JAX's ``_tap_conv`` ragged-chunk
fault, ROADMAP.md Queue 3), to 2e-5. One case shows the mask is needed: with
bias = 4 and a = b = 1 the combine of two zero-filled boxes is 4, and a
decomposition that kept it would move y7's border rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dwconv import _combine_args, _count, _jit, _np

from dino_pose_tpu.ops import dwconv as jdwconv
from dino_pose_tpu_torch.ops import dwconv as tdwconv

SMS = 132
RB = tdwconv.PAIR_RB
TOL = 1e-5
# (C, H = W): t8's stage 0 and 1 at 256², ragged rows and columns, and
# widths the wrapper pads to a multiple of 8 (fastvit_ma36's 76, and 20).
PLAN_SHAPES = [(48, 64), (96, 32), (48, 24), (96, 56), (76, 16), (20, 24)]
MODES = {"fwd": tdwconv.COMBINE, "bwd": tdwconv.COMBINE_BWD}


@pytest.fixture
def card(monkeypatch):
    """The plan on a fake card of ``sms`` SMs (132 unless a test sets
    ``card.sms``) that holds two blocks an SM where each takes at most half
    its shared memory, else one; the plan cache emptied before and after."""
    class Card:
        sms = SMS

    monkeypatch.setattr(tdwconv, "_sms", lambda index: Card.sms)
    monkeypatch.setattr(tdwconv, "_occupancy", lambda kk, mode, depth, plan: _blocks(plan[-1]))
    tdwconv._plan.cache_clear()
    yield Card
    tdwconv._plan.cache_clear()


def _blocks(smem: int) -> int:
    return 2 if smem <= tdwconv._SMEM_BUDGET else 1


def _items(plan, b, h, w, c):
    """(item, n, h0, w0, c0) in the kernel's order: the group slowest, then
    sample, band, column tile (``pair_item``)."""
    groups, bands, ctiles = -(-c // plan.cg), -(-h // plan.th), -(-w // plan.twc)
    per = b * bands * ctiles
    for item in range(groups * per):
        g, s = divmod(item, per)
        t, ct = divmod(s, ctiles)
        n, band = divmod(t, bands)
        yield item, n, band * plan.th, ct * plan.twc, g * plan.cg


def _coverage(plan, b, h, w, c) -> np.ndarray:
    """How often the plan's items and steps write each output (row, column,
    channel) of sample 0: an item's threads take its group's channels and
    8-column slots (the plan's ``nt`` is checked to hold them all), each
    output step RB rows within the band and the image. Every sample has the
    same items as sample 0."""
    hits = np.zeros((h, w, c), np.int32)
    per_sample = np.zeros(b, np.int32)
    for _, n, h0, w0, c0 in _items(plan, b, h, w, c):
        per_sample[n] += 1
        if n:
            continue
        for m in range(plan.th // RB):
            hits[h0 + RB * m:min(h0 + RB * m + RB, h0 + plan.th, h),
                 w0:w0 + plan.twc, c0:c0 + plan.cg] += 1
    assert (per_sample == per_sample[0]).all()
    return hits


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("b", [1, 8, 32, 128])
def test_pair_plan_fits_and_covers(b, kk, mode, card):
    """At every shape: an instance the kernel has (8 columns a thread's slot
    forward, 16 backward), shared memory within a block's 227 KB by the
    kernel's formula, the deepest ring (at most 4 stages) that fits (the
    forward's half an SM, two blocks an SM, else a whole SM; the
    backward's a whole SM), threads = the group's channels x slots in whole
    warps (at most 384 forward, 192 backward), a grid of at most one block
    an item and as many as the card holds, and every output written by
    exactly one thread of one item (the sums' slots are one a block:
    ``grid``)."""
    bwd = mode == "bwd"
    for c0, hw in PLAN_SHAPES:
        c = -(-c0 // 8) * 8  # the wrapper's padded width
        plan = tdwconv._plan(b, hw, hw, c, kk, MODES[mode], 0)
        assert plan.tw == tdwconv.PAIR_TW[bwd] == (16 if bwd else 8)
        assert plan.rb == RB and plan.th % RB == 0 and plan.twc % plan.tw == 0
        assert plan.cg % 8 == 0 and plan.cg <= (96 if bwd else 64) and plan.twc + kk - 1 <= 256
        assert plan.nt == -(-plan.cg * plan.twc // plan.tw // 32) * 32 <= (192 if bwd else 384)
        assert plan.smem == tdwconv._pair_smem(kk, bwd, plan.cg, plan.twc, plan.stages, c)
        assert plan.smem <= tdwconv._SMEM_LIMIT and 2 <= plan.stages <= 4

        def smem(stages):
            return tdwconv._pair_smem(kk, bwd, plan.cg, plan.twc, stages, c)

        budget = (tdwconv._SMEM_BUDGET if not bwd and plan.smem <= tdwconv._SMEM_BUDGET
                  else tdwconv._SMEM_LIMIT)
        assert bwd or budget == tdwconv._SMEM_BUDGET or smem(2) > tdwconv._SMEM_BUDGET
        assert plan.stages == 4 or smem(plan.stages + 1) > budget
        items = b * -(-hw // plan.th) * -(-hw // plan.twc) * -(-c // plan.cg)
        assert plan.items == items and plan.grid == min(items, SMS * _blocks(plan.smem))
        assert plan.nt >= plan.cg * (plan.twc // plan.tw)
        assert (_coverage(plan, b, hw, hw, c) == 1).all(), (c, hw, plan)


@pytest.mark.parametrize("mode", list(MODES))
def test_pair_plan_bands(mode, card):
    """t8 at B=128 takes whole images (no halo rows read twice), at most one
    item a block (the forward two blocks an SM); at B=1 and 8 the bands
    shrink until the items fill the card."""
    for c, hw in ((48, 64), (96, 32)):
        big = tdwconv._plan(128, hw, hw, c, 7, MODES[mode], 0)
        assert big.th == hw and (mode == "bwd" or big.smem <= tdwconv._SMEM_BUDGET)
        assert big.items == big.grid <= _blocks(big.smem) * SMS
        for b in (1, 8):
            small = tdwconv._plan(b, hw, hw, c, 7, MODES[mode], 0)
            tiles = -(-hw // small.twc) * -(-c // small.cg)
            assert small.th < hw and small.items == b * -(-hw // small.th) * tiles > b * tiles


def test_pair_plan_is_cached(card):
    first = tdwconv._plan(8, 32, 32, 96, 7, tdwconv.COMBINE, 0)
    assert tdwconv._plan(8, 32, 32, 96, 7, tdwconv.COMBINE, 0) is first
    assert tdwconv._plan(8, 32, 32, 96, 7, tdwconv.COMBINE_BWD, 0) is not first
    assert tdwconv._plan(8, 32, 32, 96, 3, tdwconv.COMBINE, 0) is not first


def test_pair_plan_refuses_what_does_not_fit(card, monkeypatch):
    monkeypatch.setattr(tdwconv, "_SMEM_LIMIT", 20000)
    monkeypatch.setattr(tdwconv, "_SMEM_BUDGET", 10000)
    with pytest.raises(ValueError, match="do not fit shared memory"):
        tdwconv._plan(1, 64, 64, 48, 7, tdwconv.COMBINE_BWD, 0)


# ---------------------------------------------------------------------------
# The decomposition in plain PyTorch.


def _box(t: torch.Tensor, n: int, h0: int, w0: int, c0: int, rows: int, cols: int, cg: int):
    """A TMA box (rows, cols, cg) of the (B, H, W, C) tensor ``t`` at (n,
    h0, w0, c0): zero wherever it leaves the tensor."""
    _, hh, ww, cc = t.shape
    out = torch.zeros(rows, cols, cg, dtype=t.dtype)
    hs, he = max(h0, 0), min(h0 + rows, hh)
    ws, we = max(w0, 0), min(w0 + cols, ww)
    if hs < he and ws < we and c0 < cc:
        out[hs - h0:he - h0, ws - w0:we - w0, :min(cg, cc - c0)] = t[n, hs:he, ws:we, c0:c0 + cg]
    return out


def _group(v: torch.Tensor, c0: int, cg: int) -> torch.Tensor:
    """The group's channels of a (..., C) tensor, zero past C."""
    out = torch.zeros(*v.shape[:-1], cg, dtype=v.dtype)
    part = v[..., c0:c0 + cg]
    out[..., :part.shape[-1]] = part
    return out


def _decompose(plan, kk, x, y0, a, b, bias, kern, dx2bar=None, dy7bar=None, mask=True):
    """pair_kernel's arithmetic in PyTorch: the forward's (x2, y7), or with
    the cotangents the backward's (dx, dy0, da, db, dbias). ``mask=False``
    leaves the combine of zero-filled boxes in the conv ring (the trap)."""
    bsz, h, w, c = x.shape
    bwd = dy7bar is not None
    p, pre = kk // 2, (kk - 1) // RB
    steps, ring, cols = plan.th // RB + pre, RB + kk - 1, plan.twc + kk - 1
    nslots = plan.twc // plan.tw
    taps = kern[:, :, 0, :].float()
    taps = taps.flip(0, 1) if bwd else taps
    out, out2 = torch.zeros_like(x), torch.zeros_like(x)
    slots = torch.zeros(plan.grid, 3, c)
    items = list(_items(plan, bsz, h, w, c))
    for blk in range(plan.grid):
        bsum = torch.zeros(3, c)
        sums = torch.zeros(3, nslots, plan.cg)  # a thread's (slot, channel) sums
        grp = None
        for _, n, h0, w0, c0 in items[blk::plan.grid]:
            cg = plan.cg
            if c0 != grp:
                if bwd and grp is not None:
                    bsum[:, grp:grp + cg] = _group(sums.sum(1), 0, cg)[:, :min(cg, c - grp)]
                    sums.zero_()
                grp = c0
            tp, va, vb, vbias = (_group(v, c0, cg) for v in (taps, a, b, bias))
            h_end = min(h, h0 + plan.th)
            conv = torch.zeros(ring, cols, cg)
            for t in range(steps):
                r0 = h0 - p + t * RB
                if bwd:
                    chunk = _box(dy7bar, n, r0, w0 - p, c0, RB, cols, cg).float()
                else:
                    xb = _box(x, n, r0, w0 - p, c0, RB, cols, cg).float()
                    yb = _box(y0, n, r0, w0 - p, c0, RB, cols, cg).float()
                    x2 = (xb * va + yb * vb + vbias).to(x.dtype)
                    rows = torch.arange(r0, r0 + RB)[:, None, None]
                    wcol = torch.arange(w0 - p, w0 - p + cols)[None, :, None]
                    inside = (rows >= 0) & (rows < h) & (wcol >= 0) & (wcol < w)
                    chunk = torch.where(inside, x2.float(), 0.0) if mask else x2.float()
                    for r in range(RB):  # the item's own pixels of x2
                        hr = r0 + r
                        if h0 <= hr < h_end:
                            nw, nc = min(plan.twc, w - w0), min(cg, c - c0)
                            out2[n, hr, w0:w0 + nw, c0:c0 + nc] = x2[r, p:p + nw, :nc]
                for r in range(RB):
                    conv[(t * RB + r) % ring] = chunk[r]
                m = t - pre
                if m < 0:
                    continue
                win = torch.stack([conv[(m * RB + r) % ring] for r in range(RB + kk - 1)])
                for j in range(RB):
                    ho = h0 + m * RB + j
                    if ho >= h_end:
                        break
                    acc = torch.zeros(plan.twc, cg)
                    for dh in range(kk):
                        for dw in range(kk):
                            acc = acc + win[j + dh, dw:dw + plan.twc] * tp[dh, dw]
                    nw, nc = min(plan.twc, w - w0), min(cg, c - c0)
                    if not bwd:
                        out[n, ho, w0:w0 + nw, c0:c0 + nc] = acc[:nw, :nc].to(x.dtype)
                        continue
                    d2 = _box(dx2bar, n, ho, w0, c0, 1, plan.twc, cg)[0].float() + acc
                    xs = _box(x, n, ho, w0, c0, 1, plan.twc, cg)[0].float()
                    ys = _box(y0, n, ho, w0, c0, 1, plan.twc, cg)[0].float()
                    out[n, ho, w0:w0 + nw, c0:c0 + nc] = (d2 * va)[:nw, :nc].to(x.dtype)
                    out2[n, ho, w0:w0 + nw, c0:c0 + nc] = (d2 * vb)[:nw, :nc].to(x.dtype)
                    for i in range(plan.tw):  # a thread's columns in order
                        col = torch.arange(nslots) * plan.tw + i
                        ok = (col < nw)[:, None]
                        for q, term in enumerate((d2 * xs, d2 * ys, d2)):
                            sums[q] += torch.where(ok, term[col], 0.0)
        if bwd:
            bsum[:, grp:grp + plan.cg] = _group(sums.sum(1), 0, plan.cg)[:, :min(plan.cg, c - grp)]
            slots[blk] = bsum
    if not bwd:
        return out2, out
    total = torch.zeros(3, c)
    for blk in range(plan.grid):  # the last block's sum, in block order
        total = total + slots[blk]
    return out, out2, total[0], total[1], total[2]


def _tensors(shape, kk, seed, dtype=torch.float32, **over):
    x, y0, a, b, bias, kern, dx2bar, dy7bar = _combine_args(seed, shape, kk)
    vals = dict(x=x, y0=y0, a=a, b=b, bias=bias, kern=kern, dx2bar=dx2bar, dy7bar=dy7bar)
    vals.update({k: np.broadcast_to(np.float32(v), vals[k].shape).copy() for k, v in over.items()})
    t = {k: torch.from_numpy(v) for k, v in vals.items()}
    for k in ("x", "y0", "dx2bar", "dy7bar"):
        t[k] = t[k].to(dtype)
    return t


def _close(got, want, tol=TOL):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    assert (got - want).abs().max() <= tol * max(want.abs().max().item(), 1e-30)


# (B, H, W, C), k, SMs of the fake card: t8-like widths at small sizes, a
# ragged H and W (one band past the image), two channel groups (C = 192)
# with blocks walking both, several items a block.
CASES = [((2, 16, 16, 48), 7, 3), ((2, 8, 8, 96), 3, 5), ((1, 12, 20, 48), 7, 4),
         ((2, 16, 8, 192), 3, 3), ((3, 16, 16, 48), 3, 132)]


@pytest.mark.parametrize("shape, kk, sms", CASES)
def test_decomposition_matches_the_plain_versions(shape, kk, sms, card):
    """x2 bit-equal to ``_combine``'s, y7, dx, dy0 and the three sums within
    1e-5 of their largest magnitude, at f32 (and x2 bit-equal at bf16)."""
    card.sms = sms
    bsz, h, w, c = shape
    t = _tensors(shape, kk, sum(shape) + kk)
    fwd = tdwconv._plan(bsz, h, w, c, kk, tdwconv.COMBINE, 0)
    bwd = tdwconv._plan(bsz, h, w, c, kk, tdwconv.COMBINE_BWD, 0)
    args = (t["x"], t["y0"], t["a"], t["b"], t["bias"], t["kern"])
    x2, y7 = _decompose(fwd, kk, *args)
    wx2, wy7 = tdwconv.combine_dw_math(*args)
    assert torch.equal(x2, wx2)
    _close(y7, wy7)
    got = _decompose(bwd, kk, *args, dx2bar=t["dx2bar"], dy7bar=t["dy7bar"])
    want = tdwconv.combine_dw_bwd_math(t["x"], t["y0"], t["dx2bar"], t["dy7bar"], t["a"], t["b"],
                                       t["kern"])
    for g, r in zip(got, want):
        _close(g, r)
    tb = _tensors(shape, kk, sum(shape) + kk, torch.bfloat16)
    argsb = (tb["x"], tb["y0"], tb["a"], tb["b"], tb["bias"], tb["kern"])
    assert torch.equal(_decompose(fwd, kk, *argsb)[0], tdwconv.combine_dw_math(*argsb)[0])


@pytest.mark.parametrize("shape, kk", [((2, 16, 16, 48), 7), ((2, 8, 8, 96), 3),
                                       ((1, 16, 8, 192), 7)])
def test_decomposition_matches_jax(shape, kk, card, monkeypatch):
    """The decomposition against JAX's ``_combine_dw_fwd_kernel`` and
    ``_combine_dw_bwd_kernel`` (interpret mode, under ``jax.vjp``) at f32,
    2e-5 of each output's largest magnitude."""
    card.sms = 3
    bsz, h, w, c = shape
    t = _tensors(shape, kk, 3 * sum(shape) + kk)
    calls = _count(monkeypatch, jdwconv, "_combine_dw_fwd_kernel", "_combine_dw_bwd_kernel")

    def jfn(x_, y0_, a_, b_, bias_, k_, dx2_, dy7_):
        out, vjp = jax.vjp(jdwconv.combine_dw_frozen, x_, y0_, a_, b_, bias_, k_)
        return (*out, *vjp((dx2_, dy7_))[:5])

    want = _jit(jfn, *(jnp.asarray(t[k].numpy()) for k in
                       ("x", "y0", "a", "b", "bias", "kern", "dx2bar", "dy7bar")))
    assert calls == {"_combine_dw_fwd_kernel": 1, "_combine_dw_bwd_kernel": 1}
    args = (t["x"], t["y0"], t["a"], t["b"], t["bias"], t["kern"])
    got = (*_decompose(tdwconv._plan(bsz, h, w, c, kk, tdwconv.COMBINE, 0), kk, *args),
           *_decompose(tdwconv._plan(bsz, h, w, c, kk, tdwconv.COMBINE_BWD, 0), kk, *args,
                       dx2bar=t["dx2bar"], dy7bar=t["dy7bar"]))
    for g, r in zip(got, want):
        _close(g, torch.from_numpy(np.array(_np(r))), 2e-5)


def test_the_padding_is_x2s():
    """With bias = 4 and a = b = 1 the combine of two zero-filled boxes
    outside the image is 4, not 0: the decomposition that masks it matches
    the plain version, one that keeps it moves y7's border rows and columns
    (and only those)."""
    shape, kk = (2, 16, 16, 48), 7
    t = _tensors(shape, kk, 21, a=1.0, b=1.0, bias=4.0)
    args = (t["x"], t["y0"], t["a"], t["b"], t["bias"], t["kern"])
    plan = tdwconv.Plan(16, 16, 48, 96, 2, 2, 0, RB, 2, 8, None, 0)  # whole images, 2 blocks
    _, want = tdwconv.combine_dw_math(*args)
    _, good = _decompose(plan, kk, *args)
    _, leak = _decompose(plan, kk, *args, mask=False)
    _close(good, want)
    moved = (leak - want).abs().amax(dim=(0, 3)) > 1e-3  # (H, W)
    p = kk // 2
    border = torch.ones(16, 16, dtype=torch.bool)
    border[p:16 - p, p:16 - p] = False
    assert moved[0].all() and moved[-1].all() and moved[:, 0].all()
    assert torch.equal(moved, border)
