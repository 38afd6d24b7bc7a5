"""The port's depthwise-conv arm and stage-pair segment kernels' plain versions
against the JAX package's Pallas kernels, on the CPU.

``dino_pose_tpu_torch/ops/dwconv.py`` (``dw_conv_frozen``,
``combine_dw_frozen``) is held against ``dino_pose_tpu/ops/dwconv.py`` run in
Pallas interpret mode (``_dw_kernel``, ``_combine_dw_fwd_kernel``,
``_combine_dw_bwd_kernel``, each counted), as tests/test_dwconv.py runs it,
and ``ops/convffn.py``'s ``convffn_res_train`` against JAX's
``fused_convffn_res`` (``_convffn_fwd_res_kernel``, and
``_convffn_bwd_kernel`` in its vjp) with ``DINO_POSE_TPU_CONVFFN=force``.
Inputs come from numpy seeds. H is at most 16 or a multiple of 16: JAX's
``_tap_conv`` fails on ragged 16-row chunks (ROADMAP.md Queue 3); the port's
kernels take any H, held on the card (tests/test_torch_cuda.py).

The JAX side runs jitted with ``xla_allow_excess_precision`` off, else
XLA:CPU drops the kernels' bf16 round trips (the combine's x2 rounded before
the conv reads it), which Mosaic keeps on a TPU. Tolerances: f32 to 2e-5
abs/rel (the JAX suite's own; summation order only), the f32 sums da, db,
dbias to 1e-5 relative Frobenius. bf16: activations within one bf16 ulp of
the output's largest magnitude, and different on at most 1e-3 of the
elements (the conv sums 9 or 49 f32 products in another order, so a rounding
can flip: measured at most 1.5e-4); the convffn_res output and dy within two
ulps (tests/test_torch_convffn.py's GELU bound: the jitted GELU polynomial
flips roundings of g) on at most 1e-2 of the elements (measured 1.7e-3);
da, db, dbias, f32 sums of f32 terms, to 1e-5 relative Frobenius.

The witness: in bf16 the conv route's bf16 taps round differently from
JAX's kernel on ~40% of the outputs, so these tests see the taps' type. The
gates equal JAX's at every t8, sa12 and ma36 stage shape at 256² (JAX's
``_dispatch_target`` patched to one TPU, its ``on`` condition).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_convffn import S_LORA, _inputs, _rel_fro

from dino_pose_tpu.ops import convffn as jconvffn
from dino_pose_tpu.ops import dispatch as jdispatch
from dino_pose_tpu.ops import dwconv as jdwconv
from dino_pose_tpu_torch.ops import convffn as tconvffn
from dino_pose_tpu_torch.ops import dwconv as tdwconv

NO_EXCESS = {"xla_allow_excess_precision": False}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jit(fn, *args):
    """``fn`` compiled without excess precision, applied to ``args``."""
    with jdispatch.local():
        return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _count(monkeypatch, module, *names) -> dict:
    calls = dict.fromkeys(names, 0)
    for name in names:
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _o=orig, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _o(*a, **k))
    return calls


def _np(t) -> np.ndarray:
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _ulp(want: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _close(got, want, dtype, ulps: int = 1, frac: float = 1e-3) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert np.abs(got - want).max() <= ulps * _ulp(want)
        assert (got != want).mean() <= frac, (got != want).mean()


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


# (B, H, W, C), k: stage-0-like at batch > 1, the mixer's 3x3, stage 1's C,
# ma36's C = 76 (W*C not a multiple of 128), H = 32 (two 16-row chunks).
CONV_CASES = [((3, 16, 16, 48), 7), ((2, 8, 8, 48), 3), ((1, 8, 8, 96), 7),
              ((2, 8, 16, 76), 7), ((2, 32, 8, 16), 3)]


def _dw_both(shape, kk, dtype, seed, monkeypatch):
    """(port, JAX) dx-chain outputs: y and dx (the kernel's gradient too)."""
    x, kern, ct = _arrays(seed, shape, (kk, kk, 1, shape[-1]), shape)
    calls = _count(monkeypatch, jdwconv, "_dw_kernel")
    jdt = JDT[dtype]

    def jfn(x_, k_, ct_):
        y, vjp = jax.vjp(jdwconv.dw_conv_frozen, x_, k_)
        return (y, *vjp(ct_))

    want = _jit(jfn, jnp.asarray(x, jdt), jnp.asarray(kern), jnp.asarray(ct, jdt))
    assert calls["_dw_kernel"] == 2  # forward and the flipped-tap dx
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = torch.from_numpy(kern).requires_grad_()
    y = tdwconv.dw_conv_frozen(xt, kt)
    y.backward(torch.from_numpy(ct).to(dtype))
    return (y, xt.grad, kt.grad), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, kk", CONV_CASES)
def test_dw_conv_frozen_matches_jax(shape, kk, dtype, monkeypatch):
    """Forward and dx against JAX's ``_dw_kernel`` (its dx reuses it on the
    flipped taps); the conv kernel's gradient is zero on both sides."""
    (y, dx, dk), (jy, jdx, jdk) = _dw_both(shape, kk, dtype, sum(shape) + kk, monkeypatch)
    assert y.dtype == dx.dtype == dtype and y.shape == shape
    _close(y, jy, dtype)
    _close(dx, jdx, dtype)
    assert dk is not None and not dk.any() and not np.asarray(jdk).any()


@pytest.mark.parametrize("shape, kk", CONV_CASES[:2])
def test_f32_taps_witness(shape, kk):
    """In bf16 the conv route's bf16 taps (``fastvit_fold.dw_branch_conv``)
    round differently from JAX's kernel on ~40% of the outputs (measured
    38-42%), where the arm's f32 taps differ on at most 1.5e-4 of them: a
    port that cast the taps would fail the 1e-3 share of the tests above."""
    x, kern = _arrays(7, shape, (kk, kk, 1, shape[-1]))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = _np(_jit(jdwconv.dw_conv_frozen, jnp.asarray(x, jnp.bfloat16), jnp.asarray(kern)))
    arm = tdwconv.dw_conv_math(xb, torch.from_numpy(kern)).float().numpy()
    bf16_taps = F.conv2d(xb.permute(0, 3, 1, 2), torch.from_numpy(kern).permute(3, 2, 0, 1)
                         .to(torch.bfloat16), None, 1, kk // 2, 1, shape[-1])
    bf16_taps = bf16_taps.permute(0, 2, 3, 1).float().numpy()
    assert (arm != want).mean() <= 1e-3
    assert (bf16_taps != want).mean() >= 0.1, (bf16_taps != want).mean()


def _combine_args(seed, shape, kk):
    c = shape[-1]
    rng = np.random.default_rng(seed)
    x, y0, dx2bar, dy7bar = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    a = rng.uniform(0.8, 1.2, c).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    kern = (rng.standard_normal((kk, kk, 1, c)) * 0.3).astype(np.float32)
    return x, y0, a, b, bias, kern, dx2bar, dy7bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, kk", [((3, 16, 16, 48), 7), ((2, 8, 8, 96), 7),
                                       ((2, 32, 8, 16), 3)])
def test_combine_dw_frozen_matches_jax(shape, kk, dtype, monkeypatch):
    """(x2, y7) and the backward (dx, dy0, da, db, dbias) against JAX's
    ``_combine_dw_fwd_kernel`` and ``_combine_dw_bwd_kernel`` under
    ``jax.vjp``, unit-scale cotangents of both outputs; the conv kernel's
    gradient is zero on both sides."""
    x, y0, a, b, bias, kern, dx2bar, dy7bar = _combine_args(sum(shape) + kk, shape, kk)
    calls = _count(monkeypatch, jdwconv, "_combine_dw_fwd_kernel", "_combine_dw_bwd_kernel")
    jdt = JDT[dtype]

    def jfn(x_, y0_, a_, b_, bias_, k_, dx2_, dy7_):
        out, vjp = jax.vjp(jdwconv.combine_dw_frozen, x_, y0_, a_, b_, bias_, k_)
        return (*out, *vjp((dx2_, dy7_)))

    want = _jit(jfn, *(jnp.asarray(v, jdt) for v in (x, y0)),
                *(jnp.asarray(v) for v in (a, b, bias, kern)),
                *(jnp.asarray(v, jdt) for v in (dx2bar, dy7bar)))
    assert calls == {"_combine_dw_fwd_kernel": 1, "_combine_dw_bwd_kernel": 1}
    leaves = [torch.from_numpy(v).to(dtype).requires_grad_() for v in (x, y0)]
    leaves += [torch.from_numpy(v).requires_grad_() for v in (a, b, bias, kern)]
    x2, y7 = tdwconv.combine_dw_frozen(*leaves)
    torch.autograd.backward((x2, y7), (torch.from_numpy(dx2bar).to(dtype),
                                       torch.from_numpy(dy7bar).to(dtype)))
    jx2, jy7, jdx, jdy0, jda, jdb, jdbias, jdk = want
    for got, ref in ((x2, jx2), (y7, jy7), (leaves[0].grad, jdx), (leaves[1].grad, jdy0)):
        assert got.dtype == dtype
        _close(got, ref, dtype)
    for got, ref in ((leaves[2].grad, jda), (leaves[3].grad, jdb), (leaves[4].grad, jdbias)):
        assert got.dtype == torch.float32 and _rel_fro(_np(got), _np(ref)) < 1e-5
    assert not leaves[5].grad.any() and not np.asarray(jdk).any()


def test_combine_dw_reads_x2_as_rounded():
    """The conv reads x2 after its rounding to bf16 (dwconv.py:299-303): the
    plain version's y7 is dw_conv_math of its own x2, and differs from the
    conv of the unrounded f32 combine."""
    x, y0, a, b, bias, kern, _, _ = _combine_args(3, (2, 16, 16, 48), 7)
    t = [torch.from_numpy(v) for v in (x, y0, a, b, bias, kern)]
    xb, y0b = t[0].to(torch.bfloat16), t[1].to(torch.bfloat16)
    x2, y7 = tdwconv.combine_dw_math(xb, y0b, *t[2:])
    assert torch.equal(y7, tdwconv.dw_conv_math(x2, t[5]))
    unrounded = tdwconv._conv_f32(xb.float() * t[2] + y0b.float() * t[3] + t[4], t[5])
    assert not torch.equal(y7, unrounded.to(torch.bfloat16))


def test_combine_dw_bwd_math_matches_autograd():
    """In f32 the hand-written backward equals autograd of the plain
    forward (x2's rounding is the identity in f32)."""
    x, y0, a, b, bias, kern, dx2bar, dy7bar = _combine_args(5, (2, 8, 8, 48), 7)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, y0, a, b, bias)]
    kt = torch.from_numpy(kern)
    x2 = leaves[0] * leaves[2] + leaves[1] * leaves[3] + leaves[4]
    y7 = tdwconv._conv_f32(x2, kt)
    torch.autograd.backward((x2, y7), (torch.from_numpy(dx2bar), torch.from_numpy(dy7bar)))
    got = tdwconv.combine_dw_bwd_math(*(torch.from_numpy(v) for v in (x, y0, dx2bar, dy7bar,
                                                                      a, b)), kt)
    for g, leaf in zip(got, leaves):
        assert _rel_fro(g.numpy(), leaf.grad.numpy()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convffn_res_train_matches_jax(dtype, monkeypatch):
    """res + ConvFFN against JAX's ``fused_convffn_res`` (interpret) and its
    vjp: the output, dy, dres (= df, exactly) and the six parameter
    gradients (f32: 1e-5 relative Frobenius; bf16: as
    tests/test_torch_convffn.py, dy within two ulps, gradients within 1e-2
    of their largest magnitude)."""
    monkeypatch.setenv("DINO_POSE_TPU_CONVFFN", "force")
    calls = _count(monkeypatch, jconvffn, "_convffn_fwd_res_kernel", "_convffn_bwd_kernel")
    y, p = _inputs(64, 4, seed=90)
    res, df = _arrays(91, y.shape, y.shape)
    jdt = JDT[dtype]
    fields = ("inv", "shift", "a1", "b1l", "a2", "b2l")

    def jfn(y_, res_, p_, df_):
        out, vjp = jax.vjp(lambda a, r, q: jconvffn.fused_convffn_res(a, r, q, S_LORA),
                           y_, res_, p_)
        dy, dres, dp = vjp(df_)
        return out, dy, dres, [getattr(dp, k) for k in fields]

    jp = jconvffn.ConvFFNParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jout, jdy, jdres, jgrads = _jit(jfn, jnp.asarray(y, jdt), jnp.asarray(res, jdt), jp,
                                    jnp.asarray(df, jdt))
    assert calls == {"_convffn_fwd_res_kernel": 1, "_convffn_bwd_kernel": 1}
    leaves = {k: torch.from_numpy(v).requires_grad_(k in fields) for k, v in p.items()}
    yt = torch.from_numpy(y).to(dtype).requires_grad_()
    rt = torch.from_numpy(res).to(dtype).requires_grad_()
    out = tconvffn.convffn_res_train(yt, rt, tconvffn.ConvFFNParams(**leaves), S_LORA)
    dft = torch.from_numpy(df).to(dtype)
    out.backward(dft)
    assert out.dtype == dtype and torch.equal(rt.grad, dft)
    np.testing.assert_array_equal(_np(jdres), dft.float().numpy())
    _close(out, jout, dtype, ulps=2, frac=1e-2)
    if dtype == torch.float32:
        assert _rel_fro(_np(yt.grad), _np(jdy)) < 1e-5
    else:
        _close(yt.grad, jdy, dtype, ulps=2, frac=1e-2)
    for k, jg in zip(fields, jgrads):
        g, w = leaves[k].grad.numpy(), np.asarray(jg)
        if dtype == torch.float32:
            assert _rel_fro(g, w) < 1e-5, k
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), k


def test_convffn_res_refuses_trainable_base_weights():
    y, p = _inputs(64, 4, seed=92)
    leaves = {k: torch.from_numpy(v).requires_grad_(k == "w2") for k, v in p.items()}
    yt = torch.from_numpy(y)
    with pytest.raises(ValueError, match="requires grad"):
        tconvffn.convffn_res_train(yt, yt, tconvffn.ConvFFNParams(**leaves), S_LORA)


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors each new wrapper is its plain version, bit for bit, and
    no launch is counted."""
    tdwconv.LAUNCHES.update(dict.fromkeys(tdwconv.LAUNCHES, 0))
    x, y0, a, b, bias, kern, dx2bar, dy7bar = (torch.from_numpy(v) for v in
                                               _combine_args(11, (2, 8, 8, 48), 3))
    x, y0, dx2bar, dy7bar = (t.to(torch.bfloat16) for t in (x, y0, dx2bar, dy7bar))
    assert torch.equal(tdwconv.fused_dw_conv(x, kern), tdwconv.dw_conv_math(x, kern))
    for got, want in zip(tdwconv.fused_combine_dw(x, y0, a, b, bias, kern),
                         tdwconv.combine_dw_math(x, y0, a, b, bias, kern)):
        assert torch.equal(got, want)
    for got, want in zip(tdwconv.fused_combine_dw_bwd(x, y0, dx2bar, dy7bar, a, b, kern),
                         tdwconv.combine_dw_bwd_math(x, y0, dx2bar, dy7bar, a, b, kern)):
        assert torch.equal(got, want)
    yv, p = _inputs(64, 4, seed=12)
    pt = tconvffn._cast(tconvffn.ConvFFNParams(**{k: torch.from_numpy(v) for k, v in p.items()}),
                        torch.bfloat16)
    yb = torch.from_numpy(yv).to(torch.bfloat16)
    assert torch.equal(tconvffn.fused_convffn_res(yb, yb, pt, S_LORA),
                       tconvffn.convffn_res_math(yb, yb, pt, S_LORA))
    assert all(n == 0 for n in tdwconv.LAUNCHES.values())


def test_costs_count_the_work():
    assert tdwconv.dwconv_cost(128, 64, 64, 48, 7) == (2 * 128 * 64 * 64 * 48 * 49,
                                                       4 * 128 * 64 * 64 * 48 + 49 * 48 * 4)
    flops, nbytes = tdwconv.combine_dw_cost(2, 8, 8, 48, 7)
    assert flops == 2 * 2 * 8 * 8 * 48 * 51 and nbytes == 8 * 2 * 8 * 8 * 48 + 52 * 48 * 4
    flops, nbytes = tconvffn.convffn_cost(2, 64, 48, 144, 8, res=True)
    assert nbytes - tconvffn.convffn_cost(2, 64, 48, 144, 8)[1] == 2 * 64 * 48 * 2


# Every FastViT stage at 256²: (C, H = W, hidden) of t8, sa12 and ma36.
STAGES = {"t8": [(48, 64, 144), (96, 32, 288), (192, 16, 576), (384, 8, 1152)],
          "sa12": [(64, 64, 256), (128, 32, 512), (256, 16, 1024), (512, 8, 2048)],
          "ma36": [(76, 64, 304), (152, 32, 608), (304, 16, 1216), (608, 8, 2432)]}


@pytest.mark.parametrize("mode", ["on", "force"])
@pytest.mark.parametrize("model", list(STAGES))
def test_gates_equal_jax(model, mode, monkeypatch):
    """``dwconv_enabled`` (k = 3 and 7), ``pair_enabled`` and
    ``convffn_res_enabled`` (train, LoRA rank 8 and 0; eval) against JAX's at
    every stage shape, B = 1, 8, 128, bf16 and f32, with JAX's dispatch
    target patched to one TPU; unset, both are off. The t8/sa12 table of the
    slice's plan holds: t8 stages 0-1 take both arms at bs=128, sa12 stage 0
    only the conv arm."""
    monkeypatch.setattr(jdwconv, "_dispatch_target", lambda: ("tpu", 1))
    monkeypatch.delenv("DINO_POSE_TPU_CONVFFN", raising=False)
    for env in ("DINO_POSE_TPU_DWCONV", "DINO_POSE_TPU_STAGE_PAIR"):
        monkeypatch.delenv(env, raising=False)
    assert not tdwconv.dwconv_enabled(48, 64, 64, 7, 2, batch=128)
    assert not tdwconv.pair_enabled(48, 64, 64, 7, 2, batch=128)
    for env in ("DINO_POSE_TPU_DWCONV", "DINO_POSE_TPU_STAGE_PAIR"):
        monkeypatch.setenv(env, mode)
    seen = []
    for c, hw, hidden in STAGES[model]:
        for b in (1, 8, 128):
            for itemsize in (2, 4):
                for kk in (3, 7):
                    args = (c, hw, hw, kk, itemsize)
                    got = tdwconv.dwconv_enabled(*args, batch=b)
                    assert got == jdwconv.dwconv_enabled(*args, batch=b), (args, b)
                    got_pair = tdwconv.pair_enabled(*args, batch=b)
                    assert got_pair == jdwconv.pair_enabled(*args, batch=b), (args, b)
                    seen.append((c, b, itemsize, kk, got, got_pair))
                for train, rank in ((True, 8), (True, 0), (False, 0)):
                    args = (c, hidden, hw * hw, itemsize, train, rank)
                    assert (tconvffn.convffn_res_enabled(*args, batch=b)
                            == jconvffn.convffn_res_enabled(*args, batch=b)), (args, b)
    bs128 = {(c, kk): (dw, pair) for c, b, i, kk, dw, pair in seen if b == 128 and i == 2}
    if mode == "on" and model == "t8":
        assert bs128[48, 7] == bs128[96, 7] == (True, True)
        assert bs128[192, 7] == bs128[384, 3] == (False, False)
    if mode == "on" and model == "sa12":
        assert bs128[64, 7] == (True, False) and bs128[128, 7] == (False, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, kk", CONV_CASES[:3])
def test_fused_dw_conv_flip_is_the_conv_transpose(shape, kk, dtype):
    """``fused_dw_conv(x, k, flip=True)`` (the kernel reads the taps
    mirrored, no flipped copy) is the conv with ``k.flip(0, 1)`` bit for
    bit on the CPU, and JAX's ``dw_conv_frozen`` dx (its vjp); f32 within
    1e-5, bf16 within one ulp on at most 1e-3 of the outputs."""
    ct, kern = _arrays(sum(shape) + 3 * kk, shape, (kk, kk, 1, shape[-1]))
    jdt = JDT[dtype]

    def jdx(x_, k_, ct_):
        return jax.vjp(jdwconv.dw_conv_frozen, x_, k_)[1](ct_)[0]

    want = _jit(jdx, jnp.zeros(shape, jdt), jnp.asarray(kern), jnp.asarray(ct, jdt))
    ctt, kt = torch.from_numpy(ct).to(dtype), torch.from_numpy(kern)
    got = tdwconv.fused_dw_conv(ctt, kt, flip=True)
    assert torch.equal(got, tdwconv.dw_conv_math(ctt, kt.flip(0, 1)))
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    else:
        _close(got, want, dtype)


# Plan shapes (C, H = W): t8's stage 0 and 1, ragged rows and columns (24,
# 56: not multiples of the 8-row strip or 8-column slot), ma36's C = 76 and
# a C = 20 (not multiples of 8: staged a pair at a time).
PLAN_SHAPES = [(48, 64), (96, 32), (48, 24), (96, 56), (76, 16), (20, 24), (76, 64)]


@pytest.fixture
def fake_card(monkeypatch):
    """The plan on a fake card of 132 SMs, each holding one block of any
    plan; the plan cache emptied before and after."""
    monkeypatch.setattr(tdwconv, "_sms", lambda index: 132)
    monkeypatch.setattr(tdwconv, "_occupancy", lambda kk, mode, rb, plan: 1)
    tdwconv._plan.cache_clear()
    yield
    tdwconv._plan.cache_clear()


def _coverage(plan, h, w, c, kk) -> np.ndarray:
    """How often the plan's items and threads write each (row, column,
    channel) of one sample: item (strip, column tile, group), then thread t
    of the block on channel pair t % np and the (2-row, 8-column) slots
    t // np, + nt // np, ... (dw_kernel's walk), inside the image only."""
    hits = np.zeros((h, w, c), np.int32)
    np_ = (plan.cg + 1) // 2
    chs = plan.twc // 8
    subs = plan.th // plan.rb * chs
    for r0 in range(0, h, plan.th):
        for w0 in range(0, w, plan.twc):
            for c0 in range(0, c, plan.cg):
                cgn = min(plan.cg, c - c0)
                for t in range(plan.nt):
                    pr, slot = t % np_, t // np_
                    chans = [c0 + 2 * pr + j for j in (0, 1) if 2 * pr + j < cgn]
                    for q in range(slot, subs, plan.nt // np_):
                        rg, ch = divmod(q, chs)
                        rows = slice(r0 + plan.rb * rg, min(r0 + plan.rb * (rg + 1), h))
                        cols = slice(w0 + 8 * ch, min(w0 + 8 * ch + 8, w))
                        hits[rows, cols, chans] += 1
    return hits


def _pair_coverage(plan, h, w, c) -> np.ndarray:
    """How often pair_kernel's items of one sample write each (row, column,
    channel): an item (band, column tile, group) writes its band's rows
    within the image, its tile's columns and its group's channels, the
    group's channels x 8-column slots taken by the block's threads."""
    hits = np.zeros((h, w, c), np.int32)
    for h0 in range(0, h, plan.th):
        for w0 in range(0, w, plan.twc):
            for c0 in range(0, c, plan.cg):
                hits[h0:min(h0 + plan.th, h), w0:w0 + plan.twc, c0:c0 + plan.cg] += 1
    return hits


@pytest.mark.parametrize("mode", [tdwconv.DW, tdwconv.COMBINE, tdwconv.COMBINE_BWD])
@pytest.mark.parametrize("kk", [3, 7])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_plan_covers_every_output_once(b, kk, mode, fake_card):
    """Every output row, column and channel is written by exactly one
    thread of one item, at every plan shape; the plan keeps what the
    kernel takes (dw_kernel: even strips, 8-column tiles, groups of <= 64
    channels in whole 16-byte vectors where C allows, threads a multiple of
    the pairs and at most 192; pair_kernel, the segment's, at the wrapper's
    width padded to a multiple of 8: even bands, 8-column tiles, groups of
    <= 64 (forward) or 96 (backward) channels in 16-byte vectors, a thread
    for each channel and 8 (forward) or 16 (backward) columns, at most 384
    or 192) and never asks for more than the shared memory a
    block may use. tests/test_torch_dwconv_plan.py holds the segment's plan
    in detail."""
    for c, hw in PLAN_SHAPES:
        if mode != tdwconv.DW:
            cp = -(-c // 8) * 8
            plan = tdwconv._plan(b, hw, hw, cp, kk, mode, 0)
            bwd = mode == tdwconv.COMBINE_BWD
            assert plan.th % 2 == 0 and plan.twc % plan.tw == 0 and plan.cg % 8 == 0
            assert plan.cg <= (96 if bwd else 64) and plan.tw == (16 if bwd else 8)
            assert plan.cg * (plan.twc // plan.tw) <= plan.nt <= (192 if bwd else 384)
            assert plan.rb == 2
            assert plan.smem == tdwconv._pair_smem(kk, mode == tdwconv.COMBINE_BWD, plan.cg,
                                                   plan.twc, plan.stages, cp)
            assert plan.smem <= tdwconv._SMEM_LIMIT
            assert plan.items == b * -(-hw // plan.th) * -(-hw // plan.twc) * -(-cp // plan.cg)
            assert plan.grid == min(plan.items, 132)
            assert (_pair_coverage(plan, hw, hw, cp) == 1).all(), (c, hw, plan)
            continue
        plan = tdwconv._plan(b, hw, hw, c, kk, mode, 0)
        assert plan.th % 2 == 0 and plan.twc % 8 == 0 and plan.cg <= 64
        # two rows a slot where the batch fills the card
        assert plan.rb == (2 if b == 128 else 1)
        assert plan.cg % 8 == 0 if c % 8 == 0 else plan.cg % 2 == 0
        assert plan.nt % ((plan.cg + 1) // 2) == 0 and plan.nt <= 192
        assert plan.smem == tdwconv._smem_bytes(plan.th, plan.twc, kk, plan.cg)
        assert plan.smem <= tdwconv._SMEM_LIMIT
        groups = -(-c // plan.cg)
        assert plan.items == b * -(-hw // plan.th) * -(-hw // plan.twc) * groups
        assert plan.grid == min(plan.items, 132)
        assert (_coverage(plan, hw, hw, c, kk) == 1).all(), (c, hw, plan)


@pytest.mark.parametrize("kk", [3, 7])
def test_plan_fills_the_card_at_batch_1(kk, fake_card):
    """At t8's stage 0 and batch 1 (the serving forward) the plan tiles W as
    well as H: at least one block on each of the 132 SMs, with strips of
    more than one row, so that fewer input rows are staged for each output
    row than the one-row strips of the old plan (k of them)."""
    plan = tdwconv._plan(1, 64, 64, 48, kk, tdwconv.DW, 0)
    assert plan.grid >= 132 and plan.twc < 64 and plan.th >= 2
    assert (plan.th + kk - 1) / plan.th < kk
    big = tdwconv._plan(128, 64, 64, 48, kk, tdwconv.DW, 0)
    assert big.th >= 8 and big.smem <= tdwconv._SMEM_BUDGET  # tall strips at batch 128


def test_plan_is_cached(fake_card):
    first = tdwconv._plan(8, 32, 32, 96, 7, tdwconv.COMBINE, 0)
    assert tdwconv._plan(8, 32, 32, 96, 7, tdwconv.COMBINE, 0) is first
    assert tdwconv._plan(8, 32, 32, 96, 7, tdwconv.DW, 0) is not first


def test_plan_refuses_what_does_not_fit(fake_card, monkeypatch):
    """A shape whose smallest tile outgrows the plan's shared-memory budget
    is refused, not launched."""
    monkeypatch.setattr(tdwconv, "_SMEM_BUDGET", 4096)
    with pytest.raises(ValueError, match="do not fit shared memory"):
        tdwconv._plan(1, 64, 64, 48, 7, tdwconv.DW, 0)


def test_wrapper_refusals_run_on_the_cpu():
    """What the kernels refuse, ``_check`` and ``_launch_checks`` refuse on
    any device: the same errors the wrappers raise on the card."""
    x = torch.zeros(1, 16, 16, 48, dtype=torch.bfloat16)
    kern = torch.zeros(7, 7, 1, 48)
    vec = torch.zeros(48)
    assert tdwconv._check("w", kern, x, x, vecs=(vec,)) == (1, 16, 16, 48, 7)
    with pytest.raises(TypeError, match="bf16"):
        tdwconv._check("w", kern, x.float())
    with pytest.raises(ValueError, match="HWIO"):
        tdwconv._check("w", torch.zeros(5, 5, 1, 48), x)
    with pytest.raises(ValueError, match="vectors"):
        tdwconv._check("w", kern, x, vecs=(vec.double(),))
    with pytest.raises(ValueError, match="one shape"):
        tdwconv._check("w", kern, x, x[:, :8])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tdwconv._check("w", kern, torch.zeros(16 * 16 * 48 + 1, dtype=torch.bfloat16)[1:]
                       .view(1, 16, 16, 48))
    with pytest.raises(ValueError, match="no backward"):
        tdwconv._launch_checks("w", x.clone().requires_grad_())
