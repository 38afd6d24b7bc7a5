"""The chains' backward products on the CPU: ``ops/block.gemm_nt_math`` and
``gemm_tn_math``, the plain versions of the wgmma/TMA ``gemm_nt_kernel`` and
``gemm_tn_kernel`` behind ``fused_gemm_nt`` and ``fused_gemm_tn``, with
``scale_rows_math`` (``scale_rows_kernel``, the scaled cotangent formed once),
composed as each backward chain composes them, reproduce the port's plain
backward halves bit for bit: ``mlp_bwd_math`` and ``mlp_stream_bwd_math``
(every product and gradient), ``attn_bwd_math`` and
``attn_stream_bwd_math``, ``mlp_dx_math`` and a shard's
``mlp_partial_dx_math``. Those plain halves are held against the JAX
package's kernels in interpret mode (tests/test_torch_block_train.py,
test_torch_stream_train.py, test_torch_train.py, test_torch_tp.py), so this
ties each new epilogue's rounding points (bf16(acc * gelu'(h1)) and its
unrounded column sums, the f32 dm and da, bf16 dctx, the f32 weight
gradients and dbqkv's sums of the bf16 dqkv) to JAX's. The attention
step between the products is written out here as ``_attn_bwd`` writes it.
Exact equality throughout: the composition runs the same PyTorch operations
in the same order.

Also: the wrappers take their plain versions on the CPU; the weight
gradients' row splits (``_splits``) cover M exactly in 64-row steps;
``gemm_nt_cost`` and ``gemm_tn_cost`` with the forward ``gemm_cost`` add up
to ``block_flops``' backward counts.

Inputs are seeded with numpy; bf16 and f32, widths D = 64 (two heads of
32) and 128 (two of 64), a shard count of 2.
"""

import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.ops import block

EPS = 1e-6
B, S = 2, 17
DTYPES = [torch.bfloat16, torch.float32]
WIDTHS = [64, 128]
HEADS = 2


def _inputs(d: int, dtype: torch.dtype, seed: int = 0):
    rng = np.random.default_rng(seed + d)

    def t(*shape, std=1.0, mean=0.0, mat=True):
        v = torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32))
        return v.to(dtype) if mat else v

    h = 4 * d
    p = block.BlockParams(
        g1=t(d, std=0.1, mean=1, mat=False), b1=t(d, std=0.05, mat=False),
        wqkv=t(d, 3 * d, std=d**-0.5), bqkv=t(3 * d, std=0.05, mat=False),
        wo=t(d, d, std=d**-0.5), bo=t(d, std=0.05, mat=False),
        ls1=t(d, std=0.2, mean=0.5, mat=False), g2=t(d, std=0.1, mean=1, mat=False),
        b2=t(d, std=0.05, mat=False), w1=t(d, h, std=d**-0.5), bf1=t(h, std=0.05, mat=False),
        w2=t(h, d, std=h**-0.5), bf2=t(d, std=0.05, mat=False),
        ls2=t(d, std=0.2, mean=0.5, mat=False))
    return t(B, S, d), t(B, S, d, std=0.5), p


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _mlp_bwd_compose(x, dy, mp, h2=None):
    """mlp_bwd's chain (block_kernels.cu ``mlp_bwd``): LN2 rows -> (h1, g)
    -> h2 (recomputed, or the forward's saved one) -> scale_rows(dy*ls2) ->
    gemm_nt<gelu_grad, colsum>(dh1b, dbf1) -> gemm_tn(dW2) -> gemm_nt<f32>(dm)
    -> the row step -> gemm_tn(dW1)."""
    dt = x.dtype
    m, xhat, r = block._ln_fwd(x, mp.g2, mp.b2, EPS)
    h1, g = block.gemm_math(block.ln_rows(x, mp.g2, mp.b2, EPS), mp.w1, "bias_gelu_pair", mp.bf1)
    if h2 is None:
        h2, dbf2 = block.gemm_math(g, mp.w2, "bias", mp.bf2), block._colsum(
            dy.float() * mp.ls2.float())
    else:
        dbf2 = mp.ls2.float() * block._colsum(dy.float())
    dys = block.scale_rows_math(dy, mp.ls2)
    dh1b, dbf1 = block.gemm_nt_math(dys, mp.w2, "gelu_grad", aux=h1, colsum=True)
    dw2 = block.gemm_tn_math(g, dys)
    assert torch.equal(dw2, block.gemm_tn_math(g, dy, scale=mp.ls2))
    dm = block.gemm_nt_math(dh1b, mp.w1, "f32")
    dx2 = (dy.float() + block._ln_bwd(dm, xhat, r, mp.g2)).to(dt)
    dw1 = block.gemm_tn_math(m, dh1b)
    return dx2, block.MlpParams(
        g2=block._colsum(dm * xhat), b2=block._colsum(dm), w1=dw1, bf1=dbf1, w2=dw2, bf2=dbf2,
        ls2=block._colsum(dy.float() * h2.float()))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("route", ["resident", "stream"])
def test_gemm_bwd_composes_the_mlp_backward(route, dtype, d):
    """#6 _mlp_bwd_kernel (mlp_bwd_math) and #15-16 _mlp_stream_dx_full_kernel
    + _mlp_stream_dw_kernel (mlp_stream_bwd_math, h2 the forward's): dx2 and
    every gradient, the products through the new plain versions."""
    x, dy, p = _inputs(d, dtype)
    mp = block.mlp_params(p)
    if route == "resident":
        want = block.mlp_bwd_math(x, dy, mp, eps=EPS)
        got = _mlp_bwd_compose(x, dy, mp)
    else:
        h2 = block.mlp_part_stream_train_math(x, mp, eps=EPS)[1]
        want = block.mlp_stream_bwd_math(x, dy, h2, mp, eps=EPS)
        got = _mlp_bwd_compose(x, dy, mp, h2)
    _equal(got[0], want[0])
    _equal(tuple(got[1]), tuple(want[1]))


def _attn_bwd_compose(x, dres, ap, ls1):
    """attn_bwd's chain (block_kernels.cu ``attn_bwd``): LN1 rows -> qkv ->
    attention -> (scale_rows(dx2*ls1) where ls1 is given) -> gemm_nt<bf16>
    (dctx) -> gemm_tn(dWo) -> the attention backward -> gemm_nt<f32>(da) ->
    the row step -> gemm_tn<gsum>(dWqkv, dbqkv). The attention steps as
    ``_attn_bwd`` writes them."""
    dt = x.dtype
    b, s, d = x.shape
    dh = d // HEADS
    scale = dh**-0.5

    def heads(t):
        return t.reshape(b, s, HEADS, dh).transpose(1, 2).float()

    def merge(t):
        return t.transpose(1, 2).reshape(b, s, d).to(dt)

    a, xhat, r = block._ln_fwd(x, ap.g1, ap.b1, EPS)
    qkv = block.gemm_math(block.ln_rows(x, ap.g1, ap.b1, EPS), ap.wqkv, "bias", ap.bqkv)
    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    pb = p.to(dt).float()
    ctx = merge(pb @ v)
    dob = dres if ls1 is None else block.scale_rows_math(dres, ls1)
    dctx = heads(block.gemm_nt_math(dob, ap.wo, "bf16"))
    dwo = block.gemm_tn_math(ctx, dres, scale=ls1)
    assert torch.equal(dwo, block.gemm_tn_math(ctx, dob))
    dp = dctx @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).float()
    dqkv = torch.cat([merge((dsb @ k) * scale), merge((dsb.transpose(-1, -2) @ q) * scale),
                      merge(pb.transpose(-1, -2) @ dctx)], dim=-1)
    da = block.gemm_nt_math(dqkv, ap.wqkv, "f32")
    dwqkv, dbqkv = block.gemm_tn_math(a, dqkv, gsum=True)
    dln = block._ln_bwd(da, xhat, r, ap.g1)
    grads = dict(g1=block._colsum(da * xhat), b1=block._colsum(da), wqkv=dwqkv, bqkv=dbqkv,
                 wo=dwo)
    if ls1 is None:
        return dln.to(dt), block.AttnParams(**grads, bo=block._colsum(dres.float()))
    dx2f = dres.float()
    o = block.gemm_math(ctx, ap.wo, "bias", ap.bo)
    return (dx2f + dln).to(dt), block.AttnTrainParams(
        **grads, bo=block._colsum(dx2f * ls1.float()), ls1=block._colsum(dx2f * o.float()))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("route", ["resident", "stream"])
def test_gemm_bwd_composes_the_attention_backward(route, dtype, d):
    """#7 _attn_bwd_kernel (attn_bwd_math, dx2 scaled by ls1) and #18-19
    _attn_stream_dx_kernel + _attn_stream_dw_kernel (attn_stream_bwd_math,
    the pre-LayerScale do): dx and every gradient."""
    x, dres, p = _inputs(d, dtype, seed=5)
    if route == "resident":
        atp = block.attn_train_params(p)
        want = block.attn_bwd_math(x, dres, atp, num_heads=HEADS, eps=EPS)
        got = _attn_bwd_compose(x, dres, block.attn_params(p), p.ls1)
    else:
        ap = block.attn_params(p)
        want = block.attn_stream_bwd_math(x, dres, ap, num_heads=HEADS, eps=EPS)
        got = _attn_bwd_compose(x, dres, ap, None)
    _equal(got[0], want[0])
    assert type(got[1]) is type(want[1])
    for field in want[1]._fields:
        _equal(getattr(got[1], field), getattr(want[1], field))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("route", ["mlp_dx", "mlp_partial_dx"])
def test_gemm_bwd_composes_the_dx_chains(route, dtype, d):
    """#4/#13 _mlp_dx_kernel (mlp_dx_math: scale_rows(dy*ls2), dy added) and
    #22 _mlp_partial_dx_kernel on a shard (mlp_partial_dx_math: the shard's
    dp as it comes, no residual): h1 -> gemm_nt<gelu_grad> -> gemm_nt<f32> ->
    the LayerNorm backward."""
    x, dy, p = _inputs(d, dtype, seed=9)
    mp = block.mlp_params(p)
    if route == "mlp_partial_dx":
        mp = block.shard_mlp(mp, 2, 1)
    _, xhat, r = block._ln_fwd(x, mp.g2, mp.b2, EPS)
    h1 = block.gemm_math(block.ln_rows(x, mp.g2, mp.b2, EPS), mp.w1, "bias", mp.bf1)
    dys = block.scale_rows_math(dy, mp.ls2) if route == "mlp_dx" else dy
    dh1b = block.gemm_nt_math(dys, mp.w2, "gelu_grad", aux=h1)
    dln = block._ln_bwd(block.gemm_nt_math(dh1b, mp.w1, "f32"), xhat, r, mp.g2)
    if route == "mlp_dx":
        _equal((dy.float() + dln).to(dtype), block.mlp_dx_math(x, dy, mp, eps=EPS))
    else:
        _equal(dln.to(dtype), block.mlp_partial_dx_math(x, dy, mp, eps=EPS))


@pytest.mark.parametrize("epi", block.EPILOGUES_NT)
def test_fused_gemm_nt_takes_its_plain_version_on_the_cpu(epi):
    """On a CPU tensor the wrapper is gemm_nt_math, every epilogue, with and
    without the scale and the column sums."""
    x, dy, p = _inputs(64, torch.bfloat16)
    a = x.reshape(-1, 64)
    aux = dy.reshape(-1, 64).repeat(1, 4)
    for kw in ({}, {"scale": p.ls2, "colsum": True}):
        _equal(block.fused_gemm_nt(a, p.w2, epi, aux=aux, **kw),
               block.gemm_nt_math(a, p.w2, epi, aux=aux, **kw))
    with pytest.raises(ValueError, match="unknown epilogue"):
        block.fused_gemm_nt(a, p.w2, epi + "_x")


@pytest.mark.parametrize("gsum", [False, True])
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_gemm_tn_takes_its_plain_version_on_the_cpu(scaled, gsum):
    x, dy, p = _inputs(64, torch.bfloat16)
    a, g = x.reshape(-1, 64), dy.reshape(-1, 64)
    kw = {"scale": p.ls2 if scaled else None, "gsum": gsum}
    _equal(block.fused_gemm_tn(a, g, **kw), block.gemm_tn_math(a, g, **kw))


def test_scale_rows_rounds_once():
    """bf16(f32(a) * scale): one rounding of the f32 product, not a product
    of two bf16 roundings."""
    a = torch.tensor([[1.0, 3.0]], dtype=torch.bfloat16)
    scale = torch.tensor([1.0 / 3.0, 1.0 / 3.0])
    got = block.scale_rows_math(a, scale)
    assert got.dtype == torch.bfloat16
    _equal(got, (a.float() * scale).to(torch.bfloat16))
    assert got[0, 1].item() == 1.0


# Every weight-gradient shape the dinov2 backward chains run: (K_in, N) of
# dW1, dW2, dWqkv and dWo at D = 384, 768, 1024, and a D = 64 (test/vit-tiny)
# and D = 192 (a 64-row tile) one.
TN_SHAPES = [(k, n) for d in (384, 768, 1024) for k, n in ((d, 4 * d), (4 * d, d), (d, 3 * d),
                                                           (d, d))] + [(64, 256), (192, 576)]


@pytest.mark.parametrize("k_in,n", TN_SHAPES)
def test_splits_cover_the_rows_in_64_row_steps(k_in, n):
    """Every row in exactly one split, every split but the last full, each
    a multiple of the 64-row TMA box (no box reads the next split's rows),
    no split empty; a batch-1 product takes one split, and a batch-128 one
    at most 32."""
    tm, tn = block._tn_tile(k_in, n)
    assert k_in % tm == 0 and n % tn == 0
    for m in (1, 63, 64, 65, 114, 257, 2 * 57, 8 * 257, 128 * 257, 32 * 1297):
        s = block._splits(m, k_in, n)
        rows = block._split_rows(m, s)
        assert s >= 1 and rows % 64 == 0
        assert (s - 1) * rows < m <= s * rows
        assert s <= 32
    assert block._splits(257, k_in, n) == 1


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("d", [384, 768, 1024])
def test_gemm_bwd_costs_add_up_to_block_flops(d, tp):
    """Each backward wrapper's FLOPs are its products' 2*M*N*K: the forward
    recomputes (gemm_cost), the dx products (gemm_nt_cost), the weight
    gradients (gemm_tn_cost) and, for the attention backward, six of
    2*S^2*D."""
    s, h = 257, 4 * d
    f = block.block_flops(s, d, h, tp)

    def fwd(m, n, k):
        return block.gemm_cost(m, n, k)[0]

    def nt(m, n, k):
        return block.gemm_nt_cost(m, n, k)[0]

    def tn(m, k_in, n):
        return block.gemm_tn_cost(m, k_in, n)[0]

    hl = h // tp
    assert f["fused_mlp_partial_dx"] == fwd(s, hl, d) + nt(s, hl, d) + nt(s, d, hl)
    if tp > 1:
        return
    assert f["fused_mlp_dx"] == fwd(s, h, d) + nt(s, h, d) + nt(s, d, h)
    mlp_stream = fwd(s, h, d) + nt(s, h, d) + nt(s, d, h) + tn(s, d, h) + tn(s, h, d)
    assert f["fused_mlp_bwd_stream"] == mlp_stream
    assert f["fused_mlp_bwd"] == mlp_stream + fwd(s, d, h)
    attn_stream = (fwd(s, 3 * d, d) + nt(s, d, d) + 6 * 2 * s * s * d + nt(s, d, 3 * d)
                   + tn(s, d, 3 * d) + tn(s, d, d))
    assert f["fused_attn_bwd_stream"] == attn_stream
    assert f["fused_attn_bwd"] == attn_stream + fwd(s, d, d)


def test_gemm_bwd_costs_count_their_bytes():
    """a, w (or g) and the output once, f32 where the output is; aux for
    the GELU gradient; the f32 column sums where asked."""
    m, n, k = 10, 64, 32
    core = 2 * (m * k + n * k)
    assert block.gemm_nt_cost(m, n, k) == (2 * m * n * k, core + 2 * m * n)
    assert block.gemm_nt_cost(m, n, k, "f32")[1] == core + 4 * m * n
    assert block.gemm_nt_cost(m, n, k, "gelu_grad", True)[1] == core + 4 * m * n + 4 * n
    assert block.gemm_tn_cost(m, k, n) == (2 * m * k * n, 2 * m * (k + n) + 4 * k * n)
    assert block.gemm_tn_cost(m, k, n, gsum=True)[1] == 2 * m * (k + n) + 4 * k * n + 4 * n


def test_gelu_grad_formula_of_the_kernel():
    """The gemm_nt epilogue's gelu_grad (block_kernels.cu), its coefficients
    read from the source and evaluated in f32 with exact division and exp,
    against the exact d/dz GELU(z) at every finite bf16 z with |z| < 30:
    within 3e-7 (the formula's own error, 1.7e-7 at most; ex2.approx and the
    fast division add a few f32 ulps on the card, which the card tests
    hold), as close as torch's erff and expf (within 1.3e-7)."""
    import math
    import pathlib
    import re

    src = (pathlib.Path(block.__file__).parent / "csrc" / "block_kernels.cu").read_text()
    body = src[src.index("__device__ __forceinline__ float gelu_grad(float z)"):]
    body = body[:body.index("\n}\n")]
    nums = [np.float32(float(v)) for v in re.findall(r"-?\d\.\d+e-\d+", body)]
    assert len(nums) == 12
    alpha, beta = nums[:7], nums[7:]
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.int16)
    z = torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
    z = z[np.isfinite(z) & (np.abs(z) < 30)]
    x = np.clip(z * np.float32(0.70710678118654752440), np.float32(-4), np.float32(4))
    x2 = x * x
    p, q = alpha[0], beta[0]
    for c in alpha[1:]:
        p = p * x2 + c
    for c in beta[1:]:
        q = q * x2 + c
    got = (np.float32(0.5) * (np.float32(1) + x * p / q)
           + z * np.exp(np.float32(-0.5) * z * z) * np.float32(0.3989422804014327))
    assert got.dtype == np.float32
    zd = z.astype(np.float64)
    exact = np.array([0.5 * (1 + math.erf(v / math.sqrt(2))) for v in zd]) \
        + zd * np.exp(-0.5 * zd * zd) / math.sqrt(2 * math.pi)
    assert np.abs(got - exact).max() <= 3e-7
    torch_err = np.abs(block._gelu_grad(torch.from_numpy(z)).double().numpy() - exact).max()
    assert torch_err <= 1.3e-7
