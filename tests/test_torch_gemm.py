"""The chains' GEMM core on the CPU: ``ops/block.gemm_math``, the plain
version of the wgmma/TMA ``gemm_kernel`` behind ``fused_gemm``, composed as
each chain composes its products, reproduces the port's plain halves bit for
bit: ``attn_part_math`` and its streamed and shard forms, the whole block's
attention residual, ``mlp_part_math`` and its streamed, training and shard
forms, ``mlp_dx_math``'s recomputed forward product and the MLP backward's
GELU pair and h2. Those plain halves are held against the JAX package's
kernels in interpret mode (tests/test_torch_block.py, test_torch_stream.py,
test_torch_stream_train.py, test_torch_tp.py), so this ties each epilogue's
rounding points to JAX's. The chains normalise their rows once
(``ln_rows``, plain version ``_ln_fwd``) before the first product; the
forward halves' ``layer_norm`` gives the same bits. ``gemm_cost`` adds up to
``block_flops``' per-wrapper counts.

Inputs are seeded with numpy; bf16 and f32, widths D = 64 (two heads of 32)
and 128 (two of 64), shard counts 2 and 4. Exact equality throughout: the
composition runs the same PyTorch operations in the same order.
"""

import numpy as np
import pytest
import torch

from dino_pose_tpu_torch.nn.layers import layer_norm
from dino_pose_tpu_torch.ops import block

EPS = 1e-6
B, S = 2, 17


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
    x = t(B, S, d)
    return x, p


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _attn_compose(x, ap, heads, last, ls=None):
    qkv = block.gemm_math(layer_norm(x, ap.g1, ap.b1, EPS), ap.wqkv, "bias", ap.bqkv)
    ctx = block._heads_attention(qkv, heads)
    return block.gemm_math(ctx, ap.wo, last, getattr(ap, "bo", None), ls, x)


def _mlp_compose(x2, mp, last):
    h = block.gemm_math(layer_norm(x2, mp.g2, mp.b2, EPS), mp.w1, "bias_gelu", mp.bf1)
    return block.gemm_math(h, mp.w2, last, getattr(mp, "bf2", None), getattr(mp, "ls2", None),
                           x2)


DTYPES = [torch.bfloat16, torch.float32]
WIDTHS = [64, 128]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("half", ["attn_part", "attn_part_stream", "block_x2"])
def test_gemm_composes_the_attention_halves(half, dtype, d):
    """qkv (``bias``) -> attention -> out-projection: ``bias`` is
    attn_part_math, ``f32bias`` attn_part_stream_math, ``bias_ls_res``
    the whole block's x2 = x + ls1*o (block_train_math)."""
    x, p = _inputs(d, dtype)
    heads = 2
    ap = block.attn_params(p)
    if half == "attn_part":
        want = block.attn_part_math(x, ap, num_heads=heads, eps=EPS)
        got = _attn_compose(x, ap, heads, "bias")
    elif half == "attn_part_stream":
        want = block.attn_part_stream_math(x, ap, num_heads=heads, eps=EPS)
        got = _attn_compose(x, ap, heads, "f32bias")
    else:
        want = block.block_train_math(x, p, num_heads=heads, eps=EPS)[1]
        got = _attn_compose(x, ap, heads, "bias_ls_res", p.ls1)
    _equal(got, want)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("half", ["mlp_part", "mlp_part_stream", "mlp_part_stream_train",
                                  "block"])
def test_gemm_composes_the_mlp_halves(half, dtype, d):
    """fc1 (``bias_gelu``) -> fc2: ``bias_ls_res`` is mlp_part_math (and the
    whole block's y), ``f32bias_ls_res`` mlp_part_stream_math,
    ``f32bias_ls_res_h2`` mlp_part_stream_train_math's (y, h2)."""
    x, p = _inputs(d, dtype)
    mp = block.mlp_params(p)
    if half == "mlp_part":
        want, got = block.mlp_part_math(x, mp, eps=EPS), _mlp_compose(x, mp, "bias_ls_res")
    elif half == "mlp_part_stream":
        want = block.mlp_part_stream_math(x, mp, eps=EPS)
        got = _mlp_compose(x, mp, "f32bias_ls_res")
    elif half == "mlp_part_stream_train":
        want = block.mlp_part_stream_train_math(x, mp, eps=EPS)
        got = _mlp_compose(x, mp, "f32bias_ls_res_h2")
    else:
        want = block.block_math(x, p, num_heads=2, eps=EPS)
        x2 = _attn_compose(x, block.attn_params(p), 2, "bias_ls_res", p.ls1)
        got = _mlp_compose(x2, mp, "bias_ls_res")
    _equal(got, want)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_gemm_composes_the_shard_halves(dtype, d, tp):
    """A shard's halves (#20 _attn_part_partial_kernel, #21
    _mlp_part_partial_kernel): qkv_l (``bias``) -> its heads -> ``none``,
    and fc1_l (``bias_gelu``) -> ``none``, on every shard's slice."""
    x, p = _inputs(d, dtype, seed=tp)
    heads = 4
    for r in range(tp):
        pa = block.shard_attn(block.attn_params(p), tp, r)
        pm = block.shard_mlp(block.mlp_params(p), tp, r)
        _equal(_attn_compose(x, pa, heads // tp, "none"),
               block.attn_part_math_partial(x, pa, num_heads=heads // tp, eps=EPS))
        _equal(_mlp_compose(x, pm, "none"), block.mlp_part_math_partial(x, pm, eps=EPS))


def _spy(monkeypatch, name):
    """Record every output of block.<name> while the plain version runs."""
    seen = []
    fn = getattr(block, name)

    def spy(*args):
        out = fn(*args)
        seen.append(out)
        return out

    monkeypatch.setattr(block, name, spy)
    return seen


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("route", ["mlp_dx", "mlp_partial_dx"])
def test_gemm_gives_the_dx_chains_forward_product(route, dtype, d, monkeypatch):
    """The dx chains recompute h1 = bf16(LN2(x2) W1) + bf16(bf1): ln_rows'
    plain rows, then ``bias``, as mlp_dx_math (and mlp_partial_dx_math on a
    shard) forms it."""
    x, p = _inputs(d, dtype)
    mp = block.mlp_params(p)
    dy = torch.ones_like(x)
    seen = _spy(monkeypatch, "_dense")
    if route == "mlp_dx":
        block.mlp_dx_math(x, dy, mp, eps=EPS)
    else:
        mp = block.shard_mlp(mp, 2, 1)
        block.mlp_partial_dx_math(x, dy, mp, eps=EPS)
    monkeypatch.undo()
    assert len(seen) == 1
    _equal(block.gemm_math(block.ln_rows(x, mp.g2, mp.b2, EPS), mp.w1, "bias", mp.bf1), seen[0])


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_gemm_gives_the_mlp_backward_products(dtype, d, monkeypatch):
    """mlp_bwd_math recomputes (h1, g = gelu(h1)), the ``bias_gelu_pair``
    epilogue's two outputs, and h2 = ``bias`` on g."""
    x, p = _inputs(d, dtype)
    mp = block.mlp_params(p)
    dense, gelu = _spy(monkeypatch, "_dense"), _spy(monkeypatch, "_gelu_exact")
    block.mlp_bwd_math(x, torch.ones_like(x), mp, eps=EPS)
    monkeypatch.undo()
    h1, g = block.gemm_math(block.ln_rows(x, mp.g2, mp.b2, EPS), mp.w1, "bias_gelu_pair", mp.bf1)
    _equal((h1, g), (dense[0], gelu[0]))
    _equal(block.gemm_math(g, mp.w2, "bias", mp.bf2), dense[1])


def test_ln_rows_and_layer_norm_round_alike():
    """The chains' LayerNorm rows (plain ``_ln_fwd``) and the forward
    halves' ``layer_norm`` give the same bits, bf16 and f32."""
    for dtype in DTYPES:
        x, p = _inputs(128, dtype)
        _equal(block.ln_rows(x, p.g1, p.b1, EPS), layer_norm(x, p.g1, p.b1, EPS))


@pytest.mark.parametrize("epi", block.EPILOGUES)
def test_fused_gemm_takes_gemm_math_on_the_cpu(epi):
    """On a CPU tensor the wrapper is its plain version, every epilogue."""
    x, p = _inputs(64, torch.bfloat16)
    a = x.reshape(-1, 64)
    res = torch.ones(a.shape[0], 256, dtype=a.dtype)
    kw = {"bias": p.bf1, "ls": p.bf1 + 1, "res": res}
    _equal(block.fused_gemm(a, p.w1, epi, **kw), block.gemm_math(a, p.w1, epi, **kw))
    with pytest.raises(ValueError, match="unknown epilogue"):
        block.fused_gemm(a, p.w1, epi + "_x")


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("d", [384, 768, 1024])
def test_gemm_cost_adds_up_to_block_flops(d, tp):
    """Each wrapper's FLOPs are its products' 2*M*N*K plus, for the
    attention halves, the scores and P V (4*S^2*D at the local width)."""
    s = 257
    h = 4 * d
    f = block.block_flops(s, d, h, tp)

    def g(m, n, k):
        return block.gemm_cost(m, n, k)[0]

    attn = 4 * s * s * d // tp
    assert f["fused_attn_part_partial"] == g(s, 3 * d // tp, d) + attn + g(s, d, d // tp)
    assert f["fused_mlp_part_partial"] == g(s, h // tp, d) + g(s, d, h // tp)
    assert f["fused_mlp_partial_dx"] == g(s, h // tp, d) + g(s, h // tp, d) + g(s, d, h // tp)
    if tp == 1:
        assert f["fused_attn_part"] == g(s, 3 * d, d) + attn + g(s, d, d)
        assert f["fused_mlp_part"] == g(s, h, d) + g(s, d, h)
        assert f["fused_block"] == f["fused_attn_part"] + f["fused_mlp_part"]
        assert f["fused_mlp_dx"] == g(s, h, d) + g(s, h, d) + g(s, d, h)


def test_gemm_cost_counts_the_epilogue_bytes():
    """a, w and out once; the f32 bias (and ls) vectors, the residual and a
    second output where the epilogue reads or writes them."""
    m, n, k = 10, 64, 32
    core = 2 * (m * k + k * n + m * n)
    assert block.gemm_cost(m, n, k) == (2 * m * n * k, core)
    assert block.gemm_cost(m, n, k, "bias")[1] == core + 4 * n
    assert block.gemm_cost(m, n, k, "bias_ls_res")[1] == core + 8 * n + 2 * m * n
    assert block.gemm_cost(m, n, k, "bias_gelu_pair")[1] == core + 4 * n + 2 * m * n
    assert block.gemm_cost(m, n, k, "f32bias_ls_res_h2")[1] == core + 8 * n + 4 * m * n
