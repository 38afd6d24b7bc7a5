"""FastViT ConvFFN past its depthwise conv: the plain PyTorch version and the
CUDA kernel wrapper (counterpart of dino_pose_tpu/ops/convffn.py).

=====================  ======================  =======================================
wrapper                plain version           TPU kernel it replaces
=====================  ======================  =======================================
``fused_convffn``      ``convffn_math``        ``_convffn_fwd_kernel`` (convffn.py:92)
``fused_convffn_bwd``  ``convffn_bwd_math``    ``_convffn_bwd_kernel`` (convffn.py:117)
``fused_convffn_res``  ``convffn_res_math``    ``_convffn_fwd_res_kernel`` (convffn.py:370)
=====================  ======================  =======================================

Over each row of ``y`` (one token, C channels)::

    m   = y * inv + shift                                  # BatchNorm as an affine
    h   = m @ W1 + b1 + ((m @ A1) * mask1) @ B1 * s        # fc1 + ConvLoRA
    g   = gelu(h)
    out = g @ W2 + b2 + ((g @ A2) * mask2) @ B2 * s        # fc2 + ConvLoRA

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel (``ops/csrc/convffn_kernels.cu``) and adds one to
``LAUNCHES[<wrapper>]``, or raises; it never falls back. ``convffn_train``
is the differentiable ConvFFN (JAX's ``custom_vjp`` ``fused_convffn``):
forward ``fused_convffn``, backward ``fused_convffn_bwd``, gradients for
y, the BatchNorm affine and the four LoRA matrices, none for the frozen
fc1/fc2. ``convffn_res_train`` is the same with the block residual
(JAX's ``fused_convffn_res``, the stage-pair arm's block output): forward
``fused_convffn_res``, backward ``fused_convffn_bwd`` and dres = df.
``convffn_res_enabled`` is JAX's gate for it, with its VMEM byte models
copied.

Rank 0 (no LoRA) is expressed as JAX expresses it (fastvit.py:596-603):
rank-1 zero adapters, ones masks and s = 1, so one kernel serves every
configuration.

The kernels take widths C and H in multiples of 16 (their k16 steps).
fastvit_ma36's stages 0 and 1 (C = 76, 152) are not: the wrappers
zero-pad C and H up to the next multiple of 16 before the launch
(``pad_widths``: y, res, df, inv, shift, the W1 rows and columns, the W2
rows and columns, b1, b2, the A1 and A2 rows and the B1 and B2 columns)
and slice the outputs and gradients back (``unpad_grads``). The padded
lanes carry exact zeros through every product (m, h, g, dh and dm are 0
there), so the result is the unpadded one up to the order of the f32 sums.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from dino_pose_tpu_torch.ops import _ext
from dino_pose_tpu_torch.ops.block import _gelu_grad

LAUNCHES = _ext.LAUNCHES

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
MAX_RANK = 8          # LoRA rank the kernel takes (its m64n8k16 rank products)


class ConvFFNParams(NamedTuple):
    """Everything past the depthwise conv, in the JAX package's layout:
    1x1-conv kernels squeezed to (in, out) matrices; ``m1``/``m2`` the
    per-(sample, rank) Dropout2d masks, already scaled by 1/keep (ones in
    eval). For the kernel, matrices are bf16 and vectors and masks f32."""

    inv: torch.Tensor    # (C,)   f32
    shift: torch.Tensor  # (C,)   f32
    w1: torch.Tensor     # (C, H)
    b1: torch.Tensor     # (H,)   f32
    w2: torch.Tensor     # (H, C)
    b2: torch.Tensor     # (C,)   f32
    a1: torch.Tensor     # (C, R)
    b1l: torch.Tensor    # (R, H)
    a2: torch.Tensor     # (H, R)
    b2l: torch.Tensor    # (R, C)
    m1: torch.Tensor     # (B, R) f32
    m2: torch.Tensor     # (B, R) f32


class ConvFFNGrads(NamedTuple):
    """The backward's parameter gradients, f32 sums over every row (base
    fc1/fc2 and the masks get none)."""

    inv: torch.Tensor    # (C,)
    shift: torch.Tensor  # (C,)
    a1: torch.Tensor     # (C, R)
    b1l: torch.Tensor    # (R, H)
    a2: torch.Tensor     # (H, R)
    b2l: torch.Tensor    # (R, C)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of compute-dtype operands, summed in f32 and not rounded
    (JAX's ``preferred_element_type=float32``)."""
    return a.float() @ b.float()


def _hidden(y: torch.Tensor, p: ConvFFNParams, s_lora: float):
    """The forward up to g, with the kernels' rounding points: (m, u1 in y's
    dtype, h, g)."""
    dt = y.dtype
    m = (y.float() * p.inv + p.shift).to(dt)
    u1 = (_mm(m, p.a1.to(dt)) * p.m1[:, None, :]).to(dt)
    h = (_mm(m, p.w1.to(dt)).to(dt) + p.b1.to(dt)) + (_mm(u1, p.b1l.to(dt)) * s_lora).to(dt)
    g = torch.nn.functional.gelu(h.float()).to(dt)
    return m, u1, h, g


def convffn_math(y: torch.Tensor, p: ConvFFNParams, s_lora: float) -> torch.Tensor:
    """Plain version of ``_convffn_fwd_kernel`` (convffn.py:96-114) on (B, S, C)
    rows, with its rounding points: the products sum in f32, each is rounded
    to y's dtype before its add, and the three terms of h (and of out) add
    left to right in that dtype, each sum rounded."""
    dt = y.dtype
    _, _, _, g = _hidden(y, p, s_lora)
    u2 = _mm(g, p.a2.to(dt)) * p.m2[:, None, :]
    return (_mm(g, p.w2.to(dt)).to(dt) + p.b2.to(dt)) + (_mm(u2.to(dt), p.b2l.to(dt)) * s_lora).to(dt)


def convffn_bwd_math(y: torch.Tensor, df: torch.Tensor, p: ConvFFNParams,
                     s_lora: float) -> tuple[torch.Tensor, ConvFFNGrads]:
    """Plain version of ``_convffn_bwd_kernel`` (convffn.py:127-175): dy and
    the parameter gradients from the cotangent ``df`` of the output, the
    forward recomputed with its rounding points. The products sum in f32;
    du2, dh and du1 are rounded to y's dtype before they feed products, dg
    stays f32 into gelu'; the gradients are f32 sums over all B*S rows."""
    dt = y.dtype
    yf = y.float()
    m1, m2 = p.m1[:, None, :], p.m2[:, None, :]
    m, u1, h, g = _hidden(y, p, s_lora)
    dfb = df.to(dt)
    u2 = (_mm(g, p.a2.to(dt)) * m2).to(dt)
    du2 = (_mm(dfb, p.b2l.to(dt).t()) * s_lora * m2).to(dt)
    dg = _mm(dfb, p.w2.to(dt).t()) + _mm(du2, p.a2.to(dt).t())
    dh = (dg * _gelu_grad(h.float())).to(dt)
    du1 = (_mm(dh, p.b1l.to(dt).t()) * s_lora * m1).to(dt)
    dm = _mm(dh, p.w1.to(dt).t()) + _mm(du1, p.a1.to(dt).t())

    def outer(a, b):  # sum over rows of a^T b, f32
        return _mm(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]))

    grads = ConvFFNGrads(
        inv=(dm * yf).sum(dim=(0, 1)), shift=dm.sum(dim=(0, 1)),
        a1=outer(m, du1), b1l=outer(u1, dh) * s_lora,
        a2=outer(g, du2), b2l=outer(u2, dfb) * s_lora)
    return (dm * p.inv).to(dt), grads


def convffn_res_math(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams,
                     s_lora: float) -> torch.Tensor:
    """Plain version of ``_convffn_fwd_res_kernel`` (convffn.py:370):
    ``convffn_math``'s output plus res, added in y's dtype, last."""
    return convffn_math(y, p, s_lora) + res.to(y.dtype)


# JAX's VMEM byte models of the ConvFFN kernels (convffn.py:178-250), copied
# for ``convffn_res_enabled``.
_FWD_BUDGET = 12 * 1024 * 1024
_BWD_BUDGET = 10 * 1024 * 1024


def _fwd_bytes(g: int, sp: int, c: int, h: int, r: int, i: int, streams: int = 2) -> int:
    stream_b = streams * (2 * g * sp * c * i)       # y (+res) in + out, 2x-buffered
    temps = g * sp * c * (i + 4) + g * sp * h * (2 * i + 8) + g * sp * r * 12
    weights = 2 * c * h * i + 2 * r * (c + h) * i
    return stream_b + temps + weights


def _bwd_bytes(spt: int, c: int, h: int, r: int, i: int) -> int:
    streams = 3 * (2 * spt * c * i)                 # y, df, dy
    temps = spt * c * (2 * i + 12) + spt * h * (3 * i + 12) + spt * r * 16
    weights = 2 * c * h * i + 2 * r * (c + h) * i
    accums = 4 * (2 * c + r * (2 * c + 2 * h))
    return streams + temps + weights + accums


def _fwd_plan(sp: int, c: int, h: int, r: int, itemsize: int, batch: int,
              streams: int) -> tuple[int, int]:
    g = 0
    for cand in (8, 4, 2, 1):
        if _fwd_bytes(cand, sp, c, h, r, itemsize, streams) <= _FWD_BUDGET:
            g = cand
            break
    while g > 1 and batch % g:
        g //= 2
    if g:
        return g, 1
    kt = 2
    while kt <= sp // 8:
        if sp % kt == 0 and (sp // kt) % 8 == 0 and _fwd_bytes(
                1, sp // kt, c, h, r, itemsize, streams) <= _FWD_BUDGET:
            return 1, kt
        kt *= 2
    return 0, 0


def _bwd_row_chunks(sp: int, c: int, h: int, r: int, itemsize: int) -> int:
    kt = 1
    while kt <= sp // 8:
        if sp % kt == 0 and (sp // kt) % 8 == 0 and (
                _bwd_bytes(sp // kt, c, h, r, itemsize) <= _BWD_BUDGET):
            return kt
        kt *= 2
    return 0


def convffn_res_enabled(c: int, hidden: int, s: int, itemsize: int, train: bool,
                        lora_rank: int, batch: int | None = None) -> bool:
    """JAX's ``convffn_res_enabled`` (convffn.py:494), its contract part: the
    ConvFFN side of the stage-pair gate, in training only with LoRA (the
    backward gives the base fc1/fc2 no gradient), and only where JAX's
    residual forward plan (three streams) and, in training, its backward
    row chunks fit VMEM. (JAX's ``DINO_POSE_TPU_CONVFFN`` kill switch
    selects its ConvFFN route, which the port does not have.)"""
    if train and lora_rank == 0:
        return False
    sp = -(-s // 8) * 8
    r = max(1, lora_rank)
    if _fwd_plan(sp, c, hidden, r, itemsize, batch or 1, streams=3)[0] == 0:
        return False
    return not train or _bwd_row_chunks(sp, c, hidden, r, itemsize) > 0


def convffn_cost(b: int, s: int, c: int, h: int, r: int, res: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: the two products (4*B*S*C*H, JAX's
    CostEstimate) and the four LoRA products (4*B*S*R*(C+H)); y (and with
    ``res`` the residual) read and out written once in bf16, the bf16
    weights and LoRA matrices once, the f32 vectors and masks once."""
    flops = 4 * b * s * c * h + 4 * b * s * r * (c + h) + (b * s * c if res else 0)
    nbytes = ((3 if res else 2) * b * s * c * 2 + (2 * c * h + 2 * r * (c + h)) * 2
              + (3 * c + h) * 4 + 2 * b * r * 4)
    return flops, nbytes


def convffn_bwd_cost(b: int, s: int, c: int, h: int, r: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one backward call: three products of 2*B*S*C*H (h
    recomputed, dg, dm) and eleven rank-R ones (u1, du2, du1·A1ᵀ, dA1, dB2
    over C; the fc1 LoRA term, u2, du2·A2ᵀ, du1, dB1, dA2 over H); y and df
    read and dy written once in bf16, the bf16 weights and LoRA matrices, the
    f32 inv, shift, b1 and masks once, the f32 gradients written once."""
    m = b * s
    flops = 6 * m * c * h + 2 * m * r * (5 * c + 6 * h)
    nbytes = (3 * m * c * 2 + (2 * c * h + 2 * r * (c + h)) * 2 + (2 * c + h) * 4
              + 2 * b * r * 4 + (2 * c + 2 * r * (c + h)) * 4)
    return flops, nbytes


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def pad_widths(y: torch.Tensor, p: ConvFFNParams, *rows: torch.Tensor
               ) -> tuple[torch.Tensor, ConvFFNParams, tuple[torch.Tensor, ...]]:
    """(y, p, rows) with C and H zero-padded up to multiples of 16, the
    kernels' widths: y and each of ``rows`` (res, df: (B, S, C)) along C;
    inv, shift, b2, the W2 and B2 columns and the W1 and A1 rows along C;
    b1, the W1 and B1 columns and the W2 and A2 rows along H. The masks are
    unchanged. Returns the operands as they are where both widths already
    are multiples of 16."""
    c, h = y.shape[-1], p.w1.shape[-1]
    dc, dh = _up16(c) - c, _up16(h) - h
    if not (dc or dh):
        return y, p, rows

    def pad(t: torch.Tensor, last: int, first: int = 0) -> torch.Tensor:
        return torch.nn.functional.pad(t, (0, last, 0, first) if first else (0, last))

    padded = ConvFFNParams(
        inv=pad(p.inv, dc), shift=pad(p.shift, dc), w1=pad(p.w1, dh, dc), b1=pad(p.b1, dh),
        w2=pad(p.w2, dc, dh), b2=pad(p.b2, dc), a1=pad(p.a1, 0, dc), b1l=pad(p.b1l, dh),
        a2=pad(p.a2, 0, dh), b2l=pad(p.b2l, dc), m1=p.m1, m2=p.m2)
    return pad(y, dc), padded, tuple(pad(t, dc) for t in rows)


def unpad_grads(g: ConvFFNGrads, c: int, h: int) -> ConvFFNGrads:
    """The gradients of ``pad_widths``' operands sliced back to C and H."""
    return ConvFFNGrads(inv=g.inv[:c], shift=g.shift[:c], a1=g.a1[:c].contiguous(),
                        b1l=g.b1l[:, :h].contiguous(), a2=g.a2[:h].contiguous(),
                        b2l=g.b2l[:, :c].contiguous())


def _unpad_rows(t: torch.Tensor, c: int) -> torch.Tensor:
    return t if t.shape[-1] == c else t[..., :c].contiguous()


def _check(y: torch.Tensor, p: ConvFFNParams, name: str) -> tuple[int, int, int, int, int]:
    """Refuses what the kernels do not take, on the caller's (unpadded)
    operands."""
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 activations, got {y.dtype}")
    if y.dim() != 3 or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be a contiguous, 16-byte aligned (B, S, C) tensor")
    b, s, c = y.shape
    h, r = p.w1.shape[-1], p.a1.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {r} is not in 1..{MAX_RANK} (rank 0 is rank-1 zeros)")
    shapes = {"inv": (c,), "shift": (c,), "w1": (c, h), "b1": (h,), "w2": (h, c), "b2": (c,),
              "a1": (c, r), "b1l": (r, h), "a2": (h, r), "b2l": (r, c), "m1": (b, r), "m2": (b, r)}
    for field, shape in shapes.items():
        t = getattr(p, field)
        want = torch.bfloat16 if t.dim() == 2 and field not in ("m1", "m2") else torch.float32
        if t.device != y.device or t.dtype != want:
            raise TypeError(f"{name}: {field} must be {want} on {y.device}, got {t.dtype} on {t.device}")
        # 32-byte alignment: TMA reads W1 and W2 from their base addresses.
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name}: {field} must be a contiguous, 32-byte aligned {shape} "
                             f"tensor, got {tuple(t.shape)}")
    return b, s, c, h, r


# The kernel's shared memory (ops/csrc/convffn_kernels.cu ``make_layout``),
# mirrored here so that the plan is chosen, cached and tested on the host.
_BOX, _RANK_TILE = 8192, 1024   # a 64 x 64 bf16 tile; an 8-row rank tile
_SLICES = {False: 4, True: 3}   # 64-column out (dm) slices a consumer warpgroup holds
_RING = (8, 6, 4)               # ring depths tried, deepest first
# The kernel's instances (BWD, column warpgroups, slices, row lanes).
INSTANCES = frozenset({
    (False, 1, 1, 2), (False, 1, 2, 2), (False, 1, 3, 2), (False, 2, 2, 1), (False, 2, 3, 1),
    (False, 2, 4, 1), (True, 1, 1, 2), (True, 1, 2, 2), (True, 1, 1, 1), (True, 1, 2, 1),
    (True, 2, 2, 1), (True, 2, 3, 1)})


def partial_floats(c: int, h: int, r: int) -> int:
    """f32 values of one partial gradient set: inv, shift (C), A1 (C, R),
    B1 (R, H), A2 (H, R), B2 (R, C)."""
    return 2 * c + 2 * r * (c + h)


def convffn_smem(bwd: bool, c: int, h: int, r: int, nwg: int, lanes: int, tb: int, rs: int,
                 dfr: bool, lres: bool, persist: bool) -> int:
    """Shared-memory bytes of one plan of the kernel (``dp_convffn_smem``)."""
    nc, nch = -(-c // 64), -(-h // 64)
    o = tb * lanes * nc * _BOX * (2 if bwd and not dfr else 1) + rs * _BOX
    o += nwg * lanes * (_BOX * (2 if bwd else 1) + (0 if lres else 3 * _RANK_TILE))
    o += (2 * nch + 1) * _RANK_TILE if lres else 0
    o += lanes * _BOX + (2 * nc + 1) * _RANK_TILE
    if bwd:
        o += lanes * 4 * _RANK_TILE + nwg * lanes * 2048
    if nwg > 1:
        o += 128 * 8 * 4
    if persist:
        o += lanes * -(-partial_floats(c, h, r) * 4 // 1024) * 1024
    return o + (2 * rs + 2 * tb * lanes) * 8 + 1024


class Plan(NamedTuple):
    """One launch of the ConvFFN kernel: ``nwg`` column warpgroups sharing a
    row tile's chunks and holding ``nsw`` 64-column out (dm) slices each for
    ``passes`` walks of H, or ``lanes`` row lanes each on its own tile and
    all reading every weight box; ``tb`` row-tile buffers; ``rs`` weight-box
    ring slots (``resident``: the tile's whole box sequence, loaded once);
    ``lres`` every chunk's B1 and A2^T rank tiles resident; ``dfr`` df's
    boxes through the ring; ``persist`` the backward's partial sets kept in
    shared memory across the block's tiles (else one set a tile);
    ``splits`` the forward's H split (``cpg`` chunk groups a split);
    ``blocks`` the grid; ``sets`` the backward's partial sets."""

    nwg: int
    nsw: int
    lanes: int
    passes: int
    tb: int
    rs: int
    resident: bool
    lres: bool
    dfr: bool
    persist: bool
    splits: int
    cpg: int
    blocks: int
    sets: int
    smem: int


@functools.lru_cache(maxsize=None)
def convffn_plan(bwd: bool, m: int, c: int, h: int, r: int, sms: int) -> Plan:
    """The launch plan over M = B*S rows of widths C, H (multiples of 16) at
    rank r on a card of ``sms`` SMs, cached per shape. Up to C = 128 (192
    forward) two row lanes (the row split; one where the backward's partial
    sets would not fit two), else two column warpgroups and the passes that
    their out (dm) slices need. The backward keeps its partial sets on chip
    where a block walks several tiles (else one set a tile), and streams df
    through the ring only where its tile does not fit beside m's. The
    weights resident where one tile's boxes fit, else the deepest ring that
    does; two row-tile buffers where a block walks several tiles and they
    fit; the chunks' rank tiles resident where they fit. Where the
    forward's row tiles would fill less than half the card, H is split over
    blocks (each a run of chunk groups), as many splits as fill it; a
    finishing kernel sums the splits in order."""
    nc, nch, tiles = -(-c // 64), -(-h // 64), -(-m // 64)
    nwg, lanes0 = (1, 2) if nc <= (2 if bwd else 3) else (2, 1)
    passes = -(-nc // (nwg * _SLICES[bwd]))
    nsw = -(-nc // (nwg * passes))
    ng = -(-nch // nwg)
    splits, cpg = 1, ng
    if not bwd and 2 * -(-tiles // lanes0) <= sms and ng > 1:
        splits = min(ng, sms // -(-tiles // lanes0))
        cpg = -(-ng // splits)
        splits = -(-ng // cpg)
    boxes = nch * nc * (3 if bwd else 2)  # one tile's weight boxes, one pass
    for dfr in ((False, True) if bwd else (False,)):
        for persist in ((True, False) if bwd else (False,)):
            for lanes in ((lanes0, 1) if bwd and lanes0 > 1 else (lanes0,)):
                groups = -(-tiles // lanes)
                many = groups > sms
                if persist and not many:
                    continue
                tbs = (2, 1) if many and (persist or not bwd) else (1,)
                resident_ok = passes == 1 and not dfr and splits == 1
                for tb, rs in ([(tb, boxes) for tb in tbs] if resident_ok else []) + [
                        (tb, n) for tb in tbs for n in _RING]:
                    for lres in (True, False):
                        smem = convffn_smem(bwd, c, h, r, nwg, lanes, tb, rs, dfr, lres, persist)
                        if smem <= _SMEM_LIMIT:
                            blocks = (groups * splits if splits > 1 else
                                      groups if bwd and not persist else min(groups, sms))
                            return Plan(nwg, nsw, lanes, passes, tb, rs,
                                        rs == boxes and resident_ok, lres, dfr, persist, splits,
                                        cpg, blocks, blocks * lanes if persist else tiles, smem)
    raise ValueError(f"ConvFFN at C={c}, H={h} fits no plan in shared memory")


_SMS: dict[int, int] = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _forward(name: str, y: torch.Tensor, res: torch.Tensor | None, p: ConvFFNParams,
             s_lora: float) -> torch.Tensor:
    """One launch of the forward kernel on the padded operands."""
    c = y.shape[-1]
    y, p, rows = pad_widths(y, p, *(() if res is None else (res,)))
    b, s, cp = y.shape
    hp, r = p.w1.shape[-1], p.a1.shape[-1]
    plan = convffn_plan(False, b * s, cp, hp, r, _sms(y.device))
    out = torch.empty_like(y)
    # The H split's f32 partial out and u2, splits x M x (C + 8).
    scratch = (torch.empty(plan.splits * b * s * (cp + 8), dtype=torch.float32, device=y.device)
               if plan.splits > 1 else None)
    err = _ext.lib().dp_convffn_fwd(
        y.data_ptr(), rows[0].data_ptr() if rows else None, *(t.data_ptr() for t in p),
        out.data_ptr(), b * s, s, cp, hp, r, float(s_lora), plan.nwg, plan.nsw, plan.lanes,
        plan.passes, plan.tb, plan.rs, int(plan.resident), int(plan.lres), plan.splits, plan.cpg,
        None if scratch is None else scratch.data_ptr(), plan.blocks, _ext.stream(y.device.index))
    _ext.check(err, name)
    LAUNCHES[name] += 1
    return _unpad_rows(out, c)


def fused_convffn(y: torch.Tensor, p: ConvFFNParams, s_lora: float) -> torch.Tensor:
    """out over (B, S, C) rows; replaces ``_convffn_fwd_kernel``
    (dino_pose_tpu/ops/convffn.py:92, via ``fused_convffn`` :258).

    Design: one launch of ``convffn_kernel<false, NWG, NSW, LANES>``
    (ops/csrc/convffn_kernels.cu) on ``convffn_plan``'s persistent grid,
    each block walking 64-row tiles (two at a time at C <= 192, one per
    warpgroup); a producer thread loads y by TMA and the W1/W2 64 x 64
    boxes into an mbarrier ring (resident where a tile's boxes fit); per
    64-column chunk of H, h-chunk = m @ W1 on ``wgmma`` with the fc1 LoRA
    up-term u1b @ B1 as one k16 step into its own accumulator, the bias
    epilogue and GELU (a table of every bf16 h) into a bf16 g tile in
    shared memory, u2 += g @ A2 (m64n8k16), and out += g @ W2 into f32
    registers held across the walk; then out = bf16(bf16(bf16(acc) +
    bf16(b2)) + bf16(f32(u2b @ B2) * s)). Where the row tiles would fill
    less than half the card, H is split over blocks and a finishing kernel
    (inside the same C entry) sums the f32 partials in order before that
    epilogue. h and g never reach device memory, as on the TPU. The masks
    are per sample (row // S). ma36's C = 76 and 152 are padded
    (``pad_widths``).

    Bound on an H100: 4*B*S*C*H FLOPs (plus 4*B*S*R*(C+H) for LoRA) at
    989 TFLOP/s, or y and out (bf16) plus the weights at 3.35 TB/s;
    ``convffn_cost`` counts both.
    """
    name = "fused_convffn"
    if y.device.type == "cpu":
        return convffn_math(y, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, *p)):
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "convffn_train is the differentiable ConvFFN")
    _check(y, p, name)
    return _forward(name, y, None, p, s_lora)


def fused_convffn_res(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams,
                      s_lora: float) -> torch.Tensor:
    """res + out over (B, S, C) rows; replaces ``_convffn_fwd_res_kernel``
    (dino_pose_tpu/ops/convffn.py:370, via ``fused_convffn_res`` :377), the
    stage-pair arm's block output (LayerScale folded into w2, b2 and b2l by
    the caller).

    Design: ``fused_convffn``'s kernel with the residual as one more operand;
    its epilogue adds res to the rounded output, one more bf16 rounding, as
    JAX adds it after the three bf16 terms (convffn.py:112-113). One launch.

    Bound on an H100: ``fused_convffn``'s FLOPs, or y, res and out (bf16)
    plus the weights at 3.35 TB/s; ``convffn_cost(..., res=True)``."""
    name = "fused_convffn_res"
    if y.device.type == "cpu":
        return convffn_res_math(y, res, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, res, *p)):
        raise ValueError(f"{name} has no backward of its own, and an operand requires grad: "
                         "convffn_res_train is the differentiable one")
    _check(y, p, name)
    if (res.shape != y.shape or res.dtype != y.dtype or res.device != y.device
            or not res.is_contiguous() or res.data_ptr() % 16):
        raise ValueError(f"{name}: res must be a contiguous, 16-byte aligned bf16 tensor of y's "
                         f"shape {tuple(y.shape)}")
    return _forward(name, y, res, p, s_lora)


def fused_convffn_bwd(y: torch.Tensor, df: torch.Tensor, p: ConvFFNParams,
                      s_lora: float) -> tuple[torch.Tensor, ConvFFNGrads]:
    """(dy, parameter gradients) over (B, S, C) rows; replaces
    ``_convffn_bwd_kernel`` (dino_pose_tpu/ops/convffn.py:117, via
    ``fused_convffn``'s vjp :307).

    Design: one launch of ``convffn_kernel<true, NWG, NSW, LANES>`` on
    ``convffn_plan``'s grid, then ``convffn_bwd_reduce_kernel`` (inside the
    same C entry) summing the f32 partial gradient sets in order: no
    atomics, the same bits from run to run. Per 64-row tile the forward is
    recomputed on ``wgmma`` (m by TMA, converted in place; u1 = m @ A1,
    m64n8k16), du2 = bf16(f32(df @ B2^T) * s * m2) first; then per 64-column
    chunk of H: h-chunk (m @ W1) with its own LoRA accumulator and g,
    dg-chunk = [df | du2b] @ [W2^T ; A2^T] in one accumulator, dh =
    bf16(dg * gelu'(h)) (gelu' from a table of every bf16 h), u2 += g @ A2,
    du1 += dh @ B1^T, the chunk's dA2 = g^T du2b and dB1^T = dh^T u1b over
    the tile's rows (m64n8k16, A transposed), and dm += dh @ W1^T held in
    f32 registers across the walk. After it dm += du1b @ A1^T (one k16
    step), dy = bf16(dm * inv), the dinv/dshift column sums, dA1 = m^T du1b
    and dB2^T = df^T u2b. The partial sets stay in shared memory across
    the block's tiles and are written once (or, where they do not fit,
    one set a tile). h, g, dg and dh never reach device memory.

    Bound on an H100: 6*B*S*C*H FLOPs plus the rank-R terms at 989 TFLOP/s,
    or y, df and dy (bf16) plus the weights at 3.35 TB/s;
    ``convffn_bwd_cost`` counts both."""
    name = "fused_convffn_bwd"
    if y.device.type == "cpu":
        return convffn_bwd_math(y, df, p, s_lora)
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    _, _, c, h, _ = _check(y, p, name)
    if (df.shape != y.shape or df.dtype != y.dtype or df.device != y.device
            or not df.is_contiguous() or df.data_ptr() % 16):
        raise ValueError(f"{name}: df must be a contiguous, 16-byte aligned bf16 tensor of y's "
                         f"shape {tuple(y.shape)}")
    y, p, (df,) = pad_widths(y, p, df)
    b, s, cp = y.shape
    hp, r = p.w1.shape[-1], p.a1.shape[-1]
    m = b * s
    plan = convffn_plan(True, m, cp, hp, r, _sms(y.device))
    n = partial_floats(cp, hp, r)
    scratch = torch.empty((plan.sets + 1) * n, dtype=torch.float32, device=y.device)
    flat = scratch[plan.sets * n:]
    dy = torch.empty_like(y)
    err = _ext.lib().dp_convffn_bwd(
        *(t.data_ptr() for t in (y, df, *p, dy, scratch, flat)), m, s, cp, hp, r, float(s_lora),
        plan.nwg, plan.nsw, plan.lanes, plan.passes, plan.tb, plan.rs, int(plan.resident),
        int(plan.lres), int(plan.dfr), int(plan.persist), plan.blocks, plan.sets,
        _ext.stream(y.device.index))
    _ext.check(err, name)
    LAUNCHES[name] += 1
    shapes = ((cp,), (cp,), (cp, r), (r, hp), (hp, r), (r, cp))
    sizes = [math.prod(shape) for shape in shapes]
    grads = ConvFFNGrads(*(t.view(shape) for t, shape in zip(flat.split(sizes), shapes)))
    return _unpad_rows(dy, c), unpad_grads(grads, c, h)


_FROZEN = ("w1", "b1", "w2", "b2", "m1", "m2")


def _cast(p: ConvFFNParams, dtype: torch.dtype) -> ConvFFNParams:
    """The kernels' layout (JAX ``_prep``): matrices in ``dtype``, vectors
    and masks f32, all contiguous."""
    return ConvFFNParams(**{
        k: t.to(dtype if t.dim() == 2 and k not in ("m1", "m2") else torch.float32).contiguous()
        for k, t in p._asdict().items()})


class _ConvFFNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, res, s_lora, kernels, *params):
        trainable = [k for k, need in zip(ConvFFNParams._fields, ctx.needs_input_grad[4:])
                     if need and k in _FROZEN]
        if trainable:
            raise ValueError(
                f"convffn_train: {trainable} requires grad, but the ConvFFN backward gives the "
                "base fc1/fc2 (and the masks) no gradient, as JAX's does (frozen-backbone LoRA)")
        ctx.save_for_backward(y, *params)
        ctx.s_lora, ctx.kernels = s_lora, kernels
        pc = _cast(ConvFFNParams(*params), y.dtype)
        if res is None:
            return fused_convffn(y, pc, s_lora) if kernels else convffn_math(y, pc, s_lora)
        if kernels:
            return fused_convffn_res(y, res, pc, s_lora)
        return convffn_res_math(y, res, pc, s_lora)

    @staticmethod
    def backward(ctx, df):
        y, *params = ctx.saved_tensors
        pc = _cast(ConvFFNParams(*params), y.dtype)
        bwd = fused_convffn_bwd if ctx.kernels else convffn_bwd_math
        dy, g = bwd(y, df.to(y.dtype).contiguous(), pc, ctx.s_lora)
        g = g._asdict()
        # In each parameter's own dtype (JAX ``astype(p.a1.dtype)``): f32 for f32 masters.
        grads = [g[k].to(t.dtype) if need and k in g else None
                 for k, t, need in zip(ConvFFNParams._fields, params, ctx.needs_input_grad[4:])]
        # The residual is additive: its cotangent is df (convffn.py:442-447).
        dres = df if ctx.needs_input_grad[1] else None
        return (dy if ctx.needs_input_grad[0] else None, dres, None, None, *grads)


def convffn_train(y: torch.Tensor, p: ConvFFNParams, s_lora: float, *,
                  kernels: bool = True) -> torch.Tensor:
    """The ConvFFN past its depthwise conv under autograd (JAX's
    ``custom_vjp`` ``fused_convffn``, convffn.py:258-367): differentiable in
    y, inv, shift, a1, b1l, a2 and b2l. The forward is ``fused_convffn``,
    the backward ``fused_convffn_bwd`` (``kernels=False``: ``convffn_math``
    and ``convffn_bwd_math``, on any device). ``p`` holds the tensors as
    they train (LoRA matrices f32, with their graphs); they are cast to the
    kernels' layout inside, as JAX's ``_prep`` runs inside its
    ``custom_vjp``, so their gradients come back f32. Raises ``ValueError``
    if w1, b1, w2 or b2 requires grad: the backward gives them no gradient.
    Saves only y and ``p``; the backward recomputes the hidden activations."""
    return _ConvFFNTrain.apply(y.contiguous(), None, float(s_lora), kernels, *p)


def convffn_res_train(y: torch.Tensor, res: torch.Tensor, p: ConvFFNParams, s_lora: float, *,
                      kernels: bool = True) -> torch.Tensor:
    """res + the ConvFFN past its depthwise conv under autograd (JAX's
    ``custom_vjp`` ``fused_convffn_res``, convffn.py:377-447): as
    ``convffn_train``, the forward ``fused_convffn_res`` (``kernels=False``:
    ``convffn_res_math``), the backward ``fused_convffn_bwd`` with the
    residual's gradient df. Same contract for the parameters."""
    return _ConvFFNTrain.apply(y.contiguous(), res.contiguous(), float(s_lora), kernels, *p)
