"""The benchmark's own count of the work a step or a forward needs, and the
H100's peaks, for ``mfu.*`` and the ``*_roofline`` metrics.

Only products the algorithm needs are counted, each once; nothing the
program recomputes. That is where this copy departs from the program's
``ops/block.block_flops`` and ``ops/attention.flash_cost``:

- ``block_flops`` counts the resident backward halves' recomputed forward
  (the MLP backward as six 2*S*D*4D products where four are needed, the
  attention backward with the recomputed qkv, o, scores and PV), and the
  frozen MLP half's dx as three products where two are needed;
- ``flash_cost``'s backward counts 10 * B*H*S^2*dh, of which the
  recomputed scores are 2; here it is 8 (dP, dV, dQ, dK), and the forward
  4 (scores and PV);
- the LoRA step needs, from the last block, only the MLP half's dx (the
  adapter sits on the attention half's output) and the adapter's three
  backward products; the frozen blocks below take no backward at all;
- unfreezing the last N blocks needs dx and dW of their four products,
  but for the lowest of them the qkv product's dx: the gradient of that
  block's input reaches no trainable leaf.

Bytes: each operand read once and each result written once, bf16, weight
gradients in f32. A bound is max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s):
NVIDIA's H100 SXM data sheet, dense bf16, at the 700 W limit.
"""

from __future__ import annotations

from posebench.reference.spec import ModelShape, upsampling_plan

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _product(m: int, k: int, n: int, out_bytes: int = 2) -> tuple[int, int]:
    """(FLOPs, bytes) of an (m, k) x (k, n) product."""
    return 2 * m * k * n, 2 * (m * k + k * n) + out_bytes * m * n


def block_forward_products(tokens: int, d: int, hidden: int) -> list[tuple[int, int, int]]:
    """(m, k, n) of a block's four forward products: qkv, out-projection,
    fc1, fc2."""
    return [(tokens, d, 3 * d), (tokens, d, d), (tokens, d, hidden), (tokens, hidden, d)]


def gemm_work(shape: ModelShape, finetune: dict, batch: int, size: int,
              train: bool) -> list[tuple[int, int]]:
    """(FLOPs, bytes) of every block product a step (``train``) or a
    forward needs: the GEMM core's share of the work."""
    s = (size // shape.patch) ** 2 + 1
    t, d, hid = batch * s, shape.hidden, shape.hidden * shape.mlp_ratio
    fwd = block_forward_products(t, d, hid)
    work = [_product(*p) for _ in range(shape.layers) for p in fwd]
    if not train:
        return work
    if finetune.get("use_lora"):
        # The last block's MLP half: dx of fc2, then of fc1.
        return work + [_product(t, d, hid), _product(t, hid, d)]
    for layer in range(int(finetune.get("unfreeze_last_n_layers", 0))):
        for j, (m, k, n) in enumerate(fwd):
            if layer or j:                                  # the lowest block's qkv dx
                work.append(_product(m, n, k))              # feeds no leaf: dx = dY W^T
            work.append(_product(k, m, n, out_bytes=4))     # dW = A^T dY, f32
    return work


def attention_work(shape: ModelShape, finetune: dict, batch: int, size: int,
                   train: bool) -> tuple[list, list]:
    """(forward, backward) lists of (FLOPs, bytes), one a layer, of the
    attention core: 4 and 8 * B*S^2*D; q, k, v in and o out, then q, k, v,
    o and dO in and dq, dk, dv out."""
    s = (size // shape.patch) ** 2 + 1
    d = shape.hidden
    act = batch * s * d * 2
    fwd = [(4 * batch * s * s * d, 4 * act)] * shape.layers
    bwd = []
    if train and not finetune.get("use_lora"):
        bwd = [(8 * batch * s * s * d, 8 * act)] * int(finetune.get("unfreeze_last_n_layers", 0))
    return fwd, bwd


def _conv(h: int, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> tuple[int, int]:
    """(FLOPs, output side) of a SAME-padded k x k conv on an h x h map."""
    out = (h + 2 * (k // 2) - k) // stride + 1
    return 2 * out * out * cout * (cin // groups) * k * k, out


def heads_flops(shape: ModelShape, grid: int) -> tuple[int, int]:
    """(weighted products, resize products) FLOPs of the heads' forward on
    one image with a grid x grid patch map: every conv, transposed conv and
    Linear; and the bilinear resize's two products where the map is not
    already at the heatmap size (at 224^2 the reference resizes 48 to 48,
    which needs nothing)."""
    d, total = shape.hidden, 0
    for h, cin, cout, k, stride, groups in (
        (grid, d, 512, 3, 1, 1), (grid, 512, 512, 3, 1, 512), (grid, 512, 512, 1, 1, 1),
        (grid, 512, 256, 3, 2, 1), ((grid + 1) // 2, 256, 128, 3, 2, 1),
        ((grid + 3) // 4, 128, 128, 3, 1, 1), ((grid + 3) // 4, 128, 128, 3, 1, 1),
        (grid, 512, 512, 1, 1, 1), (grid, 512, 256, 3, 1, 1),
    ):
        total += _conv(h, cin, cout, k, stride, groups)[0]
    q = (grid + 3) // 4
    total += 2 * q * q * 128 * 256 * 4 + 2 * (2 * q) ** 2 * 256 * 512 * 4   # up1, up2 (k2, s2)
    side, cin = grid, 256
    for cout, stride in upsampling_plan(grid, shape.heatmap):
        total += 2 * side * side * cin * cout * 16                            # k4 transposed
        side, cin = (side - 1) * stride + 2, cout
    total += _conv(side, cin, 64, 3)[0] + _conv(side, 64, shape.keypoints, 1)[0]
    prev = d
    for w in (*shape.z_hidden, shape.keypoints):
        total += 2 * prev * w
        prev = w
    resize = 0
    if side != shape.heatmap:
        hm, k = shape.heatmap, shape.keypoints
        resize = 2 * k * hm * side * side + 2 * k * hm * hm * side
    return total, resize


def model_flops(shape: ModelShape, finetune: dict, batch: int, size: int, train: bool) -> int:
    """FLOPs a train step (``train``) or a forward of ``batch`` images
    needs: the patch embedding, the blocks, the adapter, the heads; and the
    backward products the trainable leaves need."""
    grid = size // shape.patch
    s, d = grid * grid + 1, shape.hidden
    t = batch * s
    fwd_att, bwd_att = attention_work(shape, finetune, batch, size, train)
    total = 2 * batch * grid * grid * d * 3 * shape.patch ** 2
    total += sum(f for f, _ in gemm_work(shape, finetune, batch, size, train))
    total += sum(f for f, _ in fwd_att) + sum(f for f, _ in bwd_att)
    heads, resize = heads_flops(shape, grid)
    lora = bool(finetune.get("use_lora"))
    total += batch * (heads + resize)
    if lora:
        total += 2 * 2 * t * d * shape.lora_rank
    if train:
        total += batch * (2 * heads + resize)
        if lora:
            total += 3 * 2 * t * d * shape.lora_rank
    return total
