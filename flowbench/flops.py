"""Model FLOPs of RAFT from shapes: convolutions and products only.

A conv counts 2 * N * Ho * Wo * Cin * Cout * kh * kw (a multiply and an add
per tap), a product 2 * m * n * k, as `torch.utils.flop_counter` counts
them. Norms, activations, the lookup's gathers and the upsampling's
weighted sums are not counted. The conv list is the reference's
(`reference.raft.param_shapes`), so the count follows the architecture and
not the program.

  - serving (`serve_flops`): both encoders, the volume, `iters` update
    blocks, and the mask head once (only the last iteration's mask reaches
    flow_up);
  - training (`train_flops`): 3x the forward with the mask head every
    iteration (the sequence loss reads every flow_up); recomputation is not
    counted.
"""

from __future__ import annotations

import math

from flowbench.reference.raft import Arch, param_shapes

MASK_CONVS = ("update_block.mask_0", "update_block.mask_2")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _out_hw(name: str, small: bool, H: int, W: int):
    """The output resolution of the conv `name` (its weight's layer name)."""
    parts = name.split(".")
    if parts[0] == "update_block":
        return H // 8, W // 8
    part = parts[1]
    if part == "conv1":
        return _ceil_div(H, 2), _ceil_div(W, 2)
    if part == "conv2":
        return H // 8, W // 8
    stage = int(part[len("layer")])
    div = 2 ** stage
    # a bottleneck's first 1x1 conv runs at the block's input resolution
    if small and part.endswith("_0") and parts[2] == "conv1" and stage > 1:
        div //= 2
    return _ceil_div(H, div), _ceil_div(W, div)


def conv_flops(arch: Arch, H: int, W: int):
    """{conv layer: FLOPs for one image at H x W}."""
    out = {}
    for name, shape, kind in param_shapes(arch):
        if kind not in ("conv", "enc_conv"):
            continue
        layer = name.rsplit(".", 1)[0]
        cout, cin, kh, kw = shape
        ho, wo = _out_hw(layer, arch.small, H, W)
        out[layer] = 2 * ho * wo * cin * cout * kh * kw
    return out


def volume_flops(arch: Arch, N: int, H: int, W: int) -> int:
    h, w = H // 8, W // 8
    total, hl, wl = 0, h, w
    for _ in range(arch.levels):
        total += 2 * N * (h * w) * (hl * wl) * arch.fdim
        hl, wl = hl // 2, wl // 2
    return total


def forward_flops(arch: Arch, N: int, H: int, W: int, iters: int, mask_iters: int) -> int:
    convs = conv_flops(arch, H, W)
    enc = sum(v * (2 * N if k.startswith("fnet") else N)
              for k, v in convs.items() if not k.startswith("update_block"))
    upd = sum(v for k, v in convs.items() if k.startswith("update_block") and k not in MASK_CONVS)
    mask = sum(v for k, v in convs.items() if k in MASK_CONVS)
    return enc + volume_flops(arch, N, H, W) + N * (iters * upd + mask_iters * mask)


def serve_flops(arch: Arch, N: int, H: int, W: int, iters: int) -> int:
    return forward_flops(arch, N, H, W, iters, mask_iters=min(iters, 1))


def train_flops(arch: Arch, N: int, H: int, W: int, iters: int) -> int:
    return 3 * forward_flops(arch, N, H, W, iters, mask_iters=iters)


def padded(n: int, stride: int = 8) -> int:
    return math.ceil(n / stride) * stride
