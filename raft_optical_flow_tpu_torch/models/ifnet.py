"""IFNet (RIFE's flow network), used as a flow estimator.

Counterpart of `raft_optical_flow_tpu/models/ifnet.py`: three cascaded
IFBlocks (c = 240, 150, 90) at scales 4, 2, 1. Each block resizes its input
to 1/scale, runs two stride-2 convs, an 8-conv residual trunk (PReLU after
every conv) and a transposed-conv head, resizes the 5-channel output (4
channels of flow in both directions, 1 of mask) back to full size, and the
flows and masks add up across the blocks. Between blocks both images are
warped by the current flow halves (border padding).

Modules run NCHW inside; the public tensors are NHWC. Module names mirror
the flax names (`block0.conv0_0_0`, `block1.convblock_3_1`,
`block2.lastconv`, ...); the PReLU slopes are `weight` (flax `scale`).

Policies (`compute_dtype`): the blocks' convs cast their input to the
compute dtype, the PReLUs and the transposed conv run in their input's
dtype, so under bf16 a block's output and its resize are bf16; the flow and
the mask accumulate in fp32 and the full-size warps run on the fp32 images
with fp32 coordinates. fp32 runs with TF32 off (`fp32_policy`).

`feature_res_warp` builds each later block's input at its own 1/scale size
and warps there, warp(resize(img), resize(flow) / s) in place of
resize(warp(img, flow)): exact for the channels that are not warped, close
for the two that are (the JAX package's serving option).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from raft_optical_flow_tpu_torch.models.layers import (
    PReLU,
    conv,
    deconv,
    fp32_policy,
    init_weights,
    nchw,
    nhwc,
)
from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear
from raft_optical_flow_tpu_torch.ops.warp import backward_warp

BLOCK_WIDTHS = (240, 150, 90)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """`resize_bilinear` of NCHW x."""
    return nchw(resize_bilinear(nhwc(x), tuple(hw)))


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """`backward_warp` of NCHW img by NCHW flow, border padding."""
    return nchw(backward_warp(nhwc(img), nhwc(flow), padding="border"))


class IFBlock(nn.Module):
    """One scale of the cascade.

    forward(x, flow, scale, out_hw=None): x [N, in_planes - 4 (or
    in_planes without a flow), h, w] and flow [N, 4, h, w] NCHW, either at
    the cascade's full size out_hw (the block resizes them) or already at
    out_hw // scale with the flow scaled (the feature_res_warp path).
    Returns the flow [N, 4, H, W] and mask [N, 1, H, W] at out_hw, in the
    dtype of the block's head.
    """

    def __init__(self, in_planes: int, c: int, dtype: torch.dtype):
        super().__init__()
        self.conv0_0_0 = conv(in_planes, c // 2, 3, 2, 1, compute_dtype=dtype)
        self.conv0_0_1 = PReLU(c // 2)
        self.conv0_1_0 = conv(c // 2, c, 3, 2, 1, compute_dtype=dtype)
        self.conv0_1_1 = PReLU(c)
        for i in range(8):
            setattr(self, f"convblock_{i}_0", conv(c, c, 3, 1, 1, compute_dtype=dtype))
            setattr(self, f"convblock_{i}_1", PReLU(c))
        self.lastconv = deconv(c, 5, 4, 2, 1)

    def forward(self, x, flow: Optional[torch.Tensor], scale: int, out_hw=None):
        H, W = out_hw if out_hw is not None else x.shape[2:]
        tgt = (H // scale, W // scale)
        if tuple(x.shape[2:]) != tgt:
            x = _resize(x, tgt)
        if flow is not None:
            if tuple(flow.shape[2:]) != tgt:
                flow = _resize(flow, tgt) * (1.0 / scale)
            x = torch.cat([x, flow], dim=1)
        x = self.conv0_0_1(self.conv0_0_0(x))
        x = self.conv0_1_1(self.conv0_1_0(x))
        y = x
        for i in range(8):
            y = getattr(self, f"convblock_{i}_1")(getattr(self, f"convblock_{i}_0")(y))
        tmp = _resize(self.lastconv(y + x), (H, W))
        return tmp[:, :4] * (scale * 2.0), tmp[:, 4:5]


class IFNet(nn.Module):
    """Three-block flow cascade.

    forward(img0, img1, scale=(4, 2, 1), timestep=0.5): images [N, H, W, 3]
    (the JAX trainers pass them in [0, 1]). Returns (flow_list, mask_list,
    warped_list), one entry per block, all fp32 NHWC: the accumulated flow
    [N, H, W, 4] (channels 0-1 warp img0, 2-3 img1), the sigmoid mask
    [N, H, W, 1], and the pair (img0, img1) warped by the flow's halves.
    `train=True` keeps autograd; the default runs without it.
    """

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 feature_res_warp: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.feature_res_warp = feature_res_warp
        for i, c in enumerate(BLOCK_WIDTHS):
            setattr(self, f"block{i}", IFBlock(7 if i == 0 else 18, c, compute_dtype))
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, scale: Sequence[int] = (4, 2, 1),
                timestep: float = 0.5, train: bool = False):
        if self.compute_dtype == torch.float32:
            fp32_policy()
        if train:
            return self._forward(img0, img1, scale, timestep)
        with torch.no_grad():
            return self._forward(img0, img1, scale, timestep)

    def _forward(self, img0, img1, scale, timestep):
        img0, img1 = nchw(img0).contiguous(), nchw(img1).contiguous()
        N, _, H, W = img0.shape
        ts = img0.new_full((N, 1, H, W), timestep)
        flow_list, mask_list, warped_list = [], [], []
        warped0, warped1 = img0, img1
        flow = mask = None
        for i, s in enumerate(scale):
            block = getattr(self, f"block{i}")
            if flow is None:
                flow_d, mask_d = block(torch.cat([img0, img1, ts], dim=1), None, s)
                flow, mask = flow_d.float(), mask_d.float()
            else:
                if self.feature_res_warp and s != 1:
                    tgt = (H // s, W // s)
                    img0_s, img1_s = _resize(img0, tgt), _resize(img1, tgt)
                    flow_s = _resize(flow, tgt) * (1.0 / s)
                    x = torch.cat([img0_s, img1_s, img0.new_full((N, 1, *tgt), timestep),
                                   _warp(img0_s, flow_s[:, :2]), _warp(img1_s, flow_s[:, 2:4]),
                                   _resize(mask, tgt)], dim=1)
                    flow_d, mask_d = block(x, flow_s, s, out_hw=(H, W))
                else:
                    x = torch.cat([img0, img1, ts, warped0, warped1, mask], dim=1)
                    flow_d, mask_d = block(x, flow, s)
                flow = flow + flow_d.float()
                mask = mask + mask_d.float()
            mask_list.append(nhwc(torch.sigmoid(mask)))
            flow_list.append(nhwc(flow))
            warped0, warped1 = _warp(img0, flow[:, :2]), _warp(img1, flow[:, 2:4])
            warped_list.append((nhwc(warped0), nhwc(warped1)))
        return flow_list, mask_list, warped_list


def ifnet(device="cuda", generator=None, **kw) -> IFNet:
    return IFNet(device=device, generator=generator, **kw)
