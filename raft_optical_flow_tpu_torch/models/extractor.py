"""RAFT feature and context encoders, NCHW inside.

Counterpart of `raft_optical_flow_tpu/models/extractor.py`: ResidualBlock,
BottleneckBlock, BasicEncoder (7x7/s2, three stages of 64/96/128) and
SmallEncoder (32/64/96). Submodule names are the flax names (`layer1_0`,
`downsample_conv`), so weights carry across mechanically
(`utils/weights.py`). Both encoders take the two frames stacked on the batch
axis; the caller folds and unfolds them.

`forward(x, train=False, bn_train=None, generator=None, blocks=1)` follows the JAX
encoders: `bn_train` (default `train`) puts BatchNorm in training mode (batch
statistics, running statistics updated); `train` with `dropout > 0` drops
whole output channels with masks drawn from `generator`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.models.layers import Norm, channel_dropout, conv


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride, 1)
        self.norm1 = Norm(norm_fn, planes)
        self.conv2 = conv(planes, planes, 3, 1, 1)
        self.norm2 = Norm(norm_fn, planes)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = conv(cin, planes, 1, stride, 0)
            self.downsample_norm = Norm(norm_fn, planes)

    def forward(self, x: torch.Tensor, bn_train: bool = False) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x), bn_train))
        y = F.relu(self.norm2(self.conv2(y), bn_train))
        if self.stride != 1:
            x = self.downsample_norm(self.downsample_conv(x), bn_train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        p4 = planes // 4
        # GroupNorm uses planes//8 groups even on the planes//4 intermediates
        g = planes // 8
        self.conv1 = conv(cin, p4, 1, 1, 0)
        self.norm1 = Norm(norm_fn, p4, g)
        self.conv2 = conv(p4, p4, 3, stride, 1)
        self.norm2 = Norm(norm_fn, p4, g)
        self.conv3 = conv(p4, planes, 1, 1, 0)
        self.norm3 = Norm(norm_fn, planes, g)
        self.stride = stride
        if stride != 1:
            self.downsample_conv = conv(cin, planes, 1, stride, 0)
            self.downsample_norm = Norm(norm_fn, planes, g)

    def forward(self, x: torch.Tensor, bn_train: bool = False) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x), bn_train))
        y = F.relu(self.norm2(self.conv2(y), bn_train))
        y = F.relu(self.norm3(self.conv3(y), bn_train))
        if self.stride != 1:
            x = self.downsample_norm(self.downsample_conv(x), bn_train)
        return F.relu(x + y)


class _Encoder(nn.Module):
    # the reference initializes every encoder conv with kaiming(fan_out)
    kaiming_out = True

    def __init__(self, block, dims, stem: int, output_dim: int, norm_fn: str,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = conv(3, stem, 7, 2, 3)
        self.norm1 = Norm(norm_fn, stem, 8)
        cin = stem
        for i, (dim, stride) in enumerate(zip(dims, (1, 2, 2)), start=1):
            setattr(self, f"layer{i}_0", block(cin, dim, norm_fn, stride))
            setattr(self, f"layer{i}_1", block(dim, dim, norm_fn, 1))
            cin = dim
        self.conv2 = conv(cin, output_dim, 1, 1, 0)

    def forward(self, x: torch.Tensor, train: bool = False, bn_train: Optional[bool] = None,
                generator: Optional[torch.Generator] = None, blocks: int = 1) -> torch.Tensor:
        """x: [N, 3, H, W] normalized images -> [N, output_dim, H/8, W/8];
        blocks: x's rows are that many stacked batches (the dropout draw)."""
        bn_train = train if bn_train is None else bn_train
        x = F.relu(self.norm1(self.conv1(x), bn_train))
        for i in (1, 2, 3):
            x = getattr(self, f"layer{i}_0")(x, bn_train)
            x = getattr(self, f"layer{i}_1")(x, bn_train)
        x = self.conv2(x)
        if train and self.dropout > 0:
            if generator is None:
                raise ValueError("dropout in training needs a generator")
            x = channel_dropout(x, self.dropout, generator, blocks)
        return x


class BasicEncoder(_Encoder):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__(ResidualBlock, (64, 96, 128), 64, output_dim, norm_fn, dropout)


class SmallEncoder(_Encoder):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__(BottleneckBlock, (32, 64, 96), 32, output_dim, norm_fn, dropout)
