"""SimpleFlowNet: a small three-scale coarse-to-fine flow network.

Counterpart of `raft_optical_flow_tpu/models/simple_flow.py`:
  - SFFeatureExtractor: a 7x7 stride-2 conv, BatchNorm and ReLU, then five
    BatchNorm residual blocks; features at 1/2 (32 channels), 1/4 (64) and
    1/8 (128).
  - `correlation_layer`: the 9x9 shifted correlation of the L2-normalised
    features, channel k = (dy + r)(2r + 1) + (dx + r) holding
    <f1(x), f2(x - (dx, dy))>, zero where the shift leaves the map.
  - SFFlowDecoder: [correlation (81) + previous flow (2)] -> 128 -> 64 ->
    32 -> 2, a zero flow at the coarsest scale.
  - coarse to fine: the previous flow upsampled (half-pixel) and scaled per
    axis, feature 2 warped by it x20 (zeros outside), the decoder's residual
    added; every flow returned x20, coarsest first [1/8, 1/4, 1/2].

Modules run NCHW inside; the public tensors are NHWC. Module names mirror
the flax names (`feature_extractor.res_block2.shortcut_1`,
`flow_decoder.flow_conv`, ...), so `utils/weights.py` carries the JAX
package's params and batch_stats across without a name table.

Policies (`SimpleFlowConfig.compute_dtype`): every conv casts its input to
the compute dtype (flax's `nn.Conv(dtype=...)`) and the BatchNorms run in
their input's dtype with fp32 statistics; the correlation normalises and
sums in fp32 and rounds once to the feature dtype; the flow is carried fp32
across scales and the warp coordinates are fp32. fp32 runs with TF32 off
(`fp32_policy`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.models.layers import (
    Norm,
    conv,
    fp32_policy,
    init_weights,
    nchw,
    nhwc,
)
from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear
from raft_optical_flow_tpu_torch.ops.spatial_corr import spatial_correlation_sample
from raft_optical_flow_tpu_torch.ops.warp import backward_warp


@dataclasses.dataclass(frozen=True)
class SimpleFlowConfig:
    input_channels: int = 3
    feature_dim: int = 64
    max_displacement: int = 4
    flow_scale: float = 20.0
    compute_dtype: torch.dtype = torch.float32


class SFResidualBlock(nn.Module):
    """BatchNorm residual block; a 1x1 conv and BatchNorm on the shortcut
    where the stride or the width changes."""

    def __init__(self, cin: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = conv(cin, features, 3, stride, 1, compute_dtype=dtype)
        self.bn1 = Norm("batch", features)
        self.conv2 = conv(features, features, 3, 1, 1, compute_dtype=dtype)
        self.bn2 = Norm("batch", features)
        if stride != 1 or cin != features:
            self.shortcut_0 = conv(cin, features, 1, stride, 0, compute_dtype=dtype)
            self.shortcut_1 = Norm("batch", features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if hasattr(self, "shortcut_0"):
            x = self.shortcut_1(self.shortcut_0(x), train)
        return F.relu(x + y)


class SFFeatureExtractor(nn.Module):
    """Returns the 1/2, 1/4 and 1/8 features (d/2, d, 2d channels)."""

    def __init__(self, cin: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.conv1_0 = conv(cin, d // 2, 7, 2, 3, compute_dtype=dtype)
        self.conv1_1 = Norm("batch", d // 2)
        self.res_block1 = SFResidualBlock(d // 2, d // 2, 1, dtype)
        self.res_block2 = SFResidualBlock(d // 2, d, 2, dtype)
        self.res_block3 = SFResidualBlock(d, d, 1, dtype)
        self.res_block4 = SFResidualBlock(d, 2 * d, 2, dtype)
        self.res_block5 = SFResidualBlock(2 * d, 2 * d, 1, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        x = F.relu(self.conv1_1(self.conv1_0(x), train))
        x = self.res_block1(x, train)
        feats = [x]
        x = self.res_block3(self.res_block2(x, train), train)
        feats.append(x)
        x = self.res_block5(self.res_block4(x, train), train)
        feats.append(x)
        return feats


def _l2_normalize(f: torch.Tensor) -> torch.Tensor:
    """f / |f| over the last axis in fp32, rounded to f's dtype. The clamp
    sits inside the sqrt, as in the JAX package: an all-zero vector (they
    occur after a ReLU at random init) gets a zero gradient, where
    `F.normalize` would give it another."""
    f32 = f.float()
    sumsq = torch.sum(f32 * f32, dim=-1, keepdim=True)
    return (f32 / torch.sqrt(torch.clamp(sumsq, min=1e-24))).to(f.dtype)


def correlation_layer(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4) -> torch.Tensor:
    """9x9 (for r = 4) shifted correlation of the L2-normalised features.

    f1, f2: [B, H, W, C]. Returns [B, H, W, (2r+1)^2] in f1's dtype, channel
    k = (dy + r)(2r + 1) + (dx + r) holding <f1(x), f2(x - (dx, dy))>, zero
    where the shift leaves the map. `spatial_correlation_sample` puts
    <f1(x), f2(x + d)> at the same k, so its channels run reversed here.
    """
    f1n, f2n = _l2_normalize(f1), _l2_normalize(f2)
    corr = spatial_correlation_sample(f1n, f2n, 2 * max_displacement + 1)
    return corr.flip(-1)


class SFFlowDecoder(nn.Module):
    """[correlation + previous flow] -> flow residual; a zero flow joins the
    coarsest scale's correlation."""

    def __init__(self, corr_ch: int, dtype: torch.dtype):
        super().__init__()
        self.corr_ch = corr_ch
        self.conv1_0 = conv(corr_ch + 2, 128, 3, 1, 1, compute_dtype=dtype)
        self.conv2_0 = conv(128, 64, 3, 1, 1, compute_dtype=dtype)
        self.conv3_0 = conv(64, 32, 3, 1, 1, compute_dtype=dtype)
        self.flow_conv = conv(32, 2, 3, 1, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == self.corr_ch:
            x = torch.cat([x, x.new_zeros(x.shape[0], 2, *x.shape[2:])], dim=1)
        x = F.relu(self.conv1_0(x))
        x = F.relu(self.conv2_0(x))
        x = F.relu(self.conv3_0(x))
        return self.flow_conv(x)


class SimpleFlowNet(nn.Module):
    """Three-scale coarse-to-fine flow estimator.

    forward(img1, img2, train=False): images [B, H, W, C] (the JAX trainers
    pass them in [0, 1]). Returns the list of fp32 flows [B, h_i, w_i, 2],
    x flow_scale, coarsest first (1/8, 1/4, 1/2). `train=True` normalises
    with batch statistics and updates the BatchNorms' running statistics in
    place (each frame's features once, frame 1 first: flax's mutable
    `batch_stats`); `train=False` runs without autograd.
    """

    def __init__(self, config: SimpleFlowConfig = SimpleFlowConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {config.compute_dtype}")
        self.config = cfg = config
        dt = cfg.compute_dtype
        self.feature_extractor = SFFeatureExtractor(cfg.input_channels, cfg.feature_dim, dt)
        self.flow_decoder = SFFlowDecoder((2 * cfg.max_displacement + 1) ** 2, dt)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def forward(self, img1: torch.Tensor, img2: torch.Tensor, train: bool = False):
        if self.config.compute_dtype == torch.float32:
            fp32_policy()
        if train:
            return self._forward(img1, img2, True)
        with torch.no_grad():
            return self._forward(img1, img2, False)

    def _forward(self, img1, img2, train: bool):
        cfg = self.config
        feats1 = self.feature_extractor(nchw(img1).contiguous(), train)
        feats2 = self.feature_extractor(nchw(img2).contiguous(), train)
        preds = []
        prev_flow = None  # NCHW fp32, in units of flow_scale
        for f1, f2 in zip(feats1[::-1], feats2[::-1]):
            if prev_flow is None:
                corr = correlation_layer(nhwc(f1), nhwc(f2), cfg.max_displacement)
                x = nchw(corr)
            else:
                (h, w), (ph, pw) = f1.shape[2:], prev_flow.shape[2:]
                scale = torch.tensor([w / pw, h / ph], dtype=torch.float32, device=f1.device)
                prev_flow = nchw(resize_bilinear(nhwc(prev_flow), (h, w)) * scale)
                f2w = backward_warp(nhwc(f2), nhwc(prev_flow * cfg.flow_scale), padding="zeros")
                corr = correlation_layer(nhwc(f1), f2w, cfg.max_displacement)
                # the concat promotes to fp32 (as jnp.concatenate does); the
                # decoder's first conv casts back to the compute dtype
                x = torch.cat([nchw(corr).float(), prev_flow], dim=1)
            flow = self.flow_decoder(x).float()
            if prev_flow is not None:
                flow = flow + prev_flow
            preds.append(flow)
            prev_flow = flow
        return [nhwc(f * cfg.flow_scale) for f in preds]


def simple_flow_net(device="cuda", generator=None, **kw) -> SimpleFlowNet:
    return SimpleFlowNet(SimpleFlowConfig(**kw), device, generator)
