"""LiteFlowNet3 (standard, S, and either with PseudoReg).

Counterpart of `raft_optical_flow_tpu/models/liteflownet3.py`: a 4-level
coarse-to-fine estimator, strides 32 -> 4. Each level runs
FlowFieldDeformation and CostVolumeModulation (from `min_mod_level` on: 2
for the standard variant, 1 for S), Matching, SubPixel and Regularization.
Flows inside are divided by div_flow = 20, with the per-level multiplier
20 / 2^(5 - i). The final 4x transposed conv brings the stride-4 flow to
full size; PseudoReg instead adds a 2x refinement stage (PseudoSubpixel,
PseudoRegularization) and a 2x transposed conv.

Spans (`utils/profiling.py::span`): `lfn3.forward` around the call; the
stages, disjoint and covering it, `lfn3.features` (mean offsets, the
rescale, the feature extractor, the image pyramid), `lfn3.deform`,
`lfn3.modulate`, `lfn3.match`, `lfn3.subpixel`, `lfn3.regularize` (each a
module's call at one level, with the casts of its outputs) and
`lfn3.upsample` (PseudoReg, the final transposed conv, the rescale back,
the confidence's resize); inside them the mechanisms `lfn3.corr` (a
correlation, its leaky ReLU and the division by C), `lfn3.warp` and
`lfn3.smooth` (the distance-softmax smoothing).

Modules run NCHW inside; the public tensors are NHWC. The frame pair is
folded into the batch through the feature extractor, frame 1 of every
sample first. Module names mirror the flax names (`feature_net.convs_0_0`,
`deformation_nets_0.feat_net_0`, `regularization_nets_2.dist_0`,
`pseudo_subpixel.flow_net_0`, `up_flow`, ...), so `utils/weights.py` carries
the JAX package's parameters across without a name table.

Policies (`LFN3Config.compute_dtype`): every conv casts its input to the
compute dtype (flax's `nn.Conv(dtype=...)`); the transposed convs run in
their input's dtype, so the `up_flow` and `up_conf` ones stay fp32; flow and
conf are carried fp32 between modules, the correlations sum in fp32 and the
warp coordinates are fp32. fp32 runs with TF32 off (`fp32_policy`).
float64 (frames in float64 too) runs everything in float64, fp32 weights
cast exactly: the CPU yardstick that fp32 gradients are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.models.layers import (
    conv,
    deconv,
    fp32_policy,
    init_weights,
    leaky_relu,
    nchw,
    nhwc,
)
from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear, widen
from raft_optical_flow_tpu_torch.ops.padding import InputScaler
from raft_optical_flow_tpu_torch.ops.spatial_corr import spatial_correlation_sample
from raft_optical_flow_tpu_torch.ops.warp import warp_lfn3
from raft_optical_flow_tpu_torch.utils.profiling import span

BGR_ADD = (-0.454253, -0.434631, -0.411618)  # the reference's mean offsets, BGR order
FEAT_CH = (192, 128, 96, 64)  # feature channels at levels 0..3 (strides 32..4)
NUM_LEVELS = len(FEAT_CH)


@dataclasses.dataclass(frozen=True)
class LFN3Config:
    div_flow: float = 20.0
    use_pseudo_regularization: bool = False
    use_s_version: bool = False
    output_stride: int = 32
    compute_dtype: torch.dtype = torch.float32

    @property
    def min_mod_level(self) -> int:
        return 1 if self.use_s_version else 2

    def mult(self, level: int) -> float:
        return self.div_flow / 2 ** (NUM_LEVELS - level + 1)


def _warp(x: torch.Tensor, flow: torch.Tensor, div_flow: float) -> torch.Tensor:
    """`warp_lfn3` of NCHW x by NCHW flow."""
    with span("lfn3.warp"):
        return nchw(warp_lfn3(nhwc(x), nhwc(flow), div_flow))


def _corr(f1: torch.Tensor, f2: torch.Tensor, patch: int, dilation: int = 1) -> torch.Tensor:
    """leaky_relu of the NCHW correlation, divided by the channel count."""
    with span("lfn3.corr"):
        c = spatial_correlation_sample(nhwc(f1), nhwc(f2), patch, dilation)
        return nchw(leaky_relu(c)) / f1.shape[1]


def _unfold_neighbors(x: torch.Tensor, k: int) -> torch.Tensor:
    """All k x k neighbourhoods of NCHW x, zero padded: [N, C, k*k, H, W],
    entry ky*k + kx at offset (ky - k//2, kx - k//2) (`nn.Unfold` order)."""
    N, C, H, W = x.shape
    return F.unfold(x, k, padding=k // 2).view(N, C, k * k, H, W)


def _distance_smooth(flow: torch.Tensor, dist: torch.Tensor, k: int) -> torch.Tensor:
    """The flow averaged over each k x k neighbourhood with the weights
    softmax(-dist^2) over the k*k channels of dist [N, k*k, H, W]."""
    with span("lfn3.smooth"):
        dist = -torch.square(dist)
        dist = torch.exp(dist - dist.amax(dim=1, keepdim=True))
        div = dist.sum(dim=1, keepdim=True)
        return (_unfold_neighbors(flow, k) * dist[:, None]).sum(dim=2) / div


class FeatureExtractor(nn.Module):
    """Six-stage pyramid encoder; returns the stride 32, 16, 8, 4 features."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        spec = (("convs_0_0", 3, 32, 7, 1, 3), ("convs_1_0", 32, 32, 3, 2, 1),
                ("convs_1_2", 32, 32, 3, 1, 1), ("convs_1_4", 32, 32, 3, 1, 1),
                ("convs_2_0", 32, 64, 3, 2, 1), ("convs_2_2", 64, 64, 3, 1, 1),
                ("convs_3_0", 64, 96, 3, 2, 1), ("convs_3_2", 96, 96, 3, 1, 1),
                ("convs_4_0", 96, 128, 3, 2, 1), ("convs_5_0", 128, 192, 3, 2, 1))
        for name, cin, cout, k, s, p in spec:
            setattr(self, name, conv(cin, cout, k, s, p, compute_dtype=dtype))

    def forward(self, x: torch.Tensor):
        feats = []
        for name in ("convs_0_0", "convs_1_0", "convs_1_2", "convs_1_4", "convs_2_0",
                     "convs_2_2", "convs_3_0", "convs_3_2", "convs_4_0", "convs_5_0"):
            x = leaky_relu(getattr(self, name)(x))
            if name in ("convs_2_2", "convs_3_2", "convs_4_0", "convs_5_0"):
                feats.append(x)
        return feats[::-1]  # coarse -> fine


class FlowFieldDeformation(nn.Module):
    """Upsamples the flow and conf of the level below and warps the flow by
    a displacement predicted from the dilated self-correlation of f1."""

    def __init__(self, level: int, dtype: torch.dtype):
        super().__init__()
        self.patch = (None, 5, 7, 9)[level]
        k = (None, 3, 5, 5)[level]
        self.up_conf = deconv(1, 1, 4, 2, 1, bias=False)
        self.up_flow = deconv(2, 2, 4, 2, 1, bias=False, groups=2)
        self.feat_net_0 = conv(self.patch ** 2 + 1, 128, 3, 1, 1, compute_dtype=dtype)
        self.feat_net_2 = conv(128, 64, 3, 1, 1, compute_dtype=dtype)
        self.feat_net_4 = conv(64, 32, 3, 1, 1, compute_dtype=dtype)
        self.disp_pred = conv(32, 2, k, 1, k // 2, compute_dtype=dtype)
        self.conf_pred_0 = conv(32, 1, k, 1, k // 2, compute_dtype=dtype)

    def forward(self, f1, flow, conf):
        conf = self.up_conf(conf)
        flow = self.up_flow(flow)
        self_corr = _corr(f1, f1, self.patch, dilation=2)
        x = torch.cat([self_corr.to(conf.dtype), conf], dim=1)
        x = leaky_relu(self.feat_net_0(x))
        x = leaky_relu(self.feat_net_2(x))
        x = leaky_relu(self.feat_net_4(x))
        flow = _warp(flow, self.disp_pred(x), 1.0)
        return flow, torch.sigmoid(self.conf_pred_0(x))


class CostVolumeModulation(nn.Module):
    """The 9x9 cost volume of f1 against the warped f2, scaled and offset by
    maps predicted from it."""

    def __init__(self, level: int, cfg: LFN3Config):
        super().__init__()
        dt = cfg.compute_dtype
        self.mult = cfg.mult(level)
        self.feat_net_0 = conv(FEAT_CH[level] + 81 + 1, 128, 3, 1, 1, compute_dtype=dt)
        self.feat_net_2 = conv(128, 64, 3, 1, 1, compute_dtype=dt)
        self.mod_scalar_net_0 = conv(64, 32, 3, 1, 1, compute_dtype=dt)
        self.mod_scalar_net_2 = conv(32, 81, 1, 1, 0, compute_dtype=dt)
        self.mod_offset_net_0 = conv(64, 32, 3, 1, 1, compute_dtype=dt)
        self.mod_offset_net_2 = conv(32, 81, 1, 1, 0, compute_dtype=dt)

    def forward(self, f1, f2, flow, conf):
        corr = _corr(f1, _warp(f2, flow, 1.0 / self.mult), 9)
        x = torch.cat([f1.to(conf.dtype), corr.to(conf.dtype), conf], dim=1)
        x = leaky_relu(self.feat_net_0(x))
        x = leaky_relu(self.feat_net_2(x))
        scalar = self.mod_scalar_net_2(leaky_relu(self.mod_scalar_net_0(x)))
        offset = self.mod_offset_net_2(leaky_relu(self.mod_offset_net_0(x)))
        return scalar * corr + offset


class Matching(nn.Module):
    """Cost volume -> flow residual; at level 1 of the standard variant it
    first upsamples the flow of level 0 (S has a deformation stage there)."""

    def __init__(self, level: int, cfg: LFN3Config):
        super().__init__()
        dt = cfg.compute_dtype
        k = (3, 3, 5, 5)[level]
        self.mult = cfg.mult(level)
        if level == 1 and not cfg.use_s_version:
            self.up_flow = deconv(2, 2, 4, 2, 1, bias=False, groups=2)
        chans = (81, 128, 128, 96, 64, 32)
        for j in range(5):
            setattr(self, f"flow_net_{2 * j}", conv(chans[j], chans[j + 1], 3, 1, 1, compute_dtype=dt))
        self.flow_net_10 = conv(32, 2, k, 1, k // 2, compute_dtype=dt)

    def forward(self, f1, f2, flow, corr):
        if hasattr(self, "up_flow"):
            flow = self.up_flow(flow)
        if corr is None:
            corr = _corr(f1, f2 if flow is None else _warp(f2, flow, 1.0 / self.mult), 9)
        x = corr
        for j in range(5):
            x = leaky_relu(getattr(self, f"flow_net_{2 * j}")(x))
        new_flow = self.flow_net_10(x)
        return new_flow if flow is None else flow + new_flow


class SubPixel(nn.Module):
    """Refines the flow from f1, the warped f2 and the flow itself; also
    returns its last features (PseudoSubpixel's input)."""

    def __init__(self, level: int, cfg: LFN3Config):
        super().__init__()
        dt = cfg.compute_dtype
        k = (3, 3, 5, 5)[level]
        self.mult = cfg.mult(level)
        chans = (2 * FEAT_CH[level] + 2, 128, 128, 96, 64, 32)
        for j in range(5):
            setattr(self, f"feat_net_{2 * j}", conv(chans[j], chans[j + 1], 3, 1, 1, compute_dtype=dt))
        self.flow_net = conv(32, 2, k, 1, k // 2, compute_dtype=dt)

    def forward(self, f1, f2, flow):
        warped2 = _warp(f2, flow, 1.0 / self.mult)
        x = torch.cat([f1.to(flow.dtype), warped2.to(flow.dtype), flow], dim=1)
        for j in range(5):
            x = leaky_relu(getattr(self, f"feat_net_{2 * j}")(x))
        return flow + self.flow_net(x), x


class Regularization(nn.Module):
    """Smooths the flow over k x k neighbourhoods with weights from a
    distance softmax predicted from the warp error, the flow and f1; also
    returns a conf map where the JAX package has one, and its last features
    (PseudoRegularization's input)."""

    def __init__(self, level: int, cfg: LFN3Config):
        super().__init__()
        dt = cfg.compute_dtype
        self.level = level
        self.k = k = (3, 3, 5, 5)[level]
        conf_k = (3, 3, 5, None)[level]
        self.mult = cfg.mult(level)
        feat_ch = FEAT_CH[level]
        if level >= 2:
            self.feat_conv_0 = conv(feat_ch, 128, 1, 1, 0, compute_dtype=dt)
            feat_ch = 128
        chans = (3 + feat_ch, 128, 128, 64, 64, 32, 32)
        for j in range(6):
            setattr(self, f"feat_net_{2 * j}", conv(chans[j], chans[j + 1], 3, 1, 1, compute_dtype=dt))
        if level < 2:
            self.dist = conv(32, k * k, 3, 1, 1, compute_dtype=dt)
        else:
            self.dist_0 = conv(32, k * k, (k, 1), 1, (k // 2, 0), compute_dtype=dt)
            self.dist_1 = conv(k * k, k * k, (1, k), 1, (0, k // 2), compute_dtype=dt)
        if not ((level == 0 and not cfg.use_s_version) or level == 3):
            self.conf_pred_0 = conv(32, 1, conf_k, 1, conf_k // 2, compute_dtype=dt)

    def forward(self, img1, img2, f1, flow):
        img2_warped = _warp(img2, flow, 1.0 / self.mult)
        # +1e-12 keeps sqrt's gradient finite where the warp error is 0
        diff = torch.sqrt(torch.sum((img1 - img2_warped) ** 2, dim=1, keepdim=True) + 1e-12)
        flow_nomean = flow - flow.mean(dim=(2, 3), keepdim=True)
        feat = leaky_relu(self.feat_conv_0(f1)) if self.level >= 2 else f1
        x = torch.cat([diff, flow_nomean, feat.to(flow.dtype)], dim=1)
        for j in range(6):
            x = leaky_relu(getattr(self, f"feat_net_{2 * j}")(x))
        dist = self.dist(x) if self.level < 2 else self.dist_1(self.dist_0(x))
        flow = _distance_smooth(flow, dist, self.k)
        conf = torch.sigmoid(self.conf_pred_0(x)) if hasattr(self, "conf_pred_0") else None
        return flow, conf, x


class PseudoSubpixel(nn.Module):
    """2x flow upsample plus a residual from SubPixel's last features."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.up_flow = deconv(2, 2, 4, 2, 1, bias=False, groups=2)
        self.flow_net_0 = deconv(32, 32, 4, 2, 1)
        self.flow_net_1 = conv(32, 2, 7, 1, 3, compute_dtype=dtype)

    def forward(self, sub_feat, flow):
        return self.up_flow(flow) + self.flow_net_1(self.flow_net_0(sub_feat))


class PseudoRegularization(nn.Module):
    """Distance-softmax smoothing (7x7, separable weights) at twice the
    finest level's resolution."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.feat_net_0 = deconv(32, 32, 4, 2, 1)
        self.feat_net_1 = conv(32, 49, (7, 1), 1, (3, 0), compute_dtype=dtype)
        self.feat_net_2 = conv(49, 49, (1, 7), 1, (0, 3), compute_dtype=dtype)

    def forward(self, reg_feat, flow):
        dist = self.feat_net_2(self.feat_net_1(self.feat_net_0(reg_feat)))
        return _distance_smooth(flow, dist, 7)


class LiteFlowNet3(nn.Module):
    """LiteFlowNet3 flow estimator.

    forward(images, training=False): images [B, 2, H, W, 3] in [0, 1], any
    H and W (rescaled inside to multiples of 32 and back). Returns a dict of
    fp32 NHWC tensors: "flows" [B, 1, H, W, 2] and "confs" [B, 1, H, W, 1];
    with `training=True` also "flow_preds" (each level's flow, coarse to
    fine, [B, h, w, 2] in units of div_flow) and "conf_preds" ([B, h, w, 1],
    in the order they are made). `training=False` runs without autograd.
    """

    def __init__(self, config: LFN3Config = LFN3Config(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"compute_dtype must be float32, bfloat16 or float64, "
                             f"got {config.compute_dtype}")
        self.config = cfg = config
        dt = cfg.compute_dtype
        self.feature_net = FeatureExtractor(dt)
        for i in range(NUM_LEVELS):
            if i >= cfg.min_mod_level:
                j = i - cfg.min_mod_level
                setattr(self, f"deformation_nets_{j}", FlowFieldDeformation(i, dt))
                setattr(self, f"modulation_nets_{j}", CostVolumeModulation(i, cfg))
            setattr(self, f"matching_nets_{i}", Matching(i, cfg))
            setattr(self, f"subpixel_nets_{i}", SubPixel(i, cfg))
            setattr(self, f"regularization_nets_{i}", Regularization(i, cfg))
        if cfg.use_pseudo_regularization:
            self.pseudo_subpixel = PseudoSubpixel(dt)
            self.pseudo_regularization = PseudoRegularization(dt)
            self.up_flow = deconv(2, 2, 4, 2, 1, bias=False, groups=2)
        else:
            self.up_flow = deconv(2, 2, 8, 4, 2, bias=False, groups=2)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def forward(self, images: torch.Tensor, training: bool = False):
        if self.config.compute_dtype == torch.float32:
            fp32_policy()
        with span("lfn3.forward"):
            if training:
                return self._forward(images, True)
            with torch.no_grad():
                return self._forward(images, False)

    def _forward(self, images: torch.Tensor, training: bool):
        cfg = self.config
        B, _, H, W, _ = images.shape
        with span("lfn3.features"):
            x = (images + torch.tensor(BGR_ADD, dtype=images.dtype, device=images.device)).flip(-1)
            scaler = InputScaler(images.shape, stride=cfg.output_stride)
            # frame 1 of every sample, then frame 2 of every sample
            x = scaler.fill(x.transpose(0, 1).reshape(2 * B, H, W, 3))
            # a copy to NCHW, also when traced: the card's upsample returns
            # channels-last, but its fake version (what torch.export traces)
            # says NCHW, so a `.contiguous()` would leave the exported program
            # and its convs running channels-last (one-ulp drift from eager)
            x = nchw(x).clone(memory_format=torch.contiguous_format)
            feats = [(f[:B], f[B:]) for f in self.feature_net(x)]
            images_pyr = [nchw(resize_bilinear(nhwc(x), f1.shape[2:])).split(B)
                          for f1, _ in feats]

        flow_preds, conf_preds = [], []
        flow = conf = corr = sub_feat = reg_feat = None
        for i in range(NUM_LEVELS):
            f1, f2 = feats[i]
            if i >= cfg.min_mod_level:
                j = i - cfg.min_mod_level
                with span("lfn3.deform"):
                    flow, conf = getattr(self, f"deformation_nets_{j}")(f1, flow, conf)
                    flow, conf = widen(flow), widen(conf)
                conf_preds.append(conf)
                with span("lfn3.modulate"):
                    corr = getattr(self, f"modulation_nets_{j}")(f1, f2, flow, conf)
            with span("lfn3.match"):
                flow = widen(getattr(self, f"matching_nets_{i}")(f1, f2, flow, corr))
            with span("lfn3.subpixel"):
                flow, sub_feat = getattr(self, f"subpixel_nets_{i}")(f1, f2, flow)
            with span("lfn3.regularize"):
                flow, conf, reg_feat = getattr(self, f"regularization_nets_{i}")(
                    *images_pyr[i], f1, flow)
                flow = widen(flow)
                if conf is not None:
                    conf = widen(conf)
            flow_preds.append(flow)
            if conf is not None:
                conf_preds.append(conf)
            corr = None

        with span("lfn3.upsample"):
            if cfg.use_pseudo_regularization:
                flow = self.pseudo_subpixel(sub_feat, flow)
                flow = self.pseudo_regularization(reg_feat, flow)
            flow = self.up_flow(flow) * cfg.div_flow
            flow = scaler.unfill(nhwc(flow), is_flow=True)
            conf_last = nhwc(conf_preds[-1])
            conf_full = resize_bilinear(conf_last,
                                        (conf_last.shape[1] * 4, conf_last.shape[2] * 4))
            out = {"flows": flow[:, None], "confs": scaler.unfill(conf_full)[:, None]}
        if training:
            out["flow_preds"] = [nhwc(f) for f in flow_preds]
            out["conf_preds"] = [nhwc(c) for c in conf_preds]
        return out

def liteflownet3(device="cuda", generator=None, **kw) -> LiteFlowNet3:
    return LiteFlowNet3(LFN3Config(**kw), device, generator)


def liteflownet3_pseudoreg(device="cuda", generator=None, **kw) -> LiteFlowNet3:
    return LiteFlowNet3(LFN3Config(use_pseudo_regularization=True, **kw), device, generator)


def liteflownet3s(device="cuda", generator=None, **kw) -> LiteFlowNet3:
    return LiteFlowNet3(LFN3Config(use_s_version=True, **kw), device, generator)


def liteflownet3s_pseudoreg(device="cuda", generator=None, **kw) -> LiteFlowNet3:
    return LiteFlowNet3(
        LFN3Config(use_s_version=True, use_pseudo_regularization=True, **kw), device, generator)
