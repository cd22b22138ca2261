"""Plain LiteFlowNet3 (the standard variant, no PseudoReg) in plain PyTorch:
the benchmark's reference.

Hui & Loy, "LiteFlowNet3: Resolving Correspondence Ambiguity for More
Accurate Optical Flow Estimation" (ECCV 2020, arXiv:2007.09319). A pyramid
of features of both frames (strides 32, 16, 8, 4; 192, 128, 96, 64
channels) is matched coarse to fine. At level i (0 the coarsest) flows are
in units of div_flow = 20 and a flow f moves a pixel by f * m_i,
m_i = 20 / 2^(5 - i). Each level runs, in order:

  - flow-field deformation (levels 2 and 3): the flow and confidence of the
    level above, 2x transposed convs; a displacement d and a confidence c
    predicted from the dilated self-correlation of f1 (7x7, then 9x9
    offsets at dilation 2) and the upsampled confidence; the flow warped by
    d (flow(p) <- flow(p + d(p)));
  - cost-volume modulation (levels 2 and 3): the 9x9 cost volume V of f1
    against f2 warped by the flow, then alpha * V + beta with the per-pixel,
    per-offset maps alpha and beta predicted from (f1, V, c);
  - matching: a flow residual from the (modulated) cost volume; at level 0
    from f1 against the unwarped f2, at level 1 after a 2x transposed conv
    of the level-0 flow;
  - sub-pixel refinement: a residual from f1, f2 warped by the flow, and
    the flow;
  - feature-driven regularization: the flow averaged over each k x k
    neighbourhood (k 3, 3, 5, 5) with weights softmax(-D^2) over the k^2
    channels of a map D predicted from the warp error of the images, the
    flow less its mean and f1; levels 1 and 2 also predict a confidence.

A cost volume is leaky_relu(sum_c f1[c](p) * f2[c](p + o)) / C over the
offsets o, zero outside the map, channel (dy, dx) y-major. A warp samples
bilinearly at p + flow(p) (zeros outside) and keeps only the positions in
the closed box [0, W-1] x [0, H-1]. The final flow is an 8x8 stride-4
transposed conv of the level-3 flow, times div_flow.

Departures from the paper, all of them the published code's (and the
program's) choices: frames in [0, 1] get the code's mean offsets
(-0.454253, -0.434631, -0.411618) added per channel, then their channel
order reversed; they are resized (bilinear, half-pixel centres) to the
next multiple of 32 and the flow resized back, each component scaled by
its size ratio; every activation is a leaky ReLU of slope 0.1; the
level-3 confidence (the deformation's) is the one returned, resized 4x and
back to the frame's size.

The model is a function of a flat parameter dict whose names and shapes are
`param_shapes()`, the program's `state_dict` names, so one seeded dict
loads into both. NCHW inside; images [B, 2, H, W, 3] in, a dict of
"flows" [B, 1, H, W, 2] and "confs" [B, 1, H, W, 1] (fp32) out.

This file's own mechanisms: the correlation pads f2 and rolls it to each
offset (`torch.roll`; one rolled copy at a time, so the whole batch fits at
full-HD sizes); a warp gathers its four taps with `F.grid_sample`
(nearest, at the taps) and weights them itself, since grid_sample weights
in its input's dtype from coordinates in that dtype, and bf16 positions are
4 px apart at x ~ 1000; the smoothing unfolds the flow (`F.unfold`).

Policies, as `reference/raft.py` states them:
  - "fp32": every conv, transposed conv, product and warp in full fp32
    (TF32 off);
  - "bf16": conv operands bf16 and the bias added after the output's
    rounding; correlation products and sums in fp32, rounded once to bf16;
    flow, confidence and warp coordinates in fp32, the flow's and
    confidence's transposed convs too; every other operation in its
    operands' dtype, as plain PyTorch runs it: a leaky ReLU's slope rounded
    to bf16 (0.10009765625), a bf16 map warped in bf16 (each tap's
    bilinear weight rounded to bf16, the four taps weighted and summed in
    bf16, left to right), the smoothing's weights exp(-D^2) in bf16 with
    the weighted sum of the flow in fp32.
Controls, one precision step below (operands rounded, products summed in
fp32): "tf32" (the fp32 policy with TF32 operands) and "fp8" (the bf16
policy with float8 e4m3 operands of every bf16 conv and every correlation
product, each tensor scaled by a power of two to e4m3's range).

Imports torch only: nothing of the program, nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from flowbench.reference.raft import Policy, full_fp32

FEAT_CH = (192, 128, 96, 64)  # levels 0..3, strides 32..4
LEVELS = len(FEAT_CH)
MOD_FROM = 2  # the first level with deformation and modulation
DIV_FLOW = 20.0
OUTPUT_STRIDE = 32  # frames are resized to multiples of it
MEAN_OFFSETS = (-0.454253, -0.434631, -0.411618)
SLOPE = 0.1
MATCH_PATCH = 9  # matching and modulation: 9 x 9 offsets
SELF_PATCH = (None, None, 7, 9)  # deformation's self-correlation, at dilation 2
SELF_DILATION = 2
HEAD_K = (3, 3, 5, 5)  # flow heads' kernel and the smoothing window, by level
# feature extractor: (name, cin, cout, kernel, stride); its outputs at
# convs_2_2, convs_3_2, convs_4_0 and convs_5_0 are levels 3, 2, 1, 0
EXTRACTOR = (("convs_0_0", 3, 32, 7, 1), ("convs_1_0", 32, 32, 3, 2),
             ("convs_1_2", 32, 32, 3, 1), ("convs_1_4", 32, 32, 3, 1),
             ("convs_2_0", 32, 64, 3, 2), ("convs_2_2", 64, 64, 3, 1),
             ("convs_3_0", 64, 96, 3, 2), ("convs_3_2", 96, 96, 3, 1),
             ("convs_4_0", 96, 128, 3, 2), ("convs_5_0", 128, 192, 3, 2))
PYRAMID_AT = ("convs_5_0", "convs_4_0", "convs_3_2", "convs_2_2")  # levels 0..3


def mult(level: int) -> float:
    return DIV_FLOW / 2 ** (LEVELS - level + 1)


# ----------------------------------------------------------------- parameters


def _conv(name: str, cin: int, cout: int, kh: int, kw: Optional[int] = None):
    kw = kh if kw is None else kw
    return [(f"{name}.weight", (cout, cin, kh, kw), "conv"), (f"{name}.bias", (cout,), "bias")]


def _deconv(name: str, channels: int, k: int):
    """A transposed conv of one channel a group, no bias (weight [in, 1, k, k])."""
    return [(f"{name}.weight", (channels, 1, k, k), "deconv")]


def _chain(prefix: str, name: str, chans, step: int = 2):
    out = []
    for j in range(len(chans) - 1):
        out += _conv(f"{prefix}.{name}_{step * j}", chans[j], chans[j + 1], 3)
    return out


def param_shapes() -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter, the program's state_dict
    order. kind: conv (weight [out, in, kh, kw]), bias, deconv."""
    s = []
    for name, cin, cout, k, _ in EXTRACTOR:
        s += _conv(f"feature_net.{name}", cin, cout, k)
    for i in range(LEVELS):
        c, k = FEAT_CH[i], HEAD_K[i]
        if i >= MOD_FROM:
            d, p = f"deformation_nets_{i - MOD_FROM}", SELF_PATCH[i]
            s += _deconv(f"{d}.up_conf", 1, 4) + _deconv(f"{d}.up_flow", 2, 4)
            s += _chain(d, "feat_net", (p * p + 1, 128, 64, 32))
            s += _conv(f"{d}.disp_pred", 32, 2, k) + _conv(f"{d}.conf_pred_0", 32, 1, k)
            m = f"modulation_nets_{i - MOD_FROM}"
            s += _chain(m, "feat_net", (c + 81 + 1, 128, 64))
            for head in ("mod_scalar_net", "mod_offset_net"):
                s += _conv(f"{m}.{head}_0", 64, 32, 3) + _conv(f"{m}.{head}_2", 32, 81, 1)
        if i == 1:
            s += _deconv(f"matching_nets_{i}.up_flow", 2, 4)
        s += _chain(f"matching_nets_{i}", "flow_net", (81, 128, 128, 96, 64, 32))
        s += _conv(f"matching_nets_{i}.flow_net_10", 32, 2, k)
        s += _chain(f"subpixel_nets_{i}", "feat_net", (2 * c + 2, 128, 128, 96, 64, 32))
        s += _conv(f"subpixel_nets_{i}.flow_net", 32, 2, k)
        r = f"regularization_nets_{i}"
        if i >= 2:
            s += _conv(f"{r}.feat_conv_0", c, 128, 1)
            c = 128
        s += _chain(r, "feat_net", (3 + c, 128, 128, 64, 64, 32, 32))
        if i < 2:
            s += _conv(f"{r}.dist", 32, k * k, 3)
        else:
            s += _conv(f"{r}.dist_0", 32, k * k, k, 1) + _conv(f"{r}.dist_1", k * k, k * k, 1, k)
        if i in (1, 2):
            s += _conv(f"{r}.conf_pred_0", 32, 1, k)
    return s + _deconv("up_flow", 2, 8)


# ----------------------------------------------------------------- the model


class PlainLFN3:
    """forward(params, images) over images [B, 2, H, W, 3] in [0, 1], any H
    and W: {"flows": [B, 1, H, W, 2], "confs": [B, 1, H, W, 1]}, fp32, no
    autograd."""

    def __init__(self, policy: str):
        self.policy = Policy(policy)

    # convs -----------------------------------------------------------------

    def conv(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, stride: int = 1):
        """The conv `name` in the compute dtype, padded to keep the size
        (k // 2 on each side of each axis); the bias after the rounding."""
        w = p[f"{name}.weight"]
        dt, op = self.policy.dtype, self.policy.operand
        kh, kw = w.shape[2:]
        y = F.conv2d(op(x.to(dt)), op(w.to(dt)), None, stride, (kh // 2, kw // 2))
        return y + p[f"{name}.bias"].to(dt)[:, None, None]

    def deconv(self, p, name: str, x: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
        """A transposed conv in x's dtype, one channel a group (the flow's
        and the confidence's upsampling: fp32 under every policy)."""
        w = p[f"{name}.weight"].to(x.dtype)
        if x.dtype == self.policy.dtype:
            x, w = self.policy.operand(x), self.policy.operand(w)
        return F.conv_transpose2d(x, w, None, stride, pad, groups=x.shape[1])

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """leaky ReLU, its slope rounded to x's dtype (0.10009765625 in bf16)."""
        return F.leaky_relu(x, float(torch.tensor(SLOPE, dtype=x.dtype)))

    def chain(self, p, prefix: str, x: torch.Tensor, n: int) -> torch.Tensor:
        for j in range(n):
            x = self.act(self.conv(p, f"{prefix}_{2 * j}", x))
        return x

    # mechanisms ------------------------------------------------------------

    def correlation(self, f1: torch.Tensor, f2: torch.Tensor, patch: int,
                    dilation: int = 1) -> torch.Tensor:
        """leaky_relu(sum_c f1 * f2 shifted) / C, [B, patch^2, H, W] in f1's
        dtype: f2 zero-padded and rolled to each offset, each product and the
        sum over C in fp32, rounded once."""
        B, C, H, W = f1.shape
        op = self.policy.operand
        a = op(f1).float()
        pad = dilation * (patch // 2)
        b = F.pad(op(f2).float(), (pad, pad, pad, pad))
        sums = []
        for i in range(patch):  # rows of offsets: dy = (i - patch // 2) * dilation
            for j in range(patch):
                shifted = torch.roll(b, (-i * dilation, -j * dilation), (2, 3))[:, :, :H, :W]
                sums.append((a * shifted).sum(dim=1))
        return self.act(torch.stack(sums, dim=1).to(f1.dtype)) / C

    @staticmethod
    def warp(x: torch.Tensor, flow: torch.Tensor, scale: float) -> torch.Tensor:
        """x [N, C, H, W] sampled at p + flow(p) * scale (flow [N, 2, H, W]
        fp32, x first), times the closed-box mask. Bilinear in x's dtype: the
        four taps around the position (the left and top ones clamped into
        [0, W-2] x [0, H-2]) gathered by `F.grid_sample` (nearest, at the
        taps), each weighted by the product of the hat weights
        max(0, 1 - |p - tap|) of its two axes, rounded to x's dtype, and
        summed in x's dtype."""
        N, _, H, W = x.shape
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x.device),
                                torch.arange(W, dtype=torch.float32, device=x.device),
                                indexing="ij")
        px = xs + flow[:, 0].float() * scale
        py = ys + flow[:, 1].float() * scale
        x0 = torch.clamp(torch.floor(px), 0.0, W - 2.0)
        y0 = torch.clamp(torch.floor(py), 0.0, H - 2.0)

        def hat(pos, tap):
            return torch.clamp(1.0 - (pos - tap).abs(), min=0.0).to(x.dtype)[:, None]

        def tap(ty, tx):
            grid = torch.stack([tx * (2.0 / (W - 1)) - 1.0, ty * (2.0 / (H - 1)) - 1.0], dim=-1)
            return F.grid_sample(x.float(), grid, mode="nearest", padding_mode="zeros",
                                 align_corners=True).to(x.dtype)

        wy0, wy1, wx0, wx1 = hat(py, y0), hat(py, y0 + 1), hat(px, x0), hat(px, x0 + 1)
        out = (tap(y0, x0) * (wy0 * wx0) + tap(y0, x0 + 1) * (wy0 * wx1)
               + tap(y0 + 1, x0) * (wy1 * wx0) + tap(y0 + 1, x0 + 1) * (wy1 * wx1))
        inside = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        return out * inside[:, None].to(x.dtype)

    @staticmethod
    def smooth(flow: torch.Tensor, dist: torch.Tensor, k: int) -> torch.Tensor:
        """flow [N, 2, H, W] averaged over each k x k neighbourhood (zero
        padded) with the weights softmax(-dist^2) over dist's k^2 channels:
        exp(-dist^2 - max) in dist's dtype, the weighted sum in fp32 over the
        weights' sum."""
        N, _, H, W = flow.shape
        e = -torch.square(dist)
        e = torch.exp(e - e.amax(dim=1, keepdim=True))
        nb = F.unfold(flow, k, padding=k // 2).view(N, 2, k * k, H, W)
        return (nb * e[:, None]).sum(dim=2) / e.sum(dim=1, keepdim=True)

    @staticmethod
    def resize(x: torch.Tensor, hw) -> torch.Tensor:
        return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)

    # levels ----------------------------------------------------------------

    def deformation(self, p, i: int, f1, flow, conf):
        d = f"deformation_nets_{i - MOD_FROM}"
        conf = self.deconv(p, f"{d}.up_conf", conf, 2, 1)
        flow = self.deconv(p, f"{d}.up_flow", flow, 2, 1)
        x = torch.cat([self.correlation(f1, f1, SELF_PATCH[i], SELF_DILATION).float(), conf], 1)
        x = self.chain(p, f"{d}.feat_net", x, 3)
        flow = self.warp(flow, self.conv(p, f"{d}.disp_pred", x), 1.0)
        return flow, torch.sigmoid(self.conv(p, f"{d}.conf_pred_0", x)).float()

    def modulation(self, p, i: int, f1, f2, flow, conf):
        m = f"modulation_nets_{i - MOD_FROM}"
        vol = self.correlation(f1, self.warp(f2, flow, mult(i)), MATCH_PATCH)
        x = self.chain(p, f"{m}.feat_net", torch.cat([f1.float(), vol.float(), conf], 1), 2)
        alpha, beta = (self.conv(p, f"{m}.{head}_2", self.act(self.conv(p, f"{m}.{head}_0", x)))
                       for head in ("mod_scalar_net", "mod_offset_net"))
        return alpha * vol + beta

    def matching(self, p, i: int, f1, f2, flow, vol):
        mn = f"matching_nets_{i}"
        if i == 1:
            flow = self.deconv(p, f"{mn}.up_flow", flow, 2, 1)
        if vol is None:
            vol = self.correlation(f1, f2 if flow is None else self.warp(f2, flow, mult(i)),
                                   MATCH_PATCH)
        res = self.conv(p, f"{mn}.flow_net_10", self.chain(p, f"{mn}.flow_net", vol, 5)).float()
        return res if flow is None else flow + res

    def subpixel(self, p, i: int, f1, f2, flow):
        s = f"subpixel_nets_{i}"
        x = torch.cat([f1.float(), self.warp(f2, flow, mult(i)).float(), flow], 1)
        return flow + self.conv(p, f"{s}.flow_net", self.chain(p, f"{s}.feat_net", x, 5)).float()

    def regularization(self, p, i: int, img1, img2, f1, flow):
        r, k = f"regularization_nets_{i}", HEAD_K[i]
        err = torch.sqrt(torch.sum((img1 - self.warp(img2, flow, mult(i))) ** 2, 1, keepdim=True)
                         + 1e-12)
        feat = self.act(self.conv(p, f"{r}.feat_conv_0", f1)) if i >= 2 else f1
        x = torch.cat([err, flow - flow.mean(dim=(2, 3), keepdim=True), feat.float()], 1)
        x = self.chain(p, f"{r}.feat_net", x, 6)
        if i < 2:
            dist = self.conv(p, f"{r}.dist", x)
        else:
            dist = self.conv(p, f"{r}.dist_1", self.conv(p, f"{r}.dist_0", x))
        conf = torch.sigmoid(self.conv(p, f"{r}.conf_pred_0", x)).float() if i in (1, 2) else None
        return self.smooth(flow, dist, k), conf

    # forward ---------------------------------------------------------------

    def forward(self, p: Dict[str, torch.Tensor], images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.policy.name in ("fp32", "tf32"):
            full_fp32()
        with torch.no_grad():
            return self._forward(p, images)

    def _forward(self, p, images):
        B, _, H, W, _ = images.shape
        th, tw = -(-H // OUTPUT_STRIDE) * OUTPUT_STRIDE, -(-W // OUTPUT_STRIDE) * OUTPUT_STRIDE
        x = (images.float() + torch.tensor(MEAN_OFFSETS, device=images.device)).flip(-1)
        x = x.transpose(0, 1).reshape(2 * B, H, W, 3)  # frame 1s, then frame 2s
        x = self.resize(x.permute(0, 3, 1, 2), (th, tw)).contiguous()
        feats = {}
        y = x
        for name, _, _, _, stride in EXTRACTOR:
            y = self.act(self.conv(p, f"feature_net.{name}", y, stride))
            feats[name] = y
        pyr = [feats[name] for name in PYRAMID_AT]
        flow = conf = None
        for i in range(LEVELS):
            f1, f2 = pyr[i][:B], pyr[i][B:]
            img1, img2 = self.resize(x, f1.shape[2:]).split(B)
            vol = None
            if i >= MOD_FROM:
                flow, conf = self.deformation(p, i, f1, flow, conf)
                vol = self.modulation(p, i, f1, f2, flow, conf)
            flow = self.matching(p, i, f1, f2, flow, vol)
            flow = self.subpixel(p, i, f1, f2, flow)
            flow, level_conf = self.regularization(p, i, img1, img2, f1, flow)
            conf = conf if level_conf is None else level_conf
        flow = self.deconv(p, "up_flow", flow, 4, 2) * DIV_FLOW
        flow = self.resize(flow, (H, W))
        flow = flow * torch.tensor([W / tw, H / th], device=flow.device)[:, None, None]
        conf = self.resize(self.resize(conf, (conf.shape[2] * 4, conf.shape[3] * 4)), (H, W))
        return {"flows": flow.permute(0, 2, 3, 1)[:, None].contiguous(),
                "confs": conf.permute(0, 2, 3, 1)[:, None].contiguous()}
