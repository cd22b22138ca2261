"""Plain RAFT, standard and small, in plain PyTorch: the benchmark's reference.

Teed & Deng, "RAFT: Recurrent All-Pairs Field Transforms for Optical Flow"
(ECCV 2020, arXiv:2003.12039), as github.com/princeton-vl/RAFT `core/raft.py`
builds it:

  - feature encoder (instance norm) on both frames, context encoder (batch
    norm, running statistics) on frame 1; 1/8 resolution;
  - the all-pairs volume, one product per level against 2x2-pooled fmap2,
    scaled by 1/sqrt(C), four levels;
  - per iteration: a bilinear (2r+1)^2 window of every level around the
    current coordinates (zero outside), the motion encoder, the GRU
    (SepConvGRU for standard, ConvGRU for small), the flow head and, for
    standard, the mask head;
  - convex 8x upsampling (standard) or bilinear align-corners (small).

The model is a function of a flat parameter dict whose names and shapes come
from `param_shapes`, so the benchmark hands one seeded dict to this reference
and to the program under test alike. NHWC at the surface, NCHW inside.

Policies, stated by a configuration:
  - "fp32": every conv and product in full fp32 (TF32 off);
  - "bf16": the mixed policy: encoders, volume product (fp32 sums), update
    block in bf16; fmaps, coordinates, flow and the upsampling in fp32; the
    lookup sums in fp32 and rounds its windows once to bf16.
Controls, one precision step below a policy (operands of every conv and
product rounded, products summed in fp32 as tensor cores do):
  - "tf32": the fp32 policy with TF32 operands (10-bit mantissa, to nearest);
  - "fp8": the bf16 policy with float8 e4m3 operands, each tensor scaled by
    a power of two to e4m3's range.

Imports torch only: nothing of the program, nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

POLICIES = ("fp32", "bf16", "tf32", "fp8")


@dataclasses.dataclass(frozen=True)
class Arch:
    small: bool
    levels: int = 4

    @property
    def radius(self) -> int:
        return 3 if self.small else 4

    @property
    def hidden(self) -> int:
        return 96 if self.small else 128

    @property
    def context(self) -> int:
        return 64 if self.small else 128

    @property
    def fdim(self) -> int:
        return 128 if self.small else 256

    @property
    def corr_channels(self) -> int:
        return self.levels * (2 * self.radius + 1) ** 2


# ----------------------------------------------------------------- parameters


def _conv(name: str, cin: int, cout: int, kh: int, kw: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.weight", (cout, cin, kh, kw), "conv"), (f"{name}.bias", (cout,), "bias")]


def _norm(name: str, kind: str, c: int) -> List[Tuple[str, tuple, str]]:
    if kind != "batch":
        return []
    return [(f"{name}.weight", (c,), "bn_weight"), (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"), (f"{name}.running_var", (c,), "bn_var")]


def _encoder_shapes(prefix: str, small: bool, out: int, norm: str):
    stem, dims = (32, (32, 64, 96)) if small else (64, (64, 96, 128))
    s = _conv(f"{prefix}.conv1", 3, stem, 7, 7) + _norm(f"{prefix}.norm1", norm, stem)
    cin = stem
    for i, (dim, stride) in enumerate(zip(dims, (1, 2, 2)), start=1):
        for j, (c0, st) in enumerate(((cin, stride), (dim, 1))):
            b = f"{prefix}.layer{i}_{j}"
            if small:
                p4 = dim // 4
                s += _conv(f"{b}.conv1", c0, p4, 1, 1) + _norm(f"{b}.norm1", norm, p4)
                s += _conv(f"{b}.conv2", p4, p4, 3, 3) + _norm(f"{b}.norm2", norm, p4)
                s += _conv(f"{b}.conv3", p4, dim, 1, 1) + _norm(f"{b}.norm3", norm, dim)
            else:
                s += _conv(f"{b}.conv1", c0, dim, 3, 3) + _norm(f"{b}.norm1", norm, dim)
                s += _conv(f"{b}.conv2", dim, dim, 3, 3) + _norm(f"{b}.norm2", norm, dim)
            if st != 1:
                s += (_conv(f"{b}.downsample_conv", c0, dim, 1, 1)
                      + _norm(f"{b}.downsample_norm", norm, dim))
        cin = dim
    return s + _conv(f"{prefix}.conv2", cin, out, 1, 1)


def param_shapes(arch: Arch) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and buffer, in a fixed order.
    kind: conv, bias, bn_weight, bn_bias, bn_mean, bn_var; an encoder's conv
    kernels are `enc_conv` (RAFT draws them from kaiming fan-out)."""
    hd, cd = arch.hidden, arch.context
    enc = (_encoder_shapes("fnet", arch.small, arch.fdim, "instance")
           + _encoder_shapes("cnet", arch.small, hd + cd, "none" if arch.small else "batch"))
    enc = [(n, sh, "enc_conv" if k == "conv" else k) for n, sh, k in enc]
    u = "update_block"
    if arch.small:
        upd = (_conv(f"{u}.encoder.convc1", arch.corr_channels, 96, 1, 1)
               + _conv(f"{u}.encoder.convf1", 2, 64, 7, 7)
               + _conv(f"{u}.encoder.convf2", 64, 32, 3, 3)
               + _conv(f"{u}.encoder.conv", 128, 80, 3, 3))
        for g in "zrq":
            upd += _conv(f"{u}.gru.conv{g}", hd + cd + 82, hd, 3, 3)
        upd += _conv(f"{u}.flow_head.conv1", hd, 128, 3, 3)
        upd += _conv(f"{u}.flow_head.conv2", 128, 2, 3, 3)
    else:
        upd = (_conv(f"{u}.encoder.convc1", arch.corr_channels, 256, 1, 1)
               + _conv(f"{u}.encoder.convc2", 256, 192, 3, 3)
               + _conv(f"{u}.encoder.convf1", 2, 128, 7, 7)
               + _conv(f"{u}.encoder.convf2", 128, 64, 3, 3)
               + _conv(f"{u}.encoder.conv", 256, 126, 3, 3))
        for g in "zrq":
            upd += _conv(f"{u}.gru.conv{g}1", hd + cd + 128, hd, 1, 5)
            upd += _conv(f"{u}.gru.conv{g}2", hd + cd + 128, hd, 5, 1)
        upd += _conv(f"{u}.flow_head.conv1", hd, 256, 3, 3)
        upd += _conv(f"{u}.flow_head.conv2", 256, 2, 3, 3)
        upd += _conv(f"{u}.mask_0", hd, 256, 3, 3)
        upd += _conv(f"{u}.mask_2", 256, 64 * 9, 1, 1)
    return enc + upd


# ------------------------------------------------------------ precision steps


class _RoundTF32(torch.autograd.Function):
    """fp32 rounded to TF32's 10-bit mantissa, to nearest even; the gradient
    passes through."""

    @staticmethod
    def forward(ctx, x):
        i = x.contiguous().view(torch.int32)
        lsb = (i >> 13) & 1
        return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 after scaling by a power of two that brings
    its largest magnitude under 448, then scaled back (exact in bf16); the
    gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        if x.numel() == 0:
            return x.clone()
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = torch.exp2(torch.ceil(torch.log2(amax / 448.0)))
        q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Policy:
    """The compute dtype and the operand rounding of one policy."""

    def __init__(self, name: str):
        if name not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {name!r}")
        self.name = name
        self.dtype = torch.bfloat16 if name in ("bf16", "fp8") else torch.float32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return _RoundTF32.apply(x)
        if self.name == "fp8":
            return _RoundFP8.apply(x)
        return x


def full_fp32() -> None:
    """TF32 off for cuBLAS and cuDNN: fp32 products stay fp32 (a control's
    TF32 rounding is explicit, in `Policy.operand`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- the model


class PlainRAFT:
    """forward(params, image1, image2, iters, test_mode) over NHWC frames in
    [0, 255], H and W divisible by 8. test_mode: (flow_low [N, h, w, 2],
    flow_up [N, H, W, 2]); else every iteration's flow_up, [iters, N, H, W, 2]."""

    def __init__(self, arch: Arch, policy: str):
        self.arch = arch
        self.policy = Policy(policy)

    # convs and norms -------------------------------------------------------

    def conv(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, stride=1, pad=0):
        w = p[f"{name}.weight"].to(x.dtype)
        b = p[f"{name}.bias"].to(x.dtype)
        pol = self.policy
        return F.conv2d(pol.operand(x), pol.operand(w), b, stride, pad)

    @staticmethod
    def norm(p, name: str, kind: str, x: torch.Tensor) -> torch.Tensor:
        if kind == "instance":
            x32 = x.float()
            mean = x32.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp((x32 * x32).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
            return (x - mean.to(x.dtype)) * torch.rsqrt(var + 1e-5).to(x.dtype)
        if kind == "batch":
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(p[f"{name}.running_var"] + 1e-5) * p[f"{name}.weight"]
            y = ((x.float() - p[f"{name}.running_mean"].view(shape)) * mul.view(shape)
                 + p[f"{name}.bias"].view(shape))
            return y.to(x.dtype)
        return x

    def encoder(self, p, prefix: str, norm: str, x: torch.Tensor) -> torch.Tensor:
        small = self.arch.small
        x = F.relu(self.norm(p, f"{prefix}.norm1", norm, self.conv(p, f"{prefix}.conv1", x, 2, 3)))
        for i, stride in zip((1, 2, 3), (1, 2, 2)):
            for j, st in ((0, stride), (1, 1)):
                b = f"{prefix}.layer{i}_{j}"
                if small:
                    y = F.relu(self.norm(p, f"{b}.norm1", norm, self.conv(p, f"{b}.conv1", x)))
                    y = F.relu(self.norm(p, f"{b}.norm2", norm,
                                         self.conv(p, f"{b}.conv2", y, st, 1)))
                    y = F.relu(self.norm(p, f"{b}.norm3", norm, self.conv(p, f"{b}.conv3", y)))
                else:
                    y = F.relu(self.norm(p, f"{b}.norm1", norm,
                                         self.conv(p, f"{b}.conv1", x, st, 1)))
                    y = F.relu(self.norm(p, f"{b}.norm2", norm, self.conv(p, f"{b}.conv2", y, 1, 1)))
                if st != 1:
                    x = self.norm(p, f"{b}.downsample_norm", norm,
                                  self.conv(p, f"{b}.downsample_conv", x, st, 0))
                x = F.relu(x + y)
        return self.conv(p, f"{prefix}.conv2", x)

    # volume and lookup -----------------------------------------------------

    def pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
        """[B, Q, Hl, Wl] per level in the compute dtype, from fp32 NHWC fmaps."""
        B, H, W, C = fmap1.shape
        dt = self.policy.dtype
        f1 = self.policy.operand(fmap1.reshape(B, H * W, C).to(dt))
        f2 = fmap2
        out = []
        for lvl in range(self.arch.levels):
            Hl, Wl = f2.shape[1:3]
            f2l = self.policy.operand(f2.reshape(B, Hl * Wl, C).to(dt))
            out.append((torch.matmul(f1, f2l.transpose(1, 2)) * C ** -0.5).reshape(B, H * W, Hl, Wl))
            if lvl + 1 < self.arch.levels:
                h2, w2 = Hl // 2, Wl // 2
                f2 = f2[:, : 2 * h2, : 2 * w2].reshape(B, h2, 2, w2, 2, C).mean(dim=(2, 4))
        return out

    def window(self, corr_l: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
        """Bilinear (2r+1)^2 window of corr_l [B, Q, Hl, Wl] around fp32 centres
        [B, Q]; channel a*(2r+1)+b samples offset (a-r, b-r); fp32 sums."""
        r = self.arch.radius
        B, Q, Hl, Wl = corr_l.shape
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=corr_l.device)
        K = d.numel()
        if Hl == 0 or Wl == 0:  # a level pooled away reads 0
            return torch.zeros(B, Q, K * K, device=corr_l.device)
        px = cx[..., None] + d.repeat_interleave(K)
        py = cy[..., None] + d.repeat(K)
        x0, y0 = torch.floor(px), torch.floor(py)
        wx, wy = px - x0, py - y0
        x0i, y0i = x0.clamp(-2, Wl).long(), y0.clamp(-2, Hl).long()
        flat = corr_l.float().reshape(B, Q, Hl * Wl)

        def tap(xi, yi):
            inb = (xi >= 0) & (xi <= Wl - 1) & (yi >= 0) & (yi <= Hl - 1)
            v = torch.gather(flat, 2, yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1))
            return torch.where(inb, v, torch.zeros((), device=v.device))

        return (tap(x0i, y0i) * (1 - wy) * (1 - wx) + tap(x0i + 1, y0i) * (1 - wy) * wx
                + tap(x0i, y0i + 1) * wy * (1 - wx) + tap(x0i + 1, y0i + 1) * wy * wx)

    def lookup(self, pyramid, coords: torch.Tensor) -> torch.Tensor:
        """[B, L*(2r+1)^2, h, w] in the compute dtype."""
        B, h, w, _ = coords.shape
        cx = coords[..., 0].reshape(B, h * w)
        cy = coords[..., 1].reshape(B, h * w)
        out = [self.window(c, cx * (1.0 / 2**lvl), cy * (1.0 / 2**lvl))
               for lvl, c in enumerate(pyramid)]
        out = torch.cat(out, dim=-1).to(self.policy.dtype)
        return out.reshape(B, h, w, -1).permute(0, 3, 1, 2)

    # update block ----------------------------------------------------------

    def update(self, p, net, inp, corr, flow):
        u = "update_block"
        c = lambda name, x, pad=0: self.conv(p, f"{u}.{name}", x, 1, pad)  # noqa: E731
        if self.arch.small:
            cor = F.relu(c("encoder.convc1", corr))
            flo = F.relu(c("encoder.convf2", F.relu(c("encoder.convf1", flow, 3)), 1))
            mot = torch.cat([F.relu(c("encoder.conv", torch.cat([cor, flo], 1), 1)), flow], 1)
            x = torch.cat([inp, mot], 1)
            hx = torch.cat([net, x], 1)
            z = torch.sigmoid(c("gru.convz", hx, 1))
            r = torch.sigmoid(c("gru.convr", hx, 1))
            q = torch.tanh(c("gru.convq", torch.cat([r * net, x], 1), 1))
            net = (1 - z) * net + z * q
            delta = c("flow_head.conv2", F.relu(c("flow_head.conv1", net, 1)), 1)
            return net, None, delta
        cor = F.relu(c("encoder.convc2", F.relu(c("encoder.convc1", corr)), 1))
        flo = F.relu(c("encoder.convf2", F.relu(c("encoder.convf1", flow, 3)), 1))
        mot = torch.cat([F.relu(c("encoder.conv", torch.cat([cor, flo], 1), 1)), flow], 1)
        x = torch.cat([inp, mot], 1)
        for suffix, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([net, x], 1)
            z = torch.sigmoid(c(f"gru.convz{suffix}", hx, pad))
            r = torch.sigmoid(c(f"gru.convr{suffix}", hx, pad))
            q = torch.tanh(c(f"gru.convq{suffix}", torch.cat([r * net, x], 1), pad))
            net = (1 - z) * net + z * q
        delta = c("flow_head.conv2", F.relu(c("flow_head.conv1", net, 1)), 1)
        mask = 0.25 * c("mask_2", F.relu(c("mask_0", net, 1)))
        return net, mask, delta

    # upsampling ------------------------------------------------------------

    @staticmethod
    def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """flow [N, h, w, 2], mask [N, h, w, 576] -> [N, 8h, 8w, 2] fp32."""
        N, h, w, _ = flow.shape
        m = torch.softmax(mask.float().reshape(N, h, w, 9, 64), dim=3)
        fp = F.pad(8.0 * flow.float(), (0, 0, 1, 1, 1, 1))
        nb = torch.stack([fp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)], 3)
        up = torch.sum(m[..., None] * nb[:, :, :, :, None, :], dim=3)
        return up.reshape(N, h, w, 8, 8, 2).permute(0, 1, 3, 2, 4, 5).reshape(N, 8 * h, 8 * w, 2)

    @staticmethod
    def _axis_align_corners(x: torch.Tensor, out: int, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        # positions i * fl(stop * fl(1 / (out - 1))), the last exactly stop
        inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(out - 1, dtype=torch.float32)
        step = torch.tensor(n - 1.0, dtype=torch.float32) * inv
        pos = torch.arange(out, dtype=torch.float32) * step
        pos[-1] = n - 1.0
        pos = pos.to(x.device)
        i0 = torch.floor(pos).clamp(0, n - 2)
        w = pos - i0
        lo = x.index_select(axis, i0.long())
        hi = x.index_select(axis, i0.long() + 1)
        shape = [1] * x.dim()
        shape[axis] = out
        w = w.reshape(shape).to(x.dtype)
        return lo * (1 - w) + hi * w

    def upflow8(self, flow: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = flow.shape
        up = self._axis_align_corners(flow, 8 * h, 1)
        return 8.0 * self._axis_align_corners(up, 8 * w, 2)

    # forward ---------------------------------------------------------------

    def forward(self, p: Dict[str, torch.Tensor], image1: torch.Tensor, image2: torch.Tensor,
                iters: int, test_mode: bool = True):
        if test_mode:
            with torch.no_grad():
                return self._forward(p, image1, image2, iters, True)
        return self._forward(p, image1, image2, iters, False)

    def _forward(self, p, image1, image2, iters, test_mode):
        arch, dt = self.arch, self.policy.dtype
        if self.policy.name in ("fp32", "tf32"):
            full_fp32()
        N, H, W, _ = image1.shape
        i1 = 2.0 * (image1.float() / 255.0) - 1.0
        i2 = 2.0 * (image2.float() / 255.0) - 1.0
        pair = torch.cat([i1, i2], 0).permute(0, 3, 1, 2).to(dt)
        fmaps = self.encoder(p, "fnet", "instance", pair).float().permute(0, 2, 3, 1)
        pyr = self.pyramid(fmaps[:N], fmaps[N:])
        cnet = self.encoder(p, "cnet", "none" if arch.small else "batch",
                            i1.permute(0, 3, 1, 2).to(dt)).float()
        net, inp = torch.split(cnet, [arch.hidden, arch.context], dim=1)
        net, inp = torch.tanh(net).to(dt), F.relu(inp).to(dt)
        h, w = H // 8, W // 8
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image1.device),
                                torch.arange(w, dtype=torch.float32, device=image1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], -1)[None].expand(N, h, w, 2)
        coords1 = coords0
        preds, mask = [], None
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = self.lookup(pyr, coords1)
            flow = (coords1 - coords0).to(dt).permute(0, 3, 1, 2)
            net, mask, delta = self.update(p, net, inp, corr, flow)
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
            if not test_mode:
                preds.append(self.upsample(coords1 - coords0, mask))
        if not test_mode:
            return torch.stack(preds)
        flow_lo = coords1 - coords0
        return flow_lo, self.upsample(flow_lo, mask)

    def upsample(self, flow_lo, mask):
        if self.arch.small:
            return self.upflow8(flow_lo)
        return self.convex_upsample(flow_lo, mask.float().permute(0, 2, 3, 1))

