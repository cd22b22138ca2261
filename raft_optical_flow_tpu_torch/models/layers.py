"""Shared building blocks with the JAX package's semantics.

Counterpart of `raft_optical_flow_tpu/models/layers.py`. Modules run NCHW
inside; the model's public tensors stay NHWC.

Compute-dtype policy: parameters stay fp32 and every conv and norm runs in the
dtype of its input. The model casts its inputs to the compute dtype once
(fp32, or bf16 under the mixed-precision policy), which plays the part of the
JAX package's `compute_dtype_scope`. A conv built with `compute_dtype` casts
its input to that dtype instead, as flax's `nn.Conv(dtype=...)` does:
LiteFlowNet3 concatenates fp32 flow with bf16 features and still runs the
next conv in bf16. Transposed convs (`deconv`) run in their input's dtype,
as the JAX package's `TorchConvTranspose` does.

fp32 parity: the JAX fp32 path runs every contraction at HIGHEST precision,
so the fp32 policy needs TF32 off for both cuBLAS matmuls and cuDNN convs
(`fp32_policy`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.ops.grid import widen

IntPair = Union[int, Sequence[int]]


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW tensor (the ops' public layout)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of an NHWC tensor (the modules' inner layout)."""
    return x.permute(0, 3, 1, 2)


def fp32_policy() -> None:
    """Turn TF32 off for matmuls and convs: the fp32 policy is full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Conv2d(nn.Conv2d):
    """Conv2d with torch-style symmetric padding that runs in its input's dtype,
    or in `compute_dtype` when one is given (fp32 parameters are cast to the
    activation dtype, bias included)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            bias = None if self.bias is None else self.bias.to(x.dtype)
            return F.conv2d(
                x, self.weight.to(x.dtype), bias, self.stride, self.padding,
                self.dilation, self.groups,
            )
        # flax's nn.Conv(dtype=...): the conv's output rounds to the compute
        # dtype, then the bias is added in it (two roundings under bf16)
        x = x.to(self.compute_dtype)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y if self.bias is None else y.add_(self.bias.to(x.dtype)[:, None, None])


def conv(cin: int, cout: int, kernel_size: IntPair = 3, stride: IntPair = 1,
         padding: IntPair = 1, compute_dtype: Optional[torch.dtype] = None) -> Conv2d:
    return Conv2d(cin, cout, kernel_size, stride, padding, compute_dtype=compute_dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d that runs in its input's dtype (the JAX package's
    `TorchConvTranspose`, which casts its kernel to the input's dtype).
    Weight layout (in, out / groups, kh, kw): the flax kernel
    (kh, kw, out / groups, in) under the HWIO -> OIHW transpose of
    `utils/weights.py`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bias is added after the output's rounding to x's dtype, as
        # `TorchConvTranspose` adds it
        y = F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )
        return y if self.bias is None else y.add_(self.bias.to(x.dtype)[:, None, None])


def deconv(cin: int, cout: int, kernel_size: int = 4, stride: int = 2, padding: int = 1,
           bias: bool = True, groups: int = 1) -> ConvTranspose2d:
    """Transposed conv of torch's geometry: out = (H - 1) * stride - 2 * padding + k."""
    return ConvTranspose2d(cin, cout, kernel_size, stride, padding, bias=bias, groups=groups)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """`jax.nn.leaky_relu`: the slope is a weakly typed constant there, so it
    is rounded to x's dtype first (0.1 is 0.10009765625 in bf16)."""
    return F.leaky_relu(x, _rounded(negative_slope, x.dtype))


class PReLU(nn.Module):
    """Per-channel PReLU of NCHW x, `where(x >= 0, x, a * x)` with the slope
    `weight` [C] (init 0.25) cast to x's dtype: the JAX package's IFNet
    PReLU (`models/ifnet.py`, param `scale`). Not `F.prelu`: its gradient
    at x = 0 is the slope, JAX's is 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype)[:, None, None] * x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel spatial normalization of NCHW x; no affine.

    One-pass fp32 stats (float64 for float64 x), E[x^2] - E[x]^2, clamped at
    0; the normalize pass runs in the input dtype (`layers.py::instance_norm`
    of the JAX package).
    """
    x32 = widen(x)
    mean = x32.mean(dim=(2, 3), keepdim=True)
    mean_sq = (x32 * x32).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * inv.to(x.dtype)


def batch_norm_train(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    momentum: float = 0.9,
    eps: float = 1e-5,
) -> torch.Tensor:
    """BatchNorm of NCHW x in training mode, as flax's `nn.BatchNorm(momentum=0.9)`.

    Normalizes with the batch's one-pass fp32 statistics (E[x^2] - E[x]^2,
    biased, clamped at 0; gradients flow through them) and rounds once to the
    input dtype. Updates the running statistics in place with
    `ra = momentum * ra + (1 - momentum) * stat`, the variance BIASED as flax
    keeps it: `F.batch_norm(training=True)` would store the unbiased one.
    """
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    mean_sq = (x32 * x32).mean(dim=(0, 2, 3))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1 - momentum) * var)
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * weight
    y = (x32 - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y.to(x.dtype)


def apply_norm(
    x: torch.Tensor,
    norm_fn: str,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    running_mean: Optional[torch.Tensor] = None,
    running_var: Optional[torch.Tensor] = None,
    num_groups: Optional[int] = None,
    eps: float = 1e-5,
    bn_train: bool = False,
) -> torch.Tensor:
    """Norm of NCHW x for norm_fn in {'group', 'batch', 'instance', 'none'}.

    BatchNorm uses the running statistics unless `bn_train`, which normalizes
    with batch statistics and updates the running ones (`batch_norm_train`).
    Group and batch norms compute in fp32 and round once to the input dtype,
    as flax does.
    """
    if norm_fn == "group":
        y = F.group_norm(x.float(), num_groups, weight, bias, eps)
        return y.to(x.dtype)
    if norm_fn == "batch":
        if bn_train:
            return batch_norm_train(x, weight, bias, running_mean, running_var, eps=eps)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(running_var + eps) * weight
        y = (x.float() - running_mean.view(shape)) * mul.view(shape) + bias.view(shape)
        return y.to(x.dtype)
    if norm_fn == "instance":
        return instance_norm(x, eps)
    if norm_fn == "none":
        return x
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


def channel_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Dropout of whole channels of NCHW x: one keep-mask per sample and channel,
    kept values scaled by 1/(1-rate) (flax `nn.Dropout(broadcast_dims=(1, 2))`
    on NHWC). The mask is drawn on the generator's device from `generator`."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape[0], x.shape[1], 1, 1, generator=generator, device=generator.device)
    mask = (u < keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Norm(nn.Module):
    """Holds the parameters `apply_norm` needs for one norm_fn.

    batch: `weight`, `bias` and the `running_mean`/`running_var` buffers (no
    `num_batches_tracked`: flax keeps none); group: `weight`, `bias`;
    instance, none: nothing. `forward(x, bn_train)`: see `apply_norm`.
    """

    def __init__(self, norm_fn: str, features: int, num_groups: Optional[int] = None):
        super().__init__()
        if norm_fn not in ("group", "batch", "instance", "none"):
            raise ValueError(f"unknown norm_fn {norm_fn!r}")
        self.norm_fn = norm_fn
        self.num_groups = num_groups if num_groups is not None else features // 8
        if norm_fn in ("group", "batch"):
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        if norm_fn == "batch":
            self.register_buffer("running_mean", torch.zeros(features))
            self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, bn_train: bool = False) -> torch.Tensor:
        return apply_norm(
            x, self.norm_fn,
            getattr(self, "weight", None), getattr(self, "bias", None),
            getattr(self, "running_mean", None), getattr(self, "running_var", None),
            self.num_groups, bn_train=bn_train,
        )


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init matching the JAX package's initializers in scale.

    Conv kernels: U(+-1/sqrt(fan_in)) (torch's Conv2d default, the JAX
    package's TORCH_DEFAULT_INIT); transposed-conv kernels
    (in, out/g, kh, kw): U(+-sqrt(3 / (out/g * kh * kw))), the JAX package's
    `TorchConvTranspose` init; conv biases zero; norms identity. Modules
    with `kaiming_out = True` (the RAFT encoders) draw their conv kernels from
    N(0, 2/fan_out) instead, truncated at two standard deviations
    (`KAIMING_OUT_INIT`). The numbers differ from the JAX package's at the same
    seed: tests that compare the two carry weights across instead.
    """
    kaiming = {
        id(m)
        for p in module.modules() if getattr(p, "kaiming_out", False)
        for m in p.modules()
    }
    for m in module.modules():
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            continue
        w = m.weight
        cout, cin_g, kh, kw = w.shape
        with torch.no_grad():
            if isinstance(m, nn.ConvTranspose2d):
                bound = (3.0 / (cin_g * kh * kw)) ** 0.5
                w.copy_((2.0 * torch.rand(w.shape, generator=generator) - 1.0) * bound)
            elif id(m) in kaiming:
                # flax's truncated normal keeps unit variance after truncation
                std = (2.0 / (cout * kh * kw)) ** 0.5 / 0.87962566103423978
                t = torch.randn(w.shape, generator=generator)
                bad = t.abs() > 2.0
                while bad.any():
                    t[bad] = torch.randn(int(bad.sum()), generator=generator)
                    bad = t.abs() > 2.0
                w.copy_(t * std)
            else:
                bound = (cin_g * kh * kw) ** -0.5
                w.copy_((2.0 * torch.rand(w.shape, generator=generator) - 1.0) * bound)
            if m.bias is not None:
                m.bias.zero_()
