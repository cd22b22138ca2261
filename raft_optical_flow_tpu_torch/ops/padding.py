"""Input padding and rescaling to stride-divisible sizes.

Counterpart of `raft_optical_flow_tpu/ops/padding.py`: `InputPadder`
(RAFT's modes: 'sintel' centres the pad, 'kitti' pads the bottom only and
centres the width; LiteFlowNet3's options: any stride, replicate or
constant padding, one- or two-sided, a fixed target size) and
`InputScaler` (LiteFlowNet3's half-pixel bilinear rescale to a multiple of
the stride and back). NHWC tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear


class InputPadder:
    """Pads NHWC images so H and W are divisible by `stride`, or up to
    `fixed_size` (H, W) when given.

    `mode` 'kitti' pads the bottom only and centres the width; otherwise
    `two_side_pad` centres both pads (the odd pixel at the bottom and
    right), and without it the pads go bottom and right. `pad_mode`
    'replicate' repeats the edge pixels (`jnp.pad(mode="edge")`), 'constant'
    fills with `pad_value`.
    """

    def __init__(self, dims, mode: str = "sintel", stride: int = 8,
                 pad_mode: str = "replicate", pad_value: float = 0.0,
                 two_side_pad: bool = True, fixed_size=None):
        if pad_mode not in ("replicate", "constant"):
            raise ValueError(f"pad_mode must be 'replicate' or 'constant', got {pad_mode!r}")
        # dims: shape tuple [..., H, W, C]
        self.ht, self.wd = dims[-3], dims[-2]
        if fixed_size is not None:
            pad_ht = max(fixed_size[0] - self.ht, 0)
            pad_wd = max(fixed_size[1] - self.wd, 0)
        else:
            pad_ht = (((self.ht // stride) + 1) * stride - self.ht) % stride
            pad_wd = (((self.wd // stride) + 1) * stride - self.wd) % stride
        if mode == "kitti":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)
        elif two_side_pad:
            # (left, right, top, bottom)
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (0, pad_wd, 0, pad_ht)
        self._pad_mode = pad_mode
        self._pad_value = pad_value

    def _pad_one(self, x: torch.Tensor) -> torch.Tensor:
        # F.pad's widths run from the last dim: C by none, W by (l, r), H by
        # (t, b), straight on NHWC, so a contiguous input is read in place
        # and the output is contiguous NHWC (the models' convs then run
        # channels-last, faster in bf16: PERF.md). Replicate padding of
        # the last three dims needs a 5-D input: a leading 1.
        widths = (0, 0) + self._pad
        if self._pad_mode == "constant":
            return F.pad(x, widths, mode="constant", value=self._pad_value)
        return F.pad(x[None], widths, mode="replicate")[0]

    def pad(self, *inputs):
        out = [self._pad_one(x) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t : ht - b, l : wd - r, :]


class InputScaler:
    """Rescales NHWC inputs to the next multiple of `stride` (ceil) with the
    half-pixel bilinear resize, and back. `unfill` on a flow field also
    scales its values by the size ratio (x by the widths, y by the heights).
    `interpolation_align_corners` is accepted and ignored, as in the JAX
    package."""

    def __init__(self, dims, stride: int = 32, interpolation_align_corners: bool = False):
        self.orig_ht, self.orig_wd = dims[-3], dims[-2]
        self.tgt_ht = -(-self.orig_ht // stride) * stride
        self.tgt_wd = -(-self.orig_wd // stride) * stride

    def fill(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, (self.tgt_ht, self.tgt_wd))

    def unfill(self, x: torch.Tensor, is_flow: bool = False) -> torch.Tensor:
        out = resize_bilinear(x, (self.orig_ht, self.orig_wd))
        if is_flow:
            scale = torch.tensor([self.orig_wd / self.tgt_wd, self.orig_ht / self.tgt_ht],
                                 dtype=out.dtype, device=out.device)
            out = out * scale
        return out
