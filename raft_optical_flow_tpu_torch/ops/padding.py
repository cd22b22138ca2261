"""Input padding and rescaling to stride-divisible sizes.

Counterpart of `raft_optical_flow_tpu/ops/padding.py`: `InputPadder` in its
RAFT modes (replicate padding; 'sintel' centres the pad, 'kitti' pads the
bottom only and centres the width) and `InputScaler` (LiteFlowNet3's
half-pixel bilinear rescale to a multiple of the stride and back). NHWC
tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear


class InputPadder:
    """Pads NHWC images so H and W are divisible by `stride`."""

    def __init__(self, dims, mode: str = "sintel", stride: int = 8):
        # dims: shape tuple [..., H, W, C]
        self.ht, self.wd = dims[-3], dims[-2]
        pad_ht = (((self.ht // stride) + 1) * stride - self.ht) % stride
        pad_wd = (((self.wd // stride) + 1) * stride - self.wd) % stride
        if mode == "kitti":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)
        else:
            # (left, right, top, bottom)
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)

    def pad(self, *inputs):
        out = [
            F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
            for x in inputs
        ]
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
