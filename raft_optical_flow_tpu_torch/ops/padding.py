"""Input padding to stride-divisible sizes.

Counterpart of `raft_optical_flow_tpu/ops/padding.py::InputPadder` in its
RAFT modes: replicate padding; 'sintel' centres the pad, 'kitti' pads the
bottom only (and centres the width); NHWC tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
