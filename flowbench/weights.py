"""Seeded weights for a configuration, made on the device in one draw.

One uniform draw of every parameter's and buffer's values from a generator
on the device, seeded by the run's seed, carved into the leaves that
`reference.raft.param_shapes` lists and scaled as RAFT initializes them:

  - encoder conv kernels: kaiming fan-out (std sqrt(2 / fan_out)), the
    reference's `nn.init.kaiming_normal_(mode='fan_out')`, drawn uniform
    with that std;
  - other conv kernels and every conv bias: U(+-1/sqrt(fan_in)), PyTorch's
    conv default;
  - BatchNorm: weight 1 +- 0.1, bias +- 0.1, running mean +- 0.1, running
    variance 1 +- 0.25, so that the running statistics do work.

The same dict goes to the program (`load_state_dict`) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from flowbench.reference.raft import Arch, param_shapes


def make_weights(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(arch)
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, fan_in = {}, {}
    offset = 0
    for (name, shape, kind), n in zip(shapes, sizes):
        x = u[offset:offset + n].view(shape)
        offset += n
        layer = name.rsplit(".", 1)[0]
        if kind in ("conv", "enc_conv"):
            cout, cin, kh, kw = shape
            fan_in[layer] = cin * kh * kw
            if kind == "enc_conv":
                x = x * (math.sqrt(3.0) * math.sqrt(2.0 / (cout * kh * kw)))
            else:
                x = x / math.sqrt(fan_in[layer])
        elif kind == "bias":
            x = x / math.sqrt(fan_in[layer])
        elif kind == "bn_weight" or kind == "bn_var":
            x = 1.0 + x * (0.1 if kind == "bn_weight" else 0.25)
        else:  # bn_bias, bn_mean
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def trainable(arch: Arch):
    """The names of the leaves a training step moves (buffers excluded)."""
    return [n for n, _, k in param_shapes(arch) if k not in ("bn_mean", "bn_var")]
