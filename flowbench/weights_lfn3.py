"""Seeded weights for LiteFlowNet3, made on the device in one draw.

One uniform draw of every parameter's values from a generator on the
device, seeded by the run's seed, carved into the leaves that
`reference.liteflownet3.param_shapes` lists and scaled so that activations
keep their size through the layers and the flow moves pixels:

  - conv kernels: U(+-sqrt(6 / ((1 + 0.1^2) * fan_in))), He's uniform draw
    for the leaky ReLU of slope 0.1 (`nn.init.kaiming_uniform_(a=0.1)`);
  - the heads' kernels larger: the convs that put out a flow or a
    displacement (matching's `flow_net_10`, sub-pixel's `flow_net`,
    deformation's `disp_pred`) 2 times that, the confidence logits'
    (`conf_pred_0`) 4 times (HEAD_GAIN). With He's scale alone the
    final flow reads 0.28-3.1 px RMS at 1920x1080 (16 seeds; the
    program's own U(+-1/sqrt(fan_in)) near 0.05 px), where the warps of
    many seeds sample nothing useful, and the confidence stays within one
    bf16 step of 0.5 under the fp8 control too. 2x flow heads read
    0.52-6.4 px (4x: 1.1-14 px), and 4x confidence heads bring the
    control's confidence 2.8 bf16 steps or more away (16 and 12 seeds);
  - conv biases: U(+-1/sqrt(fan_in)), PyTorch's conv default (the
    program's init zeroes them; drawn here so that every bias reaches the
    comparison);
  - transposed-conv kernels (in, out / groups, kh, kw):
    U(+-sqrt(3 / (out / groups * kh * kw))).

The same dict goes to the program (`load_state_dict`) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from flowbench.reference.liteflownet3 import SLOPE, param_shapes

HEAD_GAIN = {"flow_net_10": 2.0, "flow_net": 2.0, "disp_pred": 2.0, "conf_pred_0": 4.0}


def make_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes()
    sizes = [math.prod(s) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, fan_in = {}, {}
    offset = 0
    for (name, shape, kind), n in zip(shapes, sizes):
        x = u[offset:offset + n].view(shape)
        offset += n
        layer = name.rsplit(".", 1)[0]
        if kind == "conv":
            fan_in[layer] = math.prod(shape[1:])
            x = x * math.sqrt(6.0 / ((1.0 + SLOPE**2) * fan_in[layer]))
            x = x * HEAD_GAIN.get(layer.rsplit(".", 1)[1], 1.0)
        elif kind == "bias":
            x = x / math.sqrt(fan_in[layer])
        else:  # deconv
            x = x * math.sqrt(3.0 / math.prod(shape[1:]))
        out[name] = x.contiguous()
    return out
