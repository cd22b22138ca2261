#!/usr/bin/env python3
"""How far RAFT-standard's fp32 training gradients move under a tiny change
of the forward, in the PyTorch port.

    python3 tools/port_grad_sensitivity.py [--size 96 128] [--iters 3 12] [--device cuda|cpu]

For each iteration count: one train-mode forward, sequence loss and
backward of RAFT-standard (fp32, batch 2, seeded weights and data, frozen
BatchNorm) for the unfused SepConvGRU, for `fused_gru` (K7, or its plain
version on the CPU), and for the unfused model with its GRU weights scaled
by 1 + 1e-7 and 1 + 1e-6. Prints the loss and the worst layer's gradient
max_rel (max|d| / max|ref| over a layer's weight and bias) of each against
the unfused run, and the ReLU inputs of the update block that change sign
under the 1e-6 scaling (iteration, layer, count, largest |pre-activation|
among them). A change of sign there is a kink of the step: the gradient
jumps, whatever computed the forward. Runs on the card by default, with
cudnn.deterministic and PyTorch's deterministic algorithms on; `--device
cpu` runs it on the CPU (small sizes only).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _layer_max_rel(grads, ref):
    diff, scale = {}, {}
    for k, v in ref.items():
        layer = k.rsplit(".", 1)[0]
        diff[layer] = max(diff.get(layer, 0.0), float((grads[k] - v).abs().max()))
        scale[layer] = max(scale.get(layer, 0.0), float(v.abs().max()))
    # a layer the step does not reach: 0.0 if both gradients are zero, else inf
    return {n: diff[n] / scale[n] if scale[n] else (0.0 if diff[n] == 0 else math.inf)
            for n in scale}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--iters", type=int, nargs="+", default=(3, 12))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("port_grad_sensitivity: no CUDA device (--device cpu for the CPU)",
                  file=sys.stderr)
            return 1
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    sys.path.insert(0, REPO)
    from raft_optical_flow_tpu_torch.losses import sequence_loss
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    dev = torch.device(args.device)
    H, W = args.size
    g = torch.Generator().manual_seed(5)
    i1 = (torch.rand(2, H, W, 3, generator=g) * 255).to(dev)
    i2 = (torch.rand(2, H, W, 3, generator=g) * 255).to(dev)
    flow = (torch.rand(2, H, W, 2, generator=g) * 10 - 5).to(dev)
    valid = torch.ones(2, H, W, device=dev)

    def run(fused, scale, iters):
        model = RAFT(RAFTConfig(fused_gru=fused), device=dev,
                     generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in model.update_block.gru.parameters():
                p.mul_(scale)
        block = model.update_block
        relu_fed = {"encoder.convc1": block.encoder.convc1, "encoder.convc2": block.encoder.convc2,
                    "encoder.convf1": block.encoder.convf1, "encoder.convf2": block.encoder.convf2,
                    "encoder.conv": block.encoder.conv, "flow_head.conv1": block.flow_head.conv1,
                    "mask_0": block.mask_0}
        pre = []
        hooks = [m.register_forward_hook(lambda m, i, o, n=n: pre.append((n, o.detach())))
                 for n, m in relu_fed.items()]
        preds = model(i1, i2, iters=iters, test_mode=False)
        loss, _ = sequence_loss(preds, flow, valid)
        loss.backward()
        for h in hooks:
            h.remove()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}, pre

    for iters in args.iters:
        loss_u, grads_u, pre_u = run(False, 1.0, iters)
        print(f"{args.device} {H}x{W} batch 2 iters={iters}: unfused loss {loss_u!r}")
        for name, fused, scale in (("fused_gru", True, 1.0),
                                   ("GRU weights x (1 + 1e-7)", False, 1 + 1e-7),
                                   ("GRU weights x (1 + 1e-6)", False, 1 + 1e-6)):
            loss, grads, pre = run(fused, scale, iters)
            rel = _layer_max_rel(grads, grads_u)
            worst = max(rel, key=rel.get)
            print(f"  {name}: loss {loss!r}, worst layer {worst} max_rel {rel[worst]:.3e}")
            if scale == 1 + 1e-6:
                per_iter = len(pre) // iters
                for k, ((layer, a), (_, b)) in enumerate(zip(pre_u, pre)):
                    flips = (a > 0) != (b > 0)
                    if bool(flips.any()):
                        print(f"    ReLU sign changes: iteration {k // per_iter} {layer}: "
                              f"{int(flips.sum())}, largest |pre-activation| "
                              f"{float(a[flips].abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
