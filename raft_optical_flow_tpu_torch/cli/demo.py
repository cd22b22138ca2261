"""Demo CLI (the reference's `demo.py` / `demo_simple_flow.py` /
`liteflownet3_demo.py`).

Counterpart of the JAX package's `cli/demo.py`, with its flags plus
`--device` (default cuda); frames are read and PNGs written by the port's
codecs (no PIL). Runs a model over consecutive frame pairs in a directory
and writes each first frame stacked over its flow's color-wheel
visualization (`demo.py:44-67` semantics):

  python -m raft_optical_flow_tpu_torch.cli.demo --model checkpoints/raft_small.npz \\
      --small --path demo-frames --out demo_out
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402


def create_demo_images(output_dir: str = "./demo_images", size: int = 256):
    """Synthetic demo pair: a circle moving +40 px in x (`demo_simple_flow.py:225-258`)."""
    from raft_optical_flow_tpu_torch.data.frame_utils import write_png

    os.makedirs(output_dir, exist_ok=True)
    y, x = np.ogrid[:size, :size]
    paths = []
    for i, cx in enumerate((size // 2 - 20, size // 2 + 20)):
        img = np.zeros((size, size, 3), np.uint8)
        img[(x - cx) ** 2 + (y - size // 2) ** 2 <= 30**2] = [255, 0, 0]
        p = os.path.join(output_dir, f"img{i + 1}.png")
        write_png(p, img)
        paths.append(p)
    return tuple(paths)


def _forward(arch, state_dict, args):
    """(fwd(a, b) -> flow [N, H, W, 2], needs_pad) for NHWC 0-255 frames."""
    import torch

    from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear

    if arch == "raft":
        from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig

        model = RAFT(RAFTConfig(small=args.small, alternate_corr=args.alternate_corr),
                     device=args.device)
        fwd = lambda a, b: model(a, b, iters=args.iters, test_mode=True)[1]  # noqa: E731
        needs_pad = True
    elif arch.startswith("liteflownet3"):
        from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config, LiteFlowNet3

        model = LiteFlowNet3(LFN3Config(use_s_version=arch.endswith("s")), device=args.device)
        fwd = lambda a, b: model(torch.stack([a, b], 1) / 255.0)["flows"][:, 0]  # noqa: E731
        needs_pad = False
    elif arch == "simple_flow":
        from raft_optical_flow_tpu_torch.models.simple_flow import SimpleFlowNet

        model = SimpleFlowNet(device=args.device)

        def fwd(a, b):
            f = model(a / 255.0, b / 255.0)[-1]  # finest (1/2 res)
            return resize_bilinear(f, a.shape[1:3]) * 2.0

        needs_pad = True
    else:  # ifnet
        from raft_optical_flow_tpu_torch.models.ifnet import IFNet

        model = IFNet(device=args.device)
        fwd = lambda a, b: model(a / 255.0, b / 255.0)[0][-1][..., 2:4]  # noqa: E731
        needs_pad = True
    model.load_state_dict(state_dict)
    return torch.inference_mode()(fwd), needs_pad


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, help="converted .npz checkpoint")
    parser.add_argument("--arch", default="raft",
                        choices=["raft", "liteflownet3", "liteflownet3s",
                                 "simple_flow", "ifnet"])
    parser.add_argument("--path", default=None, help="directory of frames")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate and use a synthetic demo pair")
    parser.add_argument("--out", default="demo_out")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--alternate_corr", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser


def parse_args(argv=None):
    return _parser().parse_args(argv)


def main(argv=None):
    """Write `<out>/flow_<i>.png` for each consecutive pair; returns their paths."""
    args = parse_args(argv)
    if args.path is None and not args.synthetic:
        _parser().error("--path or --synthetic required")

    import torch

    from raft_optical_flow_tpu_torch.data.frame_utils import read_gen, write_png
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder
    from raft_optical_flow_tpu_torch.utils.flow_viz import flow_to_image
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    fwd, needs_pad = _forward(args.arch, load_flax_npz(args.model), args)
    if args.synthetic:
        args.path = os.path.join(args.out, "demo_images")
        create_demo_images(args.path)
    frames = sorted(
        glob.glob(os.path.join(args.path, "*.png"))
        + glob.glob(os.path.join(args.path, "*.jpg"))
    )
    os.makedirs(args.out, exist_ok=True)
    written = []
    for i, (f1, f2) in enumerate(zip(frames[:-1], frames[1:])):
        img1 = np.asarray(read_gen(f1)).astype(np.float32)
        img2 = np.asarray(read_gen(f2)).astype(np.float32)
        a = torch.from_numpy(img1)[None].to(args.device)
        b = torch.from_numpy(img2)[None].to(args.device)
        if needs_pad:
            padder = InputPadder((1,) + img1.shape)
            flow = padder.unpad(fwd(*padder.pad(a, b)))[0].float().cpu().numpy()
        else:
            flow = fwd(a, b)[0].float().cpu().numpy()
        viz = flow_to_image(flow)
        stacked = np.concatenate([img1.astype(np.uint8), viz], axis=0)
        out_path = os.path.join(args.out, f"flow_{i:04d}.png")
        write_png(out_path, stacked)
        written.append(out_path)
        print(f"{f1} -> {out_path}  (|flow| mean {np.linalg.norm(flow, axis=-1).mean():.2f})")
    return written


if __name__ == "__main__":
    main()
