"""Evaluation CLI (the reference's `evaluate.py` / `evaluate_liteflownet3.py`).

Counterpart of the JAX package's `cli/evaluate.py`, with its flags, but
`--device` (default cuda) in place of `--platform`. Example:

  python -m raft_optical_flow_tpu_torch.cli.evaluate --model checkpoints/raft_small.npz \\
      --small --dataset sintel --sintel_root datasets/Sintel

Reference golden numbers to compare against are recorded in `evaluate.py:193-203`
and `evaluate_liteflownet3.py:282-296` (e.g. raft-small iters=32 Sintel-val clean
EPE 2.0867 / final 3.6822).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def _eval_samples(dataset):
    """Yield numpy (img1, img2, flow[, valid]) from a FlowDataset without aug."""
    for i in range(len(dataset)):
        yield dataset.__getitem__(i)


def make_validation_fn(names, config, iters, data_root=None):
    """A `val_fn(model) -> {name: value}` running the named validation sets
    (chairs, sintel, kitti) on the model, where it is."""

    def val_fn(model):
        from raft_optical_flow_tpu_torch.data import datasets as D
        from raft_optical_flow_tpu_torch.eval import evaluate as E

        fwd = E.make_raft_forward(config, model, iters)
        results = {}
        for name in names:
            if name == "chairs":
                root = data_root or "datasets/FlyingChairs_release/data"
                ds = D.FlyingChairs(None, split="validation", root=root)
                results.update(E.validate_chairs(fwd, _eval_samples(ds)))
            elif name == "sintel":
                root = data_root or "datasets/Sintel"
                for dstype in ("clean", "final"):
                    ds = D.MpiSintelVal(None, root=root, dstype=dstype)
                    results.update(E.validate_sintel(fwd, _eval_samples(ds), dstype))
            elif name == "kitti":
                root = data_root or "datasets/KITTI"
                ds = D.KITTI(None, split="training", root=root)
                results.update(E.validate_kitti(fwd, _eval_samples(ds)))
        return results

    return val_fn


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, help="converted .npz checkpoint")
    parser.add_argument("--arch", default="raft",
                        choices=["raft", "liteflownet3", "liteflownet3s",
                                 "liteflownet3_pseudoreg", "liteflownet3s_pseudoreg"])
    parser.add_argument("--dataset", default="sintel",
                        choices=["chairs", "sintel", "kitti", "synthetic"])
    parser.add_argument("--synthetic_size", type=int, nargs=2, default=[128, 192],
                        help="crop H W of the synthetic warped-pair set")
    parser.add_argument("--synthetic_samples", type=int, default=8)
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--iters", type=int, default=32)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--alternate_corr", action="store_true")
    parser.add_argument("--sintel_root", default="datasets/Sintel")
    parser.add_argument("--chairs_root", default="datasets/FlyingChairs_release/data")
    parser.add_argument("--kitti_root", default="datasets/KITTI")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the chosen validation; returns {name: value} of every validator run."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from raft_optical_flow_tpu_torch.data import datasets as D
    from raft_optical_flow_tpu_torch.eval import evaluate as E
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    state_dict = load_flax_npz(args.model)
    if args.arch == "raft":
        from raft_optical_flow_tpu_torch.models.raft import RAFTConfig

        config = RAFTConfig(
            small=args.small, alternate_corr=args.alternate_corr,
            compute_dtype=torch.bfloat16 if args.mixed_precision else torch.float32,
        )
        fwd = E.make_raft_forward(config, state_dict, args.iters, device=args.device)
    else:
        from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config

        config = LFN3Config(
            use_s_version="s" in args.arch.replace("liteflownet3", "", 1)[:1],
            use_pseudo_regularization="pseudoreg" in args.arch,
        )
        fwd = E.make_lfn3_forward(config, state_dict, device=args.device)

    results = {}
    if args.dataset == "synthetic":
        # warped pairs of real frames with exact ground truth: the validator
        # path without a dataset on disk
        from raft_optical_flow_tpu_torch.data.synthetic import SyntheticFlowDataset

        ds = SyntheticFlowDataset(crop=tuple(args.synthetic_size),
                                  length=args.synthetic_samples)
        results = E.validate_sintel(fwd, _eval_samples(ds), "synthetic")
        assert all(np.isfinite(v) for v in results.values()), results
    elif args.dataset == "chairs":
        ds = D.FlyingChairs(None, split="validation", root=args.chairs_root)
        results = E.validate_chairs(fwd, _eval_samples(ds), iters=args.iters)
    elif args.dataset == "sintel":
        for dstype in ("clean", "final"):
            ds = D.MpiSintelVal(None, root=args.sintel_root, dstype=dstype)
            results.update(E.validate_sintel(fwd, _eval_samples(ds), dstype))
    elif args.dataset == "kitti":
        ds = D.KITTI(None, split="training", root=args.kitti_root)
        results = E.validate_kitti(fwd, _eval_samples(ds))
    return results


if __name__ == "__main__":
    main()
