"""RAFT training CLI on one device (the reference `train.py`).

Flags are those of the JAX package's `cli/train_raft.py`, without its
multi-host `--dist_*` flags and `--platform`, plus `--device` (default cuda).
Only `--synthetic` data runs in this port so far: warped pairs cropped from
the repo's 192x320 golden frames, so `--image_size` is at most 168x296 in
multiples of 8 (the stage crops, 368x496 and up, wait for the real datasets).
Example:

  python -m raft_optical_flow_tpu_torch.cli.train_raft --name raft-synthetic \\
      --stage chairs --synthetic --num_steps 1000 --batch_size 10 \\
      --lr 4e-4 --image_size 168 296
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--name", default="raft", help="name your experiment")
    parser.add_argument("--stage", required=True,
                        help="dataset stage: chairs | things | sintel | kitti")
    parser.add_argument("--restore_ckpt", default=None,
                        help="flax-layout .npz checkpoint to warm start from")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--validation", type=str, nargs="+", default=[])
    parser.add_argument("--lr", type=float, default=4e-4)
    parser.add_argument("--num_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=6)
    parser.add_argument("--image_size", type=int, nargs="+", default=[384, 512])
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--wdecay", type=float, default=5e-5)
    parser.add_argument("--epsilon", type=float, default=1e-8)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--gamma", type=float, default=0.8, help="exponential weighting")
    parser.add_argument("--add_noise", action="store_true")
    parser.add_argument("--alternate_corr", action="store_true",
                        help="use the on-demand (volume-free) correlation")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--data_root", default=None,
                        help="override the stage dataset root (not ported yet)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on warped-pair synthetic data (no dataset needed)")
    parser.add_argument("--resume", action="store_true",
                        help="resume the full train state from the latest checkpoint")
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--val_freq", type=int, default=5000)
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.synthetic or args.data_root is not None:
        raise NotImplementedError(
            f"--stage {args.stage} data and --data_root are not ported yet (ROADMAP.md "
            "Queue 1 item 10, data layer); use --synthetic")
    if args.validation:
        raise NotImplementedError(
            "--validation is not ported yet (ROADMAP.md Queue 1 item 7, validators)")

    import torch

    from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader
    from raft_optical_flow_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_optical_flow_tpu_torch.models.raft import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    stage = StageConfig(
        name=args.name, stage=args.stage, num_steps=args.num_steps,
        batch_size=args.batch_size, lr=args.lr, image_size=tuple(args.image_size),
        wdecay=args.wdecay, gamma=args.gamma, iters=args.iters, clip=args.clip,
        epsilon=args.epsilon, small=args.small, mixed_precision=args.mixed_precision,
        add_noise=args.add_noise,
        freeze_bn=(args.stage != "chairs"),  # the reference trains BN on chairs only
        val_freq=args.val_freq, seed=args.seed,
    )
    config = RAFTConfig(
        small=args.small, dropout=args.dropout, alternate_corr=args.alternate_corr,
        compute_dtype=torch.bfloat16 if args.mixed_precision else torch.float32,
    )
    try:
        dataset = SyntheticFlowDataset(crop=stage.image_size)
    except ValueError as e:
        raise ValueError(f"--image_size {' '.join(map(str, args.image_size))}: {e}; --synthetic crops the repo's "
                         "192x320 golden frames, so the crop is at most 168x296") from None
    restore = load_flax_checkpoint(args.restore_ckpt) if args.restore_ckpt else None
    trainer = RAFTTrainer(stage, config=config, restore_variables=restore,
                          checkpoint_dir=args.checkpoint_dir, device=args.device)
    print(f"Training with {len(dataset)} image pairs on {trainer.device}")
    loader = FlowDataLoader(dataset, batch_size=args.batch_size,
                            num_workers=args.num_workers, seed=args.seed)
    trainer.run(loader, num_steps=args.num_steps, resume=args.resume)


if __name__ == "__main__":
    main()
