"""Training CLI of the LiteFlowNet3, SimpleFlowNet and IFNet families
(supervised and unsupervised) on one device.

Counterpart of the JAX package's `cli/train_flow.py`, with its flags, but
`--device` (default cuda) in place of `--platform`; the multi-host
`--dist_*` flags and dataset stages are not ported yet. `--synthetic`
trains on random tensors (the reference's DummyDataset fallback). Example:

  python -m raft_optical_flow_tpu_torch.cli.train_flow --model simple_flow \\
      --unsupervised --synthetic --num_steps 1000 --batch_size 8 --lr 1e-4
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402


def _synthetic_batches(batch_size, image_size, seed=0):
    """Endless batches of random tensors, the JAX package's draw: image1
    and image2 uniform in [0, 255) [B, H, W, 3], flow uniform in [-5, 5)
    [B, H, W, 2], valid ones [B, H, W]; float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    H, W = image_size
    while True:
        yield {
            "image1": rng.uniform(0, 255, (batch_size, H, W, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (batch_size, H, W, 3)).astype(np.float32),
            "flow": rng.uniform(-5, 5, (batch_size, H, W, 2)).astype(np.float32),
            "valid": np.ones((batch_size, H, W), np.float32),
        }


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, choices=["lfn3", "lfn3s", "simple_flow", "ifnet"])
    parser.add_argument("--unsupervised", action="store_true")
    parser.add_argument("--stage", default="sintel",
                        help="dataset stage: chairs | things | sintel | kitti (not ported yet)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on random tensors (DummyDataset fallback)")
    parser.add_argument("--num_steps", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--lr_step_size", type=int, default=10000)
    parser.add_argument("--image_size", type=int, nargs="+", default=[384, 768])
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--data_root", default=None,
                        help="override the stage dataset root (not ported yet)")
    parser.add_argument("--restore_ckpt", default=None,
                        help="flax-layout .npz checkpoint to start from")
    parser.add_argument("--resume", action="store_true",
                        help="resume the full train state from the latest checkpoint")
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--val_freq", type=int, default=5000)
    parser.add_argument("--dist_coordinator", default=None, help="multi-host (not ported yet)")
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if (args.dist_coordinator, args.dist_num_processes, args.dist_process_id) != (None,) * 3:
        raise NotImplementedError(
            "--dist_* (multi-host) is not ported yet (ROADMAP.md Queue 1 item 16, parallel)")
    if not args.synthetic or args.data_root is not None:
        raise NotImplementedError(
            f"--stage {args.stage} data and --data_root are not ported yet (ROADMAP.md "
            "Queue 1 item 10, data layer); use --synthetic")

    from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config
    from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer, OptimConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    base = "lfn3" if args.model.startswith("lfn3") else args.model
    kind = base + ("_unsup" if args.unsupervised else "")
    model_config = None
    if base == "lfn3":
        model_config = LFN3Config(use_s_version=args.model.endswith("s"))
    optim = OptimConfig(lr=args.lr, weight_decay=args.weight_decay, adamw=(base != "lfn3"),
                        step_size=args.lr_step_size)
    restore = load_flax_checkpoint(args.restore_ckpt) if args.restore_ckpt else None
    image_size = tuple(args.image_size)
    trainer = FlowTrainer(kind, image_size=image_size, model_config=model_config, optim=optim,
                          seed=args.seed, restore_variables=restore,
                          checkpoint_dir=args.checkpoint_dir, device=args.device)
    print(f"Training {kind} on synthetic batches on {trainer.device}")
    trainer.run(_synthetic_batches(args.batch_size, image_size, args.seed),
                num_steps=args.num_steps, val_freq=args.val_freq, resume=args.resume)
    return trainer


if __name__ == "__main__":
    main()
