"""RAFT training CLI (the reference `train.py`), on one device or
data-parallel over processes.

Flags are those of the JAX package's `cli/train_raft.py`, without
`--platform`, plus `--device` (default cuda). `--dist_coordinator host:port`,
`--dist_num_processes N` and `--dist_process_id i` start process i of N
(one device each: NCCL for the card, gloo for `--device cpu`); the batch
size is the global one, and each process loads its rows of every batch.
The stage's dataset comes from `data/datasets.py::fetch_dataset` (its root
overridden by `--data_root`), augmented and batched by the port's data
layer; `--validation chairs sintel kitti` runs the validators every
`--val_freq` steps (the chairs root is `--data_root` when given).
`--synthetic` trains on warped pairs cropped from the repo's 192x320 golden
frames instead (`--image_size` at most 168x296). Example:

  python -m raft_optical_flow_tpu_torch.cli.train_raft --name raft-chairs \\
      --stage chairs --data_root datasets/FlyingChairs_release/data \\
      --validation chairs --num_steps 100000 --batch_size 10 --lr 4e-4 \\
      --image_size 368 496

On a host with several cards the command above trains on every visible
card (`parallel/launch.py`: one worker process per card, the batch split
over them; `CUDA_VISIBLE_DEVICES` limits them, `--device cuda:1` or
`--device cpu` keeps one process). Across hosts, or by hand, one command
per process:

  python -m raft_optical_flow_tpu_torch.cli.train_raft --stage chairs ... \
      --dist_coordinator localhost:29500 --dist_num_processes 2 --dist_process_id 0
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
                        help="override the stage dataset root")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on warped-pair synthetic data (no dataset needed)")
    parser.add_argument("--resume", action="store_true",
                        help="resume the full train state from the latest checkpoint")
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--val_freq", type=int, default=5000)
    parser.add_argument("--dist_coordinator", default=None,
                        help="multi-process: the coordinator's address host:port")
    parser.add_argument("--dist_num_processes", type=int, default=None)
    parser.add_argument("--dist_process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the trainer, or the launcher's exit code when the
    command ran as one worker process per visible card."""
    args = parse_args(argv)

    from raft_optical_flow_tpu_torch.parallel import distributed, launch

    code = launch.over_local_cards("raft_optical_flow_tpu_torch.cli.train_raft",
                                   sys.argv[1:] if argv is None else argv, args, args.batch_size)
    if code is not None:
        return code

    # connect to the other processes before any CUDA work (a no-op alone)
    started = distributed.initialize(args.dist_coordinator, args.dist_num_processes,
                                     args.dist_process_id, device=args.device)
    try:
        return _train(args)
    finally:
        if started:
            distributed.shutdown()


def _train(args):
    import torch

    from raft_optical_flow_tpu_torch.data.datasets import fetch_dataset
    from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader
    from raft_optical_flow_tpu_torch.data.synthetic import SyntheticFlowDataset
    from raft_optical_flow_tpu_torch.models.raft import RAFTConfig
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh
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
    if args.synthetic:
        try:
            dataset = SyntheticFlowDataset(crop=stage.image_size)
        except ValueError as e:
            raise ValueError(f"--image_size {' '.join(map(str, args.image_size))}: {e}; --synthetic "
                             "crops the repo's 192x320 golden frames, so the crop is at most "
                             "168x296") from None
    else:
        roots = {args.stage: args.data_root} if args.data_root else None
        dataset = fetch_dataset(args.stage, stage.image_size, roots=roots)
    restore = load_flax_checkpoint(args.restore_ckpt) if args.restore_ckpt else None
    mesh = make_mesh(device=args.device)
    trainer = RAFTTrainer(stage, config=config, mesh=mesh, restore_variables=restore,
                          checkpoint_dir=args.checkpoint_dir)
    n = mesh.shape["data"]
    if distributed.is_lead_host():
        print(f"Training with {len(dataset)} image pairs on {n} devices / {n} processes "
              f"({trainer.device})")
    if n > 1:
        print(f"process {mesh.rank} of {n} on {trainer.device}", flush=True)
    # batch_size is GLOBAL; each process loads only its rows of every batch
    loader = FlowDataLoader(dataset, batch_size=args.batch_size, num_workers=args.num_workers,
                            seed=args.seed, num_shards=n, shard_id=mesh.coord("data"))
    val_fn = None
    if args.validation:
        from raft_optical_flow_tpu_torch.cli.evaluate import make_validation_fn

        val_fn = make_validation_fn(args.validation, config, args.iters, data_root=args.data_root)
    trainer.run(loader, num_steps=args.num_steps, val_fn=val_fn, resume=args.resume)
    return trainer


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
