"""Training CLI of the LiteFlowNet3, SimpleFlowNet and IFNet families
(supervised and unsupervised), on one device or data-parallel over
processes.

Counterpart of the JAX package's `cli/train_flow.py`, with its flags, but
`--device` (default cuda) in place of `--platform`. `--dist_coordinator`,
`--dist_num_processes` and `--dist_process_id` start one process of a
data-parallel run (one device each, as `cli/train_raft.py`); the batch size
is the global one. Without them, on a host with several cards, the command
trains on every visible card, one worker process each
(`parallel/launch.py`; `CUDA_VISIBLE_DEVICES` limits them). The stage's
dataset comes from `data/datasets.py::fetch_dataset` (its root overridden by `--data_root`),
augmented and batched by the port's data layer; `--synthetic` trains on
random tensors instead (the reference's DummyDataset fallback). Examples:

  python -m raft_optical_flow_tpu_torch.cli.train_flow --model lfn3 --stage sintel \\
      --data_root datasets/Sintel --num_steps 10000 --batch_size 8
  python -m raft_optical_flow_tpu_torch.cli.train_flow --model simple_flow \\
      --unsupervised --synthetic --num_steps 1000 --batch_size 8 --lr 1e-4
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np  # noqa: E402


def _synthetic_batches(batch_size, image_size, seed=0, num_shards=1, shard_id=0):
    """Endless batches of random tensors, the JAX package's draw: image1
    and image2 uniform in [0, 255) [B, H, W, 3], flow uniform in [-5, 5)
    [B, H, W, 2], valid ones [B, H, W]; float32 numpy arrays. batch_size is
    the global batch: each shard draws it whole and keeps its rows."""
    if batch_size % num_shards != 0:
        raise ValueError(f"batch_size={batch_size} must be divisible by num_shards="
                         f"{num_shards} (mirrors FlowDataLoader)")
    rng = np.random.RandomState(seed)
    H, W = image_size
    lo = shard_id * (batch_size // num_shards)
    hi = lo + batch_size // num_shards
    while True:
        batch = {
            "image1": rng.uniform(0, 255, (batch_size, H, W, 3)).astype(np.float32),
            "image2": rng.uniform(0, 255, (batch_size, H, W, 3)).astype(np.float32),
            "flow": rng.uniform(-5, 5, (batch_size, H, W, 2)).astype(np.float32),
            "valid": np.ones((batch_size, H, W), np.float32),
        }
        yield {k: v[lo:hi] for k, v in batch.items()}


class SyntheticBatches:
    """`_synthetic_batches` with FlowDataLoader's `epochs(skip_batches)`, so
    that a resumed run reads on from the batch the straight run would."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def epochs(self, skip_batches: int = 0):
        it = _synthetic_batches(*self.args, **self.kwargs)
        for _ in range(skip_batches):
            next(it)
        return it

    def __iter__(self):
        return self.epochs()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True, choices=["lfn3", "lfn3s", "simple_flow", "ifnet"])
    parser.add_argument("--unsupervised", action="store_true")
    parser.add_argument("--stage", default="sintel",
                        help="dataset stage: chairs | things | sintel | kitti")
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
                        help="override the stage dataset root")
    parser.add_argument("--restore_ckpt", default=None,
                        help="flax-layout .npz checkpoint to start from")
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

    code = launch.over_local_cards("raft_optical_flow_tpu_torch.cli.train_flow",
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
    from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh
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
    mesh = make_mesh(device=args.device)
    trainer = FlowTrainer(kind, image_size=image_size, model_config=model_config, optim=optim,
                          mesh=mesh, seed=args.seed, restore_variables=restore,
                          checkpoint_dir=args.checkpoint_dir)
    n, shard = mesh.shape["data"], mesh.coord("data")
    lead = distributed.is_lead_host()
    if args.synthetic:
        if lead:
            print(f"Training {kind} on synthetic batches on {n} devices / {n} processes "
                  f"({trainer.device})")
        data_iter = SyntheticBatches(args.batch_size, image_size, args.seed,
                                     num_shards=n, shard_id=shard)
    else:
        from raft_optical_flow_tpu_torch.data.datasets import fetch_dataset
        from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader

        roots = {args.stage: args.data_root} if args.data_root else None
        dataset = fetch_dataset(args.stage, image_size, roots=roots)
        if lead:
            print(f"Training {kind} with {len(dataset)} image pairs on {n} devices / {n} "
                  f"processes ({trainer.device})")
        # batch_size is GLOBAL; each process loads only its rows of every batch
        data_iter = FlowDataLoader(dataset, batch_size=args.batch_size,
                                   num_workers=args.num_workers, seed=args.seed,
                                   num_shards=n, shard_id=shard)
    if n > 1:
        print(f"process {mesh.rank} of {n} on {trainer.device}", flush=True)
    trainer.run(data_iter, num_steps=args.num_steps, val_freq=args.val_freq, resume=args.resume)
    return trainer


if __name__ == "__main__":
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
