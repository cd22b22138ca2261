"""Training traffic: RAFT's training step, dispatched ahead.

Parameters (the mix's file): `batch_per_chip` pairs of `height` x `width`
per card and step (the global batch is that times the cell's chips), `iters`
GRU iterations, `gamma`, AdamW's `lr`, `wdecay`, `epsilon`, `clip` and the
schedule's `num_steps`, `freeze_bn`, a ring of `ring` distinct global batches
made at set-up, and `profiled_steps` steps in the traced stretch.

Set-up builds one training state (`train/trainer.py::create_train_state`)
with the benchmark's weights, and drives it through its first three steps on
batches 0, 1, 2 of the ring, through the window's own call: those steps are
what the comparison reads (each step's loss and gradient norm, the first
clipped gradient from AdamW's state after one step, the parameters' change
after three). Two more steps time a step, from which the window's step
count is set (on several cards, rank 0's count). The window then
dispatches its steps with no host synchronisation between them and ends at
a synchronize after the last.

On several cards each process takes its rows of every global batch and the
step runs inside `parallel/distributed.py::data_parallel`.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from flowbench import bytes as fbytes
from flowbench import correct as fcorrect
from flowbench import flops as fflops
from flowbench.common import Marks, arch_of, sync, traced_stretch
from flowbench.harness import Context, Record, judge
from flowbench.inputs import make_batch
from flowbench.reference.raft import Arch, PlainRAFT
from flowbench.reference.train import PlainTrainer
from flowbench.weights import make_weights, trainable

CHECKED_STEPS = 3


class ProgramSystem:
    """The program's training state and step."""

    def __init__(self, ctx: Context, weights, arch: Arch):
        import torch.distributed as dist

        from raft_optical_flow_tpu_torch.models.raft import RAFTConfig
        from raft_optical_flow_tpu_torch.parallel import distributed
        from raft_optical_flow_tpu_torch.train.configs import StageConfig
        from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step

        t = ctx.spec.traffic
        stage = StageConfig(
            name="flowbench", stage="flowbench", num_steps=int(t["num_steps"]),
            batch_size=int(t["batch_per_chip"]) * ctx.world, lr=float(t["lr"]),
            image_size=(int(t["height"]), int(t["width"])), wdecay=float(t["wdecay"]),
            gamma=float(t["gamma"]), iters=int(t["iters"]), clip=float(t["clip"]),
            epsilon=float(t["epsilon"]), small=arch.small,
            mixed_precision=ctx.spec.config["policy"] == "bf16", freeze_bn=bool(t["freeze_bn"]))
        dtype = torch.bfloat16 if stage.mixed_precision else torch.float32
        self.state = create_train_state(
            RAFTConfig(small=arch.small, corr_levels=arch.levels, compute_dtype=dtype), stage,
            device=ctx.device)
        self.state.model.load_state_dict(weights, strict=True)
        self.model = self.state.model
        group = dist.group.WORLD if ctx.world > 1 else None
        self._parallel = lambda: distributed.data_parallel(group)  # noqa: E731
        self._step = lambda b: raft_train_step(  # noqa: E731
            self.state, b, iters=stage.iters, gamma=stage.gamma, add_noise=False,
            freeze_bn=stage.freeze_bn)

    def step(self, batch: Dict[str, torch.Tensor]):
        with self._parallel():
            out = self._step(batch)
        return out["loss"], out["grad_norm"]

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def first_grad(self) -> Dict[str, torch.Tensor]:
        """The first step's clipped gradient, from AdamW's first moment
        after one step (mu = (1 - b1) g)."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["b1"]
        return {k: opt.state[p]["mu"] / (1.0 - b1) for k, p in self.model.named_parameters()}


class ReferenceSystem:
    """The reference in the program's place, in `policy` (default: the
    control, one precision step below the configuration's policy). It runs
    on one card."""

    def __init__(self, ctx: Context, weights, arch: Arch, policy=None):
        t = ctx.spec.traffic
        self.iters, self.gamma = int(t["iters"]), float(t["gamma"])
        self.trainer = PlainTrainer(PlainRAFT(arch, policy or ctx.spec.config["control"]), weights,
                                    trainable(arch), float(t["lr"]), float(t["wdecay"]),
                                    float(t["epsilon"]), float(t["clip"]), int(t["num_steps"]))
        self.model = None
        self._grads = {}

    def step(self, batch):
        n = batch["image1"].shape[0]
        loss, norm, self._grads = self.trainer.step(batch, self.iters, self.gamma, rows=n)
        return loss, norm

    def params(self):
        return {k: self.trainer.p[k] for k in self.trainer.trainable}

    def first_grad(self):
        return self._grads


SYSTEMS = {"program": ProgramSystem, "control": ReferenceSystem}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].detach().float()) for k in names])
    return dict(zip(names, vals.tolist()))


def run(ctx: Context) -> Record:
    import torch.distributed as dist

    t = ctx.spec.traffic
    arch = arch_of(ctx.spec.config)
    policy = ctx.spec.config["policy"]
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    b = int(t["batch_per_chip"])
    n_global = b * ctx.world
    H, W, iters = int(t["height"]), int(t["width"]), int(t["iters"])
    marks = Marks(ctx.t0_wall)
    weights = make_weights(arch, ctx.seed, dev)
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    ring = [{k: v[rows].contiguous() for k, v in make_batch(ctx.seed, i, n_global, H, W, dev).items()}
            for i in range(int(t["ring"]))]
    sync(dev)
    marks("weights and inputs")
    system = SYSTEMS[ctx.system](ctx, weights, arch)
    marks("model and optimizer")

    # the first three steps: the comparison's readings, and the warm-up
    p0 = {k: v.detach().clone() for k, v in system.params().items()}
    losses, gnorms = [], []
    for i in range(CHECKED_STEPS):
        loss, gn = system.step(ring[i % len(ring)])
        losses.append(loss.detach())
        gnorms.append(gn.detach())
        if i == 0:
            first_grad = _norms(system.first_grad())
    change = _norms({k: v.detach() - p0[k] for k, v in system.params().items()})
    del p0
    marks("three checked steps")
    readings = {"loss": [float(x) for x in losses], "grad_norm": [float(x) for x in gnorms],
                "first_grad": first_grad, "change": change}

    # two timed steps set the window's step count (rank 0's on every rank)
    sync(dev)
    t1 = time.perf_counter()
    for i in range(2):
        system.step(ring[(CHECKED_STEPS + i) % len(ring)])
    sync(dev)
    step_s = (time.perf_counter() - t1) / 2
    n_steps = torch.tensor([max(1, math.ceil(ctx.seconds / step_s))], device=dev)
    if ctx.world > 1:
        dist.broadcast(n_steps, src=0)
        dist.barrier()
    n_steps = int(n_steps.item())
    marks("two timed steps")
    marks.report()
    process_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx.t0_wall

    start = time.perf_counter()
    window_losses = []
    for i in range(n_steps):
        loss, _ = system.step(ring[i % len(ring)])
        window_losses.append(loss.detach())
    sync(dev)
    window_s = time.perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if ctx.world > 1:
        m = torch.tensor([peak, process_peak], dtype=torch.float64, device=dev)
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        peak, process_peak = int(m[0]), int(m[1])

    rec = Record(kind="train", policy=policy, setup_s=setup_s, window_s=window_s,
                 peak_mem_bytes=peak, process_peak_bytes=max(peak, process_peak),
                 attempted=n_steps, failed=failed, world=ctx.world, global_batch=n_global,
                 work_flops=float(fflops.train_flops(arch, n_global, H, W, iters)))
    if ctx.trace and system.model is not None:
        _traced(ctx, rec, system, ring, arch)
    del system, window_losses
    if cuda:
        torch.cuda.empty_cache()
    _compare(ctx, rec, weights, readings, arch)
    return rec


def _traced(ctx: Context, rec: Record, system, ring, arch: Arch) -> None:
    """`profiled_steps` steps, under the profiler on rank 0 (the others run
    the same steps unprofiled)."""
    n = int(ctx.spec.traffic["profiled_steps"])

    def stretch():
        for i in range(n):
            system.step(ring[i % len(ring)])
        sync(ctx.device)

    if ctx.rank != 0:
        stretch()
        return
    rec.trace, flows = traced_stretch(system.model.update_block, stretch)
    rec.profiled = n
    rec.lookup_bound_s = fbytes.train_bound_s(flows, arch.levels, arch.radius,
                                              2 if rec.policy == "bf16" else 4)


def _compare(ctx: Context, rec: Record, weights, readings, arch: Arch) -> None:
    """Every rank's readings against the reference's three steps on the
    global batch (in blocks of one card's rows), on rank 0."""
    import torch.distributed as dist

    t = ctx.spec.traffic
    per_rank = [readings]
    if ctx.world > 1:
        per_rank = [None] * ctx.world
        dist.all_gather_object(per_rank, readings)
        if ctx.rank != 0:
            return
    b = int(t["batch_per_chip"])
    n_global = b * ctx.world
    H, W = int(t["height"]), int(t["width"])
    ref = PlainTrainer(PlainRAFT(arch, ctx.spec.config["policy"]), weights, trainable(arch),
                       float(t["lr"]), float(t["wdecay"]), float(t["epsilon"]), float(t["clip"]),
                       int(t["num_steps"]))
    p0 = {k: ref.p[k].detach().clone() for k in ref.trainable}
    out = {"loss": [], "grad_norm": []}
    for i in range(CHECKED_STEPS):
        batch = make_batch(ctx.seed, i, n_global, H, W, ctx.device)
        loss, norm, grads = ref.step(batch, int(t["iters"]), float(t["gamma"]), rows=b)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(norm))
        if i == 0:
            out["first_grad"] = _norms(grads)
        del batch, grads
    out["change"] = _norms({k: ref.p[k].detach() - p0[k] for k in ref.trainable})
    numbers = [fcorrect.train_numbers(r, out) for r in per_rank]
    rec.numbers = {k: max(n[k] for n in numbers) for k in numbers[0]}
    rec.correct, rec.checks = judge(rec.numbers, ctx.spec.limits)
