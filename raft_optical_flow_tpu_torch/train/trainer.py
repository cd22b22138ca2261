"""RAFT trainer, on one device or data-parallel over processes: AdamW with a
linear one-cycle schedule, gradient clipping, the train step, logging and
checkpoints.

Counterpart of `raft_optical_flow_tpu/train/trainer.py`. The optimizer is
optax's, rebuilt, not torch's:

  - `linear_onecycle_schedule` is optax's piecewise-linear one-cycle, read at
    the update count BEFORE the update. `torch.optim.lr_scheduler.OneCycleLR`
    puts its phase ends one step earlier.
  - `AdamW` clips like `optax.clip_by_global_norm` (scale by clip/norm when
    the norm is not below clip, no epsilon) and then applies `optax.adamw`
    (bias-corrected moments, eps outside the square root, decoupled weight
    decay on every parameter, all scaled by the scheduled lr).

Data parallelism: with a mesh (`parallel/mesh.py::make_mesh`) each process
drives one device and feeds its rows of every global batch; the step runs
inside `parallel.distributed.data_parallel` over the mesh's 'data' axis
(global BatchNorm statistics and batch-wide counts, gradients averaged
before the clip, metrics averaged), so N processes take the step one
process takes on the global batch. Parameters and the step generator start
as process 0's; process 0 logs and writes the checkpoints.

Spans (`utils/profiling.py::span`, recorded only while a profiler records):
`train.loss`, `train.backward`, `train.allreduce` (with a data group
only: `parallel/distributed.py::average_gradients`), `train.optimizer` (the
clip and the update) in the step, beside the forward's `raft.forward`;
`train.data`, the wait for each batch, in `train_loop`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.losses.sequence import sequence_loss
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.parallel import distributed
from raft_optical_flow_tpu_torch.train.configs import StageConfig
from raft_optical_flow_tpu_torch.utils.profiling import span

Schedule = Callable[[int], float]


def linear_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    pct_final: float = 0.85,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """optax's `linear_onecycle_schedule`: piecewise-linear interpolation
    between accumulated values at the boundaries int(pct_start*T),
    int(pct_final*T) and T (a later boundary at the same step replaces an
    earlier one, as in optax's dict), constant after T."""
    if transition_steps <= 0:
        raise ValueError("transition_steps must be positive")
    marks = {
        int(pct_start * transition_steps): div_factor,
        int(pct_final * transition_steps): 1.0 / div_factor,
        transition_steps: 1.0 / final_div_factor,
    }
    bounds = [0] + sorted(marks)
    values = [peak_value / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * marks[b])

    def schedule(count: int) -> float:
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return (values[i + 1] - values[i]) * pct + values[i]
        return values[-1]

    return schedule


class AdamW(torch.optim.Optimizer):
    """`optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2, eps,
    weight_decay))` as a torch optimizer over one parameter group; with
    `decoupled=False`, `optax.chain(clip_by_global_norm(clip),
    add_decayed_weights(weight_decay), adam(schedule, b1, b2, eps))`: the
    L2 term weight_decay * param joins the clipped gradient before the
    moments (torch's `Adam(weight_decay=...)`), and no decay follows them.

    `step()` reads the parameters' `.grad` (a missing one counts as zeros, as
    optax sees a zero gradient), leaves them unchanged, updates the
    parameters, and returns the global gradient norm before clipping. The
    update count lives in the param group (`count`), so `state_dict()`
    carries it.
    """

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 clip: float = 1.0, decoupled: bool = True):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                      clip=clip, decoupled=decoupled, count=0))
        if len(self.param_groups) != 1:
            raise ValueError("AdamW clips by the global norm of one parameter group")
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        group = self.param_groups[0]
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: keep if norm < clip, else (g / norm) * clip
        scale = torch.where(norm < group["clip"], torch.ones_like(norm), group["clip"] / norm)
        grads = torch._foreach_mul(grads, scale)

        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        decoupled = group.get("decoupled", True)  # absent from older checkpoints
        if not decoupled:
            torch._foreach_add_(grads, params, alpha=wd)  # add_decayed_weights
        lr = self.schedule(group["count"])  # read before the count moves, as optax
        group["count"] += 1
        count = group["count"]
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(mus, 1 - b1**count)
        nu_hat = torch._foreach_div(nus, 1 - b2**count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu_hat, denom)
        if decoupled:
            torch._foreach_add_(updates, params, alpha=wd)
        torch._foreach_add_(params, updates, alpha=-lr)
        return norm


def make_optimizer(params: Iterable[torch.Tensor], lr: float, wdecay: float, epsilon: float,
                   num_steps: int, clip: float = 1.0) -> AdamW:
    """AdamW + linear one-cycle (pct_start 0.05 of num_steps + 100, div 25,
    final div 1e4) + global-norm clip: the reference RAFT's optimizer."""
    schedule = linear_onecycle_schedule(
        transition_steps=num_steps + 100, peak_value=lr, pct_start=0.05, pct_final=1.0,
        div_factor=25.0, final_div_factor=1e4,
    )
    return AdamW(params, schedule, b1=0.9, b2=0.999, eps=epsilon, weight_decay=wdecay, clip=clip)


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the model, its optimizer, the generator of the
    step's randomness (input noise, dropout) and the step count."""

    model: RAFT
    optimizer: AdamW
    generator: torch.Generator
    step: int = 0


def _merge_matching(base: Dict[str, torch.Tensor], incoming: Dict[str, torch.Tensor]):
    """base with the entries of incoming whose name and shape match (the
    reference's load_state_dict(strict=False))."""
    return {k: incoming[k] if k in incoming and incoming[k].shape == v.shape else v
            for k, v in base.items()}


def create_train_state(config: RAFTConfig, stage: StageConfig,
                       restore_variables: Optional[Dict] = None,
                       device="cuda") -> TrainState:
    """A fresh model (seeded from stage.seed), optionally warm-started from a
    flax variable tree (`utils/weights.py::load_flax_checkpoint`), and its
    optimizer."""
    from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict

    model = RAFT(config, device=device, generator=torch.Generator().manual_seed(stage.seed))
    if restore_variables is not None:
        merged = _merge_matching(model.state_dict(), flax_to_state_dict(restore_variables))
        model.load_state_dict(merged)
    optimizer = make_optimizer(model.parameters(), stage.lr, stage.wdecay, stage.epsilon,
                               stage.num_steps, stage.clip)
    generator = torch.Generator(device=device).manual_seed(stage.seed + 1)
    return TrainState(model=model, optimizer=optimizer, generator=generator)


def raft_train_step(state: TrainState, batch: Dict[str, torch.Tensor], *, iters: int = 12,
                    gamma: float = 0.8, add_noise: bool = False,
                    freeze_bn: bool = True) -> Dict[str, torch.Tensor]:
    """One step. batch: image1/image2 [N, H, W, 3] 0-255, flow [N, H, W, 2],
    valid [N, H, W], on the model's device. BN running statistics update only
    when not freeze_bn. Returns the loss metrics plus `loss` and the global
    gradient norm before clipping, `grad_norm`, as 0-d tensors. Inside
    `distributed.data_parallel` the batch is this process's rows of the
    global batch and the step is the global batch's."""
    model, gen = state.model, state.generator
    image1, image2 = batch["image1"], batch["image2"]
    if add_noise:
        stdv = torch.rand((), generator=gen, device=gen.device) * 5.0

        def noise(img):
            return distributed.local_rows(lambda n: torch.randn(
                (n,) + tuple(img.shape[1:]), generator=gen, device=gen.device), img.shape[0])

        n1, n2 = noise(image1), noise(image2)
        image1 = torch.clamp(image1 + stdv * n1, 0.0, 255.0)
        image2 = torch.clamp(image2 + stdv * n2, 0.0, 255.0)

    state.optimizer.zero_grad(set_to_none=True)
    preds = model(image1, image2, iters=iters, test_mode=False, train=True,
                  freeze_bn=freeze_bn, generator=gen)
    with span("train.loss"):
        loss, metrics = sequence_loss(preds, batch["flow"], batch["valid"], gamma=gamma)
    return finish_step(state, loss, metrics)


def finish_step(state: TrainState, loss: torch.Tensor, metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Backward, the gradients averaged over the data-parallel processes, the
    optimizer step and the count: the step's metrics, detached, with `loss`
    and `grad_norm`, each averaged over the processes (`grad_norm` is
    global already)."""
    with span("train.backward"):
        loss.backward()
    distributed.average_gradients(state.optimizer.param_groups[0]["params"])
    with span("train.optimizer"):
        grad_norm = state.optimizer.step()
    state.step += 1
    out = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return distributed.mean_over_ranks(dict(out, loss=loss.detach(), grad_norm=grad_norm),
                                       keep=("grad_norm",))


def replicate_from_lead(state: TrainState) -> None:
    """Every process takes process 0's model (parameters and buffers) and
    step generator state; a no-op without a process group."""
    if not dist.is_initialized():
        return
    distributed.broadcast_(list(state.model.state_dict().values()), group=dist.group.WORLD)
    gen_state = state.generator.get_state()
    distributed.broadcast_([gen_state], group=dist.group.WORLD)
    state.generator.set_state(gen_state)


class MetricLogger:
    """Running-mean console logger, printing every `freq` steps (the
    reference's `train.py` Logger)."""

    def __init__(self, freq: int = 100, schedule: Optional[Schedule] = None):
        self.freq = freq
        self.schedule = schedule
        self.total_steps = 0
        self.running: Dict[str, float] = {}
        self._t0 = time.time()

    def push(self, metrics: Dict[str, float]) -> None:
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.freq == self.freq - 1:
            means = {k: v / self.freq for k, v in sorted(self.running.items())}
            lr = float(self.schedule(self.total_steps)) if self.schedule else float("nan")
            dt = time.time() - self._t0
            rate = self.freq / dt if dt > 0 else 0.0
            print(f"[{self.total_steps + 1:6d}, {lr:10.7f}] "
                  + ", ".join(f"{k}={v:.4f}" for k, v in means.items())
                  + f"  ({rate:.2f} it/s)")
            self.running = {}
            self._t0 = time.time()


class RAFTTrainer:
    """End-to-end trainer: steps, logging, checkpoints, resume; on one
    device, or data-parallel over the processes of `mesh`.

    With a mesh the trainer runs on the mesh's device for this process
    (`device` is not read), each process starts from process 0's model and
    step generator, and `train_step` takes this process's rows of the
    global batch (`parallel/mesh.py::shard_batch`, or a `FlowDataLoader`
    sharded by the mesh's 'data' coordinate). `val_fn(model) -> {name:
    value}` is an optional validation hook, called every `stage.val_freq`
    steps.
    """

    def __init__(self, stage: StageConfig, config: Optional[RAFTConfig] = None, mesh=None,
                 restore_variables: Optional[Dict] = None, checkpoint_dir: str = "checkpoints",
                 device="cuda"):
        self.stage = stage
        self.config = config or RAFTConfig(
            small=stage.small,
            compute_dtype=torch.bfloat16 if stage.mixed_precision else torch.float32,
        )
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.state = create_train_state(self.config, stage, restore_variables, self.device)
        if mesh is not None:
            replicate_from_lead(self.state)
        self.schedule = self.state.optimizer.schedule
        self.logger = MetricLogger(schedule=self.schedule)

    @property
    def model(self) -> RAFT:
        return self.state.model

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        st = self.stage
        with distributed.data_parallel(data_group(self.mesh)):
            return raft_train_step(self.state, batch, iters=st.iters, gamma=st.gamma,
                                   add_noise=st.add_noise, freeze_bn=st.freeze_bn)

    def run(self, data_iter, num_steps: Optional[int] = None, val_fn=None,
            resume: bool = False) -> TrainState:
        """The reference `train.py` loop (log every 100 steps, checkpoint and
        validate every val_freq), plus full-state latest/best/periodic
        checkpoints for resume (`train_loop`)."""
        st = self.stage
        return train_loop(self, data_iter, num_steps or st.num_steps, st.name, st.val_freq,
                          val_fn, resume)

    def save_checkpoint(self, name: str) -> str:
        """Weights and BN statistics as `<checkpoint_dir>/<name>.npz` in the
        JAX package's flax layout (its `load_flax_checkpoint` reads it)."""
        from raft_optical_flow_tpu_torch.utils.weights import (
            save_flax_checkpoint,
            state_dict_to_flax,
        )

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, f"{name}.npz")
        save_flax_checkpoint(state_dict_to_flax(self.model.state_dict()), path)
        return path


def data_group(mesh):
    """The process group of the mesh's 'data' axis (None: no mesh, or one
    process without `torch.distributed`)."""
    return None if mesh is None else mesh.group("data")


def train_loop(trainer, data_iter, num_steps: int, name: str, val_freq: int, val_fn=None,
               resume: bool = False) -> TrainState:
    """The loop of both trainers: a step on each batch, its metrics logged,
    and every val_freq steps a weights `.npz` (`<name>_<step>.npz`), the
    optional validation (`val_fn(model) -> {name: value}`) and a full-state
    checkpoint (latest, best, periodic, under `<name>_state/`); at the end
    `<name>.npz` and the latest state.

    data_iter is a FlowDataLoader (resume skips its deterministic stream to
    the restored step, and batches are prefetched to the device) or a plain
    iterator of batches (resume reads on from where it stands). With a
    process group, every process steps, validates and restores; process 0
    alone logs and writes, the others wait for its writes, and the metric
    that picks 'best' is process 0's.
    """
    from raft_optical_flow_tpu_torch.data.pipeline import prefetch_to_device
    from raft_optical_flow_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        best_checkpoint_metric,
    )

    group = dist.group.WORLD if trainer.mesh is not None and dist.is_initialized() else None
    lead = distributed.is_lead_host()
    mgr = CheckpointManager(os.path.join(trainer.checkpoint_dir, f"{name}_state"),
                            keep_every=val_freq)
    if resume:
        trainer.state, ok = mgr.restore_latest(trainer.state)
        if ok and lead:
            print(f"resumed from step {trainer.state.step}")
    start = trainer.state.step
    feed = None
    if hasattr(data_iter, "epochs"):
        feed = data_iter = prefetch_to_device(data_iter.epochs(skip_batches=start),
                                              device=trainer.device)
    try:
        for step in range(start, num_steps):
            with span("train.data"):
                batch = next(data_iter)
            metrics = trainer.train_step(batch)
            if lead:
                trainer.logger.push({k: float(v) for k, v in metrics.items()})
            if (step + 1) % val_freq == 0:
                if lead:
                    trainer.save_checkpoint(f"{name}_{step + 1}")
                metric = None
                if val_fn is not None:
                    metric = best_checkpoint_metric(val_fn(trainer.model))
                metric = distributed.broadcast_float(metric, trainer.device, group=group)
                if lead:
                    mgr.save(trainer.state, step + 1, metric)
                distributed.barrier(group)
    finally:
        if feed is not None:
            feed.close()
    if lead:
        trainer.save_checkpoint(name)
        mgr.save(trainer.state, num_steps)
    distributed.barrier(group)
    return trainer.state
