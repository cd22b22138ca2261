"""Trainers of the LiteFlowNet3, SimpleFlowNet and IFNet families
(supervised and unsupervised) and RAFT-small's UFlow step, on one device.

Counterpart of `raft_optical_flow_tpu/train/trainers.py`:

  - `OptimConfig` and `make_step_optimizer`: the reference's non-RAFT
    optimizer family, a global-norm clip, then AdamW (SimpleFlowNet,
    IFNet) or Adam with an L2 term (LiteFlowNet3), over a StepLR schedule,
    optax's `exponential_decay(staircase=True)` read at the update count
    before the update (`train/trainer.py::AdamW`);
  - the step functions, one optimizer step each: `lfn3_train_step` and
    `lfn3_unsup_train_step` (forward and backward passes,
    `unsupervised_loss` on the five-level pyramid),
    `simple_flow_train_step` and `simple_flow_unsup_train_step` (BatchNorm
    in training mode: the running statistics update in place, the
    backward pass's after the forward pass's, as flax's mutable
    `batch_stats` chain), `ifnet_train_step` (flow[..., 2:4] through
    `simple_flow_loss`, or `laploss`), and `uflow_unsup_train_step`
    (RAFT-small, the UFlow losses, SMURF's sequence weighting and the
    teacher-student self-supervision);
  - `FlowTrainer`: the step, logging, weights `.npz` files in the JAX
    package's flax layout and full-state latest/best/periodic checkpoints.

Each step takes the train state (`train/trainer.py::TrainState`) and a
batch of tensors on the model's device (images 0-255 [B, H, W, 3], flow
[B, H, W, 2], valid [B, H, W]), updates the model, its optimizer and the
step count in place, and returns its metrics as 0-d tensors, with `loss`
and the global gradient norm before clipping, `grad_norm`.

Mesh/SPMD data parallelism is not ported yet (ROADMAP.md Queue 1 item 16):
the trainer drives one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from raft_optical_flow_tpu_torch.losses import uflow
from raft_optical_flow_tpu_torch.losses.laploss import laploss
from raft_optical_flow_tpu_torch.losses.sequence import multiscale_sequence_loss
from raft_optical_flow_tpu_torch.losses.simple_flow_loss import simple_flow_loss
from raft_optical_flow_tpu_torch.losses.unsupervised import unsupervised_loss
from raft_optical_flow_tpu_torch.models.ifnet import IFNet
from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.models.simple_flow import SimpleFlowConfig, SimpleFlowNet
from raft_optical_flow_tpu_torch.train.trainer import AdamW, MetricLogger, TrainState


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam/AdamW + StepLR, the reference's non-RAFT optimizer family."""

    lr: float = 1e-4
    weight_decay: float = 1e-4
    adamw: bool = True  # the reference: AdamW for simple_flow and ifnet, Adam for lfn3
    step_size: int = 10_000  # StepLR period in steps
    lr_gamma: float = 0.5
    clip: float = 1.0


def step_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """optax's `exponential_decay(lr, step_size, lr_gamma, staircase=True)`:
    lr * gamma^floor(count / step_size), in fp32 as optax computes it."""

    def schedule(count: int) -> float:
        k = np.float32(count // cfg.step_size)
        return float(np.float32(cfg.lr) * np.power(np.float32(cfg.lr_gamma), k))

    return schedule


def make_step_optimizer(params, cfg: OptimConfig) -> AdamW:
    """The clip, then AdamW (decoupled decay) or Adam with the L2 term added
    after the clip and before the moments, over `step_lr_schedule`."""
    return AdamW(params, step_lr_schedule(cfg), weight_decay=cfg.weight_decay, clip=cfg.clip,
                 decoupled=cfg.adamw)


def _finish(state: TrainState, loss: torch.Tensor, metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Backward, optimizer step, count: the step's metrics, detached, with
    `loss` and `grad_norm`."""
    loss.backward()
    grad_norm = state.optimizer.step()
    state.step += 1
    out = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return dict(out, loss=loss.detach(), grad_norm=grad_norm)


def _masked_epe(flow, gt, valid) -> torch.Tensor:
    epe = torch.sqrt(torch.sum((flow - gt) ** 2, dim=-1))
    return torch.sum(epe * valid) / torch.clamp(torch.sum(valid), min=1.0)


# ----------------------------------------------------------------- train steps


def lfn3_supervised_loss(model: LiteFlowNet3, images, flow, valid):
    """LFN3's supervised loss, multi-scale L1 on [the full-size flow] + the
    levels finest first, times div_flow (`train/trainers.py:83-86` of the
    JAX package). images [B, 2, H, W, 3] in [0, 1]: (loss, the model's
    output)."""
    out = model(images, training=True)
    div_flow = model.config.div_flow
    preds = [out["flows"][:, 0]] + [p * div_flow for p in reversed(out["flow_preds"])]
    return multiscale_sequence_loss(preds, flow, valid), out


def lfn3_train_step(state: TrainState, batch, *, config: LFN3Config):
    """Supervised LFN3 step, `lfn3_supervised_loss`; `epe` of the full-size
    flow."""
    images = torch.stack([batch["image1"], batch["image2"]], dim=1) / 255.0
    state.optimizer.zero_grad(set_to_none=True)
    loss, out = lfn3_supervised_loss(state.model, images, batch["flow"], batch["valid"])
    with torch.no_grad():
        metrics = {"epe": _masked_epe(out["flows"][:, 0], batch["flow"], batch["valid"])}
    return _finish(state, loss, metrics)


def lfn3_unsup_train_step(state: TrainState, batch, *, config: LFN3Config):
    """Unsupervised LFN3: forward and backward passes, `unsupervised_loss`
    on the five-level pyramid (scale weights 0.32 .. 0.005)."""
    model = state.model
    img1 = batch["image1"] / 255.0
    img2 = batch["image2"] / 255.0

    def run(a, b):
        out = model(torch.stack([a, b], dim=1), training=True)
        return [out["flows"][:, 0]] + [p * config.div_flow for p in reversed(out["flow_preds"])]

    state.optimizer.zero_grad(set_to_none=True)
    preds_fw = run(img1, img2)
    preds_bw = run(img2, img1)
    loss, metrics = unsupervised_loss(img1, img2, preds_fw, preds_bw,
                                      scale_weights=(0.32, 0.08, 0.02, 0.01, 0.005))
    return _finish(state, loss, metrics)


def simple_flow_train_step(state: TrainState, batch, *, config: SimpleFlowConfig):
    """Supervised SimpleFlowNet step, BatchNorm in training mode."""
    img1 = batch["image1"] / 255.0
    img2 = batch["image2"] / 255.0
    state.optimizer.zero_grad(set_to_none=True)
    preds = state.model(img1, img2, train=True)
    loss, metrics = simple_flow_loss(preds, batch["flow"], batch["valid"], img1)
    return _finish(state, loss, metrics)


def simple_flow_unsup_train_step(state: TrainState, batch, *, config: SimpleFlowConfig):
    """Unsupervised SimpleFlowNet: forward and backward passes, the running
    statistics chained through both; `unsupervised_loss`."""
    img1 = batch["image1"] / 255.0
    img2 = batch["image2"] / 255.0
    state.optimizer.zero_grad(set_to_none=True)
    preds_fw = state.model(img1, img2, train=True)
    preds_bw = state.model(img2, img1, train=True)
    loss, metrics = unsupervised_loss(img1, img2, preds_fw, preds_bw)
    return _finish(state, loss, metrics)


def ifnet_train_step(state: TrainState, batch, *, unsupervised: bool = False):
    """IFNet step: supervised, flow[..., 2:4] of every block (the img1 ->
    img0 direction) through `simple_flow_loss`; unsupervised, `laploss` on
    the warped images."""
    img1 = batch["image1"] / 255.0
    img2 = batch["image2"] / 255.0
    state.optimizer.zero_grad(set_to_none=True)
    flow_list, _, warped_list = state.model(img1, img2, train=True)
    if unsupervised:
        loss, metrics = laploss(warped_list, img1, img2)
    else:
        preds = [f[..., 2:4] for f in flow_list]
        loss, metrics = simple_flow_loss(preds, batch["flow"], batch["valid"], img1)
    return _finish(state, loss, metrics)


UFLOW_WEIGHTS = {"census": 1.0, "smooth2": 2.0, "edge_constant": 150.0, "selfsup": 0.3}


def uflow_unsup_train_step(
    state: TrainState,
    batch,
    *,
    config: Optional[RAFTConfig] = None,
    weights: Optional[Dict[str, float]] = None,
    selfsup_crop: int = 8,
    iters: int = 4,
    occlusion_estimation: str = "wang",
    occlusion_warmup_steps: int = 100,
    selfsup_ramp_steps: int = 400,
    sequence_gamma: float = 0.8,
):
    """UFlow's unsupervised step on RAFT-small: census + edge-aware smooth2 +
    self-supervision (`losses/uflow.py`), RAFT in training mode.

    The teacher flows are the full-frame passes with stopped gradients; the
    student re-runs the model on a border crop of `selfsup_crop` pixels, and
    the teacher's flow, cropped into the student's frame, supervises it
    where forward-backward consistency says the teacher is reliable. The
    occlusion masks switch on at step `occlusion_warmup_steps` (all pixels
    visible before), and the self-supervision weight ramps from 0 to
    weights['selfsup'] over `selfsup_ramp_steps` after that; without a
    'selfsup' weight the student passes are skipped (2 model runs, not 4).
    With `sequence_gamma` > 0 every GRU iteration's flow takes the loss,
    weighted gamma^(n-1-i) and normalized (SMURF's sequence loss), the
    self-supervision term (final iteration only) outside the normalized
    sum. RAFT emits (dx, dy); the losses take UFlow's (dy, dx), flipped here.
    `epe` (monitoring) when the batch has a flow.
    """
    weights = weights or UFLOW_WEIGHTS
    use_selfsup = float(weights.get("selfsup", 0.0)) != 0.0
    model = state.model
    img1, img2 = batch["image1"], batch["image2"]  # 0-255, RAFT's convention
    c = selfsup_crop
    if c % 4:
        raise ValueError(f"selfsup_crop={c} must divide the 3-level pyramid (a multiple of 4)")
    transforms = uflow.selfsup_crop_transforms(c, c) if use_selfsup else None

    def pyramid(flow):
        _, H, W, _ = flow.shape
        return [flow, uflow.resize(flow, H // 2, W // 2, is_flow=True),
                uflow.resize(flow, H // 4, W // 4, is_flow=True)]

    def run_all(a, b):
        preds = model(a, b, iters=iters, test_mode=False, train=True, generator=state.generator)
        return [p.flip(-1) for p in preds]

    state.optimizer.zero_grad(set_to_none=True)
    fw_list, bw_list = run_all(img1, img2), run_all(img2, img1)
    images = {0: img1 / 255.0, 1: img2 / 255.0}
    occ_on = state.step >= occlusion_warmup_steps
    ramp = np.clip(np.float32(state.step - occlusion_warmup_steps)
                   / np.float32(max(selfsup_ramp_steps, 1)), 0.0, 1.0)

    selfsup_flows = None
    if use_selfsup:
        img1_crop, img2_crop = img1[:, c:-c, c:-c], img2[:, c:-c, c:-c]
        selfsup_flows = {
            (0, 1, "transformed-student"): pyramid(run_all(img1_crop, img2_crop)[-1]),
            (1, 0, "transformed-student"): pyramid(run_all(img2_crop, img1_crop)[-1]),
        }

    def iteration_losses(fw, bw, selfsup):
        flows = {(0, 1, "augmented-student"): pyramid(fw), (1, 0, "augmented-student"): pyramid(bw)}
        flows[(0, 1, "original-teacher")] = [x.detach() for x in flows[(0, 1, "augmented-student")]]
        flows[(1, 0, "original-teacher")] = [x.detach() for x in flows[(1, 0, "augmented-student")]]
        if selfsup is not None:
            flows.update(selfsup)
        warps, valid_masks, _, occ_masks, fb_sq_diff, fb_sum_sq = (
            uflow.compute_warps_and_occlusion(flows, occlusion_estimation))
        if not occ_on:
            occ_masks = {k: [torch.ones_like(m) for m in v] for k, v in occ_masks.items()}
        aug_warps = {k: v for k, v in warps.items() if k[2] == "augmented-student"}
        warped_images = uflow.apply_warps_stop_grad(images, aug_warps, level=0)
        step_weights = dict(weights)
        if selfsup is not None:
            step_weights["selfsup"] = float(np.float32(weights["selfsup"]) * ramp)
        else:
            step_weights.pop("selfsup", None)
        return uflow.compute_loss(step_weights, images, flows, warps, valid_masks, occ_masks,
                                  fb_sq_diff, fb_sum_sq, warped_images,
                                  selfsup_transform_fns=transforms if selfsup is not None else None)

    if sequence_gamma:
        n = len(fw_list)
        ws = [sequence_gamma ** (n - 1 - i) for i in range(n)]
        total_w = sum(ws)
        total = 0.0
        for i, (fw_i, bw_i) in enumerate(zip(fw_list, bw_list)):
            it = iteration_losses(fw_i, bw_i, selfsup_flows if i == n - 1 else None)
            # the selfsup term stays outside the normalized sum, so that
            # weights['selfsup'] * ramp is its effective weight
            total = total + (ws[i] / total_w) * (it["total"] - it.get("selfsup", 0.0))
            if i == n - 1:
                losses = dict(it)
                total = total + it.get("selfsup", 0.0)
        losses["total"] = total
    else:
        losses = iteration_losses(fw_list[-1], bw_list[-1], selfsup_flows)

    metrics = {k: v for k, v in losses.items() if k != "total"}
    if "flow" in batch:
        with torch.no_grad():
            fw = fw_list[-1].flip(-1)
            epe = torch.sqrt(torch.sum((fw - batch["flow"]) ** 2, dim=-1))
            vmask = batch.get("valid", torch.ones_like(epe))
            metrics["epe"] = torch.sum(epe * vmask) / torch.clamp(torch.sum(vmask), min=1.0)
    return _finish(state, losses["total"], metrics)


# ------------------------------------------------------------------ the trainer


def _model(base: str, config, device, generator: torch.Generator):
    if base == "lfn3":
        return LiteFlowNet3(config, device=device, generator=generator)
    if base == "simple_flow":
        return SimpleFlowNet(config, device=device, generator=generator)
    if base == "raft_uflow":
        return RAFT(config, device=device, generator=generator)
    return IFNet(device=device, generator=generator)


class FlowTrainer:
    """One-device trainer: the kind's step, logging, weights `.npz` files and
    full-state checkpoints.

    model_kind in STEP_FNS: 'lfn3', 'lfn3_unsup', 'simple_flow',
    'simple_flow_unsup', 'ifnet', 'ifnet_unsup', 'raft_uflow_unsup'.
    The model is initialized from `generator` (default: seeded with
    `seed`), or from a flax variable tree (`restore_variables`, as
    `utils/weights.py::load_flax_checkpoint` returns it), on `device` (the
    card by default). `step_kwargs` are the step's static knobs (the UFlow
    schedules). `image_size` is the JAX trainer's init shape; the port's
    models need none.
    """

    STEP_FNS: Dict[str, Callable] = {
        "lfn3": lfn3_train_step,
        "lfn3_unsup": lfn3_unsup_train_step,
        "simple_flow": simple_flow_train_step,
        "simple_flow_unsup": simple_flow_unsup_train_step,
        "ifnet": lambda s, b, config=None: ifnet_train_step(s, b, unsupervised=False),
        "ifnet_unsup": lambda s, b, config=None: ifnet_train_step(s, b, unsupervised=True),
        "raft_uflow_unsup": lambda s, b, config=None, **kw: uflow_unsup_train_step(
            s, b, config=config, **kw),
    }

    def __init__(
        self,
        model_kind: str,
        image_size: Tuple[int, int],
        model_config: Any = None,
        optim: Optional[OptimConfig] = None,
        mesh=None,
        seed: int = 1234,
        restore_variables: Optional[Dict] = None,
        checkpoint_dir: str = "checkpoints",
        step_kwargs: Optional[Dict[str, Any]] = None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict

        if model_kind not in self.STEP_FNS:
            raise ValueError(f"unknown model_kind {model_kind!r}")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md Queue 1 item 16, parallel): "
                "FlowTrainer drives one device")
        self.model_kind = model_kind
        self.image_size = tuple(image_size)
        base = model_kind.replace("_unsup", "")
        if model_config is None:
            model_config = {"lfn3": LFN3Config(), "simple_flow": SimpleFlowConfig(), "ifnet": None,
                            "raft_uflow": RAFTConfig(small=True)}[base]
        self.model_config = model_config
        self.optim = optim or OptimConfig(adamw=(base != "lfn3"))
        self.device = torch.device(device)
        self.checkpoint_dir = checkpoint_dir
        self.step_kwargs = dict(step_kwargs or {})

        generator = generator if generator is not None else torch.Generator().manual_seed(seed)
        model = _model(base, model_config, self.device, generator)
        if restore_variables is not None:
            sd = model.state_dict()
            restored = flax_to_state_dict(restore_variables)
            unknown = sorted(set(restored) - set(sd))
            if unknown:
                raise ValueError(f"restore_variables has entries the model lacks: {unknown[:5]}")
            sd.update(restored)
            model.load_state_dict(sd)
        optimizer = make_step_optimizer(model.parameters(), self.optim)
        self.state = TrainState(model=model, optimizer=optimizer,
                                generator=torch.Generator(device=self.device).manual_seed(seed + 1))
        self.schedule = optimizer.schedule
        self.logger = MetricLogger(schedule=self.schedule)
        self._step_fn = self.STEP_FNS[model_kind]

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch of arrays or tensors (moved to the
        trainer's device): the step's metrics as 0-d tensors."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        return self._step_fn(self.state, batch, config=self.model_config, **self.step_kwargs)

    @property
    def variables(self) -> Dict[str, Any]:
        """The model as a flax variable tree of numpy arrays."""
        from raft_optical_flow_tpu_torch.utils.weights import state_dict_to_flax

        return state_dict_to_flax(self.model.state_dict())

    def run(self, data_iter, num_steps: int, val_fn=None, val_freq: int = 5000,
            resume: bool = False) -> TrainState:
        """The loop: log every step's metrics, and every val_freq steps a
        weights `.npz` (`<kind>_<step>.npz`), the optional validation
        (`val_fn(model) -> {name: value}`) and a full-state checkpoint
        (latest, best, periodic); at the end `<kind>.npz` and the latest
        state. data_iter is a `FlowDataLoader` (resume skips its stream to
        the restored step, batches prefetched to the device) or a plain
        iterator of batches."""
        from raft_optical_flow_tpu_torch.data.pipeline import prefetch_to_device
        from raft_optical_flow_tpu_torch.utils.checkpoint import (
            CheckpointManager,
            best_checkpoint_metric,
        )

        mgr = CheckpointManager(os.path.join(self.checkpoint_dir, f"{self.model_kind}_state"),
                                keep_every=val_freq)
        if resume:
            self.state, ok = mgr.restore_latest(self.state)
            if ok:
                print(f"resumed from step {self.state.step}")
        start = self.state.step
        feed = None
        if hasattr(data_iter, "epochs"):
            feed = data_iter = prefetch_to_device(data_iter.epochs(skip_batches=start),
                                                  device=self.device)
        try:
            for step in range(start, num_steps):
                metrics = self.train_step(next(data_iter))
                self.logger.push({k: float(v) for k, v in metrics.items()})
                if (step + 1) % val_freq == 0:
                    self.save_checkpoint(f"{self.model_kind}_{step + 1}")
                    metric = None
                    if val_fn is not None:
                        metric = best_checkpoint_metric(val_fn(self.model))
                    mgr.save(self.state, step + 1, metric)
        finally:
            if feed is not None:
                feed.close()
        self.save_checkpoint(self.model_kind)
        mgr.save(self.state, num_steps)
        return self.state

    def save_checkpoint(self, name: str) -> str:
        """The model's weights (and BatchNorm statistics) as
        `<checkpoint_dir>/<name>.npz` in the JAX package's flax layout."""
        from raft_optical_flow_tpu_torch.utils.weights import save_flax_checkpoint

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir, f"{name}.npz")
        save_flax_checkpoint(self.variables, path)
        return path
