"""Full train-state checkpoints: latest / best / periodic, and resume.

Counterpart of `raft_optical_flow_tpu/utils/checkpoint.py` over `torch.save`
instead of orbax. A train state (`train/trainer.py::TrainState`) is saved as
one file per tag, `<directory>/<tag>.pt`, holding {step, model, optimizer,
generator, extra}: the model's and optimizer's `state_dict`s and the step
generator's state, so a resumed run continues bit for bit. Tags are
'latest', 'best' and 'step_%08d'. Weights-only `.npz` files in the JAX
package's flax layout are `utils/weights.py`'s.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

#: Validator keys that are end-point errors (lower is better). Validators also
#: return 1px/3px/5px accuracies and KITTI F1 (higher is better), so "best"
#: never takes a bare min over all values.
EPE_KEYS = ("chairs", "clean", "final", "kitti-epe", "epe", "loss")


def best_checkpoint_metric(results: Dict[str, float]) -> Optional[float]:
    """The lower-is-better scalar that picks 'best' checkpoints: the min over
    the EPE-style entries of a validator's results, None if there is none."""
    vals = [float(v) for k, v in results.items() if k in EPE_KEYS or k.endswith("epe")]
    return min(vals) if vals else None


def _path(directory: str, tag: str) -> str:
    return os.path.join(directory, f"{tag}.pt")


def save_train_state(directory: str, tag: str, state, extra: Optional[Dict] = None) -> str:
    """Save {step, model, optimizer, generator, extra} of `state` under `tag`;
    the file is replaced atomically."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, tag)
    payload = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "extra": extra or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(directory: str, tag: str, state):
    """Load the tag's file into `state` (model, optimizer, generator, step, on
    their own devices); returns `state`."""
    payload = torch.load(_path(directory, tag), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state


def latest_tag(directory: str) -> Optional[str]:
    """'latest' if it exists, else the newest periodic tag, else None."""
    if not os.path.isdir(directory):
        return None
    if os.path.exists(_path(directory, "latest")):
        return "latest"
    steps = [
        (int(name[5:-3]), name[:-3])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.endswith(".pt") and name[5:-3].isdigit()
    ]
    return max(steps)[1] if steps else None


class CheckpointManager:
    """The latest/best/periodic policy of the reference's richer trainers.

    The best metric is kept in `<directory>/best.json`, so a resumed run does
    not overwrite the best checkpoint with a worse model at its first
    validation.
    """

    def __init__(self, directory: str, keep_every: int = 5000):
        self.directory = directory
        self.keep_every = keep_every
        self.best_metric = self._load_best_metric()

    def _best_path(self) -> str:
        return os.path.join(self.directory, "best.json")

    def _load_best_metric(self) -> float:
        try:
            with open(self._best_path()) as f:
                return float(json.load(f)["best_metric"])
        except (OSError, ValueError, KeyError):
            return float("inf")

    def save(self, state, step: int, metric: Optional[float] = None, extra=None) -> None:
        save_train_state(self.directory, "latest", state, extra)
        if step % self.keep_every == 0:
            save_train_state(self.directory, f"step_{step:08d}", state, extra)
        if metric is not None and metric < self.best_metric:
            self.best_metric = metric
            save_train_state(self.directory, "best", state, extra)
            with open(self._best_path(), "w") as f:
                json.dump({"best_metric": metric, "step": step}, f)

    def restore_latest(self, state):
        """(state, True) restored from the latest tag, or (state, False)."""
        tag = latest_tag(self.directory)
        if tag is None:
            return state, False
        return restore_train_state(self.directory, tag, state), True
