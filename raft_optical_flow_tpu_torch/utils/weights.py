"""Weights carried across from the JAX package.

The JAX package stores flax variable trees as flat `.npz` files whose keys are
'/'-joined paths, e.g. `params/fnet/conv1/kernel` (HWIO) or
`batch_stats/cnet/norm1/mean`. The port's module names mirror the flax names
(`fnet.layer1_0.conv1`), so the conversion is mechanical:

  - `kernel` (HWIO) -> `weight` (OIHW);
  - norm `scale` -> `weight`, `bias` -> `bias`;
  - BatchNorm `batch_stats` `mean`/`var` -> `running_mean`/`running_var`;
  - the scanned update block's extra level, `update_block/block/...`, is
    dropped: the port runs the block in a plain loop as `update_block`.

`state_dict_to_flax` is the inverse, and `save_flax_checkpoint` writes the
flat `.npz` that the JAX package's `load_flax_checkpoint` reads.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_flax_checkpoint(path: str) -> Dict[str, Any]:
    """Load a flat flax `.npz` into a nested dict of numpy arrays.

    Own copy of `raft_optical_flow_tpu.utils.torch_convert.load_flax_checkpoint`.
    """
    data = np.load(path)
    tree: Dict[str, Any] = {}
    for k in data.files:
        _set_path(tree, tuple(k.split("/")), data[k])
    return tree


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path: Tuple[str, ...]) -> Tuple[str, ...]:
    if path[:2] == ("update_block", "block"):
        return ("update_block",) + path[2:]
    return path


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a flax variable tree (`{'params': ..., 'batch_stats': ...}`,
    numpy or array-like leaves) into the port's `state_dict` (fp32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables.get("params", {})):
        v = np.array(value, np.float32)  # a writable copy
        *mod, leaf = _module_path(path)
        if leaf == "kernel":
            if v.ndim != 4:
                raise ValueError(f"unexpected kernel rank {v.ndim} at {'/'.join(path)}")
            name, v = "weight", v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif leaf == "scale":
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"unhandled parameter {'/'.join(path)}")
        out[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(v))
    for path, value in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = _module_path(path)
        if leaf not in _BN_STATS:
            raise ValueError(f"unhandled batch stat {'/'.join(path)}")
        out[".".join(mod + [_BN_STATS[leaf]])] = torch.from_numpy(np.array(value, np.float32))
    return out


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """`flax_to_state_dict(load_flax_checkpoint(path))`."""
    return flax_to_state_dict(load_flax_checkpoint(path))


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's `state_dict` as a flax variable tree of fp32 numpy arrays:
    `{'params': ..., 'batch_stats': ...}` (no `batch_stats` when the model has
    no BatchNorm), the inverse of `flax_to_state_dict`."""
    stats = {v: k for k, v in _BN_STATS.items()}
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *mod, name = key.split(".")
        if mod[:1] == ["update_block"]:
            mod = ["update_block", "block"] + mod[1:]
        v = value.detach().cpu().float().numpy()
        if name in stats:
            _set_path(tree, ("batch_stats", *mod, stats[name]), v)
        elif name == "weight" and v.ndim == 4:
            _set_path(tree, ("params", *mod, "kernel"), np.ascontiguousarray(v.transpose(2, 3, 1, 0)))
        elif name == "weight" and v.ndim == 1:
            _set_path(tree, ("params", *mod, "scale"), v)
        elif name == "bias":
            _set_path(tree, ("params", *mod, "bias"), v)
        else:
            raise ValueError(f"unhandled state_dict entry {key} {tuple(v.shape)}")
    return tree


def save_flax_checkpoint(variables: Mapping[str, Any], path: str) -> None:
    """Write a flax variable tree as a flat `.npz` ('/'-joined keys).

    Own copy of `raft_optical_flow_tpu.utils.torch_convert.save_flax_checkpoint`.
    """
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in _flatten(variables)})
