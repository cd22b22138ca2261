"""Reference PyTorch checkpoints (`.pth`, Lightning `.ckpt`) into the port.

Counterpart of `raft_optical_flow_tpu/utils/torch_convert.py`, with its own
copy of the name mapping from the reference's `state_dict` to the flax
variable tree:

  - `module.` / `model.` prefixes stripped (DataParallel, Lightning);
    Lightning's `{'state_dict': ...}` unwrapped;
  - Sequential indices flattened: `layer1.0.` -> `layer1_0/`;
  - conv weights OIHW -> HWIO; ConvTranspose weights (in, out / groups,
    kh, kw) -> (kh, kw, out / groups, in), the same transpose;
  - BatchNorm: weight/bias -> params scale/bias, running_mean/var ->
    batch_stats mean/var; `num_batches_tracked` dropped.

The tree then goes through `utils/weights.py::flax_to_state_dict`, the one
path from flax names to the port's modules, whose HWIO -> OIHW transpose
undoes the one above (a deconv comes back as (in, out / groups, kh, kw)).
`convert_raft_checkpoint` and `convert_lfn3_checkpoint` return a
`state_dict` that `RAFT` and `LiteFlowNet3` load with `strict=True`.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_optical_flow_tpu_torch.utils.weights import _set_path, flax_to_state_dict


def _flatten_name(name: str) -> str:
    """'layer1.0.conv1' -> 'layer1_0/conv1': numeric Sequential indices join
    their parent's name."""
    out: List[str] = []
    for p in name.split("."):
        if re.fullmatch(r"\d+", p) and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return "/".join(out)


def torch_state_dict_to_flax(state_dict: Mapping[str, Any],
                             rename: Optional[Callable[[str], Optional[str]]] = None
                             ) -> Dict[str, Any]:
    """A reference `state_dict` (tensors or arrays) as a flax variable tree
    `{'params': ..., 'batch_stats': ...}` of numpy arrays.

    rename: applied to each flattened module path ('/'-joined); None drops
    the entry. A deconv weight takes the same transpose as a conv weight
    (the JAX package's `deconv_names` selects nothing else, so there is
    none here).
    """
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    items = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        items[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
    bn_modules = {k.rsplit(".", 1)[0] for k in items if k.endswith("running_mean")}

    for k, v in items.items():
        if k.endswith("num_batches_tracked"):
            continue
        mod, leaf = k.rsplit(".", 1)
        flat_mod = _flatten_name(mod)
        if rename is not None:
            flat_mod = rename(flat_mod)
        if flat_mod is None:
            continue
        path = tuple(flat_mod.split("/"))
        if mod in bn_modules:
            slot = {"weight": (params, "scale"), "bias": (params, "bias"),
                    "running_mean": (batch_stats, "mean"),
                    "running_var": (batch_stats, "var")}.get(leaf)
            if slot is not None:
                _set_path(slot[0], path + (slot[1],), v)
        elif leaf == "weight" and v.ndim == 4:
            _set_path(params, path + ("kernel",), v.transpose(2, 3, 1, 0))
        elif leaf == "weight" and v.ndim == 1:  # an affine norm without running stats
            _set_path(params, path + ("scale",), v)
        elif leaf == "weight" and v.ndim == 2:
            _set_path(params, path + ("kernel",), v.T)
        elif leaf == "bias":
            _set_path(params, path + ("bias",), v)
        else:
            raise ValueError(f"unhandled entry {k} {v.shape}")
    out: Dict[str, Any] = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def _raft_rename(flat: str) -> str:
    """RAFT's names in the flax tree: `downsample.0/.1` become the named conv
    and norm, and the update block nests one level deeper
    (`update_block/block/...`, the JAX package's scanned block)."""
    flat = flat.replace("downsample_0", "downsample_conv")
    flat = flat.replace("downsample_1", "downsample_norm")
    if flat.startswith("update_block/"):
        flat = "update_block/block/" + flat[len("update_block/"):]
    return flat


def _unwrap(sd: Any, keys: Tuple[str, ...]) -> Mapping[str, Any]:
    for key in keys:
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            return sd[key]
    return sd


def convert_raft_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference RAFT `.pth` as the port's `RAFT` state_dict (fp32 CPU)."""
    sd = _unwrap(torch.load(path, map_location="cpu", weights_only=True), ("model",))
    return flax_to_state_dict(torch_state_dict_to_flax(sd, rename=_raft_rename))


def convert_lfn3_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A LiteFlowNet3 `.pth` or Lightning `.ckpt` (`{'state_dict': ...}`,
    `model.` prefixes) as the port's `LiteFlowNet3` state_dict (fp32 CPU);
    the module names mirror the reference's, so nothing is renamed.

    Only tensors, containers and numbers are unpickled (`weights_only`): a
    Lightning file whose hyperparameters hold other objects is refused
    rather than run.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return flax_to_state_dict(torch_state_dict_to_flax(
        _unwrap(sd, ("state_dict", "model_state_dict", "model"))))


def check_checkpoint_compat(variables: Mapping[str, Any], reference: Mapping[str, Any]):
    """Key and shape report between two flax variable trees: (missing,
    unexpected, shape_mismatches), sorted lists of '/'-joined paths."""

    def flatten(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                out.update(flatten(v, p))
            else:
                out[p] = tuple(np.shape(v))
        return out

    a, b = flatten(variables), flatten(reference)
    missing = sorted(set(b) - set(a))
    unexpected = sorted(set(a) - set(b))
    mismatched = sorted(k for k in set(a) & set(b) if a[k] != b[k])
    return missing, unexpected, mismatched
