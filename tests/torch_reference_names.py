"""A flax variable tree in the reference PyTorch code's names: the inverse
of `torch_state_dict_to_flax`, with which the conversion tests and
`chip_smoke.py` write reference-named checkpoints. No JAX import.

Flax module paths become dotted names with Sequential indices split back
out (`layer1_0` -> `layer1.0`, `convs_1_2` -> `convs.1.2`); for RAFT,
`downsample_conv`/`downsample_norm` become `downsample.0`/`.1` and the
update block loses its `block` level. Kernels go HWIO -> OIHW, and a
transposed conv's (kh, kw, out / groups, in) -> (in, out / groups, kh, kw),
the same transpose; norm scales become `weight`; batch statistics become
`running_mean`/`running_var`, each with a `num_batches_tracked`.
"""

import re

import numpy as np
import torch

_RAFT_NAMES = {"downsample_conv": "downsample.0", "downsample_norm": "downsample.1"}


def flat_tree(tree, prefix=()):
    """(path tuple, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(path, raft):
    """Flax module path -> the reference's dotted name (Sequential indices
    split back out: `convs_1_2` -> `convs.1.2`)."""
    if raft and path[:2] == ("update_block", "block"):
        path = ("update_block",) + path[2:]
    parts = []
    for seg in path:
        if raft and seg in _RAFT_NAMES:
            parts.append(_RAFT_NAMES[seg])
            continue
        m = re.fullmatch(r"([a-z][a-z0-9_]*?)((?:_\d+)+)", seg)
        parts.append(m.group(1) + m.group(2).replace("_", ".") if m else seg)
    return ".".join(parts)


def reference_state_dict(tree, raft):
    """The flax tree as a reference `state_dict` (torch tensors)."""
    sd = {}
    for path, v in flat_tree(tree.get("params", {})):
        mod, leaf = _module_name(path[:-1], raft), path[-1]
        v = np.asarray(v)
        if leaf == "kernel":  # HWIO -> OIHW; (kh, kw, out/g, in) -> (in, out/g, kh, kw)
            sd[f"{mod}.weight"] = v.transpose(3, 2, 0, 1)
        else:
            sd[f"{mod}.{ {'scale': 'weight', 'bias': 'bias'}[leaf] }"] = v
    for path, v in flat_tree(tree.get("batch_stats", {})):
        mod = _module_name(path[:-1], raft)
        sd[f"{mod}.{ {'mean': 'running_mean', 'var': 'running_var'}[path[-1]] }"] = v
        sd[f"{mod}.num_batches_tracked"] = np.array(7)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
