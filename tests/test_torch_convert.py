"""Reference-named PyTorch checkpoints converted straight into the port
(`utils/torch_convert.py`), against the JAX package's conversion.

The test writes each `.pth` itself, from a flax `.npz` tree, in the
reference's names: `module.` prefixes (RAFT) or a Lightning wrapper with
`model.` prefixes (LiteFlowNet3), Sequential indices (`layer1.0`,
`convs.1.2`, `downsample.0`), OIHW conv weights, (in, out / groups, kh, kw)
deconv weights, BatchNorm running statistics and `num_batches_tracked`.

  - The JAX package's conversion of that file gives back the `.npz` tree
    exactly: the test's inverse is right.
  - The port's conversion loads `strict=True`, and the model's CPU forward
    equals the `.npz` model's (`utils/weights.py::load_flax_npz`) bit for
    bit: RAFT-small from `checkpoints/raft_small.npz` and RAFT-standard
    (seeded, BatchNorm in its context encoder) at 2 iterations, LiteFlowNet3
    from `tests/goldens/lfn3_standard_params.npz`.
  - `check_checkpoint_compat` reports the same missing, unexpected and
    mismatched lists as the JAX one.
"""

import os
import re

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.utils import torch_convert as jconvert
from raft_optical_flow_tpu_torch.models import RAFT, LFN3Config, LiteFlowNet3, RAFTConfig
from raft_optical_flow_tpu_torch.utils import torch_convert as tconvert
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_checkpoint,
    state_dict_to_flax,
)
from torch_reference_names import flat_tree, reference_state_dict
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFT_SMALL = os.path.join(REPO, "checkpoints", "raft_small.npz")
LFN3 = os.path.join(REPO, "tests", "goldens", "lfn3_standard_params.npz")


def _assert_trees_equal(got, want):
    got, want = dict(flat_tree(got)), dict(flat_tree(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def _frames(H=64, W=96, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(1, H + 4, W + 4, 3)).astype(np.float32)
    return (torch.from_numpy(base[:, :H, :W].copy()),
            torch.from_numpy(base[:, 2:H + 2, 3:W + 3].copy()))


@pytest.fixture(scope="module")
def standard_tree():
    model = RAFT(RAFTConfig(small=False), device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # running statistics that are not the init's
        for name, buf in model.named_buffers():
            if "running_mean" in name:
                buf.uniform_(-0.5, 0.5)
            elif "running_var" in name:
                buf.uniform_(0.5, 2.0)
    return state_dict_to_flax(model.state_dict())


@pytest.mark.parametrize("small", [True, False], ids=["raft_small", "raft_standard"])
def test_raft_pth_converts_bit_for_bit(tmp_path, small, standard_tree):
    tree = load_flax_checkpoint(RAFT_SMALL) if small else standard_tree
    sd = reference_state_dict(tree, raft=True)
    assert any(re.search(r"\.layer1\.0\.", k) for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd) != small
    path = str(tmp_path / "raft.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    _assert_trees_equal(jconvert.convert_raft_checkpoint(path), tree)

    cfg = RAFTConfig(small=small)
    converted = RAFT(cfg, device="cpu")
    converted.load_state_dict(tconvert.convert_raft_checkpoint(path), strict=True)
    reference = RAFT(cfg, device="cpu")
    reference.load_state_dict(flax_to_state_dict(tree), strict=True)
    a, b = _frames()
    got = converted(a, b, iters=2)
    want = reference(a, b, iters=2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lfn3_lightning_ckpt_converts_bit_for_bit(tmp_path):
    tree = load_flax_checkpoint(LFN3)
    sd = reference_state_dict(tree, raft=False)
    assert "matching_nets.1.up_flow.weight" in sd and "feature_net.convs.1.2.weight" in sd
    # the grouped deconv in torch's layout (in, out / groups, kh, kw)
    assert tuple(sd["matching_nets.1.up_flow.weight"].shape) == (2, 1, 4, 4)
    path = str(tmp_path / "lfn3.ckpt")
    torch.save({"epoch": 3, "global_step": 100, "hyper_parameters": {"lr": 1e-4},
                "state_dict": {"model." + k: v for k, v in sd.items()}}, path)
    _assert_trees_equal(jconvert.convert_lfn3_checkpoint(path), tree)

    converted = LiteFlowNet3(LFN3Config(), device="cpu")
    converted.load_state_dict(tconvert.convert_lfn3_checkpoint(path), strict=True)
    up = converted.matching_nets_1.up_flow.weight
    np.testing.assert_array_equal(up.detach().numpy(),
                                  sd["matching_nets.1.up_flow.weight"].numpy())
    reference = LiteFlowNet3(LFN3Config(), device="cpu")
    reference.load_state_dict(flax_to_state_dict(tree), strict=True)
    a, b = _frames(48, 64, seed=4)
    images = torch.stack([a, b], dim=1) / 255.0
    got, want = converted(images), reference(images)
    assert torch.equal(got["flows"], want["flows"]) and torch.equal(got["confs"], want["confs"])


def test_torch_state_dict_to_flax_matches_jax(standard_tree):
    sd = {"module." + k: v for k, v in reference_state_dict(standard_tree, raft=True).items()}
    _assert_trees_equal(tconvert.torch_state_dict_to_flax(sd, rename=tconvert._raft_rename),
                        jconvert.torch_state_dict_to_flax(sd, rename=jconvert._raft_rename))


def test_check_checkpoint_compat_matches_jax():
    ref = load_flax_checkpoint(LFN3)
    tree = load_flax_checkpoint(LFN3)
    del tree["params"]["matching_nets_0"]["flow_net_0"]["bias"]
    tree["params"]["feature_net"]["convs_0_0"]["kernel"] = np.zeros((3, 3, 3, 5), np.float32)
    tree["params"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    got = tconvert.check_checkpoint_compat(tree, ref)
    assert got == jconvert.check_checkpoint_compat(tree, ref)
    missing, unexpected, mismatched = got
    assert missing == ["params/matching_nets_0/flow_net_0/bias"]
    assert unexpected == ["params/extra/kernel"]
    assert mismatched == ["params/feature_net/convs_0_0/kernel"]
