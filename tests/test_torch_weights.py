"""Weights carried across from the JAX package into the PyTorch port.

Every key of a flax variable tree (the RAFT-small checkpoint, and a
RAFT-standard `init` from JAX with its BatchNorm `batch_stats`) must map onto
exactly one entry of the port's `state_dict`, with nothing left over on either
side and every shape matching. Values are moved exactly (HWIO -> OIHW).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_checkpoint,
    load_flax_npz,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(REPO, "checkpoints", "raft_small.npz")


def _flat_keys(tree, prefix=""):
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out += _flat_keys(v, p) if isinstance(v, dict) else [p]
    return out


def _assert_exact_mapping(sd, model):
    ref = model.state_dict()
    assert sorted(sd) == sorted(ref), (
        f"missing {sorted(set(ref) - set(sd))}, unexpected {sorted(set(sd) - set(ref))}"
    )
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
    model.load_state_dict(sd, strict=True)


def test_raft_small_checkpoint_maps_onto_state_dict():
    tree = load_flax_checkpoint(CKPT)
    sd = load_flax_npz(CKPT)
    assert len(sd) == len(_flat_keys(tree)) == 106
    _assert_exact_mapping(sd, RAFT(RAFTConfig(small=True), device="cpu"))
    k = tree["params"]["update_block"]["block"]["gru"]["convz"]["kernel"]
    np.testing.assert_array_equal(
        sd["update_block.gru.convz.weight"].numpy(), k.transpose(3, 2, 0, 1)
    )


@pytest.fixture(scope="module")
def standard_variables():
    model = JaxRAFT(JaxRAFTConfig())
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, dict(variables))


def test_raft_standard_init_maps_onto_state_dict(standard_variables):
    v = standard_variables
    assert "batch_stats" in v
    sd = flax_to_state_dict(v)
    assert len(sd) == len(_flat_keys(v))
    n_bn = len(_flat_keys(v["batch_stats"]))
    assert sum(k.endswith(("running_mean", "running_var")) for k in sd) == n_bn > 0
    _assert_exact_mapping(sd, RAFT(RAFTConfig(), device="cpu"))


def test_batch_stats_and_kernels_move_exactly(standard_variables):
    v = standard_variables
    sd = flax_to_state_dict(v)
    bn = v["batch_stats"]["cnet"]["layer2_0"]["downsample_norm"]
    np.testing.assert_array_equal(sd["cnet.layer2_0.downsample_norm.running_mean"].numpy(), bn["mean"])
    np.testing.assert_array_equal(sd["cnet.layer2_0.downsample_norm.running_var"].numpy(), bn["var"])
    p = v["params"]["cnet"]["layer2_0"]["downsample_norm"]
    np.testing.assert_array_equal(sd["cnet.layer2_0.downsample_norm.weight"].numpy(), p["scale"])
    k = v["params"]["update_block"]["block"]["gru"]["convq2"]["kernel"]  # (5, 1, 384, 128)
    w = sd["update_block.gru.convq2.weight"].numpy()
    assert w.shape == (128, 384, 5, 1)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))


def test_unknown_leaf_is_refused():
    with pytest.raises(ValueError):
        flax_to_state_dict({"params": {"fnet": {"conv1": {"embedding": np.zeros(3)}}}})
    with pytest.raises(ValueError):
        flax_to_state_dict({"batch_stats": {"cnet": {"norm1": {"count": np.zeros(3)}}}})
