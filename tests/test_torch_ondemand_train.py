"""RAFT training with the on-demand correlation (`alternate_corr=True`)
against the JAX package, on the CPU.

Loss and gradients of the sequence loss after 2-3 train-mode iterations,
the same batch and weights on both sides (RAFT-small: the checkpoint on a
64x96 crop, 3 iterations; RAFT-standard: seeded JAX-initialized weights on a
32x48 crop, 2 iterations). Tolerances: loss 1e-5 relative; each layer's
gradient (its weight and bias together, so a conv bias in front of an
instance norm, whose gradient is zero up to rounding, is held on its
weight's scale) within max|d| <= 2e-5 * max|ref| + 1e-12, the repo's fp32
VJP gate (utils/grad_parity.py) on each layer's own scale. Remat on and off
give equal gradients on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses.sequence import sequence_loss as jax_sequence_loss
from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.losses import sequence_loss
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "tests", "goldens", "raft_small.npz")
CKPT = os.path.join(REPO, "checkpoints", "raft_small.npz")


def _batch(h, w):
    g = np.load(GOLDEN)
    i1 = g["image1"][64:64 + h, 96:96 + w].astype(np.float32)[None]
    i2 = g["image2"][64:64 + h, 96:96 + w].astype(np.float32)[None]
    rng = np.random.RandomState(0)
    flow = rng.uniform(-4, 4, (1, h, w, 2)).astype(np.float32)
    valid = (rng.uniform(size=(1, h, w)) > 0.1).astype(np.float32)
    return i1, i2, flow, valid


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _port_loss_and_grads(model, batch, iters):
    i1, i2, flow, valid = (torch.from_numpy(x) for x in batch)
    preds = model(i1, i2, iters=iters, test_mode=False, train=True)
    loss, _ = sequence_loss(preds, flow, valid)
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})["params"]
    return float(loss.detach()), dict(_flat(grads))


CASES = {"small": (True, 64, 96, 3), "standard": (False, 32, 48, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_alternate_corr_loss_and_grads_match_jax(case):
    small, h, w, iters = CASES[case]
    batch = _batch(h, w)
    jmodel = JaxRAFT(JaxRAFTConfig(small=small, alternate_corr=True))
    i1, i2, flow, valid = (jnp.asarray(x) for x in batch)
    if small:
        variables = jax.tree.map(jnp.asarray, jax_load(CKPT))
    else:
        variables = jax.jit(lambda k: jmodel.init(k, i1, i2, iters=1, test_mode=True))(
            jax.random.PRNGKey(5))

    def loss_fn(p):
        preds = jmodel.apply({**variables, "params": p}, i1, i2, iters=iters, train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_sequence_loss(preds, flow, valid)[0]

    ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    ref = dict(_flat(jax.tree.map(np.asarray, ref)))

    model = RAFT(RAFTConfig(small=small, alternate_corr=True), device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, dict(variables))))
    loss, grads = _port_loss_and_grads(model, batch, iters)
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert grads.keys() == ref.keys()
    diff, scale = {}, {}
    for k in ref:
        layer = k[:-1]
        diff[layer] = max(diff.get(layer, 0.0), float(np.abs(grads[k] - ref[k]).max()))
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(ref[k]).max()))
    bad = {"/".join(n): diff[n] / scale[n] for n in diff if diff[n] > 2e-5 * scale[n] + 1e-12}
    assert not bad, bad


def test_remat_gives_the_same_gradients():
    batch = _batch(64, 96)
    sd = flax_to_state_dict(jax_load(CKPT))
    out = []
    for remat in (False, True):
        model = RAFT(RAFTConfig(small=True, alternate_corr=True, remat=remat), device="cpu")
        model.load_state_dict(sd)
        out.append(_port_loss_and_grads(model, batch, 2))
    assert out[0][0] == out[1][0]
    assert all(np.array_equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


def test_training_routes_lookups_through_the_function():
    """Each iteration's on-demand lookup is one OndemandCorr (forward K4,
    backward K5 and K6 on the card); no materialized-volume lookup."""
    i1, i2, _, _ = (torch.from_numpy(x) for x in _batch(32, 48))
    model = RAFT(RAFTConfig(small=True, alternate_corr=True), device="cpu")
    preds = model(i1, i2, iters=3, test_mode=False)
    seen, names, stack = set(), [], [preds.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.append(type(fn).__name__)
        stack += [f for f, _ in fn.next_functions]
    assert names.count("OndemandCorrBackward") == 3
    assert "LookupLevelBackward" not in names
