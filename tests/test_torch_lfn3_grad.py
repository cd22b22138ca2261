"""LiteFlowNet3's training gradients in the port against `jax.value_and_grad`.

`multiscale_sequence_loss` against the JAX package's, value and gradient
(the GT mask's nearest resize picks JAX's rows, 436 -> 109 among the
shapes). Standard here and S+PseudoReg (which has every S-only module) in
tests/test_torch_lfn3_grad_s.py (a file of its own, so that another worker
takes it), fp32,
batch 2, 64x96, each at its golden's params: forward with training=True,
the JAX trainer's loss convention ([flows] + [p * div_flow for p in
reversed(flow_preds)], `train/trainers.py:83-86`), backward. The loss
within rel 1e-5; each layer's gradient (weight and bias together) on its
own scale, max|d| / max|ref| within max(2e-5, 2x the case's floor): JAX
against itself under a (1 +- 1e-7) change of every weight, measured in the
same test (ROADMAP.md's rule for gradient comparisons). The floor read
1.52e-6 (standard) and 1.18e-5 (S+PseudoReg), so the gates are 2e-5 and
2.36e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses.sequence import multiscale_sequence_loss as jax_loss
from raft_optical_flow_tpu.models.liteflownet3 import LFN3Config as JaxLFN3Config
from raft_optical_flow_tpu.models.liteflownet3 import LiteFlowNet3 as JaxLiteFlowNet3
from raft_optical_flow_tpu_torch.losses import multiscale_sequence_loss
from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_npz,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("H,W,levels", [(64, 96, ((64, 96), (16, 24), (8, 12), (4, 6), (2, 3))),
                                        (436, 64, ((109, 16), (55, 8))),
                                        (50, 70, ((50, 70), (13, 18), (7, 9), (4, 5), (2, 3), (1, 2)))])
def test_multiscale_loss_matches_jax(H, W, levels):
    rng = np.random.RandomState(H)
    gt = rng.uniform(-5, 5, (2, H, W, 2)).astype(np.float32)
    gt[0, :3, :3] = 500.0  # past max_flow: invalid
    valid = (rng.rand(2, H, W) > 0.3).astype(np.float32)
    preds = [rng.uniform(-5, 5, (2, h, w, 2)).astype(np.float32) for h, w in levels]
    ref, vjp = jax.vjp(jax.jit(lambda p: jax_loss(p, jnp.asarray(gt), jnp.asarray(valid))),
                       [jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    loss = multiscale_sequence_loss(tp, torch.from_numpy(gt), torch.from_numpy(valid))
    assert abs(loss.item() - float(ref)) <= 1e-6 * abs(float(ref))
    loss.backward()
    for t, g in zip(tp, vjp(jnp.ones((), jnp.float32))[0]):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max()


def _layer_max_rel(grads, ref):
    """max|d| / max|ref| per layer, its weight and bias together."""
    num, den = {}, {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        num[layer] = max(num.get(layer, 0.0), float(np.abs(grads[k] - r).max()))
        den[layer] = max(den.get(layer, 0.0), float(np.abs(r).max()))
    return {layer: num[layer] / den[layer] for layer in num}


def check_gradients(name, kw):
    """The port's loss and per-layer gradients against JAX's at the golden
    `name`'s params, for the variant of config `kw`."""
    rng = np.random.RandomState(0)
    B, H, W = 2, 64, 96
    images = rng.uniform(0, 1, (B, 2, H, W, 3)).astype(np.float32)
    gt = rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32)
    valid = (rng.rand(B, H, W) > 0.2).astype(np.float32)
    sd = load_flax_npz(os.path.join(GOLDENS, f"lfn3_{name}_params.npz"))

    jax_model = JaxLiteFlowNet3(JaxLFN3Config(**kw))
    div_flow = jax_model.config.div_flow

    def loss_fn(params):
        out = jax_model.apply({"params": params}, jnp.asarray(images), training=True)
        preds = [out["flows"][:, 0]] + [p * div_flow for p in reversed(out["flow_preds"])]
        return jax_loss(preds, jnp.asarray(gt), jnp.asarray(valid))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(sd)["params"])

    def grads_of(p):
        loss, g = value_and_grad(p)
        g = flax_to_state_dict({"params": jax.tree.map(np.asarray, g)})
        return float(loss), {k: v.numpy() for k, v in g.items()}

    ref_loss, ref = grads_of(params)
    signs = np.random.RandomState(1)
    nudged = jax.tree.map(
        lambda a: a * (1 + 1e-7 * np.sign(signs.randn(*a.shape))).astype(np.float32), params)
    floor = max(_layer_max_rel(grads_of(nudged)[1], ref).values())

    model = LiteFlowNet3(LFN3Config(**kw), device="cpu")
    model.load_state_dict(sd, strict=True)
    out = model(torch.from_numpy(images), training=True)
    preds = [out["flows"][:, 0]] + [p * model.config.div_flow for p in reversed(out["flow_preds"])]
    loss = multiscale_sequence_loss(preds, torch.from_numpy(gt), torch.from_numpy(valid))
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    rels = _layer_max_rel(grads, ref)
    gate = max(2e-5, 2 * floor)
    worst = max(rels, key=rels.get)
    assert rels[worst] <= gate, (worst, rels[worst], floor)


def test_gradients_match_jax():
    check_gradients("standard", dict())
