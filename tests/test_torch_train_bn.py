"""BatchNorm in training mode and encoder dropout, against flax (CPU).

Tolerances:
  - `batch_norm_train` vs flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` in
    training mode: output 1e-5 absolute in fp32 (one-pass fp32 statistics
    summed in other orders), one bf16 ulp of the output in bf16; updated
    running statistics 1e-6 absolute;
  - RAFT-standard with `freeze_bn=False` (64x64, 2 iterations, batch 2) vs
    JAX's `batch_stats` after the same step: 1e-5 absolute; its loss 1e-5
    relative and gradients 1e-4 x the global norm, as for RAFT-small.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses.sequence import sequence_loss as jax_sequence_loss
from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu_torch.losses import sequence_loss
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.models.extractor import BasicEncoder
from raft_optical_flow_tpu_torch.models.layers import Norm, batch_norm_train, channel_dropout
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_train_matches_flax(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 6, 7, 5) * 2 + 1).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    mean0 = rng.randn(5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ref, mut = bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])

    norm = Norm("batch", 5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        norm.running_mean.copy_(torch.from_numpy(mean0))
        norm.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
    out = norm(xt, bn_train=True).permute(0, 2, 3, 1)
    assert out.dtype == dtype
    ref32 = np.asarray(ref.astype(jnp.float32))
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7 * np.abs(ref32).max()
    assert np.abs(out.float().detach().numpy() - ref32).max() <= tol
    assert np.abs(norm.running_mean.numpy() - np.asarray(mut["batch_stats"]["mean"])).max() <= 1e-6
    assert np.abs(norm.running_var.numpy() - np.asarray(mut["batch_stats"]["var"])).max() <= 1e-6
    # the running variance is the biased one (what flax keeps), not torch's unbiased
    biased = xt.float().var(dim=(0, 2, 3), unbiased=False).numpy()
    np.testing.assert_allclose(norm.running_var.numpy(), 0.9 * var0 + 0.1 * biased, rtol=1e-5)


def test_batch_norm_train_gradient_flows_through_statistics():
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w, b = torch.ones(3, requires_grad=True), torch.zeros(3, requires_grad=True)
    rm, rv = torch.zeros(3), torch.ones(3)
    y = batch_norm_train(x, w, b, rm, rv)
    (y * torch.arange(3.0).view(1, 3, 1, 1)).sum().backward()
    # normalizing with batch statistics: the per-channel gradient sums to ~0
    assert x.grad.sum(dim=(0, 2, 3)).abs().max() < 1e-4
    assert not rm.requires_grad and not rv.requires_grad


def test_frozen_batch_norm_leaves_statistics():
    enc = BasicEncoder(32, "batch")
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    enc(x, train=True, bn_train=False)
    assert all(torch.equal(before[k], v) for k, v in enc.state_dict().items())
    enc(x, train=True)  # bn_train follows train
    assert not torch.equal(before["norm1.running_mean"], enc.norm1.running_mean)


def test_channel_dropout_masks_whole_channels():
    x = torch.ones(4, 16, 3, 5)
    y = channel_dropout(x, 0.25, torch.Generator().manual_seed(0))
    per_channel = y.reshape(4, 16, -1)
    assert torch.all((per_channel == 0).all(-1) | (per_channel == 1 / 0.75).all(-1))
    assert 0 < int((per_channel[..., 0] == 0).sum()) < 64
    y2 = channel_dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert channel_dropout(x, 0.0, torch.Generator()) is x


def test_encoder_dropout_follows_train():
    enc = BasicEncoder(32, "instance", dropout=0.5)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    ref = enc(x)
    assert torch.equal(enc(x, train=False, generator=torch.Generator()), ref)
    out = enc(x, train=True, generator=torch.Generator().manual_seed(3))
    dropped = (out == 0).all(dim=(2, 3))
    assert dropped.any() and not dropped.all()
    kept = ~dropped
    torch.testing.assert_close(out[kept], 2 * ref[kept])
    with pytest.raises(ValueError, match="generator"):
        enc(x, train=True)


def test_raft_standard_bn_training_matches_jax():
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "raft_small.npz"))
    i1 = g["image1"][64:128, 96:160].astype(np.float32)[None]
    i2 = g["image2"][64:128, 96:160].astype(np.float32)[None]
    i1, i2 = np.concatenate([i1, i1[:, ::-1]]), np.concatenate([i2, i2[:, ::-1]])
    rng = np.random.RandomState(1)
    flow = rng.uniform(-4, 4, (2, 64, 64, 2)).astype(np.float32)
    valid = np.ones((2, 64, 64), np.float32)

    model = JaxRAFT(JaxRAFTConfig())
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(i1), jnp.asarray(i2), iters=1,
                                             test_mode=True))(jax.random.PRNGKey(3))
    variables = jax.tree.map(np.asarray, dict(variables))

    def loss_fn(p, bs):
        preds, mut = model.apply({"params": p, "batch_stats": bs}, jnp.asarray(i1),
                                 jnp.asarray(i2), iters=2, train=True, freeze_bn=False,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_sequence_loss(preds, jnp.asarray(flow), jnp.asarray(valid))[0], mut["batch_stats"]

    (ref_loss, ref_bs), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])

    port = RAFT(RAFTConfig(), device="cpu")
    port.load_state_dict(flax_to_state_dict(variables))
    preds = port(torch.from_numpy(i1), torch.from_numpy(i2), iters=2, test_mode=False,
                 train=True, freeze_bn=False)
    loss, _ = sequence_loss(preds, torch.from_numpy(flow), torch.from_numpy(valid))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))

    got_bs = dict(_flat(state_dict_to_flax(port.state_dict())["batch_stats"]))
    want_bs = dict(_flat(jax.tree.map(np.asarray, ref_bs)))
    before = dict(_flat(variables["batch_stats"]))
    assert got_bs.keys() == want_bs.keys() and len(got_bs) == 2 * 15  # 15 BN layers in cnet
    assert max(np.abs(got_bs[k] - want_bs[k]).max() for k in got_bs) <= 1e-5
    assert min(np.abs(before[k] - want_bs[k]).max() for k in got_bs) > 1e-3  # all moved

    grads = dict(_flat(state_dict_to_flax({k: p.grad for k, p in port.named_parameters()})["params"]))
    want = dict(_flat(jax.tree.map(np.asarray, ref_grads)))
    scale = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want.values()))
    assert max(float(np.abs(grads[k] - want[k]).max()) for k in want) <= 1e-4 * scale
