"""The port's RAFT training mode against the golden and the JAX package (CPU).

Tolerances:
  - RAFT-small train-mode forward at the checkpoint weights vs the reference
    golden `train_pred_last` (192x320, the golden's 4 iterations): EPE mean
    < 1e-3, the bar of tests/test_raft_parity.py;
  - RAFT-small fp32 loss and gradients vs `jax.value_and_grad` of the JAX
    sequence loss on the same batch (64x96, 3 iterations): loss 1e-5
    relative, each gradient within 1e-4 x the global gradient norm (fp32
    sums in other orders through 3 unrolled iterations);
  - the bf16 policy's loss vs JAX's bf16 policy: 2e-2 relative (the two
    frameworks round bf16 at other places);
  - remat and checkpointed upsampling on vs off, and the kernel route vs the
    plain-lookup route: loss equal, gradients within 1e-5 x the global norm
    (the bar of tests/test_train_smoke.py).
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
from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.losses import sequence_loss
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz, state_dict_to_flax
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "tests", "goldens", "raft_small.npz")
CKPT = os.path.join(REPO, "checkpoints", "raft_small.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def batch(golden):
    """A 64x96 crop of the golden frames with a seeded flow target."""
    i1 = golden["image1"][64:128, 96:192].astype(np.float32)[None]
    i2 = golden["image2"][64:128, 96:192].astype(np.float32)[None]
    rng = np.random.RandomState(0)
    flow = rng.uniform(-4, 4, (1, 64, 96, 2)).astype(np.float32)
    valid = (rng.uniform(size=(1, 64, 96)) > 0.1).astype(np.float32)
    return i1, i2, flow, valid


def _port(config):
    model = RAFT(config, device="cpu")
    model.load_state_dict(load_flax_npz(CKPT))
    return model


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _port_loss_and_grads(model, batch, iters):
    i1, i2, flow, valid = (torch.from_numpy(x) for x in batch)
    preds = model(i1, i2, iters=iters, test_mode=False, train=True)
    assert preds.shape == (iters, *flow.shape) and preds.dtype == torch.float32
    loss, _ = sequence_loss(preds, flow, valid)
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})["params"]
    return float(loss), dict(_flat(grads))


def _jax_loss_and_grads(config, batch, iters, grads=True):
    i1, i2, flow, valid = (jnp.asarray(x) for x in batch)
    model = JaxRAFT(config)
    params = jax.tree.map(jnp.asarray, jax_load(CKPT))["params"]

    def loss_fn(p):
        preds = model.apply({"params": p}, i1, i2, iters=iters, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_sequence_loss(preds, flow, valid)[0]

    if not grads:
        return float(jax.jit(loss_fn)(params)), None
    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), dict(_flat(jax.tree.map(np.asarray, g)))


def _grad_err(got, ref):
    """max over tensors of max|d|, over the global norm of ref."""
    assert got.keys() == ref.keys()
    scale = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in ref.values()))
    return max(float(np.abs(got[k] - ref[k]).max()) for k in ref) / scale


def test_raft_small_train_forward_matches_golden(golden):
    model = _port(RAFTConfig(small=True))
    i1 = torch.from_numpy(golden["image1"].astype(np.float32))[None]
    i2 = torch.from_numpy(golden["image2"].astype(np.float32))[None]
    ck.reset_launches()
    with torch.no_grad():
        preds = model(i1, i2, iters=int(golden["train_iters"]), test_mode=False)
    assert preds.shape == (int(golden["train_iters"]), 1, 192, 320, 2)
    epe = np.linalg.norm(preds[-1].numpy() - golden["train_pred_last"], axis=-1)
    assert epe.mean() < 1e-3, epe.mean()
    assert set(ck.LAUNCHES.values()) == {0}  # the CPU runs the plain versions


def test_raft_small_loss_and_grads_match_jax(batch):
    ref_loss, ref_grads = _jax_loss_and_grads(JaxRAFTConfig(small=True), batch, 3)
    loss, grads = _port_loss_and_grads(_port(RAFTConfig(small=True)), batch, 3)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert _grad_err(grads, ref_grads) <= 1e-4


def test_raft_small_bf16_policy_loss_matches_jax(batch):
    ref_loss, _ = _jax_loss_and_grads(JaxRAFTConfig(small=True, compute_dtype=jnp.bfloat16),
                                      batch, 3, grads=False)
    model = _port(RAFTConfig(small=True, compute_dtype=torch.bfloat16))
    loss, grads = _port_loss_and_grads(model, batch, 3)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("variant", [
    {"remat": True},
    {"corr_impl": "plain"},
])
def test_training_variants_match_baseline_small(batch, variant):
    base_loss, base = _port_loss_and_grads(_port(RAFTConfig(small=True)), batch, 3)
    loss, grads = _port_loss_and_grads(_port(RAFTConfig(small=True, **variant)), batch, 3)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    assert _grad_err(grads, base) <= 1e-5


@pytest.mark.parametrize("variant", [{"remat": True}, {"checkpoint_upsample": True}])
def test_training_variants_match_baseline_standard(batch, variant):
    gen = torch.Generator().manual_seed(3)
    base_model = RAFT(RAFTConfig(), device="cpu", generator=gen)
    small_batch = tuple(x[:, :32, :48] for x in batch)
    base_loss, base = _port_loss_and_grads(base_model, small_batch, 2)
    model = RAFT(RAFTConfig(**variant), device="cpu")
    model.load_state_dict(base_model.state_dict())
    loss, grads = _port_loss_and_grads(model, small_batch, 2)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    assert _grad_err(grads, base) <= 1e-5


def test_training_routes_per_level_lookups_through_the_function(batch):
    """Training never fuses the coarse levels: each level of each iteration is
    one LookupLevel, whose backward is K3 (counted on the card; here the
    autograd graph shows it): 4 levels x 2 iterations."""
    model = _port(RAFTConfig(small=True))
    i1, i2 = (torch.from_numpy(x) for x in batch[:2])
    preds = model(i1, i2, iters=2, test_mode=False)
    seen, lookups, stack = set(), 0, [preds.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        lookups += type(fn).__name__ == "LookupLevelBackward"
        stack += [f for f, _ in fn.next_functions]
    assert lookups == 4 * 2
