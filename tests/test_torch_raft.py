"""The port's RAFT serving path against the reference golden and the JAX package.

Tolerances:
  - RAFT-small fp32 at the checkpoint weights vs the reference torch golden,
    at the golden's own 192x320 size and iteration count: flow_low max 2e-3,
    flow_up EPE mean < 1e-3 and max < 5e-3 (the bar of
    tests/test_raft_parity.py for the JAX package);
  - RAFT-standard fp32 vs JAX at shared seeded weights (64x96, 3 iterations,
    warm start): flow_up EPE mean < 1e-3;
  - the bf16 policy vs JAX's bf16 policy: EPE mean < 0.02 px (bench.py's bf16
    fidelity bar): the two frameworks round bf16 at different places.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, load_flax_npz

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "tests", "goldens", "raft_small.npz")
CKPT = os.path.join(REPO, "checkpoints", "raft_small.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _epe(a, b):
    return np.linalg.norm(np.asarray(a, np.float32) - np.asarray(b, np.float32), axis=-1)


def _crop_pair(g):
    """A 64x96 crop of the golden frames (real image content at test size)."""
    i1 = g["image1"][64:128, 96:192].astype(np.float32)[None]
    i2 = g["image2"][64:128, 96:192].astype(np.float32)[None]
    return i1, i2


def _port(config, sd):
    model = RAFT(config, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def test_raft_small_matches_golden(golden):
    g = golden
    model = _port(RAFTConfig(small=True), load_flax_npz(CKPT))
    i1 = torch.from_numpy(g["image1"].astype(np.float32))[None]
    i2 = torch.from_numpy(g["image2"].astype(np.float32))[None]
    flow_low, flow_up = model(i1, i2, iters=int(g["iters"]))
    assert flow_up.shape == (1, 192, 320, 2) and flow_up.dtype == torch.float32
    assert np.abs(flow_low.numpy() - g["flow_low"]).max() < 2e-3
    epe = _epe(flow_up.numpy(), g["flow_up"])
    assert epe.mean() < 1e-3, epe.mean()
    assert epe.max() < 5e-3, epe.max()


@pytest.fixture(scope="module")
def standard_weights():
    model = JaxRAFT(JaxRAFTConfig())
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(5))
    variables = jax.tree.map(np.asarray, dict(variables))
    # non-trivial frozen BatchNorm statistics in the context encoder
    rng = np.random.RandomState(6)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.5, 0.5, a.shape) if "mean" in jax.tree_util.keystr(p)
                      else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return variables


def _jax_flows(config, variables, i1, i2, iters, flow_init=None):
    model = JaxRAFT(config)
    fwd = jax.jit(lambda v, a, b, f: model.apply(v, a, b, iters=iters, flow_init=f, test_mode=True))
    f = None if flow_init is None else jnp.asarray(flow_init)
    lo, up = fwd(jax.tree.map(jnp.asarray, variables), jnp.asarray(i1), jnp.asarray(i2), f)
    return np.asarray(lo, np.float32), np.asarray(up, np.float32)


def test_raft_standard_fp32_matches_jax(golden, standard_weights):
    i1, i2 = _crop_pair(golden)
    flow_init = np.random.RandomState(7).uniform(-2, 2, (1, 8, 12, 2)).astype(np.float32)
    ref_lo, ref_up = _jax_flows(JaxRAFTConfig(), standard_weights, i1, i2, 3, flow_init)
    sd = flax_to_state_dict(standard_weights)
    model = _port(RAFTConfig(), sd)
    lo, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=3,
                   flow_init=torch.from_numpy(flow_init))
    assert up.shape == (1, 64, 96, 2)
    assert _epe(up.numpy(), ref_up).mean() < 1e-3
    assert _epe(lo.numpy(), ref_lo).mean() < 1e-3
    # the plain-lookup path is the same function on the CPU
    plain = _port(RAFTConfig(corr_impl="plain"), sd)
    _, up_plain = plain(torch.from_numpy(i1), torch.from_numpy(i2), iters=3,
                        flow_init=torch.from_numpy(flow_init))
    torch.testing.assert_close(up_plain, up, rtol=0, atol=0)


def test_raft_small_bf16_policy_matches_jax(golden):
    i1, i2 = _crop_pair(golden)
    variables = jax_load(CKPT)
    _, ref_up = _jax_flows(JaxRAFTConfig(small=True, compute_dtype=jnp.bfloat16), variables, i1, i2, 3)
    model = _port(RAFTConfig(small=True, compute_dtype=torch.bfloat16), load_flax_npz(CKPT))
    _, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    assert up.dtype == torch.float32
    assert _epe(up.numpy(), ref_up).mean() < 0.02


def test_raft_standard_bf16_policy_matches_jax(golden, standard_weights):
    i1, i2 = _crop_pair(golden)
    _, ref_up = _jax_flows(JaxRAFTConfig(compute_dtype=jnp.bfloat16), standard_weights, i1, i2, 3)
    model = _port(RAFTConfig(compute_dtype=torch.bfloat16), flax_to_state_dict(standard_weights))
    _, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    assert _epe(up.numpy(), ref_up).mean() < 0.02


def test_cpu_run_launches_no_kernel(golden):
    i1, i2 = _crop_pair(golden)
    model = _port(RAFTConfig(small=True), load_flax_npz(CKPT))
    ck.reset_launches()
    model(torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    assert ck.LAUNCHES == {"corr_lookup_level": 0, "corr_lookup_coarse_fused": 0,
                           "corr_lookup_level_bwd": 0}


def test_zero_iterations_standard():
    model = RAFT(RAFTConfig(), device="cpu")
    img = torch.zeros(1, 64, 64, 3)
    lo, up = model(img, img, iters=0)
    assert torch.all(lo == 0) and up.shape == (1, 64, 64, 2) and torch.all(up == 0)


@pytest.mark.parametrize(
    "config,kwargs",
    [
        (RAFTConfig(small=True, fused_gru=True), {"test_mode": False}),
        (RAFTConfig(fused_gru=True), {}),
        (RAFTConfig(fused_gru=True, alternate_corr=True), {}),
    ],
)
def test_unported_paths_raise(config, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model = RAFT(config, device="cpu")
        img = torch.zeros(1, 64, 64, 3)
        model(img, img, iters=1, **kwargs)
