"""The port's fused SepConvGRU (`RAFTConfig.fused_gru`) in training, against
the port's unfused model at the same weights, on the CPU.

The fused backward is autograd of the unfused reference on the saved
inputs (`kernels/gru_fused.py::SepConvGRUFused`), and the forward is K7's
plain version here, so the two steps agree to fp32 rounding: loss 1e-6
relative, gradients within 1e-5 x the global norm (the bar of
`tests/test_torch_train.py` for training variants). A 32x48 crop of the
golden frames (levels 4x6, 2x3, 1x1 and an empty one), 2 iterations.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def crop():
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    i1 = torch.from_numpy(g["image1"][64:96, 96:144].astype(np.float32)[None])
    i2 = torch.from_numpy(g["image2"][64:96, 96:144].astype(np.float32)[None])
    flow = torch.from_numpy(np.random.RandomState(13).uniform(-4, 4, (1, 32, 48, 2))
                            .astype(np.float32))
    return i1, i2, flow


def _pair(config):
    """(fused, unfused) models of `config` with the same seeded weights."""
    unfused = RAFT(config, device="cpu", generator=torch.Generator().manual_seed(21))
    fused = RAFT(dataclasses.replace(config, fused_gru=True), device="cpu")
    fused.load_state_dict(unfused.state_dict(), strict=True)
    return fused, unfused


def _loss_and_grads(model, i1, i2, flow):
    preds = model(i1, i2, iters=2, test_mode=False)
    loss = (preds - flow).abs().mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("variant", [{}, {"alternate_corr": True, "remat": True}])
def test_fused_train_step_matches_unfused(crop, variant):
    fused, unfused = _pair(RAFTConfig(**variant))
    base_loss, base = _loss_and_grads(unfused, *crop)
    loss, grads = _loss_and_grads(fused, *crop)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in base.values())))
    assert max(float((grads[k] - g).abs().max()) for k, g in base.items()) <= 1e-5 * norm


def test_raft_small_ignores_fused_gru(crop):
    i1, i2, _ = crop
    fused, plain = _pair(RAFTConfig(small=True))
    for kw in ({}, {"test_mode": False}):
        with torch.no_grad():
            torch.testing.assert_close(fused(i1, i2, iters=2, **kw), plain(i1, i2, iters=2, **kw),
                                       rtol=0, atol=0)
