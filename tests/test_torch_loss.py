"""The port's sequence loss and optimizer against the JAX package and optax.

Tolerances:
  - `sequence_loss` and its epe/1px/3px/5px metrics: 1e-6 relative (fp32
    reductions in another order);
  - the one-cycle schedule vs `optax.linear_onecycle_schedule`: 1e-12
    relative against optax's own fp64 evaluation (a Python int step) at every
    step probed, and 1e-7 relative against what optax's update reads (an
    int32 step, evaluated in fp32) at steps 0, 1, the peak and the end. Inside
    a phase optax's fp32 evaluation itself drifts (up to 6e-4 relative one
    step before the end of a 100k-step schedule), so no fp32 bound is set
    there;
  - clipped AdamW vs optax's chain, fed the SAME gradients (Adam's first
    update is about lr*sign(g), so gradients from two backward passes that
    differ by rounding could flip near-zero signs): 1e-6 absolute on the
    updated parameters, over several steps, with the clip active and not.
"""

import copy

import numpy as np
import optax
import pytest
import jax.numpy as jnp
import torch

from raft_optical_flow_tpu.losses.sequence import sequence_loss as jax_sequence_loss
from raft_optical_flow_tpu.train.trainer import make_optimizer as jax_make_optimizer
from raft_optical_flow_tpu_torch.losses import sequence_loss
from raft_optical_flow_tpu_torch.train.trainer import (
    AdamW,
    linear_onecycle_schedule,
    make_optimizer,
)
from torch_threads import one_torch_thread  # noqa: F401


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("gamma,max_flow", [(0.8, 400.0), (0.85, 6.0)])
def test_sequence_loss_matches_jax(gamma, max_flow):
    rng = np.random.RandomState(0)
    T, N, H, W = 5, 2, 12, 16
    preds = rng.uniform(-8, 8, (T, N, H, W, 2)).astype(np.float32)
    gt = rng.uniform(-8, 8, (N, H, W, 2)).astype(np.float32)
    gt[0, :3] *= 100.0  # |gt| beyond max_flow: excluded
    valid = (rng.uniform(size=(N, H, W)) > 0.3).astype(np.float32) * 0.7
    ref_loss, ref_m = jax_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid),
                                        gamma=gamma, max_flow=max_flow)
    loss, m = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt), torch.from_numpy(valid),
                            gamma=gamma, max_flow=max_flow)
    assert _rel(loss, ref_loss) <= 1e-6
    assert set(m) == set(ref_m) == {"epe", "1px", "3px", "5px"}
    for k in m:
        assert _rel(m[k], ref_m[k]) <= 1e-6, k


def test_sequence_loss_max_flow_excludes_pixels():
    preds = torch.zeros(2, 1, 4, 4, 2)
    gt = torch.ones(1, 4, 4, 2)
    valid = torch.ones(1, 4, 4)
    full, _ = sequence_loss(preds, gt, valid)
    gt[0, :2] = 500.0  # half the pixels out: the mean still runs over all of them
    half, m = sequence_loss(preds, gt, valid)
    torch.testing.assert_close(half, full / 2)
    torch.testing.assert_close(m["epe"], torch.tensor(2.0**0.5))


def test_sequence_loss_is_differentiable():
    preds = torch.randn(3, 1, 8, 8, 2, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    loss, _ = sequence_loss(preds, torch.zeros(1, 8, 8, 2), torch.ones(1, 8, 8))
    loss.backward()
    assert torch.isfinite(preds.grad).all() and preds.grad.abs().sum() > 0


@pytest.mark.parametrize("num_steps", [100, 1000, 100_000])
def test_onecycle_schedule_matches_optax(num_steps):
    _, ref = jax_make_optimizer(4e-4, 1e-4, 1e-8, num_steps)
    T = num_steps + 100
    port = linear_onecycle_schedule(T, 4e-4, pct_start=0.05, pct_final=1.0,
                                    div_factor=25.0, final_div_factor=1e4)
    peak = int(0.05 * T)
    for step in (0, 1, peak - 1, peak, peak + 1, T // 2, T - 1, T, T + 50):
        assert _rel(port(step), ref(step)) <= 1e-12, step
    for step in (0, 1, peak, T):
        assert _rel(port(step), ref(jnp.asarray(step, jnp.int32))) <= 1e-7, step
    assert port(peak) == pytest.approx(4e-4, rel=1e-12)
    assert port(T) == pytest.approx(4e-8, rel=1e-12)


def test_onecycle_schedule_general_phases_match_optax():
    ref = optax.linear_onecycle_schedule(200, 1e-3, pct_start=0.3, pct_final=0.85)
    port = linear_onecycle_schedule(200, 1e-3, pct_start=0.3, pct_final=0.85)
    for step in (0, 30, 59, 60, 100, 169, 170, 199, 200, 250):
        assert _rel(port(step), ref(step)) <= 1e-12, step


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip inactive / active
def test_clipped_adamw_matches_optax_on_the_same_gradients(grad_scale):
    rng = np.random.RandomState(1)
    shapes = [(4, 3, 3, 3), (4,), (7,), (2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx, _ = jax_make_optimizer(4e-4, 1e-4, 1e-8, num_steps=20, clip=1.0)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(tp, 4e-4, 1e-4, 1e-8, num_steps=20, clip=1.0)
    assert isinstance(opt, AdamW)
    for _ in range(4):
        grads = [(rng.randn(*s) * grad_scale).astype(np.float32) for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        ref_norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
        assert _rel(norm, ref_norm) <= 1e-6
        for p, g in zip(tp, grads):  # the gradients are left as they were
            assert np.array_equal(p.grad.numpy(), g)
        for a, b in zip(tp, jp):
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-6
    assert opt.param_groups[0]["count"] == 4


def test_adamw_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], 1e-3, 1e-4, 1e-8, num_steps=10)
    p.grad = torch.tensor([0.1, -0.2, 0.3])
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = make_optimizer([q], 1e-3, 1e-4, 1e-8, num_steps=10)
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))  # as if read from a file
    for o, x in ((opt, p), (opt2, q)):
        x.grad = torch.tensor([0.3, 0.2, -0.1])
        o.step()
    assert torch.equal(p, q) and opt2.param_groups[0]["count"] == 2
