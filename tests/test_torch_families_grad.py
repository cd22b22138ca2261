"""SimpleFlowNet's and IFNet's losses in the port against the JAX package's,
and the shared check of the models' training gradients.

The losses (`simple_flow_loss`, `laploss`, `unsupervised_loss`), value and
gradient, on seeded inputs: values and metrics within 1e-6 relative,
gradients within 1e-5 of the largest. The sums run in another order, and
the GT's half-pixel resize differs from JAX's by an ulp here and there (a
weighted sum in JAX, an interpolation in torch): the EPE's gradient
(p - gt) / |p - gt| turns that into up to 2.3e-6 of the largest where
|p - gt| is small (the finest scale at 50x70, without the smoothness term).

`check_gradients` (the model tests: tests/test_torch_simple_flow_grad.py
and test_torch_ifnet_grad.py, files of their own so that the workers share
them): fp32, batch 2, 64x96, at
the golden's params. The loss within rel 1e-5; each layer's gradient
(weight and bias together) on its own scale, max|d| / max|ref| within
max(2e-5, 2x the case's floor): JAX against itself under a (1 +- 1e-7)
change of every weight, measured in the same test (ROADMAP.md's rule for
gradient comparisons). JAX runs in float64: its fp32 gradients lie further
from its own float64 ones than the port's do (3.0e-3 at SimpleFlowNet's
first BatchNorm, 1.45e-2 at IFNet's block0.lastconv under laploss, against
the port's 8.1e-6 and 6.6e-6), so an fp32 reference would measure JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses.laploss import laploss as jax_laploss
from raft_optical_flow_tpu.losses.simple_flow_loss import simple_flow_loss as jax_sf_loss
from raft_optical_flow_tpu.losses.unsupervised import unsupervised_loss as jax_unsup_loss
from raft_optical_flow_tpu_torch.losses import laploss, simple_flow_loss, unsupervised_loss
from raft_optical_flow_tpu_torch.losses.laploss import laplacian_pyramid
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check_loss(jax_fn, port_fn, arrays):
    """jax_fn and port_fn map a list of arrays to (loss, metrics): the
    values, the metrics and the gradients wrt every array."""
    (ref, ref_m), vjp = jax.vjp(jax.jit(jax_fn), [jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    loss, metrics = port_fn(ts)
    assert abs(loss.item() - float(ref)) <= 1e-6 * abs(float(ref))
    assert metrics.keys() == ref_m.keys()
    for k, v in ref_m.items():
        got = float(metrics[k].detach()) if torch.is_tensor(metrics[k]) else metrics[k]
        assert abs(got - float(v)) <= 1e-6 * max(abs(float(v)), 1e-30), (k, got, float(v))
    loss.backward()
    grads = vjp((jnp.ones((), jnp.float32), jax.tree.map(jnp.zeros_like, ref_m)))[0]
    for t, g in zip(ts, grads):
        got = t.grad if t.grad is not None else torch.zeros_like(t)  # valid: no gradient
        assert _max_rel(got, g) <= 1e-5


def _flows(rng, shapes, scale=4.0):
    return [rng.uniform(-scale, scale, (2, h, w, 2)).astype(np.float32) for h, w in shapes]


@pytest.mark.parametrize("H,W,shapes", [(64, 96, ((8, 12), (16, 24), (32, 48))),
                                        (50, 70, ((7, 9), (13, 18), (25, 35)))])
def test_simple_flow_loss_matches_jax(H, W, shapes):
    rng = np.random.RandomState(H)
    gt = rng.uniform(-6, 6, (2, H, W, 2)).astype(np.float32)
    gt[0, :4, :4] = 450.0  # past max_flow: invalid
    valid = (rng.rand(2, H, W) > 0.3).astype(np.float32)
    image = rng.rand(2, H, W, 3).astype(np.float32)
    preds = _flows(rng, shapes)
    n = len(preds)
    _check_loss(
        lambda a: jax_sf_loss(a[:n], a[n], a[n + 1], a[n + 2]),
        lambda t: simple_flow_loss(t[:n], t[n], t[n + 1], t[n + 2]),
        preds + [gt, valid, image])
    # no valid mask and no image: no smoothness term
    _check_loss(lambda a: jax_sf_loss(a[:n], a[n]),
                lambda t: simple_flow_loss(t[:n], t[n]), preds + [gt])


def test_laploss_matches_jax():
    rng = np.random.RandomState(1)
    img0, img1 = (rng.rand(2, 64, 96, 3).astype(np.float32) for _ in range(2))
    warped = [rng.rand(2, 64, 96, 3).astype(np.float32) for _ in range(6)]
    _check_loss(
        lambda a: jax_laploss(list(zip(a[0:6:2], a[1:6:2])), a[6], a[7]),
        lambda t: laploss(list(zip(t[0:6:2], t[1:6:2])), t[6], t[7]),
        warped + [img0, img1])
    pyr = laplacian_pyramid(torch.from_numpy(img0))
    assert [tuple(p.shape[1:3]) for p in pyr] == [(64, 96), (32, 48), (16, 24), (8, 12), (4, 6)]


def test_laploss_rejects_levels_of_two_pixels():
    """torch's reflect pad needs a side longer than 2; `jnp.pad` reflects
    again. 32x64 has 2x4 at the fifth level."""
    x = torch.rand(1, 32, 64, 3)
    with pytest.raises(ValueError, match="level 4"):
        laploss([(x, x)], x, x)
    laploss([(x, x)], x, x, max_levels=4)


@pytest.mark.parametrize("backward", [True, False])
def test_unsupervised_loss_matches_jax(backward):
    rng = np.random.RandomState(2)
    img1, img2 = (rng.rand(2, 64, 96, 3).astype(np.float32) for _ in range(2))
    shapes = ((8, 12), (16, 24), (32, 48))
    fw = _flows(rng, shapes, 3.0)
    bw = [-f + rng.uniform(-0.4, 0.4, f.shape).astype(np.float32) for f in fw]
    bw[1][0, 3:9, 3:9] += 5.0  # inconsistent: occluded
    if backward:
        _check_loss(lambda a: jax_unsup_loss(a[0], a[1], a[2:5], a[5:8]),
                    lambda t: unsupervised_loss(t[0], t[1], t[2:5], t[5:8]),
                    [img1, img2] + fw + bw)
    else:
        _check_loss(lambda a: jax_unsup_loss(a[0], a[1], a[2:5]),
                    lambda t: unsupervised_loss(t[0], t[1], t[2:5]), [img1, img2] + fw)


def _layer_max_rel(grads, ref):
    """max|d| / max|ref| per layer, its weight and bias together."""
    num, den = {}, {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        num[layer] = max(num.get(layer, 0.0), float(np.abs(grads[k] - r).max()))
        den[layer] = max(den.get(layer, 0.0), float(np.abs(r).max()))
    return {layer: num[layer] / den[layer] for layer in num}


def check_gradients(jax_loss, params, inputs, port_loss, model):
    """The port's fp32 loss and per-layer gradients against JAX's float64
    ones. jax_loss(params, inputs) -> scalar, differentiated in params
    (params and inputs cast to float64, jitted here); port_loss(model) ->
    scalar tensor. Returns (worst layer, its reading, the floor)."""
    with jax.enable_x64(True):
        value_and_grad = jax.jit(jax.value_and_grad(jax_loss))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        inputs = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), inputs)

        def grads_of(p):
            loss, g = value_and_grad(p, inputs)
            g = flax_to_state_dict({"params": jax.tree.map(np.asarray, g)})
            return float(loss), {k: v.numpy() for k, v in g.items()}

        ref_loss, ref = grads_of(params)
        signs = np.random.RandomState(1)
        nudged = jax.tree.map(lambda a: a * (1 + 1e-7 * np.sign(signs.randn(*a.shape))), params)
        floor = max(_layer_max_rel(grads_of(nudged)[1], ref).values())

    loss = port_loss(model)
    loss.backward()
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads.keys() == ref.keys()
    rels = _layer_max_rel(grads, ref)
    gate = max(2e-5, 2 * floor)
    worst = max(rels, key=rels.get)
    assert rels[worst] <= gate, (worst, rels[worst], floor)
    return worst, rels[worst], floor


def batch(seed=0, B=2, H=64, W=96):
    """Seeded frames in [0, 1] (the JAX trainers divide by 255), a GT flow
    and a valid mask."""
    rng = np.random.RandomState(seed)
    img1, img2 = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    gt = rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32)
    valid = (rng.rand(B, H, W) > 0.2).astype(np.float32)
    return img1, img2, gt, valid
