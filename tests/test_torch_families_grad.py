"""SimpleFlowNet's and IFNet's losses in the port against the JAX package's,
and the shared check of the models' training gradients.

The losses (`simple_flow_loss`, `laploss`, `unsupervised_loss`), value and
gradient, on seeded inputs: values and metrics within 1e-6 relative,
gradients within 1e-5 of the largest. The sums run in another order, and
the GT's half-pixel resize differs from JAX's by an ulp here and there (a
weighted sum in JAX, an interpolation in torch): the EPE's gradient
(p - gt) / |p - gt| turns that into up to 2.3e-6 of the largest where
|p - gt| is small (the finest scale at 50x70, without the smoothness term).

`check_step` (the train steps of every family kind: tests/
test_torch_lfn3_grad.py, test_torch_lfn3_grad_s.py,
test_torch_simple_flow_grad.py, test_torch_ifnet_grad.py and
test_torch_flow_trainers_uflow.py): one optimizer step of the port's
`FlowTrainer` against the JAX package's step function, fp32, batch 2, at
the goldens' params; the loss and metrics, `grad_norm` and each layer's
gradient (weight and bias together) on its own scale, max|d| / max|ref|,
against JAX's floor: JAX against itself under a (1 +- 1e-7) change of every
weight, measured in the same test (ROADMAP.md's rule for gradient
comparisons). SimpleFlowNet and IFNet hold JAX in float64: its fp32
gradients lie further from its own float64 ones than the port's do (3.0e-3
at SimpleFlowNet's first BatchNorm, 1.45e-2 at IFNet's block0.lastconv
under laploss, against the port's 8.1e-6 and 6.6e-6), so an fp32 reference
would measure JAX.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_optical_flow_tpu.losses.laploss import laploss as jax_laploss
from raft_optical_flow_tpu.losses.simple_flow_loss import simple_flow_loss as jax_sf_loss
from raft_optical_flow_tpu.losses.unsupervised import unsupervised_loss as jax_unsup_loss
from raft_optical_flow_tpu.train import trainers as jax_trainers
from raft_optical_flow_tpu.train.trainer import TrainState as JaxTrainState
from raft_optical_flow_tpu_torch.losses import laploss, simple_flow_loss, unsupervised_loss
from raft_optical_flow_tpu_torch.losses.laploss import laplacian_pyramid
from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer
from raft_optical_flow_tpu_torch.utils.grad_check import layer_max_rel
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


def batch(seed=0, B=2, H=64, W=96):
    """Seeded frames in [0, 1] (the JAX trainers divide by 255), a GT flow
    and a valid mask."""
    rng = np.random.RandomState(seed)
    img1, img2 = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    gt = rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32)
    valid = (rng.rand(B, H, W) > 0.2).astype(np.float32)
    return img1, img2, gt, valid


def capture_tx():
    """An optax transformation that leaves the parameters where they are and
    keeps the gradients it is handed as its state: a JAX train step's
    gradients, out of the step function itself."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _rel(got, ref):
    """|got - ref| / |ref|, past 1e-12 of absolute slack (a metric that is 0)."""
    return max(abs(got - ref) - 1e-12, 0.0) / max(abs(ref), 1e-30)


def check_step(kind, variables, batch, jax_config=None, port_config=None, x64=True,
               step_kwargs=None, step=0, frame_floor=False, float64_config=None):
    """One optimizer step of `FlowTrainer(kind)` in the port (fp32, on the
    CPU) against the JAX package's step function (`FlowTrainer.STEP_FNS[kind]`,
    jitted, in float64 with x64), on the same variables (a flax tree) and
    batch (numpy arrays), at train-state step `step`. The loss and every
    metric (`grad_norm` included) within rel 1e-5, each layer's gradient
    within 2e-5, and an entry past that within 2x its floor: JAX against
    itself under a (1 +- 1e-7) change of every weight (ROADMAP.md's rule for
    gradient comparisons), for a metric with `frame_floor` also under such a
    change of every frame pixel, whichever moves it more. With
    `float64_config` (a port model config in float64) the port's step also
    runs in float64, the yardstick: an entry past 1e-5 or 2e-5 passes only
    where its port-fp32 error against float64 is at most JAX fp32's, the
    reading that shows JAX's fp32 carries the difference. The BatchNorm
    statistics the step leaves within 1e-6 of their largest. Returns
    (worst layer, its reading, the floor)."""
    step_fn = jax_trainers.FlowTrainer.STEP_FNS[kind]
    kw = step_kwargs or {}
    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(True) if x64 else contextlib.nullcontext():
        cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
        stats = jax.tree.map(cast, variables.get("batch_stats", {}))
        jbatch = jax.tree.map(cast, batch)
        tx = capture_tx()

        def run(params, b):
            state = JaxTrainState(step=jnp.asarray(step, jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params), tx=tx)
            new_state, metrics = step_fn(state, b, config=jax_config, **kw)
            return new_state.opt_state, new_state.batch_stats, metrics

        jitted = jax.jit(run)

        def grads_of(p, b=jbatch):
            g, bs, m = jitted(p, b)
            g = flax_to_state_dict({"params": jax.tree.map(np.asarray, g)})
            return {k: v.numpy() for k, v in g.items()}, bs, {k: float(v) for k, v in m.items()}

        params = jax.tree.map(cast, variables["params"])
        ref, ref_stats, ref_m = grads_of(params)
        signs = np.random.RandomState(1)
        nudged = jax.tree.map(lambda a: a * (1 + 1e-7 * np.sign(signs.randn(*a.shape))).astype(a.dtype),
                              params)
        noisy = {k: v * (1 + 1e-7 * np.sign(signs.randn(*v.shape))).astype(v.dtype) if
                 k.startswith("image") else v for k, v in jbatch.items()}
        nudged_grads, _, nudged_m = grads_of(nudged)
        floor = max(layer_max_rel(nudged_grads, ref).values())
        m_floor = {k: 0.0 for k in ref_m}
        for m in [nudged_m] + ([grads_of(params, noisy)[2]] if frame_floor else []):
            m_floor = {k: max(f, _rel(m[k], ref_m[k])) for k, f in m_floor.items()}

    def port_step(config, dtype):
        trainer = FlowTrainer(kind, batch["image1"].shape[1:3], model_config=config,
                              restore_variables=variables, step_kwargs=kw, device="cpu")
        trainer.state.step = step
        metrics = trainer.train_step({k: v.astype(dtype) for k, v in batch.items()})
        assert trainer.state.step == step + 1
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}, trainer)

    metrics, grads, trainer = port_step(port_config, np.float32)
    assert metrics.keys() == ref_m.keys()
    assert grads.keys() == ref.keys()
    m_rels = {k: _rel(metrics[k], v) for k, v in ref_m.items()}
    rels = layer_max_rel(grads, ref)
    m_jax_off = {k: True for k in ref_m}
    jax_off = {n: True for n in rels}
    if float64_config is not None:
        m64, g64, _ = port_step(float64_config, np.float64)
        m_jax_off = {k: _rel(metrics[k], m64[k]) <= _rel(v, m64[k]) for k, v in ref_m.items()}
        port_err, jax_err = layer_max_rel(grads, g64), layer_max_rel(ref, g64)
        jax_off = {n: port_err[n] <= jax_err[n] for n in rels}
    for k, r in m_rels.items():
        assert r <= 1e-5 or (r <= 2 * m_floor[k] and m_jax_off[k]), (
            k, metrics[k], ref_m[k], m_floor[k], m_jax_off[k])
    bad = {n: (r, jax_off[n]) for n, r in rels.items()
           if not (r <= 2e-5 or (r <= 2 * floor and jax_off[n]))}
    assert not bad, (bad, floor)
    if ref_stats:
        ref_stats = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, ref_stats)})
        sd = trainer.model.state_dict()
        for k, v in ref_stats.items():
            assert (sd[k] - v).abs().max() <= 1e-6 * max(float(v.abs().max()), 1.0), k
    worst = max(rels, key=rels.get)
    return worst, rels[worst], floor


def step_batch(seed=0, B=2, H=64, W=96):
    """`batch`'s draw as a train step's batch: flow, valid, and frames 0-255
    (the steps divide by 255) on the grid 255 k / 2^16, so that frame / 255
    = k / 2^16 is exact in fp32 and float64 alike (255 k < 2^24). A frame
    whose quotient rounds in fp32 differs from JAX's float64 one by an ulp,
    and laploss's |x| kinks turn that into 1.45e-2 at IFNet's
    block0.lastconv; a coarse grid (1/256) makes ties of its own."""
    img1, img2, gt, valid = batch(seed, B, H, W)
    frame = lambda x: (np.round(x * 2.0**16) * (255.0 / 2.0**16)).astype(np.float32)  # noqa: E731
    return {"image1": frame(img1), "image2": frame(img2), "flow": gt, "valid": valid}
