"""The port's data-parallel RAFT step against the JAX package's SPMD step (CPU).

Two gloo processes of the port (`tests/torch_dist_worker.py`, job raft_bn)
take one `RAFTTrainer.train_step` of RAFT-standard at the chairs stage
(BatchNorm training), batch 4 at 64x64 (the smallest size whose four
pyramid levels are not empty), 2 iterations, each on its two rows; the JAX
package's `raft_train_step` takes the same step on a 2-device
`make_mesh(2)` + `shard_batch`, from the same weights. The two halves of
the batch differ in their statistics (the second pair is dimmed and
shifted), so BatchNorm statistics taken per process would differ from the
global batch's.

Tolerances (those of tests/test_torch_train_bn.py): loss and the epe metric
rel 1e-5; the 1px/3px/5px fractions abs 1e-4 (a pixel crossing a threshold
moves one by 1/16384); `grad_norm` rel 1e-4 (gradients are held to 1e-4 of
the global norm); BatchNorm statistics abs 1e-5. The updated parameters are
held to the statistical bound of the JAX package's
`tests/test_cli_multiprocess.py` (max |d| < 1e-3, fewer than 1% of the
elements off by more than 1e-6): AdamW's first update is about lr *
sign(gradient), so a gradient within rounding of zero can flip an element by
2 lr. Every value the processes replicate is equal on both.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_optical_flow_tpu.parallel.mesh import shard_batch as jax_shard_batch
from raft_optical_flow_tpu.train.trainer import TrainState, make_optimizer, raft_train_step
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    save_flax_checkpoint,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

H = W = 64
B = 4
LR = 4e-4


def _batch():
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens", "raft_small.npz"))
    f1, f2 = g["image1"].astype(np.float32), g["image2"].astype(np.float32)
    crops = [(40, 60), (90, 150), (20, 200), (100, 30)]
    i1 = np.stack([f1[y:y + H, x:x + W] for y, x in crops])
    i2 = np.stack([f2[y:y + H, x:x + W] for y, x in crops])
    # the second half dimmer and brighter: other BatchNorm statistics
    i1[2:], i2[2:] = 0.4 * i1[2:] + 140.0, 0.4 * i2[2:] + 140.0
    rng = np.random.RandomState(1)
    return {"image1": i1, "image2": i2,
            "flow": rng.uniform(-4, 4, (B, H, W, 2)).astype(np.float32),
            "valid": (rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two processes, started first, and the JAX step meanwhile."""
    d = tmp_path_factory.mktemp("raft_bn")
    batch = _batch()
    model = RAFT(RAFTConfig(), device="cpu", generator=torch.Generator().manual_seed(5))
    variables = state_dict_to_flax(model.state_dict())
    save_flax_checkpoint(variables, str(d / "weights.npz"))
    np.savez(d / "batch.npz", **batch)
    procs = worker.launch("raft_bn", 2, d)
    try:
        config = JaxRAFTConfig()
        tx, _ = make_optimizer(LR, 1e-4, 1e-8, 10)
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
        mesh = jax_make_mesh(2)
        step = jax.jit(lambda s, b: raft_train_step(s, b, jax.random.PRNGKey(1), config=config,
                                                    iters=2, freeze_bn=False))
        new_state, metrics = step(state, jax_shard_batch(batch, mesh))
        ref = {"metrics": {k: float(v) for k, v in metrics.items()},
               "params": _flat(jax.device_get(new_state.params)),
               "batch_stats": _flat(jax.device_get(new_state.batch_stats)),
               "before": _flat(variables["batch_stats"])}
    finally:
        worker.wait(procs)
    return ref, worker.results("raft_bn", 2, d), batch, variables


def test_two_process_step_matches_jax_mesh_step(runs):
    ref, (r0, r1), _, _ = runs
    assert r0.keys() == r1.keys()
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), f"the processes disagree on {k}"
    got = {k.split(":")[-1]: float(v) for k, v in r0.items() if ":metric:" in k}
    assert got.keys() == ref["metrics"].keys()
    for k in ("loss", "epe"):
        assert got[k] == pytest.approx(ref["metrics"][k], rel=1e-5), k
    for k in ("1px", "3px", "5px"):
        assert abs(got[k] - ref["metrics"][k]) <= 1e-4, k
    assert got["grad_norm"] == pytest.approx(ref["metrics"]["grad_norm"], rel=1e-4)

    bs = {k[len("raft_bn:var:batch_stats/"):]: v for k, v in r0.items()
          if k.startswith("raft_bn:var:batch_stats/")}
    assert bs.keys() == ref["batch_stats"].keys() and len(bs) == 2 * 15  # 15 BN layers in cnet
    assert max(np.abs(bs[k] - ref["batch_stats"][k]).max() for k in bs) <= 1e-5
    assert min(np.abs(ref["before"][k] - ref["batch_stats"][k]).max() for k in bs) > 1e-3

    params = {k[len("raft_bn:var:params/"):]: v for k, v in r0.items()
              if k.startswith("raft_bn:var:params/")}
    assert params.keys() == ref["params"].keys()
    d = np.concatenate([np.abs(params[k] - ref["params"][k]).ravel() for k in params])
    assert d.max() < 1e-3, f"max param diff {d.max():.2e}"
    assert (d > 1e-6).mean() < 0.01, f"{(d > 1e-6).mean():.2%} of the parameters differ"


def test_per_process_batch_norm_statistics_miss_the_bound(runs):
    """The same forward with each process's rows alone (BatchNorm statistics
    per process, as without the all-reduce): the running statistics miss
    the bound the global ones keep, so the test above can fail."""
    ref, _, batch, variables = runs
    worst = []
    for rows in (slice(0, 2), slice(2, 4)):
        model = RAFT(RAFTConfig(), device="cpu")
        model.load_state_dict(flax_to_state_dict(variables))
        with torch.no_grad():
            model(torch.from_numpy(batch["image1"][rows]), torch.from_numpy(batch["image2"][rows]),
                  iters=2, test_mode=False, train=True, freeze_bn=False)
        bs = _flat(state_dict_to_flax(model.state_dict())["batch_stats"])
        worst.append(max(np.abs(bs[k] - ref["batch_stats"][k]).max() for k in bs))
    assert min(worst) > 100 * 1e-5, worst
