"""RAFT with the on-demand correlation (`alternate_corr=True`) in test mode,
against the JAX package's RAFT with `alternate_corr=True`, on the CPU.

Each case runs one crop through both frameworks at shared weights:
  - RAFT-small fp32, checkpoint weights, a 96x128 crop of the golden frames,
    4 iterations: `flow_up` EPE mean < 1e-3 and max < 5e-3 against JAX (the
    bar of tests/test_raft_parity.py), max < 5e-3 against the port's
    materialized path (`test_raft_alternate_corr_matches_allpairs`'s bar);
  - RAFT-standard fp32, seeded JAX-initialized weights with non-trivial
    BatchNorm statistics, a 64x96 crop, 3 iterations from a warm start:
    the same bars;
  - RAFT-standard under the bf16 policy: EPE mean < 0.02 px against JAX's
    bf16 policy (bench.py's bf16 bar; JAX on the CPU computes the on-demand
    windows in fp32 and rounds them, the port takes bf16 operands).
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
from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "tests", "goldens", "raft_small.npz")
CKPT = os.path.join(REPO, "checkpoints", "raft_small.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def standard_weights():
    model = JaxRAFT(JaxRAFTConfig(alternate_corr=True))
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, img, img, iters=1, test_mode=True))(
        jax.random.PRNGKey(11))
    variables = jax.tree.map(np.asarray, dict(variables))
    rng = np.random.RandomState(12)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.5, 0.5, a.shape) if "mean" in jax.tree_util.keystr(p)
                      else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return variables


def _epe(a, b):
    return np.linalg.norm(np.asarray(a, np.float32) - np.asarray(b, np.float32), axis=-1)


CASES = {
    # small, compute dtype, crop (y0, x0, h, w), iterations, warm start
    "small_fp32": (True, "float32", (48, 96, 96, 128), 4, False),
    "standard_fp32": (False, "float32", (64, 96, 64, 96), 3, True),
    "standard_bf16": (False, "bfloat16", (64, 96, 64, 96), 3, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_alternate_corr_test_mode_matches_jax(case, golden, standard_weights):
    small, dtype_name, (y0, x0, h, w), iters, warm = CASES[case]
    i1 = golden["image1"][y0:y0 + h, x0:x0 + w].astype(np.float32)[None]
    i2 = golden["image2"][y0:y0 + h, x0:x0 + w].astype(np.float32)[None]
    flow_init = (np.random.RandomState(13).uniform(-2, 2, (1, h // 8, w // 8, 2))
                 .astype(np.float32) if warm else None)
    variables = jax_load(CKPT) if small else standard_weights
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)

    jmodel = JaxRAFT(JaxRAFTConfig(small=small, alternate_corr=True, compute_dtype=jdt))
    fwd = jax.jit(lambda v, a, b, f: jmodel.apply(v, a, b, iters=iters, flow_init=f,
                                                   test_mode=True))
    _, ref_up = fwd(jax.tree.map(jnp.asarray, variables), jnp.asarray(i1), jnp.asarray(i2),
                    None if flow_init is None else jnp.asarray(flow_init))

    sd = flax_to_state_dict(variables)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    tinit = None if flow_init is None else torch.from_numpy(flow_init)
    model = RAFT(RAFTConfig(small=small, alternate_corr=True, compute_dtype=tdt), device="cpu")
    model.load_state_dict(sd)
    co.reset_launches()
    _, up = model(t1, t2, iters=iters, flow_init=tinit)
    assert up.shape == (1, h, w, 2) and up.dtype == torch.float32
    assert set(co.LAUNCHES.values()) == {0}  # the CPU runs the plain versions
    epe = _epe(up.numpy(), ref_up)
    if dtype_name == "bfloat16":
        assert epe.mean() < 0.02, epe.mean()
        return
    assert epe.mean() < 1e-3 and epe.max() < 5e-3, (epe.mean(), epe.max())
    # the materialized path computes the same windows from the volume
    mat = RAFT(RAFTConfig(small=small), device="cpu")
    mat.load_state_dict(sd)
    _, up_mat = mat(t1, t2, iters=iters, flow_init=tinit)
    assert _epe(up.numpy(), up_mat.numpy()).max() < 5e-3
