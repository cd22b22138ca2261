"""RAFT with the fused SepConvGRU (`RAFTConfig.fused_gru`) against the JAX
package, on the CPU.

The JAX fused model hands off to `sepconv_gru_reference` on the CPU
(`models/update.py:90-91`); the port's runs K7's plain version. Shared seeded
weights through `utils/weights.py`, 64x96 crops of the golden frames,
two iterations.
Tolerances are those of `tests/test_torch_raft.py` for the unfused model:
  - fp32, test mode and train mode: EPE mean < 1e-3;
  - bf16 policy: EPE mean < 0.02 px (bench.py's bf16 bar), against JAX's
    *unfused* bf16 model: JAX's fused bf16 model cannot run on the CPU
    (reference fault 1, ROADMAP.md Queue 3).
The fused train step against the unfused one is in
`tests/test_torch_fused_train.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.gru_fused import sepconv_gru_pallas
from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.utils.torch_convert import save_flax_checkpoint as jax_save
from raft_optical_flow_tpu_torch.kernels import gru_fused as gf
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_npz,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
ITERS = 2


@pytest.fixture(scope="module")
def crop():
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    i1 = g["image1"][64:128, 96:192].astype(np.float32)[None]
    i2 = g["image2"][64:128, 96:192].astype(np.float32)[None]
    return i1, i2


@pytest.fixture(scope="module")
def fused_variables():
    """Seeded weights of the port's fused RAFT-standard as a flax tree
    (`utils/weights.py`), with non-trivial frozen BN statistics in the context
    encoder. `test_jax_fused_checkpoint_loads_into_port` holds the tree
    against the JAX fused model's own `init`."""
    model = RAFT(RAFTConfig(fused_gru=True), device="cpu",
                 generator=torch.Generator().manual_seed(11))
    variables = state_dict_to_flax(model.state_dict())
    rng = np.random.RandomState(12)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.5, 0.5, a.shape) if "mean" in jax.tree_util.keystr(p)
                      else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return variables


def _epe(a, b):
    return np.linalg.norm(np.asarray(a, np.float32) - np.asarray(b, np.float32), axis=-1)


def _port(config, variables):
    model = RAFT(config, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _jax_apply(config, variables, i1, i2, **kw):
    model = JaxRAFT(config)
    fwd = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=ITERS, **kw))
    return jax.tree.map(lambda t: np.asarray(t, np.float32),
                        fwd(jax.tree.map(jnp.asarray, variables), jnp.asarray(i1), jnp.asarray(i2)))


def test_fused_test_mode_matches_jax(crop, fused_variables):
    i1, i2 = crop
    ref_lo, ref_up = _jax_apply(JaxRAFTConfig(fused_gru=True), fused_variables, i1, i2,
                                test_mode=True)
    model = _port(RAFTConfig(fused_gru=True), fused_variables)
    assert model.update_block.gru.fused
    gf.reset_launches()
    lo, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=ITERS)
    assert up.shape == (1, 64, 96, 2) and up.dtype == torch.float32
    assert _epe(up.numpy(), ref_up).mean() < 1e-3
    assert _epe(lo.numpy(), ref_lo).mean() < 1e-3
    assert gf.LAUNCHES == {"sepconv_gru_pass": 0}  # the CPU runs the plain version


def test_fused_train_mode_matches_jax(crop, fused_variables):
    i1, i2 = crop
    ref = _jax_apply(JaxRAFTConfig(fused_gru=True), fused_variables, i1, i2, test_mode=False)
    model = _port(RAFTConfig(fused_gru=True), fused_variables)
    with torch.no_grad():
        preds = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=ITERS, test_mode=False)
    assert preds.shape == ref.shape == (ITERS, 1, 64, 96, 2)
    for k in range(ITERS):
        assert _epe(preds[k].numpy(), ref[k]).mean() < 1e-3, k


def test_fused_bf16_serving_matches_jax_unfused(crop, fused_variables):
    i1, i2 = crop
    _, ref_up = _jax_apply(JaxRAFTConfig(compute_dtype=jnp.bfloat16), fused_variables, i1, i2,
                           test_mode=True)
    model = _port(RAFTConfig(fused_gru=True, compute_dtype=torch.bfloat16), fused_variables)
    _, up = model(torch.from_numpy(i1), torch.from_numpy(i2), iters=ITERS)
    assert up.dtype == torch.float32
    assert _epe(up.numpy(), ref_up).mean() < 0.02


def test_reference_faults_and_bf16_fused_training_refused(crop, fused_variables):
    """Reference fault 1: JAX's fused bf16 model does not trace on the CPU (its
    CPU hand-off returns fp32 into a bf16 scan carry). Reference fault 2:
    K7's VJP under bf16 casts the cotangent to bf16 against an fp32 reference
    output. The port follows the Pallas kernel's bf16 forward and refuses bf16
    fused training with a ValueError that points at ROADMAP.md Queue 3."""
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    bf16_fused = JaxRAFT(JaxRAFTConfig(fused_gru=True, compute_dtype=jnp.bfloat16))
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        jax.jit(lambda k: bf16_fused.init(k, img, img, iters=1, test_mode=True))(
            jax.random.PRNGKey(0))
    rng = np.random.RandomState(14)
    params = {f"conv{g}{s}": (jnp.asarray(rng.randn(*ks, 40, 16) * 0.05, jnp.float32),
                              jnp.zeros(16, jnp.float32))
              for s, ks in (("1", (1, 5)), ("2", (5, 1))) for g in "zrq"}
    h = jnp.asarray(rng.randn(1, 8, 16, 16), jnp.bfloat16)
    x = jnp.asarray(rng.randn(1, 8, 16, 24), jnp.bfloat16)
    with pytest.raises(ValueError, match="got bfloat16.*but expected float32"):
        jax.grad(lambda a: jnp.sum(sepconv_gru_pallas(a, x, params, True).astype(jnp.float32)))(h)

    i1, i2 = (torch.from_numpy(a) for a in crop)
    model = _port(RAFTConfig(fused_gru=True, compute_dtype=torch.bfloat16), fused_variables)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 3"):
        model(i1, i2, iters=1, test_mode=False)


def test_jax_fused_checkpoint_loads_into_port(fused_variables, tmp_path):
    # the JAX fused model's variable tree (traced, not run) is the port's
    img = jax.ShapeDtypeStruct((1, 64, 96, 3), jnp.float32)
    tree = jax.eval_shape(lambda k, a: JaxRAFT(JaxRAFTConfig(fused_gru=True)).init(
        k, a, a, iters=1, test_mode=True), jax.random.PRNGKey(11), img)

    def shapes(t):
        return {jax.tree_util.keystr(p): tuple(a.shape)
                for p, a in jax.tree_util.tree_flatten_with_path(dict(t))[0]}

    assert shapes(tree) == shapes(fused_variables)
    path = str(tmp_path / "raft_fused.npz")
    jax_save(fused_variables, path)
    sd = load_flax_npz(path)
    model = RAFT(RAFTConfig(fused_gru=True), device="cpu")
    model.load_state_dict(sd, strict=True)
    kernel = fused_variables["params"]["update_block"]["block"]["gru"]["convq2"]["kernel"]
    np.testing.assert_array_equal(model.update_block.gru.convq2.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))
