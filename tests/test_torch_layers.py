"""Port layers and encoders against the JAX package, on the CPU.

Same seeded numpy inputs and the same weights (carried across with
`utils/weights.py`) through both. Tolerances: single layers 1e-5 max abs (fp32
rounding of one conv or norm); whole encoders 1e-4, the bar of
`tests/test_raft_parity.py` for the encoders against the reference golden.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from raft_optical_flow_tpu.models import layers as jl
from raft_optical_flow_tpu.models.extractor import BasicEncoder as JBasic
from raft_optical_flow_tpu.models.extractor import SmallEncoder as JSmall
from raft_optical_flow_tpu_torch.models import layers as tl
from raft_optical_flow_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize_batch_stats(variables, seed):
    """Non-trivial running stats, so frozen BN is really exercised."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.asarray, dict(variables))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: (rng.uniform(0.5, 2.0, a.shape) if a.ndim else a).astype(np.float32),
            v["batch_stats"],
        )
        # means may be negative
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: a - 1.0 if "mean" in jax.tree_util.keystr(p) else a, v["batch_stats"]
        )
    return v


@pytest.mark.parametrize(
    "cin,cout,k,s,p",
    [(3, 16, 7, 2, 3), (8, 12, 3, 1, 1), (8, 12, 1, 2, 0), (6, 5, (1, 5), 1, (0, 2)), (6, 5, (5, 1), 1, (2, 0))],
)
def test_conv_matches_jax(cin, cout, k, s, p):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 13, 18, cin).astype(np.float32)
    jconv = jl.conv(cout, k, s, p, name="c")
    params = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32), params)
    ref = np.asarray(jconv.apply(params, jnp.asarray(x)))
    conv = tl.conv(cin, cout, k, s, p)
    conv.load_state_dict(flax_to_state_dict(params))
    out = _nhwc(conv(_nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_instance_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 9, 11, 7) * 3 + 2).astype(np.float32)
    ref = np.asarray(jl.instance_norm(jnp.asarray(x)))
    out = _nhwc(tl.instance_norm(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


class _JNorm(nn.Module):
    norm_fn: str
    features: int
    num_groups: int = None

    @nn.compact
    def __call__(self, x):
        return jl.apply_norm(x, self.norm_fn, self.features, name="n", num_groups=self.num_groups)


@pytest.mark.parametrize("norm_fn", ["group", "batch", "instance", "none"])
def test_apply_norm_matches_jax(norm_fn):
    rng = np.random.RandomState(2)
    C = 16
    x = (rng.randn(2, 6, 10, C) * 2 + 0.5).astype(np.float32)
    jm = _JNorm(norm_fn, C, 4 if norm_fn == "group" else None)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(-0.3, 0.3, a.shape).astype(np.float32), dict(v))
    if "batch_stats" in v:
        v["batch_stats"]["n"]["var"] = np.abs(v["batch_stats"]["n"]["var"]) + 0.5
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    norm = tl.Norm(norm_fn, C, 4 if norm_fn == "group" else None)
    sd = {k[2:]: t for k, t in flax_to_state_dict(v).items()}  # strip "n."
    norm.load_state_dict(sd, strict=True)
    out = _nhwc(norm(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "kind,norm_fn,out_dim",
    [("small", "instance", 128), ("small", "none", 160), ("basic", "instance", 256), ("basic", "batch", 256)],
)
def test_encoder_matches_jax(kind, norm_fn, out_dim):
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jcls, tcls = (JSmall, SmallEncoder) if kind == "small" else (JBasic, BasicEncoder)
    jm = jcls(out_dim, norm_fn)
    v = _randomize_batch_stats(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)), 5)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    enc = tcls(out_dim, norm_fn)
    enc.load_state_dict(flax_to_state_dict(v), strict=True)
    out = _nhwc(enc(_nchw(x)))
    assert out.shape == ref.shape == (2, 4, 6, out_dim)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_raft_small_encoders_match_golden():
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    sd = load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    fnet, cnet = SmallEncoder(128, "instance"), SmallEncoder(160, "none")
    fnet.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("fnet.")})
    cnet.load_state_dict({k[5:]: v for k, v in sd.items() if k.startswith("cnet.")})
    im = np.stack([g["image1"], g["image2"]]).astype(np.float32)
    im = 2 * (im / 255.0) - 1
    with torch.no_grad():
        fm = _nhwc(fnet(_nchw(im)))
        cn = _nhwc(cnet(_nchw(im[:1])))
    assert np.abs(fm[:1] - g["fmap1"]).max() < 1e-4
    assert np.abs(fm[1:] - g["fmap2"]).max() < 1e-4
    assert np.abs(cn - g["cnet"]).max() < 1e-4


def test_bf16_conv_runs_in_input_dtype():
    conv = tl.conv(4, 6, 3, 1, 1)
    x = torch.randn(1, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    y = conv(x.bfloat16())
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    torch.testing.assert_close(y.float(), conv(x), atol=0.05, rtol=0.05)


def test_unknown_norm_is_refused():
    with pytest.raises(ValueError):
        tl.Norm("layer", 8)
