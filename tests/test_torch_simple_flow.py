"""The port's SimpleFlowNet against the reference golden and the JAX package.

Tolerances:
  - fp32 at the golden's params against the reference torch outputs: the
    bar of tests/test_simple_ifnet_parity.py (every flow atol 1e-3); the
    bf16 policy against the same golden at test_simple_flow_bf16_policy_close's
    bar (per scale mean |d| < 4e-2, max < 2e-1);
  - against the jitted JAX model at the golden's params, batch 2: fp32
    flows within 1e-4 at 64x96 and 50x70 (eval) and 64x96 (BatchNorm
    training), bf16 at 50x70 at the policy bar above; the BatchNorms' new running statistics after a
    training forward within 1e-6 relative of flax's mutable `batch_stats`;
  - each module (`check_module`) against its JAX counterpart, eval and
    BatchNorm training: fp32 (JAX jitted), every layer's output and the
    module's outputs within 1e-5 * max|ref|, the new running statistics
    within 4e-6 * max|ref| (a module reading 1.35e-6: a batch mean's sums
    over 3,072 values in another order); bf16, every conv's, norm's and
    PReLU's output has JAX's dtype (a cast in the wrong place fails) and
    the mean|d| / mean|ref| of every layer, output and running statistic
    lies within EVAL_BF16 or TRAIN_BF16. Under bf16 the JAX module runs op
    by op, so that every op rounds its output to bf16 as written: jitted
    XLA on the CPU keeps fp32 between fused ops (excess precision), which
    moves whole layers by about 1e-3 and would hide a misplaced rounding.
    Op by op, eval mode agrees bit for bit but for the decoder fed the fp32
    concat; in training mode the batch statistics' fp32 sum order differs.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from raft_optical_flow_tpu.models import layers as jlayers
from raft_optical_flow_tpu.models import simple_flow as jsf
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.models import SimpleFlowConfig, SimpleFlowNet, simple_flow_net
from raft_optical_flow_tpu_torch.models import layers
from raft_optical_flow_tpu_torch.models import simple_flow as tsf
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FP32, BF16 = torch.float32, torch.bfloat16
POLICIES = {"fp32": (FP32, None), "bf16": (BF16, jnp.bfloat16)}
# bf16 bounds on mean|d| / mean|ref|, 4x or more the worst readings: eval
# mode 5.1e-5 (the decoder fed the fp32 concat; every other case bit for
# bit); training mode 1.7e-2 (the feature extractor's res_block5: the
# batch statistics of a 4x6 map amplify each one-step rounding flip through
# ten BatchNorms in training mode)
EVAL_BF16 = 2e-4
TRAIN_BF16 = 4e-2


@pytest.fixture(scope="module")
def golden():
    path = os.path.join(GOLDENS, "simple_flow_params.npz")
    return jax.tree.map(jnp.asarray, jax_load(path)), load_flax_npz(path)


@functools.partial(jax.jit, static_argnums=(3, 4))
def jax_simple_flow(variables, img1, img2, bf16, train):
    """The JAX model's flows (and with `train`, its new batch_stats)."""
    model = jsf.SimpleFlowNet(jsf.SimpleFlowConfig(
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    if train:
        flows, mut = model.apply(variables, img1, img2, train=True, mutable=["batch_stats"])
        return flows, mut["batch_stats"]
    return model.apply(variables, img1, img2), None


def _np(x):
    """NHWC fp32 numpy of a port tensor (NCHW) or a JAX array (NHWC)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
        return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mean_rel(got, ref):
    return float(np.abs(got - ref).mean() / max(float(np.abs(ref).mean()), 1e-30))


def _flat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + (k,))
        else:
            yield pre + (k,), v


HOOKED = (nn.Conv2d, nn.ConvTranspose2d, layers.Norm, layers.PReLU)


def check_module(policy, jmodule, variables, jargs, pmodule, pargs, what, jkw=None, pkw=None,
                 train=False, bounds=None):
    """Runs the JAX module under `policy`, capturing every submodule's
    output (and with `train` its new batch_stats), and the port module,
    hooking every conv, transposed conv, norm and PReLU; holds them to the
    policy's gates (module docstring). `what` names the outputs; `bounds`,
    the bf16 bounds of the layers and of the outputs, defaults to
    EVAL_BF16 or TRAIN_BF16 for both. Returns the readings {name:
    mean_rel} under bf16."""
    def apply(v, *a):
        with jlayers.compute_dtype_scope(POLICIES[policy][1]):
            return jmodule.apply(v, *a, capture_intermediates=True, **(jkw or {}),
                                 mutable=["intermediates"] + (["batch_stats"] if train else []))

    ref, state = (jax.jit(apply) if policy == "fp32" else apply)(variables, *jargs)
    ref_layers = {".".join(p[:-1]): v[0] for p, v in _flat(state["intermediates"])
                  if p[-1] == "__call__" and len(p) > 1}
    got_layers = {}
    hooks = [m.register_forward_hook(lambda _m, _i, o, n=n: got_layers.__setitem__(n, o))
             for n, m in pmodule.named_modules() if isinstance(m, HOOKED)]
    got = pmodule(*pargs, **(pkw or {}))
    for h in hooks:
        h.remove()
    got, ref = (tuple(x) if isinstance(x, (tuple, list)) else (x,) for x in (got, ref))
    assert len(got) == len(ref) == len(what)
    assert got_layers and got_layers.keys() <= ref_layers.keys()
    readings = {}
    layer_bound, bound = bounds or (TRAIN_BF16 if train else EVAL_BF16,) * 2
    for name in got_layers:
        g, r = got_layers[name], ref_layers[name]
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        g, r = _np(g), _np(r)
        if policy == "fp32":
            assert np.abs(g - r).max() <= 1e-5 * max(float(np.abs(r).max()), 1e-30), name
        else:
            readings[name] = _mean_rel(g, r)
            assert readings[name] <= layer_bound, (name, readings[name])
    for name, g, r in zip(what, got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, name
        if policy == "fp32":
            assert np.abs(g - r).max() <= 1e-5 * max(float(np.abs(r).max()), 1e-30), name
        else:
            readings[name] = _mean_rel(g, r)
            assert readings[name] <= bound, (name, readings[name])
    if train:
        stats = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, state["batch_stats"])})
        sd = pmodule.state_dict()
        assert stats.keys() <= sd.keys() and stats
        for k, v in stats.items():
            g, r = sd[k].numpy(), v.numpy()
            if policy == "fp32":
                assert np.abs(g - r).max() <= 4e-6 * np.abs(r).max(), k
            else:
                readings[k] = _mean_rel(g, r)
                assert readings[k] <= bound, (k, readings[k])
    return readings


def _port(module, sd, prefix):
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()
                            if k.startswith(prefix + ".")}, strict=True)
    return module


def _sub(variables, *path):
    """The collections' subtrees at `path` (a collection without one is left out)."""
    out = {}
    for col, tree in variables.items():
        for p in path:
            tree = tree.get(p, {})
        if tree:
            out[col] = tree
    return out


def _nchw(a, dtype=FP32):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(dtype)


def _jnp(a, policy, feature=True):
    return jnp.asarray(a, jnp.bfloat16 if feature and policy == "bf16" else jnp.float32)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("block,cin,cout,stride", [("res_block1", 32, 32, 1),
                                                   ("res_block2", 32, 64, 2)])
def test_residual_block(golden, block, cin, cout, stride, train, policy):
    jv, sd = golden
    x = np.maximum(np.random.RandomState(cin + stride).randn(2, 12, 18, cin), 0).astype(np.float32)
    dt = POLICIES[policy][0]
    prefix = f"feature_extractor.{block}"
    port = _port(tsf.SFResidualBlock(cin, cout, stride, dt), sd, prefix)
    assert hasattr(port, "shortcut_0") == (stride != 1)
    check_module(policy, jsf.SFResidualBlock(cout, stride), _sub(jv, "feature_extractor", block),
                 (_jnp(x, policy),), port, (_nchw(x, dt), train), ["out"], jkw=dict(train=train),
                 train=train)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("train", [False, True])
def test_feature_extractor(golden, train, policy):
    jv, sd = golden
    x = np.random.RandomState(1).rand(2, 32, 48, 3).astype(np.float32)
    port = _port(tsf.SFFeatureExtractor(3, 64, POLICIES[policy][0]), sd, "feature_extractor")
    check_module(policy, jsf.SFFeatureExtractor(64), _sub(jv, "feature_extractor"),
                 (jnp.asarray(x),), port, (_nchw(x), train), ["1/2", "1/4", "1/8"],
                 jkw=dict(train=train), train=train)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("coarsest", [True, False])
def test_flow_decoder(golden, coarsest, policy):
    """The coarsest scale's correlation alone (a zero flow joins it), or
    the fp32 concat of correlation and flow, as the model passes them."""
    jv, sd = golden
    rng = np.random.RandomState(2)
    corr = rng.uniform(-1, 1, (2, 8, 12, 81)).astype(np.float32)
    if policy == "bf16":
        corr = np.array(jnp.asarray(corr, jnp.bfloat16).astype(jnp.float32))
    dt = POLICIES[policy][0]
    if coarsest:
        jx, px = _jnp(corr, policy), _nchw(corr, dt)
    else:
        x = np.concatenate([corr, rng.uniform(-1, 1, (2, 8, 12, 2)).astype(np.float32)], -1)
        jx, px = jnp.asarray(x), _nchw(x)
    port = _port(tsf.SFFlowDecoder(81, dt), sd, "flow_decoder")
    check_module(policy, jsf.SFFlowDecoder(), _sub(jv, "flow_decoder"), (jx,), port, (px,),
                 ["flow"])


def _model(sd, dtype=FP32):
    model = SimpleFlowNet(SimpleFlowConfig(compute_dtype=dtype), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _golden_images():
    g = np.load(os.path.join(GOLDENS, "simple_flow.npz"))
    return g, [torch.from_numpy(g[k]).permute(0, 2, 3, 1).contiguous() for k in ("img1", "img2")]


def test_matches_golden(golden):
    g, images = _golden_images()
    flows = _model(golden[1])(*images)
    assert len(flows) == 3
    for i, f in enumerate(flows):
        assert f.dtype == FP32
        np.testing.assert_allclose(f.numpy().transpose(0, 3, 1, 2), g[f"flow_{i}"], atol=1e-3,
                                   err_msg=f"flow_{i}")


def test_bf16_policy_close_to_golden(golden):
    g, images = _golden_images()
    for i, f in enumerate(_model(golden[1], BF16)(*images)):
        assert f.dtype == FP32
        diff = np.abs(f.numpy().transpose(0, 3, 1, 2) - g[f"flow_{i}"])
        assert diff.mean() < 4e-2 and diff.max() < 2e-1, (i, diff.mean(), diff.max())


def _images(B, H, W, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("hw,policy", [((64, 96), "fp32"), ((50, 70), "fp32"),
                                       ((50, 70), "bf16")])
def test_matches_jax(golden, hw, policy):
    jv, sd = golden
    a, b = _images(2, *hw, seed=hw[0])
    ref, _ = jax_simple_flow(jv, jnp.asarray(a), jnp.asarray(b), policy == "bf16", False)
    out = _model(sd, POLICIES[policy][0])(torch.from_numpy(a), torch.from_numpy(b))
    assert [tuple(f.shape) for f in out] == [r.shape for r in ref]
    for f, r in zip(out, ref):
        assert f.dtype == FP32 and str(r.dtype) == "float32"
        d = np.abs(f.numpy() - np.asarray(r))
        if policy == "fp32":
            assert d.max() <= 1e-4, d.max()
        else:
            assert d.mean() < 4e-2 and d.max() < 2e-1, (d.mean(), d.max())
    # the flows are not trivially small: the bound is meaningful
    assert float(np.abs(np.asarray(ref[-1])).mean()) > 0.05


def test_train_mode_matches_jax(golden):
    """train=True: flows from batch statistics, and the BatchNorms' running
    statistics updated twice a pass (frame 1's features, then frame 2's),
    as flax's mutable batch_stats; then the unsupervised step's backward
    pass (img2, img1) on the statistics the first pass left."""
    jv, sd = golden
    a, b = _images(2, 64, 96, seed=3)
    model = _model(sd)
    for first, second in ((a, b), (b, a)):
        ref, new_stats = jax_simple_flow(jv, jnp.asarray(first), jnp.asarray(second), False, True)
        flows = model(torch.from_numpy(first), torch.from_numpy(second), train=True)
        assert all(f.requires_grad for f in flows)
        for f, r in zip(flows, ref):
            assert np.abs(f.detach().numpy() - np.asarray(r)).max() <= 1e-4
        want = flax_to_state_dict({"batch_stats": jax.tree.map(np.asarray, new_stats)})
        got = model.state_dict()
        assert len(want) == 26  # every BatchNorm's mean and var
        for k, v in want.items():
            assert not np.array_equal(v.numpy(), sd[k].numpy()), k  # they moved
            rel = np.abs(got[k].numpy() - v.numpy()).max() / np.abs(v.numpy()).max()
            assert rel <= 1e-6, (k, rel)
        jv = dict(jv, batch_stats=new_stats)


def test_constructor_and_defaults():
    model = simple_flow_net(device="cpu", compute_dtype=BF16)
    assert model.config == SimpleFlowConfig(compute_dtype=BF16)
    assert not model.training
    with pytest.raises(ValueError):
        SimpleFlowNet(SimpleFlowConfig(compute_dtype=torch.float16), device="cpu")
    # seeded init: the same generator seed gives the same weights
    a = simple_flow_net(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    b = simple_flow_net(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
