"""Each module of the port's LiteFlowNet3 against its JAX counterpart, at the
goldens' weights and seeded inputs, under the fp32 and the bf16 policy.

fp32: max|d| within 1e-5 of the largest value of the JAX output (the same
convs and correlations, their sums in another order); conf maps, which
pass a sigmoid, within 1e-5 absolute.

bf16 (JAX under `compute_dtype_scope(bfloat16)`, the port at
compute_dtype=bfloat16; features go in as bf16, flow, conf and images as
fp32, as the models pass them): every conv's and transposed conv's output
has JAX's dtype (so a cast in the wrong place fails: a transposed conv run
in bf16, or a conv fed by an fp32 concat left in fp32), and the module's
outputs have JAX's dtypes. Values: mean|d| / mean|ref| of each layer's
output within LAYER_BF16 and of each module output within OUT_BF16, each
bound set from the worst reading over these cases. Both sides run the
same rounding steps (the bias added after the conv's rounding, the leaky
slope rounded to bf16), and most layers agree bit for bit. What differs:
the rare element whose fp32 sum lands on the other side of a bf16
rounding; XLA's excess precision on the CPU, which may skip a bf16
rounding between fused ops (the warp of a bf16 displacement, the
distance softmax, whose exp amplifies a one-step change of its logits);
and JAX's bf16 sigmoid, which rounds exp, the sum and the reciprocal each
to bf16 (a third of its values one step from the correctly rounded one
that torch returns).

The modules' inputs are NHWC here and NCHW in the port.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from raft_optical_flow_tpu.models import layers as jlayers
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

# the modules, not the constructors of the same name that `models` exports
jl = importlib.import_module("raft_optical_flow_tpu.models.liteflownet3")
tl = importlib.import_module("raft_optical_flow_tpu_torch.models.liteflownet3")

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FP32, BF16 = torch.float32, torch.bfloat16
POLICIES = {"fp32": (FP32, None), "bf16": (BF16, jnp.bfloat16)}
CH = (192, 128, 96, 64)
HW = ((2, 3), (4, 6), (8, 12), (16, 24))  # levels 0..3 at a 64x96 input
LAYER_BF16 = 2e-3  # 2.5x the worst reading, 7.9e-4 (Regularization level 2's conf_pred_0)
OUT_BF16 = 5e-3  # 2x the worst, 2.5e-3 (Regularization level 2's flow; a conf map 2.5e-3)


def _golden(name):
    path = os.path.join(GOLDENS, f"{name}_params.npz")
    return jax_load(path)["params"], load_flax_npz(path)


@pytest.fixture(scope="module")
def standard():
    return _golden("lfn3_standard")


@pytest.fixture(scope="module")
def s_pseudoreg():
    return _golden("lfn3_s_pseudoreg")


def _port(module, sd, prefix):
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()
                            if k.startswith(prefix + ".")}, strict=True)
    return module


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _np(x):
    """NHWC fp32 numpy of a port tensor (NCHW) or a JAX array (NHWC)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
        return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mean_rel(got, ref):
    return float(np.abs(got - ref).mean() / max(float(np.abs(ref).mean()), 1e-30))


def check(policy, jmodule, tree, jargs, pmodule, pargs, what, conf=()):
    """Runs the JAX module under `policy` (capturing each layer's output) and
    the port module (hooking each conv and transposed conv), and holds them
    to the policy's gates; `what` names the outputs, `conf` those that are
    sigmoid maps."""
    def apply(p, *a):
        with jlayers.compute_dtype_scope(POLICIES[policy][1]):
            return jmodule.apply({"params": p}, *a, capture_intermediates=True,
                                 mutable=["intermediates"])

    ref, inter = jax.jit(apply)(jax.tree.map(jnp.asarray, tree), *jargs)
    ref_layers = {k: v["__call__"][0] for k, v in inter["intermediates"].items()
                  if k != "__call__"}
    got_layers = {}
    hooks = [m.register_forward_hook(lambda _m, _i, o, n=n: got_layers.__setitem__(n, o))
             for n, m in pmodule.named_children()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    got = _tuple(pmodule(*pargs))
    for h in hooks:
        h.remove()
    ref = _tuple(ref)
    assert len(got) == len(ref) == len(what)
    assert got_layers.keys() == ref_layers.keys()
    for name in ref_layers:
        assert str(got_layers[name].dtype).split(".")[-1] == str(ref_layers[name].dtype), name
    for name, g, r in zip(what, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert str(g.dtype).split(".")[-1] == str(r.dtype), name
        g, r = _np(g), _np(r)
        assert g.shape == r.shape, name
        if policy == "fp32":
            scale = 1.0 if name in conf else max(float(np.abs(r).max()), 1e-30)
            assert np.abs(g - r).max() <= 1e-5 * scale, (name, float(np.abs(g - r).max()), scale)
        else:
            assert _mean_rel(g, r) <= OUT_BF16, (name, _mean_rel(g, r))
    if policy == "bf16":
        for name in ref_layers:
            err = _mean_rel(_np(got_layers[name]), _np(ref_layers[name]))
            assert err <= LAYER_BF16, (name, err)


def _feat(a, policy):
    """A feature map as both sides take it: rounded to bf16 under bf16."""
    if policy == "fp32":
        return a
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _j(a, policy=None, feature=False):
    if a is None:
        return None
    return jnp.asarray(a, jnp.bfloat16 if feature and policy == "bf16" else jnp.float32)


def _t(a, policy=None, feature=False):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)
    return t.to(BF16) if feature and policy == "bf16" else t


def _inputs(level, seed, policy, B=2):
    rng = np.random.RandomState(seed)
    h, w = HW[level]
    f1 = _feat(rng.randn(B, h, w, CH[level]).astype(np.float32), policy)
    f2 = _feat(rng.randn(B, h, w, CH[level]).astype(np.float32), policy)
    flow = rng.uniform(-1, 1, (B, h, w, 2)).astype(np.float32)
    return rng, f1, f2, flow


def test_config_and_unfold():
    for kw in (dict(), dict(use_s_version=True)):
        jc, tc = jl.LFN3Config(**kw), tl.LFN3Config(**kw)
        assert jc.min_mod_level == tc.min_mod_level
        assert [jc.mult(i) for i in range(4)] == [tc.mult(i) for i in range(4)]
    x = np.random.RandomState(0).randn(2, 7, 9, 2).astype(np.float32)
    for k in (3, 5, 7):
        got = tl._unfold_neighbors(_t(x), k)  # [N, C, k*k, H, W]
        for c in range(2):
            ref = np.asarray(jl._unfold_neighbors(jnp.asarray(x[..., c:c + 1]), k))
            np.testing.assert_array_equal(got[:, c].permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_feature_extractor(standard, policy):
    tree, sd = standard
    x = np.random.RandomState(1).rand(4, 64, 96, 3).astype(np.float32)
    port = _port(tl.FeatureExtractor(POLICIES[policy][0]), sd, "feature_net")
    check(policy, jl.FeatureExtractor(), tree["feature_net"], (_j(x),), port, (_t(x),),
          [f"level {i}" for i in range(4)])


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("golden,level,j", [("standard", 2, 0), ("standard", 3, 1),
                                            ("s_pseudoreg", 1, 0)])
def test_flow_field_deformation(golden, level, j, policy, request):
    tree, sd = request.getfixturevalue(golden)
    rng, f1, f2, _ = _inputs(level, level, policy)
    h, w = HW[level - 1]
    flow = rng.uniform(-1, 1, (2, h, w, 2)).astype(np.float32)
    conf = rng.rand(2, h, w, 1).astype(np.float32)
    name = f"deformation_nets_{j}"
    port = _port(tl.FlowFieldDeformation(level, POLICIES[policy][0]), sd, name)
    check(policy, jl.FlowFieldDeformation(level), tree[name],
          (_j(f1, policy, True), _j(f2, policy, True), _j(flow), _j(conf)),
          port, (_t(f1, policy, True), _t(flow), _t(conf)), ["flow", "conf"], conf=["conf"])


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("golden,level,j", [("standard", 2, 0), ("s_pseudoreg", 1, 0)])
def test_cost_volume_modulation(golden, level, j, policy, request):
    tree, sd = request.getfixturevalue(golden)
    rng, f1, f2, flow = _inputs(level, 10 + level, policy)
    conf = rng.rand(2, *HW[level], 1).astype(np.float32)
    cfg = dict(use_s_version=golden == "s_pseudoreg")
    name = f"modulation_nets_{j}"
    port = _port(tl.CostVolumeModulation(
        level, tl.LFN3Config(compute_dtype=POLICIES[policy][0], **cfg)), sd, name)
    check(policy, jl.CostVolumeModulation(level, jl.LFN3Config(**cfg)), tree[name],
          (_j(f1, policy, True), _j(f2, policy, True), _j(flow), _j(conf)),
          port, (_t(f1, policy, True), _t(f2, policy, True), _t(flow), _t(conf)), ["corr"])


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("golden,level,case", [("standard", 0, "first"), ("standard", 1, "up_flow"),
                                               ("s_pseudoreg", 1, "corr"), ("standard", 3, "warp")])
def test_matching(golden, level, case, policy, request):
    tree, sd = request.getfixturevalue(golden)
    rng, f1, f2, flow = _inputs(level, 20 + level, policy)
    corr = None
    if case == "first":
        flow = None
    elif case == "up_flow":
        flow = rng.uniform(-1, 1, (2, *HW[level - 1], 2)).astype(np.float32)
    elif case == "corr":
        corr = _feat(rng.randn(2, *HW[level], 81).astype(np.float32) * 0.1, policy)
    cfg = dict(use_s_version=golden == "s_pseudoreg")
    name = f"matching_nets_{level}"
    port = _port(tl.Matching(level, tl.LFN3Config(compute_dtype=POLICIES[policy][0], **cfg)),
                 sd, name)
    assert hasattr(port, "up_flow") == (case == "up_flow")
    check(policy, jl.Matching(level, jl.LFN3Config(**cfg)), tree[name],
          (_j(f1, policy, True), _j(f2, policy, True), _j(flow), _j(corr, policy, True)),
          port, (_t(f1, policy, True), _t(f2, policy, True), _t(flow), _t(corr, policy, True)),
          ["flow"])


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("level", [0, 3])
def test_subpixel(standard, level, policy):
    tree, sd = standard
    _, f1, f2, flow = _inputs(level, 30 + level, policy)
    name = f"subpixel_nets_{level}"
    port = _port(tl.SubPixel(level, tl.LFN3Config(compute_dtype=POLICIES[policy][0])), sd, name)
    check(policy, jl.SubPixel(level, jl.LFN3Config()), tree[name],
          (_j(f1, policy, True), _j(f2, policy, True), _j(flow)),
          port, (_t(f1, policy, True), _t(f2, policy, True), _t(flow)), ["flow", "features"])


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("golden,level,has_conf", [("standard", 0, False), ("s_pseudoreg", 0, True),
                                                   ("standard", 2, True), ("standard", 3, False)])
def test_regularization(golden, level, has_conf, policy, request):
    tree, sd = request.getfixturevalue(golden)
    rng, f1, _, flow = _inputs(level, 40 + level, policy)
    img1 = rng.rand(2, *HW[level], 3).astype(np.float32)
    img2 = rng.rand(2, *HW[level], 3).astype(np.float32)
    cfg = dict(use_s_version=golden == "s_pseudoreg")
    name = f"regularization_nets_{level}"
    port = _port(tl.Regularization(level, tl.LFN3Config(compute_dtype=POLICIES[policy][0], **cfg)),
                 sd, name)
    assert hasattr(port, "conf_pred_0") == has_conf
    check(policy, jl.Regularization(level, jl.LFN3Config(**cfg)), tree[name],
          (_j(img1), _j(img2), _j(f1, policy, True), _j(flow)),
          port, (_t(img1), _t(img2), _t(f1, policy, True), _t(flow)),
          ["flow", "conf", "features"], conf=["conf"])


@pytest.mark.parametrize("policy", list(POLICIES))
def test_pseudo_subpixel_and_regularization(s_pseudoreg, policy):
    tree, sd = s_pseudoreg
    dt = POLICIES[policy][0]
    rng = np.random.RandomState(50)
    feat = _feat(rng.rand(2, 16, 24, 32).astype(np.float32), policy)
    flow = rng.uniform(-1, 1, (2, 16, 24, 2)).astype(np.float32)
    check(policy, jl.PseudoSubpixel(), tree["pseudo_subpixel"], (_j(feat, policy, True), _j(flow)),
          _port(tl.PseudoSubpixel(dt), sd, "pseudo_subpixel"), (_t(feat, policy, True), _t(flow)),
          ["pseudo_subpixel"])
    flow2 = rng.uniform(-1, 1, (2, 32, 48, 2)).astype(np.float32)
    check(policy, jl.PseudoRegularization(), tree["pseudo_regularization"],
          (_j(feat, policy, True), _j(flow2)),
          _port(tl.PseudoRegularization(dt), sd, "pseudo_regularization"),
          (_t(feat, policy, True), _t(flow2)), ["pseudo_regularization"])
