"""`utils/grad_parity.py` against the JAX package's oracles on the CPU.

At the JAX package's interpret-mode shapes (lookup 12x16, 3 levels;
on-demand 12x16, C = 32, 2 levels), on the arrays the JAX checks draw
(`default_rng(0)` and `default_rng(1)`), the port's VJPs (the kernels'
plain versions: K3's `corr_lookup_level_bwd_plain`, K5's and K6's plain
sums; and autograd of the plain forwards) match the gradients of JAX's
`loss_xla` (`ops/corr.py::corr_pyramid_lookup`, `_ondemand_xla`): max_rel
within 2e-5 in fp32; bf16 (the volume, or the fmaps) within the bf16 bar
3e-2 of JAX's fp32 oracle on the same bf16 values. One jit of the JAX side.
`run_all()` on the CPU returns every entry ok.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.corr_ondemand import _ondemand_xla
from raft_optical_flow_tpu.ops.corr import corr_pyramid_lookup as jax_lookup
from raft_optical_flow_tpu.utils import grad_parity as jgp
from raft_optical_flow_tpu_torch.kernels.corr_lookup import corr_pyramid_lookup_cuda
from raft_optical_flow_tpu_torch.kernels.corr_ondemand import (
    corr_ondemand_fwd_plain,
    ondemand_corr_pyramid_cuda,
)
from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup
from raft_optical_flow_tpu_torch.utils import grad_parity as gp
from torch_threads import one_torch_thread  # noqa: F401

LK = dict(h=12, w=16, levels=3)
OD = dict(h=12, w=16, C=32)
R = 4


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)


def _jax_grads(lk, od):
    """JAX's oracle gradients: the lookup's volume gradients (fp32 inputs,
    and bf16-rounded ones) and the on-demand fmap gradients (fp32, bf16)."""
    def lookup_grad(pyr, coords, cot):
        return jax.grad(lambda p: jnp.vdot(jax_lookup(p, coords, R), cot))(pyr)

    def ondemand_grad(f1, f2s, coords, cot):
        return jax.grad(lambda a, bs: jnp.vdot(_ondemand_xla(a, bs, coords, R), cot),
                        argnums=(0, 1))(f1, f2s)

    pyr, coords, cot = lk
    f1, f2s, c2, cot2 = od
    return {
        "lookup": lookup_grad(pyr, coords, cot),
        "lookup_bf16": lookup_grad([_bf16(p) for p in pyr], coords, _bf16(cot)),
        "ondemand": ondemand_grad(f1, f2s, c2, cot2),
        "ondemand_bf16": ondemand_grad(_bf16(f1), [_bf16(f) for f in f2s], c2, cot2),
    }


@pytest.fixture(scope="module")
def case():
    lk = gp.lookup_inputs(radius=R, **LK)
    od = gp.ondemand_inputs(radius=R, **OD)
    ref = jax.jit(_jax_grads)(lk, od)
    return lk, od, jax.tree.map(np.asarray, ref)


def _max_rel(got, ref):
    return max(float(np.abs(g.detach().float().numpy() - r).max() / np.abs(r).max())
               for g, r in zip(got, ref))


def _torch_grads(loss_fn, arrays, dtype):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    loss_fn(ts).backward()
    return [t.grad for t in ts]


def test_inputs_are_the_jax_checks_draws():
    """The JAX check's own inputs at these shapes: the same numbers."""
    rng = np.random.default_rng(0)
    Q = LK["h"] * LK["w"]
    first = rng.normal(size=(1, Q, LK["h"], LK["w"])).astype(np.float32)
    np.testing.assert_array_equal(gp.lookup_inputs(radius=R, **LK)[0][0], first)
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(1, OD["h"], OD["w"], OD["C"])).astype(np.float32)
    np.testing.assert_array_equal(gp.ondemand_inputs(radius=R, **OD)[0], f1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_lookup_vjps_match_jax(case, dtype):
    (pyr, coords, cot), _, ref = case
    ref = ref["lookup"] if dtype == torch.float32 else ref["lookup_bf16"]
    tol = gp.VJP_TOL[dtype]
    c = torch.from_numpy(coords)
    g = torch.from_numpy(cot).to(dtype)

    def kernel_path(p):  # K1 forward, K3's plain version backward
        return (corr_pyramid_lookup_cuda(p, c, R, out_dtype=dtype).float() * g.float()).sum()

    def plain(p):
        return (corr_pyramid_lookup([x.float() for x in p], c, R) * g.float()).sum()

    assert _max_rel(_torch_grads(kernel_path, pyr, dtype), ref) <= tol
    assert _max_rel(_torch_grads(plain, pyr, dtype), ref) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_ondemand_vjps_match_jax(case, dtype):
    _, (f1, f2s, coords, cot), ref = case
    ref = ref["ondemand"] if dtype == torch.float32 else ref["ondemand_bf16"]
    ref = [ref[0], *ref[1]]
    tol = gp.VJP_TOL[dtype]
    B, h, w, C = f1.shape
    c = torch.from_numpy(coords)
    g = torch.from_numpy(cot)

    def kernel_path(t):  # K4, K5 and K6 through their plain versions
        out = ondemand_corr_pyramid_cuda(t[0], t[1:], c, R, out_dtype=dtype)
        return (out.float() * g).sum()

    def plain(t):
        out = corr_ondemand_fwd_plain(t[0].float().reshape(B, h * w, C),
                                      [f.float() for f in t[1:]], c.reshape(B, h * w, 2), R)
        return (out.reshape(B, h, w, -1) * g).sum()

    assert _max_rel(_torch_grads(kernel_path, [f1, *f2s], dtype), ref) <= tol
    assert _max_rel(_torch_grads(plain, [f1, *f2s], dtype), ref) <= tol


def test_run_all_on_the_cpu_passes_every_entry():
    res = gp.run_all(device="cpu")
    assert set(res) == {"lookup_vjp", "lookup_vjp_bf16", "ondemand_vjp", "ondemand_vjp_stream"}
    assert all(v["ok"] for v in res.values()), res
    assert res["lookup_vjp"]["tol"] == jgp.DEFAULT_TOL == gp.DEFAULT_TOL
