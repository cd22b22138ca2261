"""The fused SepConvGRU (K7's plain version and its autograd Function)
against the JAX package's `kernels/gru_fused.py`, on the CPU.

JAX runs its Pallas kernel in interpret mode, as `tests/test_kernels.py`
does; the port's wrapper runs its plain version for CPU tensors. Same
numpy-seeded inputs and weights (HWIO there, OIHW here). Tolerances:
  - fp32 forward within 1e-5 (the oracle `tests/test_kernels.py:209`);
  - bf16 forward within one bf16 rounding step of JAX's interpret-mode K7,
    which rounds where the Pallas kernel rounds (operands in bf16, fp32
    sums, rh in bf16, one rounding of h');
  - gradients of h, x and all twelve parameters within 1e-4 of `jax.grad`
    through `sepconv_gru_pallas` (fp32; its backward differentiates the XLA
    reference, as the port's does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.gru_fused import sepconv_gru_pallas
from raft_optical_flow_tpu.kernels.gru_fused import sepconv_gru_reference as jax_reference
from raft_optical_flow_tpu_torch.kernels import gru_fused as gf
from torch_threads import one_torch_thread  # noqa: F401

B, H, D, X = 1, 8, 16, 24


def _case(W, seed=3):
    """h, x and the six gates' (kernel HWIO, bias) as numpy, the shapes of
    tests/test_kernels.py::test_fused_sepconv_gru_matches_reference."""
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H, W, D).astype(np.float32)
    x = rng.randn(B, H, W, X).astype(np.float32)
    params = {}
    for s, ks in (("1", (1, 5)), ("2", (5, 1))):
        for g in "zrq":
            params[f"conv{g}{s}"] = ((rng.randn(*ks, D + X, D) * 0.05).astype(np.float32),
                                     (rng.randn(D) * 0.05).astype(np.float32))
    return h, x, params


def _jax_params(params):
    return {k: (jnp.asarray(w), jnp.asarray(b)) for k, (w, b) in params.items()}


def _torch_params(params, requires_grad=False):
    return {k: (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
                .requires_grad_(requires_grad),
                torch.from_numpy(b.copy()).requires_grad_(requires_grad))
            for k, (w, b) in params.items()}


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's interpret-mode K7 on the W = 16 and W = 37 cases, fp32 and bf16,
    and the fp32 gradients of sum(sin(out)) through its custom VJP."""
    k7 = jax.jit(lambda a, b, p: sepconv_gru_pallas(a, b, p, True))  # interpret mode
    out = {}
    for W in (16, 37):
        h, x, params = _case(W)
        jp = _jax_params(params)
        out[W, "fp32"] = np.asarray(k7(jnp.asarray(h), jnp.asarray(x), jp))
        out[W, "bf16"] = np.asarray(k7(jnp.asarray(h, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
                                       jp).astype(jnp.float32))
        out[W, "ref"] = np.asarray(jax_reference(jnp.asarray(h), jnp.asarray(x), jp))
    h, x, params = _case(37)
    grads = jax.jit(jax.grad(lambda a, b, p: jnp.sum(jnp.sin(k7(a, b, p))), argnums=(0, 1, 2)))(
        jnp.asarray(h), jnp.asarray(x), _jax_params(params))
    out["grads"] = jax.tree.map(np.asarray, grads)
    return out


def _bf16_step(ref):
    """One bf16 rounding step (ulp) at each value of ref."""
    m, e = np.frexp(ref)
    return np.where(ref == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("W", [16, 37])
def test_plain_matches_jax_fp32(jax_outputs, W):
    h, x, params = _case(W)
    gf.reset_launches()
    out = gf.sepconv_gru_cuda(torch.from_numpy(h), torch.from_numpy(x), _torch_params(params))
    assert out.dtype == torch.float32 and out.shape == (B, H, W, D)
    np.testing.assert_allclose(out.numpy(), jax_outputs[W, "fp32"], rtol=1e-5, atol=1e-5)
    assert gf.LAUNCHES == {"sepconv_gru_pass": 0}  # a CPU tensor runs the plain version


@pytest.mark.parametrize("W", [16, 37])
def test_plain_matches_jax_bf16(jax_outputs, W):
    h, x, params = _case(W)
    out = gf.sepconv_gru_plain(torch.from_numpy(h).bfloat16(), torch.from_numpy(x).bfloat16(),
                               _torch_params(params))
    assert out.dtype == torch.bfloat16
    ref = jax_outputs[W, "bf16"]
    assert np.all(np.abs(out.float().numpy() - ref) <= _bf16_step(ref))


@pytest.mark.parametrize("W", [16, 37])
def test_reference_matches_jax(jax_outputs, W):
    h, x, params = _case(W)
    out = gf.sepconv_gru_reference(torch.from_numpy(h), torch.from_numpy(x),
                                   _torch_params(params))
    np.testing.assert_allclose(out.numpy(), jax_outputs[W, "ref"], rtol=1e-5, atol=1e-5)


def test_function_gradients_match_jax(jax_outputs):
    h, x, params = _case(37)
    th = torch.from_numpy(h).permute(0, 3, 1, 2).requires_grad_()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tp = _torch_params(params, requires_grad=True)
    weights = [t for name in gf.GATES for t in tp[name]]
    out = gf.SepConvGRUFused.apply(th, tx, *weights)
    assert out.shape == (B, D, H, 37)
    torch.sin(out).sum().backward()
    gh, gx, gp = jax_outputs["grads"]
    np.testing.assert_allclose(th.grad.permute(0, 2, 3, 1).numpy(), gh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), gx, rtol=1e-4, atol=1e-4)
    for name in gf.GATES:
        w, b = tp[name]
        np.testing.assert_allclose(w.grad.permute(2, 3, 1, 0).numpy(), gp[name][0],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b.grad.numpy(), gp[name][1], rtol=1e-4, atol=1e-4)


def test_function_refuses_bf16_backward():
    h, x, params = _case(16)
    th = torch.from_numpy(h).permute(0, 3, 1, 2).bfloat16().requires_grad_()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    weights = [t for name in gf.GATES for t in _torch_params(params)[name]]
    out = gf.SepConvGRUFused.apply(th, tx, *weights)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="ROADMAP.md Queue 3"):
        out.float().sum().backward()


def test_pass_checks_its_inputs():
    h, x, params = _case(16)
    th, tx = torch.from_numpy(h), torch.from_numpy(x)
    w, b = gf.pass_weights([t for name in gf.GATES[:3] for t in _torch_params(params)[name]],
                           torch.float32)
    assert tuple(w.shape) == (5, D + X, 3 * D) and tuple(b.shape) == (3 * D,)
    with pytest.raises(TypeError):
        gf.gru_pass(th, tx.bfloat16(), w, b, 2)
    with pytest.raises(TypeError):
        gf.gru_pass(th.double(), tx.double(), w, b, 2)
    with pytest.raises(ValueError):
        gf.gru_pass(th[:, :, :8], tx, w, b, 2)
    with pytest.raises(ValueError):
        gf.gru_pass(th.transpose(1, 2), tx.transpose(1, 2), w, b, 2)
    with pytest.raises(ValueError):
        gf.gru_pass(th, tx, w.bfloat16(), b, 2)
    with pytest.raises(ValueError):
        gf.gru_pass(th, tx, w, b, 3)
