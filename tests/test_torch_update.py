"""Update blocks: port against the JAX package at shared weights, on the CPU.

JAX `init` at a seed gives the weights; `utils/weights.py` carries them into
the port. Tolerance 1e-4 max abs: a chain of fp32 convs (the encoders' bar in
`tests/test_raft_parity.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import update as jup
from raft_optical_flow_tpu_torch.models import update as tup
from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _inputs(hdim, cdim, corr_ch, seed, N=2, h=6, w=9):
    rng = np.random.RandomState(seed)
    return (
        np.tanh(rng.randn(N, h, w, hdim)).astype(np.float32),
        np.maximum(rng.randn(N, h, w, cdim), 0).astype(np.float32),
        rng.randn(N, h, w, corr_ch).astype(np.float32),
        (rng.randn(N, h, w, 2) * 2).astype(np.float32),
    )


@pytest.mark.parametrize("small", [True, False])
def test_update_block_matches_jax(small):
    hdim, cdim, r = (96, 64, 3) if small else (128, 128, 4)
    corr_ch = 4 * (2 * r + 1) ** 2
    net, inp, corr, flow = _inputs(hdim, cdim, corr_ch, seed=1)
    jb = jup.SmallUpdateBlock(hdim) if small else jup.BasicUpdateBlock(hdim)
    args = tuple(jnp.asarray(a) for a in (net, inp, corr, flow))
    v = jb.init(jax.random.PRNGKey(2), *args)
    jnet, jmask, jdelta = jb.apply(v, *args)
    tb = (tup.SmallUpdateBlock(corr_ch, hdim, cdim) if small
          else tup.BasicUpdateBlock(corr_ch, hdim, cdim))
    tb.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, dict(v))), strict=True)
    with torch.no_grad():
        tnet, tmask, tdelta = tb(*(_nchw(a) for a in (net, inp, corr, flow)))
    np.testing.assert_allclose(_nhwc(tnet), np.asarray(jnet), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_nhwc(tdelta), np.asarray(jdelta), rtol=0, atol=1e-4)
    if small:
        assert jmask is None and tmask is None
    else:
        assert tmask.shape == (2, 576, 6, 9)
        np.testing.assert_allclose(_nhwc(tmask), np.asarray(jmask), rtol=0, atol=1e-4)


@pytest.mark.parametrize("gru", ["ConvGRU", "SepConvGRU"])
def test_gru_matches_jax(gru):
    hdim, xdim = 32, 24
    rng = np.random.RandomState(3)
    h = np.tanh(rng.randn(1, 5, 7, hdim)).astype(np.float32)
    x = rng.randn(1, 5, 7, xdim).astype(np.float32)
    jm = getattr(jup, gru)(hdim)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(h), jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(h), jnp.asarray(x)))
    tm = getattr(tup, gru)(hdim, xdim)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, dict(v))), strict=True)
    with torch.no_grad():
        out = _nhwc(tm(_nchw(h), _nchw(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
