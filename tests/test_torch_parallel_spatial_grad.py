"""The gradient of the port's spatially sharded on-demand correlation (CPU).

`parallel/spatial.py::spatial_sharded_ondemand_corr` on two gloo processes
of a ('data', 'space') = (1, 2) mesh (`tests/torch_dist_worker.py`, job
spatial_grad), at the shapes of `test_torch_parallel_units.py`'s forward
test, against `jax.grad` of the JAX function on a 2-device 'space' mesh:
each process's fmap1 gradient and every level's, of the sum of the slab
losses (each process sum(slab ** 2)) and of the loss of the gathered whole
(every process sum(all_gather_rows(slab) ** 2)); rtol and atol 1e-5, as
the forward. JAX's level gradients are the sum over the slabs; so are the
port's, in another order. With one process the function is the plain
pyramid's autograd, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_worker as worker
from raft_optical_flow_tpu.ops.corr import avg_pool2x2
from raft_optical_flow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_optical_flow_tpu.parallel.spatial import (
    spatial_sharded_ondemand_corr as jax_spatial_corr,
)
from raft_optical_flow_tpu_torch.kernels.corr_ondemand import ondemand_corr_pyramid_plain
from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh
from raft_optical_flow_tpu_torch.parallel.spatial import (
    all_gather_rows,
    spatial_sharded_ondemand_corr,
)
from torch_threads import one_torch_thread  # noqa: F401

B, H, W, C, L, R = 1, 16, 24, 16, 3, 3


def _inputs():
    rng = np.random.RandomState(0)
    fmap1 = rng.randn(B, H, W, C).astype(np.float32)
    fmap2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = (np.stack([gx, gy], -1)[None] + rng.uniform(-3, 3, (B, H, W, 2))).astype(np.float32)
    pyr = [jnp.asarray(fmap2)]
    for _ in range(L - 1):
        pyr.append(avg_pool2x2(pyr[-1].transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1))
    return fmap1, [np.array(p) for p in pyr], coords


def test_spatial_gradients_match_jax_on_a_space_mesh(tmp_path):
    fmap1, pyr, coords = _inputs()
    np.savez(tmp_path / "corr.npz", fmap1=fmap1, coords=coords, levels=L, radius=R,
             **{f"level{i}": p for i, p in enumerate(pyr)})
    procs = worker.launch("spatial_grad", 2, tmp_path)
    try:
        mesh = jax_make_mesh(2, axis_names=("space",))

        def loss(f1, levels):
            return jnp.sum(jax_spatial_corr(f1, levels, jnp.asarray(coords), R, mesh) ** 2)

        ref_df1, ref_df2 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(fmap1), tuple(jnp.asarray(p) for p in pyr))
        ref = {"df1": np.asarray(ref_df1), **{f"df2_{i}": np.asarray(d)
                                              for i, d in enumerate(ref_df2)}}
    finally:
        worker.wait(procs)
    r0, r1 = worker.results("spatial_grad", 2, tmp_path)
    assert sorted(r0) == sorted(f"{case}:{k}" for case in ("slab", "whole") for k in ref)
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), f"the processes disagree on {k}"
        case, name = k.split(":")
        assert r0[k].shape == ref[name].shape
        np.testing.assert_allclose(r0[k], ref[name], rtol=1e-5, atol=1e-5, err_msg=k)
        # the gathered whole's loss reaches each slab once: the slab losses' gradients
        np.testing.assert_array_equal(r0[f"whole:{name}"], r0[f"slab:{name}"])
    # both slabs' rows of fmap1 got their gradient (no process kept only its own)
    assert all(np.abs(r0["slab:df1"][:, rows]).max() > 1.0
               for rows in (slice(0, H // 2), slice(H // 2, H)))


def test_spatial_gradients_of_one_process_are_the_plain_pyramids():
    fmap1, pyr, coords = _inputs()
    mesh = make_mesh(axis_names=("data", "space"), device="cpu")
    c = torch.from_numpy(coords)
    got, ref = [], []
    for fn, into in ((lambda f, ls: spatial_sharded_ondemand_corr(f, ls, c, R, mesh), got),
                     (lambda f, ls: ondemand_corr_pyramid_plain(f, ls, c, R), ref)):
        f1 = torch.from_numpy(fmap1).requires_grad_(True)
        levels = [torch.from_numpy(p).requires_grad_(True) for p in pyr]
        out = fn(f1, levels)
        (all_gather_rows(out, mesh) ** 2).sum().backward()
        into += [out.detach(), f1.grad] + [p.grad for p in levels]
    assert got[0].shape == (B, H, W, L * (2 * R + 1) ** 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
