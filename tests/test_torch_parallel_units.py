"""The port's `parallel/` pieces on the CPU: the sharded loader against the
JAX package's, the spatially sharded on-demand correlation against the JAX
function on a 2-device 'space' mesh, and the single-process behaviour of
`distributed` and `mesh` (no process group, no collective).

Tolerances: the loader's shards bit for bit; the gathered correlation
slabs rtol/atol 1e-5, as the JAX package's `tests/test_parallel.py:50`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from raft_optical_flow_tpu.data.pipeline import FlowDataLoader as JaxFlowDataLoader
from raft_optical_flow_tpu.kernels.corr_ondemand import ondemand_corr_pyramid
from raft_optical_flow_tpu.ops.corr import avg_pool2x2
from raft_optical_flow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_optical_flow_tpu.parallel.spatial import (
    spatial_sharded_ondemand_corr as jax_spatial_corr,
)
from raft_optical_flow_tpu_torch import parallel
from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader
from raft_optical_flow_tpu_torch.parallel import distributed
from raft_optical_flow_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_hybrid_mesh,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from torch_threads import one_torch_thread  # noqa: F401


class _Samples:
    """22 samples, each from its index and the loader's per-sample RNG."""

    def __len__(self):
        return 22

    def __getitem__(self, index, rng=None):
        r = rng.uniform(0, 1, 4).astype(np.float32)
        img1 = np.full((3, 5, 3), index, np.float32) + r[0]
        img2 = np.full((3, 5, 3), 100 + index, np.float32) + r[1]
        flow = np.full((3, 5, 2), r[2], np.float32)
        valid = np.full((3, 5), r[3] > 0.5, np.float32)
        return img1, img2, flow, valid


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("skip", [0, 3])
def test_loader_shards_are_the_jax_loaders(num_shards, skip):
    """8 batches of 4 (an epoch holds 5): the epoch boundary crossed, from
    the start and after skipping 3 batches (resume)."""
    whole = _take(FlowDataLoader(_Samples(), 4, num_workers=2).epochs(skip), 8)
    shards = []
    for shard in range(num_shards):
        ours = _take(FlowDataLoader(_Samples(), 4, num_workers=2, num_shards=num_shards,
                                    shard_id=shard).epochs(skip), 8)
        ref = _take(JaxFlowDataLoader(_Samples(), 4, num_workers=2, num_shards=num_shards,
                                      shard_id=shard).epochs(skip), 8)
        for a, b in zip(ours, ref):
            assert a.keys() == b.keys()
            assert all(a[k].shape[0] == 4 // num_shards and np.array_equal(a[k], b[k]) for k in a)
        shards.append(ours)
    for i, batch in enumerate(whole):  # the shards together are the one-process batch
        for k in batch:
            assert np.array_equal(np.concatenate([s[i][k] for s in shards]), batch[k])


def test_loader_shard_errors_are_the_jax_loaders():
    for kw in (dict(num_shards=3), dict(num_shards=2, shard_id=2), dict(shard_id=-1)):
        with pytest.raises(ValueError) as ours:
            FlowDataLoader(_Samples(), 4, **kw)
        with pytest.raises(ValueError) as ref:
            JaxFlowDataLoader(_Samples(), 4, **kw)
        assert str(ours.value) == str(ref.value)


def test_spatial_sharded_corr_matches_jax_on_a_space_mesh(tmp_path):
    """Two gloo processes on a ('data', 'space') = (1, 2) mesh each run the
    on-demand correlation (K4's plain version on the CPU) on their 8-row
    slab; the slabs gathered against the JAX function on a 2-device 'space'
    mesh."""
    rng = np.random.RandomState(0)
    B, H, W, C, L, r = 1, 16, 24, 16, 3, 3
    fmap1 = rng.randn(B, H, W, C).astype(np.float32)
    fmap2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = (np.stack([gx, gy], -1)[None] + rng.uniform(-3, 3, (B, H, W, 2))).astype(np.float32)
    pyr = [jnp.asarray(fmap2)]
    for _ in range(L - 1):
        pyr.append(avg_pool2x2(pyr[-1].transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1))
    pyr = [np.asarray(p) for p in pyr]
    np.savez(tmp_path / "corr.npz", fmap1=fmap1, coords=coords, levels=L, radius=r,
             **{f"level{i}": p for i, p in enumerate(pyr)})
    procs = worker.launch("spatial", 2, tmp_path)
    try:
        mesh = jax_make_mesh(2, axis_names=("space",))
        ref = np.asarray(jax_spatial_corr(jnp.asarray(fmap1), tuple(jnp.asarray(p) for p in pyr),
                                          jnp.asarray(coords), r, mesh))
        direct = np.asarray(ondemand_corr_pyramid(jnp.asarray(fmap1),
                                                  tuple(jnp.asarray(p) for p in pyr),
                                                  jnp.asarray(coords), r))
    finally:
        worker.wait(procs)
    r0, r1 = worker.results("spatial", 2, tmp_path)
    assert r0["odd_rows_raised"] == 1 and r1["odd_rows_raised"] == 1
    assert r0["slab"].shape == (B, H // 2, W, L * (2 * r + 1) ** 2)
    assert np.array_equal(r0["gathered"], r1["gathered"])
    np.testing.assert_array_equal(r0["gathered"][:, :H // 2], r0["slab"])
    np.testing.assert_array_equal(r0["gathered"][:, H // 2:], r1["slab"])
    np.testing.assert_allclose(r0["gathered"], ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref, direct, rtol=1e-5, atol=1e-5)


def test_initialize_is_a_no_op_alone_and_never_falls_back(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    for kw in (dict(coordinator_address="127.0.0.1:1"), dict(num_processes=2, process_id=0),
               dict(coordinator_address="127.0.0.1:1", num_processes=2)):
        with pytest.raises(ValueError, match="needs"):
            distributed.initialize(device="cpu", **kw)
    with pytest.raises(ValueError, match="out of range"):
        distributed.initialize("127.0.0.1:1", 2, 2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's environment, half set
    with pytest.raises(ValueError, match="coordinator_address, process_id"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_single_process_helpers_run_no_collective():
    assert distributed.process_info() == (0, 1) and distributed.is_lead_host()
    assert distributed.assert_batch_divisible(6) == 6
    t = torch.arange(6.0).reshape(2, 3)
    tree = {"a": t, "b": [t[0], 3], "c": (t[1],)}
    got = distributed.fetch_replicated(tree)
    assert isinstance(got["a"], np.ndarray) and np.array_equal(got["a"], t.numpy())
    assert got["b"][1] == 3 and np.array_equal(got["c"][0], t[1].numpy())
    assert distributed.all_reduce_sum(t) is t and distributed.all_reduce_sum_grad(t) is t
    assert distributed.data_group() is None and distributed.data_world() == 1
    num, den = torch.tensor(3.0), torch.tensor(0.5)
    assert torch.equal(distributed.batch_ratio(num, den, 1e-6), num / (den + 1e-6))
    assert torch.equal(distributed.batch_ratio(num, den, floor=1.0), num / 1.0)
    g = torch.Generator().manual_seed(0)
    drawn = distributed.local_rows(lambda n: torch.rand(n, 2, generator=g), 3)
    assert torch.equal(drawn, torch.rand(3, 2, generator=torch.Generator().manual_seed(0)))
    metrics = {"loss": torch.tensor(1.5)}
    assert distributed.mean_over_ranks(metrics) is metrics
    distributed.average_gradients([torch.zeros(2, requires_grad=True)])  # no-op
    distributed.barrier(None)


def test_mesh_of_one_process_has_no_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.devices.size == 1 and mesh.group("data") is None
    assert mesh.coord("data") == 0 and mesh.device == torch.device("cpu")
    two = make_mesh(axis_names=("data", "space"), device="cpu")
    assert two.shape == {"data": 1, "space": 1}
    assert make_hybrid_mesh(device="cpu").shape == {"dcn": 1, "data": 1}
    with pytest.raises(ValueError, match="every process"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(axis_names=("data", "space"), shape=(4, 2), device="cpu")
    assert parallel.__all__ == ["make_mesh", "batch_sharding", "replicated_sharding",
                                "shard_batch", "distributed"]


def test_shard_batch_keeps_this_process_rows_and_refuses_a_ragged_batch():
    """A mesh of two processes seen from process 0 (no collective needed)."""
    mesh = Mesh(np.arange(2), ("data",), torch.device("cpu"), {})
    batch = {"x": np.arange(8.0).reshape(4, 2), "y": [np.arange(4)]}
    local = shard_batch(batch, mesh)
    assert torch.equal(local["x"], torch.tensor([[0.0, 1.0], [2.0, 3.0]]))
    assert torch.equal(local["y"][0], torch.tensor([0, 1]))
    assert batch_sharding(mesh).rows(6) == slice(0, 3)
    assert replicated_sharding(mesh).rows(6) == slice(0, 6)
    with pytest.raises(ValueError, match="global batch size 3 not divisible by the mesh 'data'"):
        shard_batch({"x": np.zeros((3, 2))}, mesh)
    with pytest.raises(ValueError, match="global batch size 3 not divisible by the mesh 'data'"):
        from raft_optical_flow_tpu.parallel.mesh import shard_batch as jax_shard_batch

        jax_shard_batch({"x": jnp.zeros((3, 2))}, jax_make_mesh(2))
    assert jax.device_count() >= 2 and os.environ["JAX_PLATFORMS"] == "cpu"
