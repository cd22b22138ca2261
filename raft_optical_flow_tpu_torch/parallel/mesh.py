"""Process meshes and the batch split over them.

Counterpart of `raft_optical_flow_tpu/parallel/mesh.py`. A JAX mesh lays a
process's devices out on named axes; here each process drives one device,
so a `Mesh` lays the processes of the run (ranks of `torch.distributed`)
out on named axes, rank-major: axis 'data' splits the batch (gradients,
BatchNorm statistics and batch-wide counts are reduced over it), axis
'space' splits the query rows of the on-demand correlation
(`parallel/spatial.py`), axis 'dcn' is the outer (host) axis of a hybrid
mesh. Each axis has the process group of the processes that differ only in
its coordinate. Without a process group (one process) the mesh has one
device and no group, and nothing that uses it runs a collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.parallel.distributed import local_device, process_info


class Mesh:
    """The run's processes on named axes.

    devices: the ranks in the mesh's shape (`.size`, `.flat` as JAX's);
    shape: {axis: size}; device: this process's device; rank: its rank;
    `coord(axis)` its index along an axis; `group(axis)` the process group
    of its axis (None without `torch.distributed`).
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], device: torch.device,
                 groups: Dict[str, object]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device = device
        self.rank = process_info()[0]
        self._groups = groups
        where = np.argwhere(devices == self.rank)[0]
        self._coords = dict(zip(self.axis_names, (int(i) for i in where)))

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axis: str):
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device="cuda",
) -> Mesh:
    """A mesh over every process of the run, one device each.

    With one axis name the mesh is 1-D; `shape` lays out several axes, e.g.
    axis_names=('data', 'space'), shape=(4, 2). n_devices, when given, must
    be the number of processes (a process holds one device, and every
    process joins the mesh). Every process must call this in the same order,
    since it creates the axes' process groups.
    """
    rank, world = process_info()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans every process, one device each: n_devices={n_devices} "
                         f"but the run has {world} processes")
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {tuple(axis_names)} does not "
                         f"hold the run's {world} processes")
    ranks = np.arange(world).reshape(shape)
    groups = {}
    if dist.is_initialized():
        for i, axis in enumerate(axis_names):
            for members in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]).tolist():
                # every process creates every group, in the same order
                group = dist.group.WORLD if len(members) == world else dist.new_group(members)
                if rank in members:
                    groups[axis] = group
    return Mesh(ranks, axis_names, local_device(device), groups)


def make_hybrid_mesh(
    dcn_axis: int = 1,
    axis_names: Sequence[str] = ("dcn", "data"),
    device="cuda",
) -> Mesh:
    """A 2-D mesh with an outer axis of `dcn_axis` hosts (or slices) and an
    inner axis over each host's processes; with dcn_axis <= 1 the outer axis
    has size 1."""
    world = process_info()[1]
    dcn = max(dcn_axis, 1)
    if world % dcn:
        raise ValueError(f"{world} processes do not split over {dcn} hosts")
    return make_mesh(axis_names=axis_names, shape=(dcn, world // dcn), device=device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a tensor's leading axis lies over a mesh: split over `axis`
    (each process holds its contiguous rows, in coordinate order), or whole
    on every process (axis None)."""

    mesh: Mesh
    axis: Optional[str]

    def rows(self, n: int) -> slice:
        """The rows of an n-row tensor that this process holds."""
        if self.axis is None:
            return slice(0, n)
        k = self.mesh.shape[self.axis]
        if n % k:
            raise ValueError(
                f"global batch size {n} not divisible by the mesh '{self.axis}' "
                f"axis ({k} devices) — pick a batch size that is a "
                f"multiple of the device count")
        b = n // k
        i = self.mesh.coord(self.axis)
        return slice(i * b, (i + 1) * b)


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """The leading (batch) axis split over `axis`."""
    return NamedSharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, None)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This process's rows of a global batch, on its device.

    batch: a dict (or list, tuple) of [N, ...] arrays or tensors that every
    process holds whole, N the global batch size; each process keeps its
    contiguous N / mesh.shape[axis] rows (as JAX's `shard_batch` places
    them on the mesh's devices) and moves them to `mesh.device`. Raises
    when N does not divide the axis. A loader sharded by process
    (`FlowDataLoader(num_shards, shard_id)`) yields these rows already.
    """
    sharding = batch_sharding(mesh, axis)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    first = leaves(batch)
    rows = sharding.rows(np.shape(first[0])[0]) if first else slice(None)

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(put(v) for v in tree)
        return torch.as_tensor(tree[rows]).to(mesh.device)

    return put(batch)
