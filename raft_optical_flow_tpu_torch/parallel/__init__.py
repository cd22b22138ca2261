"""Data parallelism over processes (one device each) on `torch.distributed`.

Counterpart of `raft_optical_flow_tpu/parallel/`: the mesh and the batch
split over it (`mesh.py`), the process group and the reductions a
data-parallel step needs (`distributed.py`), the on-demand correlation
with its query rows split over a 'space' axis (`spatial.py`), and the
training CLIs' launcher of one worker process per visible card
(`launch.py`).
"""

from raft_optical_flow_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from raft_optical_flow_tpu_torch.parallel import distributed

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "distributed",
]
