"""The on-demand correlation with its query rows split over processes.

Counterpart of `raft_optical_flow_tpu/parallel/spatial.py`. Each query's
window reads only the fmap2 pyramid, which every process holds whole, so a
process of the mesh's 'space' axis computes the windows of its slab of
query rows alone: no halo, no collective. On the card the slab goes through
K4 (`kernels/corr_ondemand.py::corr_ondemand_fwd`) on the frame's query
grid, so that its bf16 tiles (4 rows x 16 queries) are the whole frame's
when the slab starts on a multiple of 4 rows, and so are its values; on
the CPU through its plain version. Forward only, as the JAX package's test
covers it: the result carries no gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.kernels.corr_ondemand import corr_ondemand_fwd
from raft_optical_flow_tpu_torch.parallel.mesh import Mesh


def spatial_sharded_ondemand_corr(
    fmap1: torch.Tensor,
    fmap2_pyramid: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
    mesh: Mesh,
    axis: str = "space",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """On-demand windowed correlation of this process's rows of queries.

    fmap1: [B, h, w, C]; fmap2_pyramid: [B, Hl, Wl, C] per level; coords:
    [B, h, w, 2] level-0 (x, y); all whole on every process. h must divide
    the axis size. Returns this process's slab [B, h / n, w, L*(2r+1)^2]
    (rows coord*h/n onwards), the counterpart of the JAX function's
    row-sharded array; `all_gather_rows` assembles the whole.
    """
    n = mesh.shape[axis]
    h = fmap1.shape[1]
    if h % n != 0:
        raise ValueError(f"query rows ({h}) must divide the '{axis}' axis size ({n})")
    B, _, w, C = fmap1.shape
    rows = h // n
    r0 = mesh.coord(axis) * rows
    f1 = fmap1[:, r0:r0 + rows].reshape(B, rows * w, C).contiguous()
    flat = coords[:, r0:r0 + rows].reshape(B, rows * w, 2).float().contiguous()
    with torch.no_grad():
        out = corr_ondemand_fwd(f1, [f.contiguous() for f in fmap2_pyramid], flat, radius,
                                out_dtype, grid_w=w)
    return out.reshape(B, rows, w, -1)


def all_gather_rows(slab: torch.Tensor, mesh: Mesh, axis: str = "space") -> torch.Tensor:
    """The slabs of every process of the axis concatenated along dim 1, in
    coordinate order (the slab itself without a process group)."""
    group = mesh.group(axis)
    if group is None:
        return slab
    slab = slab.contiguous()
    parts = [torch.empty_like(slab) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, slab, group=group)
    return torch.cat(parts, dim=1)
