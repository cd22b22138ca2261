"""The on-demand correlation with its query rows split over processes.

Counterpart of `raft_optical_flow_tpu/parallel/spatial.py`. Each query's
window reads only the fmap2 pyramid, which every process holds whole, so a
process of the mesh's 'space' axis computes the windows of its slab of
query rows alone: no halo, no collective in the forward. On the card the
slab goes through K4 (`kernels/corr_ondemand.py::OndemandCorr`) on the
frame's query grid, so that its bf16 tiles (4 rows x 16 queries) are the
whole frame's when the slab starts on a multiple of 4 rows, and so are its
values; on the CPU through its plain version.

The backward is K5 and K6 on the slab (K5 on the frame's grid too). Every
process holds fmap1 and the pyramid whole, so each process's inputs get
the gradient of the sum of every process's objective, the convention of
`parallel/distributed.py::all_reduce_sum_grad`: fmap1's gradient is this
slab's rows (zeros elsewhere) summed over the axis, i.e. the slabs' rows
side by side; each level's is this slab's K6 sums (fp32) summed over the
axis, then cast to the level's dtype. That is JAX's gradient of the
row-sharded global array.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.kernels.corr_ondemand import OndemandCorr
from raft_optical_flow_tpu_torch.parallel.mesh import Mesh


class _SumGradOver(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the group's
    processes (for an input every process holds whole)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _sum_levels_over(group):
    """The fp32 level gradients summed over the group, in one all-reduce."""

    def reduce(df2s: List[torch.Tensor]) -> List[torch.Tensor]:
        flat = torch.cat([d.reshape(-1) for d in df2s])
        dist.all_reduce(flat, group=group)
        return [part.view_as(d) for part, d in zip(flat.split([d.numel() for d in df2s]), df2s)]

    return reduce


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
    row-sharded array; `all_gather_rows` assembles the whole. Gradients
    reach fmap1 and every level, summed over the axis (no coords gradient).
    Without a process group it is `ondemand_corr_pyramid_cuda` on this
    process's rows.
    """
    n = mesh.shape[axis]
    h = fmap1.shape[1]
    if h % n != 0:
        raise ValueError(f"query rows ({h}) must divide the '{axis}' axis size ({n})")
    B, _, w, C = fmap1.shape
    rows = h // n
    r0 = mesh.coord(axis) * rows
    group = mesh.group(axis)
    levels = [f.contiguous() for f in fmap2_pyramid]
    reduce_df2 = None
    if group is not None:
        fmap1 = _SumGradOver.apply(fmap1, group)
        reduce_df2 = _sum_levels_over(group)
    f1 = fmap1[:, r0:r0 + rows].reshape(B, rows * w, C).contiguous()
    flat = coords[:, r0:r0 + rows].reshape(B, rows * w, 2).float().contiguous()
    out = OndemandCorr.apply("cuda", f1, flat, radius, out_dtype, w, reduce_df2, *levels)
    return out.reshape(B, rows, w, -1)


class _GatherRows(torch.autograd.Function):
    """The slabs of every process of the group along dim 1; the backward
    returns this process's rows of the cotangent."""

    @staticmethod
    def forward(ctx, slab, group, n, index):
        ctx.rows, ctx.index = slab.shape[1], index
        slab = slab.contiguous()
        parts = [torch.empty_like(slab) for _ in range(n)]
        dist.all_gather(parts, slab, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.index * ctx.rows
        return g[:, r0:r0 + ctx.rows].contiguous(), None, None, None


def all_gather_rows(slab: torch.Tensor, mesh: Mesh, axis: str = "space") -> torch.Tensor:
    """The slabs of every process of the axis concatenated along dim 1, in
    coordinate order (the slab itself without a process group). Its
    gradient is this process's rows of the cotangent, so that a loss every
    process computes alike on the whole reaches the inputs of
    `spatial_sharded_ondemand_corr` once, not once per process: for
    sum(whole ** 2) the gradients of the sum of the slab losses."""
    group = mesh.group(axis)
    if group is None:
        return slab
    return _GatherRows.apply(slab, group, mesh.shape[axis], mesh.coord(axis))
