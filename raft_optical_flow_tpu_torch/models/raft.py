"""RAFT inference (test mode) over the materialized correlation pyramid.

Counterpart of `raft_optical_flow_tpu/models/raft.py`:

  1. normalize the NHWC images to [-1, 1];
  2. fnet on both frames batch-folded, cnet on frame 1 (NCHW inside);
  3. the correlation pyramid, one matmul per level against pooled fmap2;
  4. the GRU loop (a Python loop): windowed lookup, update block, coords
     update; coords stay fp32, the GRU state runs in the compute dtype;
  5. upsampling: `upflow8` for RAFT-small; for RAFT-standard the mask is
     carried through the loop and `convex_upsample` runs once after it.

Policies (`RAFTConfig.compute_dtype`):

  - float32: every conv and matmul in full fp32. `fp32_policy()` turns TF32
    off for cuBLAS and cuDNN, because the JAX fp32 path runs every contraction
    at HIGHEST precision.
  - bfloat16: fnet and cnet run in bf16 and the fmaps are cast to fp32; the
    volume matmul takes bf16 operands with fp32 accumulation and the volume is
    stored in bf16; the lookup writes bf16 windows (fp32 sums, one rounding);
    the update block runs in bf16; parameters, coords, flow and the upsample
    stay fp32.

Only test mode is ported. Training mode, `alternate_corr` and `fused_gru` raise
NotImplementedError (ROADMAP.md lists them as later slices).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.kernels.corr_lookup import corr_pyramid_lookup_cuda
from raft_optical_flow_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_optical_flow_tpu_torch.models.layers import fp32_policy, init_weights
from raft_optical_flow_tpu_torch.models.update import BasicUpdateBlock, SmallUpdateBlock
from raft_optical_flow_tpu_torch.ops.corr import (
    build_corr_pyramid_from_fmaps,
    corr_pyramid_lookup,
)
from raft_optical_flow_tpu_torch.ops.grid import coords_grid, upflow8
from raft_optical_flow_tpu_torch.ops.upsample import convex_upsample

_NOT_PORTED = "not ported yet: see ROADMAP.md, Queue 1 and Queue 2"


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    small: bool = False
    alternate_corr: bool = False
    corr_levels: int = 4
    # 'cuda': the CUDA lookup kernels (their plain version on CPU tensors);
    # 'plain': ops/corr.py's plain lookup everywhere
    corr_impl: str = "cuda"
    compute_dtype: torch.dtype = torch.float32
    fused_gru: bool = False

    @property
    def corr_radius(self) -> int:
        return 3 if self.small else 4

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128


class RAFT(nn.Module):
    """RAFT flow estimator, test mode.

    forward(image1, image2, iters, flow_init=None, test_mode=True):
      image1/image2: [N, H, W, 3] in [0, 255], H and W divisible by 8;
      flow_init: optional [N, H/8, W/8, 2] warm start.
      Returns (flow_low [N, H/8, W/8, 2], flow_up [N, H, W, 2]), fp32.
    """

    def __init__(self, config: RAFTConfig = RAFTConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.alternate_corr:
            raise NotImplementedError(f"alternate_corr is {_NOT_PORTED}")
        if config.fused_gru:
            raise NotImplementedError(f"fused_gru is {_NOT_PORTED}")
        if config.corr_impl not in ("cuda", "plain"):
            raise ValueError(f"corr_impl must be 'cuda' or 'plain', got {config.corr_impl!r}")
        if config.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {config.compute_dtype}")
        self.config = config
        corr_ch = config.corr_levels * (2 * config.corr_radius + 1) ** 2
        hdim, cdim = config.hidden_dim, config.context_dim
        if config.small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(hdim + cdim, "none")
            self.update_block = SmallUpdateBlock(corr_ch, hdim, cdim)
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(hdim + cdim, "batch")
            self.update_block = BasicUpdateBlock(corr_ch, hdim, cdim)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def _lookup(self, pyramid, coords1):
        cfg = self.config
        if cfg.corr_impl == "plain":
            return corr_pyramid_lookup(pyramid, coords1, cfg.corr_radius).to(cfg.compute_dtype)
        # test mode: levels 1..L-1 go through one K2 launch
        return corr_pyramid_lookup_cuda(
            pyramid, coords1, cfg.corr_radius, out_dtype=cfg.compute_dtype, fuse_coarse=True,
        )

    @torch.no_grad()
    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        if not test_mode:
            raise NotImplementedError(f"training mode is {_NOT_PORTED}")
        cfg = self.config
        dtype = cfg.compute_dtype
        if dtype == torch.float32:
            fp32_policy()
        N, H, W, _ = image1.shape
        h, w = H // 8, W // 8

        image1 = 2.0 * (image1.float() / 255.0) - 1.0
        image2 = 2.0 * (image2.float() / 255.0) - 1.0
        pair = torch.cat([image1, image2], dim=0).permute(0, 3, 1, 2).to(dtype)
        fmaps = self.fnet(pair).float().permute(0, 2, 3, 1)  # NHWC fp32
        fmap1, fmap2 = fmaps[:N], fmaps[N:]
        pyramid = build_corr_pyramid_from_fmaps(fmap1, fmap2, cfg.corr_levels, dtype)

        cnet = self.cnet(image1.permute(0, 3, 1, 2).to(dtype)).float()
        net, inp = torch.split(cnet, [cfg.hidden_dim, cfg.context_dim], dim=1)
        net = torch.tanh(net).to(dtype)
        inp = F.relu(inp).to(dtype)

        coords0 = coords_grid(N, h, w, device=image1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init.float()
        mask = None
        for _ in range(iters):
            corr = self._lookup(pyramid, coords1).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).to(dtype).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)

        flow_lo = coords1 - coords0
        if cfg.small:
            flow_up = upflow8(flow_lo)
        else:
            if mask is None:  # iters == 0: the JAX package starts from a zero mask
                mask = torch.zeros(N, 64 * 9, h, w, dtype=dtype, device=image1.device)
            flow_up = convex_upsample(flow_lo, mask.float().permute(0, 2, 3, 1))
        return flow_lo, flow_up
