"""RAFT: inference and training, over the materialized correlation pyramid
or the on-demand correlation.

Counterpart of `raft_optical_flow_tpu/models/raft.py`:

  1. normalize the NHWC images to [-1, 1];
  2. fnet on both frames batch-folded, cnet on frame 1 (NCHW inside);
  3. the correlation pyramid, one matmul per level against pooled fmap2; or,
     with `alternate_corr`, fmap1 and the fmap2 pyramid (2x2 floor-mode
     average pooling of the fp32 fmap2), from which every lookup computes
     its windows on demand (`kernels/corr_ondemand.py`, alt_cuda_corr);
  4. the GRU loop (a Python loop): windowed lookup, update block, coords
     update; coords stay fp32, the GRU state runs in the compute dtype;
  5. upsampling: `upflow8` for RAFT-small, `convex_upsample` for
     RAFT-standard.

Test mode (`test_mode=True`, no autograd) returns (flow_low, flow_up): levels
1..L-1 of the lookup go through one K2 launch, and RAFT-standard carries the
mask through the loop and upsamples once after it. Training mode
(`test_mode=False`) returns every iteration's upsampled flow, stacked
[iters, N, H, W, 2]: coords are detached at the top of each iteration while
gradients flow through the GRU state, and each level's lookup is K1 with K3
as its backward (`kernels/corr_lookup.py::LookupLevel`); the on-demand
lookup is K4 in both modes, with K5 and K6 as its backward
(`kernels/corr_ondemand.py::OndemandCorr`). `train` turns on
encoder dropout; BatchNorm trains (batch statistics, running statistics
updated in place) when `train and not freeze_bn`.

Policies (`RAFTConfig.compute_dtype`):

  - float32: every conv and matmul in full fp32. `fp32_policy()` turns TF32
    off for cuBLAS and cuDNN, because the JAX fp32 path runs every contraction
    at HIGHEST precision.
  - bfloat16: fnet and cnet run in bf16 and the fmaps are cast to fp32; the
    volume matmul takes bf16 operands with fp32 accumulation and the volume is
    stored in bf16; the lookup writes bf16 windows (fp32 sums, one rounding);
    the update block runs in bf16; parameters, coords, flow and the upsample
    stay fp32. With `alternate_corr`, fmap1 and the fmap2 levels are cast
    to bf16 once per forward and the on-demand windows take bf16 operands
    with fp32 sums (the JAX package's Precision.DEFAULT); under fp32 they
    stay fp32, no TF32.
  - float64 (frames in float64 too; `corr_impl='plain'`, all-pairs volume):
    everything in float64, fp32 weights cast exactly. The CPU yardstick
    that fp32 gradients are held against.

`fused_gru` (RAFT-standard; RAFT-small ignores it, as the JAX package's
`SmallUpdateBlock` does) runs the SepConvGRU through K7
(`kernels/gru_fused.py`), composing with `alternate_corr` and `remat`. Its
backward is autograd of the unfused reference, in fp32 only: training under
the bf16 policy with `fused_gru` raises ValueError (the JAX package has no
working semantics there, ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from raft_optical_flow_tpu_torch.kernels.corr_lookup import corr_pyramid_lookup_cuda
from raft_optical_flow_tpu_torch.kernels.corr_ondemand import (
    ondemand_corr_pyramid_cuda,
    ondemand_corr_pyramid_plain,
)
from raft_optical_flow_tpu_torch.kernels.gru_fused import BF16_TRAINING_REFUSED
from raft_optical_flow_tpu_torch.models.extractor import BasicEncoder, SmallEncoder
from raft_optical_flow_tpu_torch.models.layers import fp32_policy, init_weights
from raft_optical_flow_tpu_torch.models.update import BasicUpdateBlock, SmallUpdateBlock
from raft_optical_flow_tpu_torch.ops.corr import (
    avg_pool2x2,
    build_corr_pyramid_from_fmaps,
    corr_pyramid_lookup,
)
from raft_optical_flow_tpu_torch.ops.grid import coords_grid, upflow8
from raft_optical_flow_tpu_torch.ops.upsample import convex_upsample


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    small: bool = False
    dropout: float = 0.0  # encoder channel dropout in training
    # on-demand correlation: no all-pairs volume (alt_cuda_corr)
    alternate_corr: bool = False
    corr_levels: int = 4
    # 'cuda': the CUDA lookup kernels (their plain versions on CPU tensors);
    # 'plain': the plain versions everywhere
    corr_impl: str = "cuda"
    compute_dtype: torch.dtype = torch.float32
    # training: recompute each GRU iteration in the backward
    # (torch.utils.checkpoint) instead of storing its activations
    remat: bool = False
    # training: recompute the convex upsample's intermediates in the backward
    checkpoint_upsample: bool = False
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
    """RAFT flow estimator.

    forward(image1, image2, iters, flow_init=None, test_mode=True, train=False,
            freeze_bn=True, generator=None):
      image1/image2: [N, H, W, 3] in [0, 255], H and W divisible by 8;
      flow_init: optional [N, H/8, W/8, 2] warm start; generator: draws the
      dropout masks when `train` and `config.dropout > 0`.
      Returns, fp32: test_mode -> (flow_low [N, H/8, W/8, 2], flow_up
      [N, H, W, 2]); else the predictions [iters, N, H, W, 2].
    """

    def __init__(self, config: RAFTConfig = RAFTConfig(), device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.corr_impl not in ("cuda", "plain"):
            raise ValueError(f"corr_impl must be 'cuda' or 'plain', got {config.corr_impl!r}")
        if config.compute_dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise ValueError(f"compute_dtype must be float32, bfloat16 or float64, "
                             f"got {config.compute_dtype}")
        if config.compute_dtype == torch.float64 and (config.corr_impl != "plain"
                                                      or config.alternate_corr):
            raise ValueError("float64 runs the plain all-pairs lookup: corr_impl='plain', "
                             "alternate_corr=False")
        self.config = config
        # the dtype of the values the policies carry in fp32 (coords, flow,
        # fmaps, correlation sums): float64 under the float64 policy
        self._wide = torch.float64 if config.compute_dtype == torch.float64 else torch.float32
        corr_ch = config.corr_levels * (2 * config.corr_radius + 1) ** 2
        hdim, cdim = config.hidden_dim, config.context_dim
        if config.small:
            self.fnet = SmallEncoder(128, "instance", config.dropout)
            self.cnet = SmallEncoder(hdim + cdim, "none", config.dropout)
            self.update_block = SmallUpdateBlock(corr_ch, hdim, cdim)
        else:
            self.fnet = BasicEncoder(256, "instance", config.dropout)
            self.cnet = BasicEncoder(hdim + cdim, "batch", config.dropout)
            self.update_block = BasicUpdateBlock(corr_ch, hdim, cdim, config.fused_gru)
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def _lookup(self, corr_state, coords1, test_mode: bool):
        cfg = self.config
        if cfg.alternate_corr:
            fmap1, f2_levels = corr_state
            lookup = (ondemand_corr_pyramid_plain if cfg.corr_impl == "plain"
                      else ondemand_corr_pyramid_cuda)
            return lookup(fmap1, f2_levels, coords1, cfg.corr_radius, cfg.compute_dtype)
        if cfg.corr_impl == "plain":
            return corr_pyramid_lookup(corr_state, coords1, cfg.corr_radius).to(cfg.compute_dtype)
        # serving fuses levels 1..L-1 into one K2 launch; training keeps the
        # per-level K1 launches, whose backward is K3
        return corr_pyramid_lookup_cuda(
            corr_state, coords1, cfg.corr_radius, out_dtype=cfg.compute_dtype,
            fuse_coarse=test_mode,
        )

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None, test_mode: bool = True,
                train: bool = False, freeze_bn: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        if cfg.compute_dtype == torch.float32:
            fp32_policy()
        elif not test_mode and cfg.fused_gru and not cfg.small:
            raise ValueError(BF16_TRAINING_REFUSED)
        if test_mode:
            with torch.no_grad():
                return self._test(*self._encode(image1, image2, False, False, None),
                                  iters, flow_init)
        # freeze_bn: BN uses running stats even in training; dropout follows train
        state = self._encode(image1, image2, train, train and not freeze_bn, generator)
        return self._train(*state, iters, flow_init)

    def _encode(self, image1, image2, train, bn_train, generator):
        """Encoders and correlation state: (pyramid or (fmap1, fmap2 levels),
        net, inp, coords0), NHWC coords."""
        cfg = self.config
        dtype = cfg.compute_dtype
        N, H, W, _ = image1.shape
        image1 = 2.0 * (image1.to(self._wide) / 255.0) - 1.0
        image2 = 2.0 * (image2.to(self._wide) / 255.0) - 1.0
        pair = torch.cat([image1, image2], dim=0).permute(0, 3, 1, 2).to(dtype)
        fmaps = self.fnet(pair, train, bn_train, generator).to(self._wide).permute(0, 2, 3, 1)
        fmap1, fmap2 = fmaps[:N], fmaps[N:]
        if cfg.alternate_corr:
            # pool in fp32, then round once (bf16 policy) for every iteration
            levels = [fmap2]
            for _ in range(cfg.corr_levels - 1):
                levels.append(avg_pool2x2(levels[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
            corr_state = (fmap1.to(dtype).contiguous(),
                          tuple(f.to(dtype).contiguous() for f in levels))
        else:
            corr_state = build_corr_pyramid_from_fmaps(fmap1, fmap2, cfg.corr_levels, dtype)

        cnet = self.cnet(image1.permute(0, 3, 1, 2).to(dtype), train, bn_train, generator)
        cnet = cnet.to(self._wide)
        net, inp = torch.split(cnet, [cfg.hidden_dim, cfg.context_dim], dim=1)
        net = torch.tanh(net).to(dtype)
        inp = F.relu(inp).to(dtype)
        coords0 = coords_grid(N, H // 8, W // 8, device=image1.device, dtype=self._wide)
        return corr_state, net, inp, coords0

    def _step(self, corr_state, net, inp, coords0, coords1, test_mode: bool):
        """One GRU iteration: (net, mask or None, coords1 + delta)."""
        dtype = self.config.compute_dtype
        corr = self._lookup(corr_state, coords1, test_mode).permute(0, 3, 1, 2)
        flow = (coords1 - coords0).to(dtype).permute(0, 3, 1, 2)
        net, mask, delta = self.update_block(net, inp, corr, flow)
        return net, mask, coords1 + delta.to(self._wide).permute(0, 2, 3, 1)

    def _test(self, corr_state, net, inp, coords0, iters, flow_init):
        cfg = self.config
        N, h, w, _ = coords0.shape
        coords1 = coords0 if flow_init is None else coords0 + flow_init.to(self._wide)
        mask = None
        for _ in range(iters):
            net, mask, coords1 = self._step(corr_state, net, inp, coords0, coords1, True)

        flow_lo = coords1 - coords0
        if cfg.small:
            flow_up = upflow8(flow_lo)
        else:
            if mask is None:  # iters == 0: the JAX package starts from a zero mask
                mask = torch.zeros(N, 64 * 9, h, w, dtype=cfg.compute_dtype, device=coords0.device)
            flow_up = convex_upsample(flow_lo, mask.to(self._wide).permute(0, 2, 3, 1))
        return flow_lo, flow_up

    def _train_iteration(self, corr_state, net, inp, coords0, coords1):
        """One training iteration: (net, coords1, flow_up [N, H, W, 2])."""
        cfg = self.config
        coords1 = coords1.detach()  # gradients flow through net, not coords
        net, mask, coords1 = self._step(corr_state, net, inp, coords0, coords1, False)
        flow_lo = coords1 - coords0
        if cfg.small:
            return net, coords1, upflow8(flow_lo)
        mask = mask.to(self._wide).permute(0, 2, 3, 1)
        if cfg.checkpoint_upsample:
            return net, coords1, checkpoint(convex_upsample, flow_lo, mask, use_reentrant=False)
        return net, coords1, convex_upsample(flow_lo, mask)

    def _train(self, corr_state, net, inp, coords0, iters, flow_init):
        coords1 = coords0 if flow_init is None else coords0 + flow_init.to(self._wide)
        preds = []
        for _ in range(iters):
            if self.config.remat:
                net, coords1, flow_up = checkpoint(
                    self._train_iteration, corr_state, net, inp, coords0, coords1,
                    use_reentrant=False,
                )
            else:
                net, coords1, flow_up = self._train_iteration(corr_state, net, inp, coords0, coords1)
            preds.append(flow_up)
        return torch.stack(preds)
