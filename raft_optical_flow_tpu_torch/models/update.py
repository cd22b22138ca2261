"""RAFT update blocks: motion encoders, ConvGRU / SepConvGRU, flow and mask
heads, NCHW inside.

Counterpart of `raft_optical_flow_tpu/models/update.py`. `SepConvGRU(fused=
True)` runs both passes through the fused kernel K7
(`kernels/gru_fused.py::SepConvGRUFused`) on the same parameters.
`SmallUpdateBlock` runs its eight convolutions through K9
(`kernels/small_update.py`) when serving fp32 on the card. Submodule names
are the flax names (`mask_0`, `flow_head`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from raft_optical_flow_tpu_torch.kernels import small_update
from raft_optical_flow_tpu_torch.kernels.gru_fused import GATES, SepConvGRUFused
from raft_optical_flow_tpu_torch.models.layers import conv


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(cin, hidden_dim, 3, 1, 1)
        self.conv2 = conv(hidden_dim, 2, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3, 1, 1)
        self.convr = conv(cin, hidden_dim, 3, 1, 1)
        self.convq = conv(cin, hidden_dim, 3, 1, 1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """Horizontal (1x5) then vertical (5x1) GRU pass.

    `fused`: both passes through K7 (two launches on the card, the plain
    version on the CPU), on the same six convs' parameters; h' comes back
    channels-last. Under bf16 the fused path rounds conv(h) + conv(x) in one
    fp32 sum where the unfused one rounds each conv's output to bf16, so the
    two agree to the bf16 bar, not bit for bit (as in the JAX package).
    """

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128, fused: bool = False):
        super().__init__()
        self.fused = fused
        cin = hidden_dim + input_dim
        for gate in "zrq":
            setattr(self, f"conv{gate}1", conv(cin, hidden_dim, (1, 5), 1, (0, 2)))
            setattr(self, f"conv{gate}2", conv(cin, hidden_dim, (5, 1), 1, (2, 0)))

    def _pass(self, h, x, suffix: str):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
        q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        if self.fused:
            weights = [t for name in GATES for t in (getattr(self, name).weight,
                                                     getattr(self, name).bias)]
            return SepConvGRUFused.apply(h, x, *weights)
        return self._pass(self._pass(h, x, "1"), x, "2")


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = conv(corr_channels, 96, 1, 1, 0)
        self.convf1 = conv(2, 64, 7, 1, 3)
        self.convf2 = conv(64, 32, 3, 1, 1)
        self.conv = conv(128, 80, 3, 1, 1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)  # 82 channels


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = conv(corr_channels, 256, 1, 1, 0)
        self.convc2 = conv(256, 192, 3, 1, 1)
        self.convf1 = conv(2, 128, 7, 1, 3)
        self.convf2 = conv(128, 64, 3, 1, 1)
        self.conv = conv(256, 126, 3, 1, 1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)  # 128 channels


class SmallUpdateBlock(nn.Module):
    """RAFT-small's update block. On fp32 CUDA inputs with no gradient
    recorded, outside `torch.export`, it runs its eight convolutions as K9
    launches (`kernels/small_update.py`; h' comes back channels-last, so the
    next iteration reads it in place); otherwise, and always for training,
    its modules (`small_update.declines` says why)."""

    def __init__(self, corr_channels: int, hidden_dim: int = 96, context_dim: int = 64):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_channels)
        self.gru = ConvGRU(hidden_dim, context_dim + 82)
        self.flow_head = FlowHead(hidden_dim, 128)
        self._k9 = None  # (parameter versions, K9's laid-out weights)

    def _k9_params(self):
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._k9 is None or self._k9[0] != key:
            self._k9 = (key, small_update.block_params(self))
        return self._k9[1]

    def forward(self, net, inp, corr, flow):
        """NCHW in, (net, None, delta) out: the small model has no mask head."""
        if small_update.declines((net, inp, corr, flow), tuple(self.parameters())) is None:
            net, delta = small_update.small_update_step(self._k9_params(), net, inp, corr, flow)
            return net, None, delta
        x = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        net = self.gru(net, x)
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int, hidden_dim: int = 128, context_dim: int = 128,
                 fused_gru: bool = False):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128, fused=fused_gru)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask_0 = conv(hidden_dim, 256, 3, 1, 1)
        self.mask_2 = conv(256, 64 * 9, 1, 1, 0)

    def forward(self, net, inp, corr, flow):
        """NCHW in, (net, mask [N, 576, h, w], delta) out; mask scaled x0.25."""
        x = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        net = self.gru(net, x)
        delta = self.flow_head(net)
        mask = 0.25 * self.mask_2(F.relu(self.mask_0(net)))
        return net, mask, delta
