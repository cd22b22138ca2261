"""LiteFlowNet3's work from shapes: the forward's FLOPs, and each
correlation's least bytes and operations.

FLOPs (`forward_flops`): every conv and transposed conv as
`torch.utils.flop_counter` counts it, 2 * N * prod(weight shape) * the
output's positions (a transposed conv: its input's), plus each correlation's
products and sums. Activations, warps, resizes and the smoothing are not
counted. The conv list is the reference's (`reference.liteflownet3.
param_shapes`), so the count follows the architecture, not the program.

Correlations (`correlations`, `corr_bound_s`): the six cost volumes of a
standard forward (matching at levels 0 and 1, the deformation's
self-correlation and the modulation's volume at levels 2 and 3), each as
the operation needs it, whatever an implementation reads again: f1 read
once, f2 read once where it is another map than f1 (the self-correlation
reads one), the p^2 outputs written once, all at the feature dtype; 2 * B *
H * W * C * p^2 operations (a product and a sum a channel and offset). Its
least time is the larger of the bytes at HBM rate and the operations at the
policy's peak.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from flowbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from flowbench.reference.liteflownet3 import (
    FEAT_CH,
    LEVELS,
    MATCH_PATCH,
    MOD_FROM,
    OUTPUT_STRIDE,
    SELF_PATCH,
    param_shapes,
)

ITEMSIZE = {"bf16": 2, "fp32": 4}


class Correlation(NamedTuple):
    batch: int
    height: int
    width: int
    channels: int
    patch: int
    same: bool  # f2 is f1

    @property
    def ops(self) -> int:
        return 2 * self.batch * self.height * self.width * self.channels * self.patch ** 2

    def nbytes(self, itemsize: int) -> int:
        n = self.batch * self.height * self.width
        reads = (1 if self.same else 2) * n * self.channels
        return (reads + n * self.patch ** 2) * itemsize


def _stride(level: int) -> int:
    return OUTPUT_STRIDE // 2 ** level


def _positions(layer: str, H: int, W: int):
    """(images per pair, positions) of the conv `layer` for one pair at
    H x W (multiples of 32): the output's positions, a transposed conv's
    input's."""
    parts = layer.split(".")
    if parts[0] == "feature_net":
        s = 2 ** int(parts[1].split("_")[1])  # convs_<stage>_<j> runs at stride 2^stage
        return 2, (H // s) * (W // s)
    if parts[0] == "up_flow":  # the final 4x, from the finest level
        s = _stride(LEVELS - 1)
    else:
        module, index = parts[0].rsplit("_", 1)
        level = int(index) + (MOD_FROM if module in ("deformation_nets", "modulation_nets") else 0)
        s = _stride(level)
        if parts[1] in ("up_flow", "up_conf"):  # 2x from the level above
            s *= 2
    return 1, (H // s) * (W // s)


def conv_flops(B: int, H: int, W: int) -> Dict[str, int]:
    """{conv layer: FLOPs of a call of B pairs at H x W}."""
    out = {}
    for name, shape, kind in param_shapes():
        if kind not in ("conv", "deconv"):
            continue
        layer = name.rsplit(".", 1)[0]
        images, positions = _positions(layer, H, W)
        w = 1
        for n in shape:
            w *= n
        out[layer] = 2 * images * B * w * positions
    return out


def correlations(B: int, H: int, W: int) -> List[Correlation]:
    out = []
    for i in range(LEVELS):
        h, w, c = H // _stride(i), W // _stride(i), FEAT_CH[i]
        if i >= MOD_FROM:
            out.append(Correlation(B, h, w, c, SELF_PATCH[i], True))  # deformation
            out.append(Correlation(B, h, w, c, MATCH_PATCH, False))  # modulation
        else:
            out.append(Correlation(B, h, w, c, MATCH_PATCH, False))  # matching
    return out


def forward_flops(B: int, H: int, W: int) -> int:
    return sum(conv_flops(B, H, W).values()) + sum(c.ops for c in correlations(B, H, W))


def corr_bound_s(B: int, H: int, W: int, policy: str) -> float:
    """Least time of one call's correlations: each its bytes at HBM rate or
    its operations at the policy's peak, whichever is longer, summed."""
    return sum(max(c.nbytes(ITEMSIZE[policy]) / HBM_BYTES_PER_S, c.ops / PEAK_FLOPS[policy])
               for c in correlations(B, H, W))

