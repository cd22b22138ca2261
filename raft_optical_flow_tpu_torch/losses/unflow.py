"""UnFlow's unsupervised-loss library.

Counterpart of `raft_optical_flow_tpu/losses/unflow.py`: the backward warp
(`image_warp`), the forward-warp occupancy (`forward_warp`, the splat of
`ops/unflow_ops.py`), the generalized Charbonnier penalty, and
`compute_losses`: photometric, Sobel gradient, first- and second-order
smoothness (diagonals included), forward-backward consistency, ternary
(census), occlusion and symmetry terms, with 'fb' or 'disocc' occlusion
masking (DISOCC_THRESH = 0.8). Flow channels are (x, y), the port's
order (unlike `losses/uflow.py`). NHWC at the surface; the 3x3 filters
(Sobel, the smoothness differences, divergence) are fp32 `F.conv2d`s with
TF32 off, as JAX's HIGHEST-precision convs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import bilinear_sampler, coords_grid
from raft_optical_flow_tpu_torch.ops.unflow_ops import forward_warp_op

DISOCC_THRESH = 0.8

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def length_sq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x), dim=3, keepdim=True)


def image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: image sampled at grid + flow (zeros outside)."""
    N, H, W, _ = image.shape
    coords = coords_grid(N, H, W, device=flow.device, dtype=flow.dtype) + flow
    return bilinear_sampler(image, coords, padding="zeros")


def forward_warp(flow: torch.Tensor) -> torch.Tensor:
    """Forward-warp occupancy [B, H, W, 1]: `ops/unflow_ops.py::forward_warp_op`
    (the clamped-border UnFlow splat, repeated indices summed)."""
    return forward_warp_op(flow)


def create_mask(tensor: torch.Tensor, paddings) -> torch.Tensor:
    """[B, H, W, 1] ones inside, zeros in a border of paddings [[top, bottom],
    [left, right]]."""
    B, H, W, _ = tensor.shape
    (t, b), (l, r) = paddings
    inner = torch.ones(H - t - b, W - l - r, dtype=tensor.dtype, device=tensor.device)
    return F.pad(inner, (l, r, t, b))[None, :, :, None].expand(B, H, W, 1)


def create_outgoing_mask(flow: torch.Tensor) -> torch.Tensor:
    """1 where the flow's endpoint stays inside the image."""
    N, H, W, _ = flow.shape
    coords = coords_grid(N, H, W, device=flow.device, dtype=flow.dtype) + flow
    inside = ((coords[..., 0] >= 0.0) & (coords[..., 0] <= W - 1)
              & (coords[..., 1] >= 0.0) & (coords[..., 1] <= H - 1))
    return inside.to(flow.dtype)[..., None]


def charbonnier_loss(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     truncate: Optional[float] = None, alpha: float = 0.45, beta: float = 1.0,
                     epsilon: float = 0.001) -> torch.Tensor:
    """Generalized Charbonnier: sum of ((x*beta)^2 + eps^2)^alpha (times the
    mask, capped at truncate) over the element count of x."""
    B, H, W, C = x.shape
    normalization = float(B * H * W * C)
    error = torch.pow(torch.square(x * beta) + epsilon**2, alpha)
    if mask is not None:
        error = error * mask
    if truncate is not None:
        error = torch.minimum(error, error.new_tensor(truncate))
    return torch.sum(error) / normalization


def photometric_loss(im_diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return charbonnier_loss(im_diff, mask, beta=255.0)


def _conv2d_same(x: torch.Tensor, kernels) -> torch.Tensor:
    """3x3 'same' conv of x [B, H, W, Cin] with kernels [3, 3, Cin, Cout]
    (HWIO), fp32 with TF32 off."""
    w = torch.as_tensor(kernels, dtype=x.dtype).to(x.device).permute(3, 2, 0, 1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1)


def _sobel():
    sx = torch.tensor(_SOBEL_X)
    return sx, sx.T


def _gradient_delta(im1: torch.Tensor, im2_warped: torch.Tensor) -> torch.Tensor:
    """Sobel gradient differences, channels [R_x, R_y, G_x, G_y, B_x, B_y]."""
    sx, sy = _sobel()
    w = torch.zeros(3, 3, 3, 6)
    for c in range(3):
        w[:, :, c, 2 * c] = sx
        w[:, :, c, 2 * c + 1] = sy
    return _conv2d_same(im1, w) - _conv2d_same(im2_warped, w)


def gradient_loss(im1, im2_warped, mask):
    mask_x = create_mask(im1, [[0, 0], [1, 1]])
    mask_y = create_mask(im1, [[1, 1], [0, 0]])
    gradient_mask = torch.cat([mask_x, mask_y], dim=3).repeat(1, 1, 1, 3)
    return charbonnier_loss(_gradient_delta(im1, im2_warped), mask * gradient_mask)


def _per_component(flow, filters):
    """filters [3, 3, 1, K] on each flow component: (delta_u, delta_v)."""
    return _conv2d_same(flow[..., 0:1], filters), _conv2d_same(flow[..., 1:2], filters)


def _smoothness_deltas(flow):
    """First-order forward differences per component, and their mask."""
    mask = torch.cat([create_mask(flow, [[0, 0], [0, 1]]), create_mask(flow, [[0, 1], [0, 0]])], dim=3)
    fx = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, -1.0], [0.0, 0.0, 0.0]])
    fy = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    return (*_per_component(flow, torch.stack([fx, fy], dim=-1)[:, :, None, :]), mask)


def smoothness_loss(flow):
    delta_u, delta_v, mask = _smoothness_deltas(flow)
    return charbonnier_loss(delta_u, mask) + charbonnier_loss(delta_v, mask)


def _second_order_deltas(flow):
    """Second differences along x, y and both diagonals, and their mask."""
    mask_diag = create_mask(flow, [[1, 1], [1, 1]])
    mask = torch.cat([create_mask(flow, [[0, 0], [1, 1]]), create_mask(flow, [[1, 1], [0, 0]]),
                      mask_diag, mask_diag], dim=3)
    filters = [
        [[0, 0, 0], [1, -2, 1], [0, 0, 0]],
        [[0, 1, 0], [0, -2, 0], [0, 1, 0]],
        [[1, 0, 0], [0, -2, 0], [0, 0, 1]],
        [[0, 0, 1], [0, -2, 0], [1, 0, 0]],
    ]
    w = torch.stack([torch.tensor(f, dtype=torch.float32) for f in filters], dim=-1)[:, :, None, :]
    return (*_per_component(flow, w), mask)


def second_order_loss(flow):
    delta_u, delta_v, mask = _second_order_deltas(flow)
    return charbonnier_loss(delta_u, mask) + charbonnier_loss(delta_v, mask)


def ternary_loss(im1, im2_warped, mask, max_distance: int = 1):
    """Census-transform consistency over a (2 max_distance + 1)^2 window."""
    patch_size = 2 * max_distance + 1

    def transform(image):
        intensities = torch.mean(image, dim=3, keepdim=True) * 255.0
        B, H, W, _ = intensities.shape
        p = max_distance
        padded = F.pad(intensities[..., 0], (p, p, p, p))
        patches = torch.stack([padded[:, ky:ky + H, kx:kx + W]
                               for ky in range(patch_size) for kx in range(patch_size)], dim=-1)
        t = patches - intensities
        return t / torch.sqrt(0.81 + torch.square(t))

    def hamming(t1, t2):
        d = torch.square(t1 - t2)
        return torch.sum(d / (0.1 + d), dim=3, keepdim=True)

    dist = hamming(transform(im1), transform(im2_warped))
    transform_mask = create_mask(mask, [[max_distance, max_distance], [max_distance, max_distance]])
    return charbonnier_loss(dist, mask * transform_mask)


def occlusion(flow_fw, flow_bw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-backward consistency occlusion masks (1 occluded)."""
    mag_sq = length_sq(flow_fw) + length_sq(flow_bw)
    flow_bw_warped = image_warp(flow_bw, flow_fw)
    flow_fw_warped = image_warp(flow_fw, flow_bw)
    occ_thresh = 0.01 * mag_sq + 0.5
    occ_fw = (length_sq(flow_fw + flow_bw_warped) > occ_thresh).to(flow_fw.dtype)
    occ_bw = (length_sq(flow_bw + flow_fw_warped) > occ_thresh).to(flow_fw.dtype)
    return occ_fw, occ_bw


def divergence(flow):
    """Sobel divergence of the flow, [B, H, W, 1]."""
    sx, sy = _sobel()
    gx = _conv2d_same(flow[..., 0:1], sx[:, :, None, None])
    gy = _conv2d_same(flow[..., 1:2], sy[:, :, None, None])
    return gx + gy


def compute_losses(im1: torch.Tensor, im2: torch.Tensor, flow_fw: torch.Tensor,
                   flow_bw: torch.Tensor, border_mask: Optional[torch.Tensor] = None,
                   mask_occlusion: str = "", data_max_distance: int = 1) -> Dict[str, torch.Tensor]:
    """The UnFlow loss terms {photo, grad, smooth_1st, smooth_2nd, fb, ternary,
    occ, sym}; NHWC inputs, flows (x, y); `mask_occlusion` '', 'fb' or
    'disocc'."""
    losses = {}
    im2_warped = image_warp(im2, flow_fw)
    im1_warped = image_warp(im1, flow_bw)
    im_diff_fw = im1 - im2_warped
    im_diff_bw = im2 - im1_warped

    disocc_fw = (forward_warp(flow_fw) < DISOCC_THRESH).to(im1.dtype)
    disocc_bw = (forward_warp(flow_bw) < DISOCC_THRESH).to(im1.dtype)

    if border_mask is None:
        mask_fw = create_outgoing_mask(flow_fw)
        mask_bw = create_outgoing_mask(flow_bw)
    else:
        mask_fw = border_mask
        mask_bw = border_mask

    flow_bw_warped = image_warp(flow_bw, flow_fw)
    flow_fw_warped = image_warp(flow_fw, flow_bw)
    flow_diff_fw = flow_fw + flow_bw_warped
    flow_diff_bw = flow_bw + flow_fw_warped
    mag_sq_fw = length_sq(flow_fw) + length_sq(flow_bw_warped)
    mag_sq_bw = length_sq(flow_bw) + length_sq(flow_fw_warped)
    fb_occ_fw = (length_sq(flow_diff_fw) > 0.01 * mag_sq_fw + 0.5).to(im1.dtype)
    fb_occ_bw = (length_sq(flow_diff_bw) > 0.01 * mag_sq_bw + 0.5).to(im1.dtype)

    if mask_occlusion == "fb":
        mask_fw = mask_fw * (1 - fb_occ_fw)
        mask_bw = mask_bw * (1 - fb_occ_bw)
    elif mask_occlusion == "disocc":
        mask_fw = mask_fw * (1 - disocc_bw)
        mask_bw = mask_bw * (1 - disocc_fw)

    occ_fw = 1 - mask_fw
    occ_bw = 1 - mask_bw

    losses["sym"] = charbonnier_loss(occ_fw - disocc_bw) + charbonnier_loss(occ_bw - disocc_fw)
    losses["occ"] = charbonnier_loss(occ_fw) + charbonnier_loss(occ_bw)
    losses["photo"] = photometric_loss(im_diff_fw, mask_fw) + photometric_loss(im_diff_bw, mask_bw)
    losses["grad"] = gradient_loss(im1, im2_warped, mask_fw) + gradient_loss(im2, im1_warped, mask_bw)
    losses["smooth_1st"] = smoothness_loss(flow_fw) + smoothness_loss(flow_bw)
    losses["smooth_2nd"] = second_order_loss(flow_fw) + second_order_loss(flow_bw)
    losses["fb"] = charbonnier_loss(flow_diff_fw, mask_fw) + charbonnier_loss(flow_diff_bw, mask_bw)
    losses["ternary"] = (ternary_loss(im1, im2_warped, mask_fw, max_distance=data_max_distance)
                         + ternary_loss(im2, im1_warped, mask_bw, max_distance=data_max_distance))
    return losses
