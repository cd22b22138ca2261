"""UFlow's unsupervised-loss library.

Counterpart of `raft_optical_flow_tpu/losses/uflow.py`: the resampler and
warps, the range map (forward-warp occupancy), the occlusion estimators
{none, brox, fb_abs, wang, wang4, wangthres, wang4thres, uflow}, the
up/down/sparse resizes, the distance metrics, census (49 taps), weighted
SSIM, the self-supervision crops and shifts, `compute_loss` (photometric,
first- and second-order edge-aware smoothness, SSIM, census, self-
supervision) and `supervised_loss`.

CONVENTION: this module keeps UFlow's (y, x) order, as the JAX package's
does: flow channels are (dy, dx) and warp coordinates (y, x), unlike the
rest of the port's (x, y). The trainer flips channels once.

The range map is a splat: `ops/unflow_ops.py::splat_sum` adds its taps as
fixed-point integers, so it is the same on every run on the card. It feeds
only stopped-gradient masks and carries no gradient. Reductions are
mask-weighted, as in JAX; |x| and clip take JAX's gradients at the kinks
(`abs_jax`, `clip_jax`). Random crops and shifts draw from an explicit
`torch.Generator` where JAX takes a key.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import abs_jax, bilinear_sampler, clip_jax, resize_bilinear
from raft_optical_flow_tpu_torch.ops.unflow_ops import splat_sum

# ----------------------------------------------------------------------------- ops


def resample(source: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of source [B, H, W, C] at (y, x) coords [B, ..., 2];
    taps outside the image are zero."""
    return bilinear_sampler(source, coords.flip(-1), padding="zeros")


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """warp = grid + flow in (y, x) order; flow [B, H, W, 2] = (dy, dx)."""
    H, W = flow.shape[-3:-1]
    gy, gx = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                            torch.arange(W, dtype=flow.dtype, device=flow.device), indexing="ij")
    return torch.stack([gy, gx], dim=-1)[None] + flow


def mask_invalid(coords: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1]: 1 where the (y, x) coords lie inside the image, else 0."""
    max_y = coords.shape[-3] - 1.0
    max_x = coords.shape[-2] - 1.0
    mask = ((coords[..., 0] >= 0.0) & (coords[..., 0] <= max_y)
            & (coords[..., 1] >= 0.0) & (coords[..., 1] <= max_x))
    return mask.to(coords.dtype)[..., None]


def upsample(img: torch.Tensor, is_flow: bool) -> torch.Tensor:
    """2x bilinear upsample; flow values doubled."""
    H, W = img.shape[1:3]
    out = resize_bilinear(img, (2 * H, 2 * W))
    return out * 2.0 if is_flow else out


def downsample(img: torch.Tensor, is_flow: bool) -> torch.Tensor:
    """2x bilinear downsample; flow values halved."""
    H, W = img.shape[1:3]
    out = resize_bilinear(img, (H // 2, W // 2))
    return out / 2.0 if is_flow else out


def resize(img: torch.Tensor, height: int, width: int, is_flow: bool,
           mask: Optional[torch.Tensor] = None):
    """Bilinear (half-pixel) resize of [B, H, W, C]. With a mask, the sparse
    resize: img * mask and mask resized, the one divided by the other (+1e-8),
    and the new mask where it is above 0; returns (img, mask) then. A flow's
    values scale by (height / H, width / W) on its (dy, dx) channels."""
    orig_h, orig_w = img.shape[-3:-1]
    if orig_h == height and orig_w == width:
        return (img, mask) if mask is not None else img
    if mask is not None:
        img_r = resize_bilinear(img * mask, (height, width))
        mask_r = resize_bilinear(mask, (height, width))
        img_r = img_r / (mask_r + 1e-8)
        mask_out = (mask_r > 0).to(img.dtype)
    else:
        img_r = resize_bilinear(img, (height, width))
    if is_flow:
        img_r = img_r * torch.tensor([height / orig_h, width / orig_w], dtype=img_r.dtype,
                                     device=img_r.device)
    if mask is not None:
        return img_r, mask_out
    return img_r


@torch.no_grad()
def compute_range_map(flow: torch.Tensor, downsampling_factor: int = 1,
                      reduce_downsampling_bias: bool = True,
                      resize_output: bool = True) -> torch.Tensor:
    """Forward-warp occupancy: how much of each target pixel is sampled.

    flow [B, H, W, 2] (dy, dx). Each source pixel splats the four bilinear
    weights of its target; taps outside are dropped. With a downsampling
    factor d > 1 the targets land on a grid d times coarser (with
    `reduce_downsampling_bias`, the flow reflect-padded d//2 times and the
    grid shifted back first) and the counts divide by d^2; `resize_output`
    brings them back to H x W. Returns [B, H, W, 1] (or the coarse size).
    No gradient (its callers stop it).
    """
    B, in_h, in_w, _ = flow.shape
    out_h = in_h // downsampling_factor
    out_w = in_w // downsampling_factor
    if downsampling_factor > 1:
        if reduce_downsampling_bias:
            p = downsampling_factor // 2
            for _ in range(p):
                flow = F.pad(flow.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
            coords = flow_to_warp(flow) - p
        else:
            coords = flow_to_warp(flow)
        coords = (coords + (1 - downsampling_factor) * 0.5) / downsampling_factor
    else:
        coords = flow_to_warp(flow)

    cf = torch.floor(coords)
    off = coords - cf
    cf = cf.long()
    y0 = cf[..., 0].reshape(B, -1)
    x0 = cf[..., 1].reshape(B, -1)
    wy = off[..., 0].reshape(B, -1)
    wx = off[..., 1].reshape(B, -1)
    index, weights = [], []
    for di, w_y in ((0, 1.0 - wy), (1, wy)):
        for dj, w_x in ((0, 1.0 - wx), (1, wx)):
            yi = y0 + di
            xi = x0 + dj
            inb = (yi >= 0) & (yi < out_h) & (xi >= 0) & (xi < out_w)
            index.append(torch.clamp(yi, 0, out_h - 1) * out_w + torch.clamp(xi, 0, out_w - 1))
            weights.append(torch.where(inb, w_y * w_x, torch.zeros((), dtype=flow.dtype,
                                                                    device=flow.device)))
    counts = splat_sum(torch.cat(index, dim=1), torch.cat(weights, dim=1), out_h * out_w)
    count_image = counts.reshape(B, out_h, out_w, 1)
    if downsampling_factor > 1:
        count_image = count_image / downsampling_factor**2
        if resize_output:
            count_image = resize(count_image, in_h, in_w, is_flow=False)
    return count_image


# ---------------------------------------------------------------- occlusion masks


def compute_warps_and_occlusion(
    flows: Dict[tuple, List[torch.Tensor]],
    occlusion_estimation: str,
    occ_weights: Optional[Dict[str, float]] = None,
    occ_thresholds: Optional[Dict[str, float]] = None,
    occ_clip_max: Optional[Dict[str, float]] = None,
    occlusions_are_zeros: bool = True,
    occ_active: Optional[Dict[str, bool]] = None,
):
    """Warps, validity masks, range maps, occlusion masks and the
    forward-backward statistics of every (i, j, tag) flow pyramid (both
    (i, j) and (j, i) present): (warps, valid_masks, range_maps_low,
    occlusion_masks, fb_sq_diff, fb_sum_sq), each {key: [per level]}
    (masks at level 0 only)."""
    warps, range_low, occ_masks, valid_masks = {}, {}, {}, {}
    fb_sq_diff, fb_sum_sq = {}, {}
    for key in flows:
        i, j, t = key
        rev_key = (j, i, t)
        warps[key] = []
        occ_masks[key] = []
        valid_masks[key] = []
        fb_sq_diff[key] = []
        fb_sum_sq[key] = []
        range_low.setdefault(rev_key, [])

        for level in range(min(3, len(flows[key]))):
            flow_ij = flows[key][level]
            flow_ji = flows[rev_key][level]
            warps[key].append(flow_to_warp(flow_ij))
            valid_masks[key].append(mask_invalid(warps[key][level]))
            flow_ji_in_i = resample(flow_ji, warps[key][level])
            fb_sq_diff[key].append(torch.sum((flow_ij + flow_ji_in_i) ** 2, dim=-1, keepdim=True))
            fb_sum_sq[key].append(torch.sum(flow_ij**2 + flow_ji_in_i**2, dim=-1, keepdim=True))
            if level != 0:
                continue

            occ = torch.zeros_like(flow_ij[..., :1])
            scores = {"forward_collision": torch.zeros_like(occ),
                      "backward_zero": torch.zeros_like(occ),
                      "fb_abs": torch.zeros_like(occ)}
            est = occlusion_estimation
            if est == "none" or (occ_active is not None and not occ_active.get(est, True)):
                pass
            elif est == "brox":
                occ = (fb_sq_diff[key][level] > 0.01 * fb_sum_sq[key][level] + 0.5).to(flow_ij.dtype)
            elif est == "fb_abs":
                occ = (fb_sq_diff[key][level] ** 0.5 > 1.5).to(flow_ij.dtype)
            elif est in ("wang", "wang4", "wangthres", "wang4thres"):
                df = 4 if "4" in est else 1
                rm = compute_range_map(flow_ji, downsampling_factor=df,
                                       reduce_downsampling_bias=(est != "wang"),
                                       resize_output=(est != "wang"))
                range_low[rev_key].append(rm)
                if "thres" in est:
                    occ = (rm < 0.75).to(flow_ij.dtype)
                else:
                    occ = 1.0 - clip_jax(rm, 0.0, 1.0)
            elif est == "uflow":
                logits = torch.zeros_like(occ)
                if "forward_collision" in occ_weights and (
                        occ_active is None or occ_active.get("forward_collision", True)):
                    rm_fwd = compute_range_map(flow_ij, 1, True, True)
                    fwd_in_i = resample(rm_fwd, warps[key][level])
                    scores["forward_collision"] = (
                        clip_jax(fwd_in_i, 1.0, occ_clip_max["forward_collision"]) - 1.0)
                if "backward_zero" in occ_weights and (
                        occ_active is None or occ_active.get("backward_zero", True)):
                    rm = compute_range_map(flow_ji, 4, True, True)
                    range_low[rev_key].append(rm)
                    scores["backward_zero"] = 1.0 - clip_jax(rm, 0.0, 1.0)
                if "fb_abs" in occ_weights and (
                        occ_active is None or occ_active.get("fb_abs", True)):
                    scores["fb_abs"] = clip_jax(fb_sq_diff[key][level] ** 0.5, 0.0,
                                                occ_clip_max["fb_abs"])
                for k, v in scores.items():
                    logits = logits + (v - occ_thresholds[k]) * occ_weights[k]
                occ = torch.sigmoid(logits)
            else:
                raise ValueError(f"Unknown occlusion_estimation {est!r}")
            occ_masks[key].append(1.0 - occ if occlusions_are_zeros else occ)
    return warps, valid_masks, range_low, occ_masks, fb_sq_diff, fb_sum_sq


def apply_warps_stop_grad(sources: Dict[int, torch.Tensor], warps: Dict[tuple, List[torch.Tensor]],
                          level: int) -> Dict[tuple, torch.Tensor]:
    """Each source image j warped by the (i, j, t) warp at `level`: the
    gradient reaches the warp only, not the image."""
    return {(i, j, t): resample(sources[j].detach(), warps[(i, j, t)][level])
            for (i, j, t) in warps}


# ---------------------------------------------------------------------- metrics


def l1(x: torch.Tensor) -> torch.Tensor:
    return abs_jax(x)


def robust_l1(x: torch.Tensor) -> torch.Tensor:
    """(x^2 + 0.001^2)^0.5."""
    return (x**2 + 0.001**2) ** 0.5


def abs_robust_loss(diff: torch.Tensor, eps: float = 0.01, q: float = 0.4) -> torch.Tensor:
    """DDFlow's robust loss (|d| + eps)^q."""
    return torch.pow(abs_jax(diff) + eps, q)


def image_grads(image_batch: torch.Tensor, stride: int = 1):
    """Forward differences along H and W of [B, H, W, C]: (d/dh, d/dw)."""
    gh = image_batch[:, stride:] - image_batch[:, :-stride]
    gw = image_batch[:, :, stride:] - image_batch[:, :, :-stride]
    return gh, gw


def get_distance_metric_fns(distance_metrics: Dict[str, str]) -> Dict[str, Callable]:
    table = {"l1": l1, "robust_l1": robust_l1, "ddflow": abs_robust_loss}
    return {k: table[v] for k, v in distance_metrics.items()}


# ------------------------------------------------------------------------ census


def zero_mask_border(mask_bhw3: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The mask with a border of patch_size // 2 pixels zeroed."""
    p = patch_size // 2
    return F.pad(mask_bhw3[:, p:-p, p:-p, :], (0, 0, p, p, p, p))


def census_transform(image: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Soft census transform of [B, H, W, C]: [B, H, W, patch_size^2], the
    offsets (ky, kx) row-major, zero outside the image."""
    intensities = torch.mean(image, dim=-1, keepdim=True) * 255.0
    B, H, W, _ = intensities.shape
    p = patch_size // 2
    padded = F.pad(intensities[..., 0], (p, p, p, p))
    neighbors = torch.stack([padded[:, ky:ky + H, kx:kx + W]
                             for ky in range(patch_size) for kx in range(patch_size)], dim=-1)
    diff = neighbors - intensities
    return diff / torch.sqrt(0.81 + torch.square(diff))


def soft_hamming(a_bhwk: torch.Tensor, b_bhwk: torch.Tensor, thresh: float = 0.1) -> torch.Tensor:
    sq = torch.square(a_bhwk - b_bhwk)
    return torch.sum(sq / (thresh + sq), dim=3, keepdim=True)


def census_loss(image_a, image_b, mask_bhw3, patch_size: int = 7,
                distance_metric_fn=abs_robust_loss) -> torch.Tensor:
    """Census loss of two images under mask [B, H, W, 1], its border zeroed."""
    hamming = soft_hamming(census_transform(image_a, patch_size), census_transform(image_b, patch_size))
    padded_mask = zero_mask_border(mask_bhw3, patch_size)
    diff = distance_metric_fn(hamming) * padded_mask
    return torch.sum(diff) / (torch.sum(padded_mask.detach()) + 1e-6)


# -------------------------------------------------------------------------- ssim


def _avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID average of [B, H, W, C]: the window's sum / 9."""
    H, W = x.shape[1] - 2, x.shape[2] - 2
    total = x[:, 0:H, 0:W]
    for i in range(3):
        for j in range(3):
            if i or j:
                total = total + x[:, i:i + H, j:j + W]
    return total / 9.0


def weighted_ssim(x, y, weight, c1: float = float("inf"), c2: float = 9e-6,
                  weight_epsilon: float = 0.01):
    """Weighted SSIM error of [B, H, W, C] images under weight [B, H, W]:
    (clip((1 - ssim) / 2, 0, 1) [B, H-2, W-2, C], the pooled weight
    [B, H-2, W-2, 1])."""
    if c1 == float("inf") and c2 == float("inf"):
        raise ValueError("Both c1 and c2 are infinite, SSIM loss is zero.")
    weight = weight[..., None]
    avg_w = _avg_pool3x3(weight)
    w_plus = weight + weight_epsilon
    inv_avg_w = 1.0 / (avg_w + weight_epsilon)

    def wpool(z):
        return _avg_pool3x3(z * w_plus) * inv_avg_w

    mu_x = wpool(x)
    mu_y = wpool(y)
    sigma_x = wpool(x**2) - mu_x**2
    sigma_y = wpool(y**2) - mu_y**2
    sigma_xy = wpool(x * y) - mu_x * mu_y
    if c1 == float("inf"):
        ssim_n = 2 * sigma_xy + c2
        ssim_d = sigma_x + sigma_y + c2
    elif c2 == float("inf"):
        ssim_n = 2 * mu_x * mu_y + c1
        ssim_d = mu_x**2 + mu_y**2 + c1
    else:
        ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
        ssim_d = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return clip_jax((1 - ssim_n / ssim_d) / 2, 0.0, 1.0), avg_w


# ----------------------------------------------------------- selfsup augmentations


def random_crop(generator: torch.Generator, batch: torch.Tensor, max_offset_height: int = 32,
                max_offset_width: int = 32):
    """A random crop of each element of [B, H, W, C] to (H - max_offset_height)
    x (W - max_offset_width): (cropped, offsets [B, 2] (h, w)), the offsets
    drawn uniformly in [0, max] from `generator`."""
    B, H, W, _ = batch.shape
    th, tw = H - max_offset_height, W - max_offset_width
    oh = torch.randint(0, max_offset_height + 1, (B,), generator=generator, device=generator.device)
    ow = torch.randint(0, max_offset_width + 1, (B,), generator=generator, device=generator.device)
    offsets = torch.stack([oh, ow], dim=-1)
    cropped = torch.stack([batch[b, h0:h0 + th, w0:w0 + tw]
                           for b, (h0, w0) in enumerate(offsets.tolist())])
    return cropped, offsets


def random_shift(generator: torch.Generator, batch: torch.Tensor, max_shift_height: int = 32,
                 max_shift_width: int = 32):
    """A random circular shift of each element of [B, H, W, C]: (shifted,
    shifts [B, 2] (h, w)), the shifts drawn uniformly in [-max, max]."""
    B = batch.shape[0]
    sh = torch.randint(-max_shift_height, max_shift_height + 1, (B,), generator=generator,
                       device=generator.device)
    sw = torch.randint(-max_shift_width, max_shift_width + 1, (B,), generator=generator,
                       device=generator.device)
    shifts = torch.stack([sh, sw], dim=-1)
    shifted = torch.stack([torch.roll(batch[b], (s0, s1), dims=(0, 1))
                           for b, (s0, s1) in enumerate(shifts.tolist())])
    return shifted, shifts


def selfsup_crop_transforms(crop_height: int, crop_width: int):
    """The self-supervision's per-level transforms into the student's frame:
    [fn_level0, fn_level1, fn_level2], fn(x, i_or_ij, is_flow) crops x by
    crop >> level on each side (a fixed border crop: flow values are
    unchanged by cropping)."""

    def make_fn(level):
        ch = crop_height >> level
        cw = crop_width >> level

        def fn(x, i_or_ij=None, is_flow=False):
            del i_or_ij, is_flow
            return x[:, ch:x.shape[1] - ch, cw:x.shape[2] - cw]

        return fn

    return [make_fn(level) for level in range(3)]


# ------------------------------------------------------------------- main losses


def compute_loss(
    weights: Dict[str, float],
    images: Dict[int, torch.Tensor],
    flows: Dict[tuple, List[torch.Tensor]],
    warps: Dict[tuple, List[torch.Tensor]],
    valid_warp_masks: Dict[tuple, List[torch.Tensor]],
    not_occluded_masks: Dict[tuple, List[torch.Tensor]],
    fb_sq_diff: Dict[tuple, List[torch.Tensor]],
    fb_sum_sq: Dict[tuple, List[torch.Tensor]],
    warped_images: Dict[tuple, torch.Tensor],
    only_forward: bool = False,
    selfsup_transform_fns=None,
    fb_sigma_teacher: float = 0.003,
    fb_sigma_student: float = 0.03,
    distance_metrics: Optional[Dict[str, str]] = None,
    smoothness_edge_weighting: str = "gaussian",
    stop_gradient_mask: bool = True,
    selfsup_mask: str = "gaussian",
    ground_truth_occlusions: Optional[torch.Tensor] = None,
    smoothness_at_level: int = 2,
) -> Dict[str, torch.Tensor]:
    """UFlow's total loss: {term: value} for every weighted term, and "total"."""
    if distance_metrics is None:
        distance_metrics = {"photo": "robust_l1", "census": "ddflow"}
    metric_fns = get_distance_metric_fns(distance_metrics)
    losses = {k: 0.0 for k in weights if k != "edge_constant"}

    compute_for = ["augmented-student"]
    num_pairs = sum(1.0 for (i, j, c) in warps if c in compute_for)

    for key in warps:
        i, j, c = key
        if c not in compute_for or (only_forward and i > j):
            continue

        if ground_truth_occlusions is None:
            mask_level0 = not_occluded_masks[key][0] * valid_warp_masks[key][0]
            if stop_gradient_mask:
                mask_level0 = mask_level0.detach()
        else:
            if i > j:
                continue
            gt_not_occ = 1.0 - ground_truth_occlusions.float()
            mask_level0 = (gt_not_occ * valid_warp_masks[key][0]).detach()

        if "photo" in weights:
            error = metric_fns["photo"](images[i] - warped_images[key])
            losses["photo"] += (weights["photo"] * torch.sum(mask_level0 * error)
                                / (torch.sum(mask_level0) + 1e-16) / num_pairs)

        if "smooth1" in weights or "smooth2" in weights:
            edge_constant = weights.get("edge_constant", 0.0)
            if smoothness_edge_weighting == "gaussian":
                abs_fn = lambda x: x**2  # noqa: E731
            elif smoothness_edge_weighting == "exponential":
                abs_fn = abs_jax
            else:
                raise ValueError(smoothness_edge_weighting)
            img0 = images[i]
            H, W = img0.shape[-3:-1]
            img1 = resize(img0, H // 2, W // 2, is_flow=False)
            img2 = resize(img1, H // 4, W // 4, is_flow=False)
            images_at_level = [img0, img1, img2]

            if "smooth1" in weights:
                gx, gy = image_grads(images_at_level[smoothness_at_level])
                wx = torch.exp(-torch.mean(abs_fn(edge_constant * gx), -1, keepdim=True))
                wy = torch.exp(-torch.mean(abs_fn(edge_constant * gy), -1, keepdim=True))
                fgx, fgy = image_grads(flows[key][smoothness_at_level])
                losses["smooth1"] += (weights["smooth1"]
                                      * (torch.mean(wx * robust_l1(fgx)) + torch.mean(wy * robust_l1(fgy)))
                                      / 2.0 / num_pairs)
            if "smooth2" in weights:
                gx, gy = image_grads(images_at_level[smoothness_at_level], stride=2)
                wxx = torch.exp(-torch.mean(abs_fn(edge_constant * gx), -1, keepdim=True))
                wyy = torch.exp(-torch.mean(abs_fn(edge_constant * gy), -1, keepdim=True))
                fgx, fgy = image_grads(flows[key][smoothness_at_level])
                fgxx, _ = image_grads(fgx)
                _, fgyy = image_grads(fgy)
                losses["smooth2"] += (weights["smooth2"]
                                      * (torch.mean(wxx * robust_l1(fgxx))
                                         + torch.mean(wyy * robust_l1(fgyy)))
                                      / 2.0 / num_pairs)

        if "ssim" in weights:
            ssim_error, avg_w = weighted_ssim(warped_images[key], images[i], mask_level0[..., 0])
            losses["ssim"] += weights["ssim"] * (
                torch.sum(ssim_error * avg_w) / (torch.sum(avg_w) + 1e-16) / num_pairs)

        if "census" in weights:
            losses["census"] += (weights["census"]
                                 * census_loss(images[i], warped_images[key], mask_level0,
                                               distance_metric_fn=metric_fns["census"])
                                 / num_pairs)

        if "selfsup" in weights:
            assert selfsup_transform_fns is not None
            _, h, w, _ = flows[key][2].shape
            teacher_flow = flows[(i, j, "original-teacher")][2]
            student_flow = flows[(i, j, "transformed-student")][2]
            teacher_flow = selfsup_transform_fns[2](teacher_flow, i_or_ij=(i, j), is_flow=True)
            if selfsup_mask == "gaussian":
                stu_fb = torch.exp(-fb_sq_diff[(i, j, "transformed-student")][2]
                                   / (fb_sigma_student**2 * (h**2 + w**2)))
                tea_fb = torch.exp(-fb_sq_diff[(i, j, "original-teacher")][2]
                                   / (fb_sigma_teacher**2 * (h**2 + w**2)))
            elif selfsup_mask == "advection":
                stu_fb = not_occluded_masks[(i, j, "transformed-student")][2]
                tea_fb = not_occluded_masks[(i, j, "original-teacher")][2]
            elif selfsup_mask == "ddflow":
                thr_s = 0.01 * fb_sum_sq[(i, j, "transformed-student")][2] + 0.5
                thr_t = 0.01 * fb_sum_sq[(i, j, "original-teacher")][2] + 0.5
                stu_fb = (fb_sq_diff[(i, j, "transformed-student")][2] < thr_s).float()
                tea_fb = (fb_sq_diff[(i, j, "original-teacher")][2] < thr_t).float()
            else:
                raise ValueError(f"Unknown selfsup_mask {selfsup_mask!r}")
            student_mask = 1.0 - stu_fb * valid_warp_masks[(i, j, "transformed-student")][2]
            teacher_mask = tea_fb * valid_warp_masks[(i, j, "original-teacher")][2]
            teacher_mask = selfsup_transform_fns[2](teacher_mask, i_or_ij=(i, j), is_flow=False)
            error = robust_l1(teacher_flow.detach() - student_flow)
            mask = (teacher_mask * student_mask).detach()
            losses["selfsup"] += (weights["selfsup"] * torch.sum(mask * error)
                                  / (torch.sum(torch.ones_like(mask)) + 1e-16) / num_pairs)

    losses["total"] = sum(losses.values())
    return losses


def supervised_loss(weights, ground_truth_flow, ground_truth_valid, predicted_flows):
    """Masked robust-L1 of the (0, 1, "augmented") prediction, resized to
    the ground truth's size: {"supervision", "total"}."""
    predicted_flow = predicted_flows[(0, 1, "augmented")][0]
    _, H, W, _ = ground_truth_flow.shape
    predicted_flow = resize(predicted_flow, H, W, is_flow=True)
    error = robust_l1(ground_truth_flow - predicted_flow)
    if ground_truth_valid is None:
        ground_truth_valid = torch.ones(ground_truth_flow.shape[:-1] + (1,),
                                        device=ground_truth_flow.device)
    losses = {"supervision": weights["supervision"] * torch.sum(ground_truth_valid * error)
              / (torch.sum(ground_truth_valid) + 1e-16)}
    losses["total"] = losses["supervision"]
    return losses
