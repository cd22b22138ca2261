"""Validation and submission drivers.

Counterpart of `raft_optical_flow_tpu/eval/evaluate.py`, after the
reference's `evaluate.py`:
  - validate_chairs (iters 24): EPE over all pixels.
  - validate_sintel (iters 32): per-dstype EPE + 1/3/5px, InputPadder pad/unpad.
  - validate_kitti (iters 24): EPE + F1 = %(epe>3 & epe/mag>0.05) over valid,
    frame sizes padded onto stride-64 buckets (KITTI's 370-376 x 1224-1242
    frames all pad to 384x1280), one shape for every pair.
  - create_sintel_submission: .flo per frame, sequence warm start via
    forward_interpolate of the previous flow_low, fed back as flow_init.
  - create_kitti_submission: KITTI 16-bit flow PNGs.

A forward is a closure `fwd(image1, image2, flow_init=None) -> (flow_low,
flow_up)` on NHWC tensors in [0, 255], under `torch.inference_mode()`;
`fwd.device` is where `_run_padded` puts its inputs. The metrics are
computed in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable

import numpy as np
import torch

from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear
from raft_optical_flow_tpu_torch.ops.padding import InputPadder


def _model(cls, config, state_dict_or_model, device):
    if isinstance(state_dict_or_model, torch.nn.Module):
        return state_dict_or_model
    model = cls(config, device=device)
    model.load_state_dict(state_dict_or_model)
    return model


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_raft_forward(config: RAFTConfig, state_dict_or_model, iters: int,
                      device="cuda") -> Callable:
    """RAFT in test mode as a (image1, image2, flow_init?) -> (flow_low,
    flow_up) closure. Given a state_dict, builds RAFT(config) on `device`;
    given a model (a trainer's, for its validation), runs it where it is."""
    model = _model(RAFT, config, state_dict_or_model, device)

    @torch.inference_mode()
    def fwd(image1, image2, flow_init=None):
        return model(image1, image2, iters=iters, flow_init=flow_init, test_mode=True)

    fwd.device = _device_of(model)
    return fwd


def make_lfn3_forward(config, state_dict_or_model, device="cuda") -> Callable:
    """LiteFlowNet3 adapted to the (flow_low, flow_up) eval protocol: images
    / 255, the flow of `outputs['flows']`; flow_init is accepted and
    ignored, and flow_low is a 1/4-res bilinear downscale of the flow / 4,
    for the API only (`evaluate_liteflownet3.py:128-193`)."""
    from raft_optical_flow_tpu_torch.models.liteflownet3 import LiteFlowNet3

    model = _model(LiteFlowNet3, config, state_dict_or_model, device)

    @torch.inference_mode()
    def fwd(image1, image2, flow_init=None):
        del flow_init
        images = torch.stack([image1, image2], dim=1) / 255.0
        flow = model(images)["flows"][:, 0]
        H, W = flow.shape[1:3]
        return resize_bilinear(flow, (H // 4, W // 4)) / 4.0, flow

    fwd.device = _device_of(model)
    return fwd


def epe_stats(flow_pred: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    """Per-pixel end-point error [H, W]."""
    return np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=-1))


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-splat flow to the next frame for warm starts; nearest-neighbor fill.

    flow: [H, W, 2] numpy (x, y). Matches `core/utils/utils.py:26-54` (scipy griddata
    nearest over forward-advected points).
    """
    from scipy import interpolate

    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    if valid.sum() == 0:
        return np.zeros_like(flow)
    flow_x = interpolate.griddata(
        (x1[valid], y1[valid]), dxf[valid], (x0, y0), method="nearest", fill_value=0
    )
    flow_y = interpolate.griddata(
        (x1[valid], y1[valid]), dyf[valid], (x0, y0), method="nearest", fill_value=0
    )
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)


def _run_padded(fwd, image1, image2, mode: str, flow_init=None, stride: int = 8):
    """Pad -> forward -> unpad. images: [H, W, 3] numpy; returns (flow [H, W,
    2], flow_low [h, w, 2]) numpy.

    `stride` > 8 buckets frame sizes (64 puts KITTI's slightly varying
    resolutions onto one shape)."""
    device = getattr(fwd, "device", "cpu")
    padder = InputPadder((1,) + image1.shape, mode=mode, stride=stride)
    i1 = torch.as_tensor(np.asarray(image1, np.float32))[None].to(device)
    i2 = torch.as_tensor(np.asarray(image2, np.float32))[None].to(device)
    i1, i2 = padder.pad(i1, i2)
    if flow_init is not None:
        flow_init = torch.as_tensor(np.asarray(flow_init, np.float32))[None].to(device)
    flow_low, flow_up = fwd(i1, i2, flow_init)
    flow = padder.unpad(flow_up)[0].float().cpu().numpy()
    return flow, flow_low[0].float().cpu().numpy()


def validate_chairs(fwd, dataset: Iterable, iters: int = 24) -> Dict[str, float]:
    """`evaluate.py:74-92`: mean EPE over FlyingChairs val."""
    epes = []
    for sample in dataset:
        image1, image2, flow_gt = sample[0], sample[1], sample[2]
        flow, _ = _run_padded(fwd, image1, image2, mode="sintel")
        epes.append(epe_stats(flow, flow_gt).reshape(-1))
    epe = np.mean(np.concatenate(epes))
    print(f"Validation Chairs EPE: {epe:.4f}")
    return {"chairs": float(epe)}


def validate_sintel(fwd, dataset: Iterable, dstype: str = "clean") -> Dict[str, float]:
    """`evaluate.py:95-127`: EPE + 1/3/5px accuracies on the fixed Sintel val split."""
    epe_list = []
    for sample in dataset:
        image1, image2, flow_gt = sample[0], sample[1], sample[2]
        flow, _ = _run_padded(fwd, image1, image2, mode="sintel")
        epe_list.append(epe_stats(flow, flow_gt).reshape(-1))
    epe_all = np.concatenate(epe_list)
    res = {
        dstype: float(np.mean(epe_all)),
        f"{dstype}_1px": float(np.mean(epe_all < 1)),
        f"{dstype}_3px": float(np.mean(epe_all < 3)),
        f"{dstype}_5px": float(np.mean(epe_all < 5)),
    }
    print(
        f"Validation ({dstype}) EPE: {res[dstype]:.4f}, "
        f"1px: {res[f'{dstype}_1px']:.4f}, 3px: {res[f'{dstype}_3px']:.4f}, "
        f"5px: {res[f'{dstype}_5px']:.4f}"
    )
    return res


def validate_kitti(fwd, dataset: Iterable, bucket_stride: int = 64) -> Dict[str, float]:
    """`evaluate.py:130-166`: KITTI EPE + F1-all over valid pixels, frame
    sizes padded onto stride-`bucket_stride` buckets."""
    out_list, epe_list = [], []
    for sample in dataset:
        image1, image2, flow_gt, valid_gt = sample[0], sample[1], sample[2], sample[3]
        flow, _ = _run_padded(fwd, image1, image2, mode="kitti", stride=bucket_stride)
        epe = epe_stats(flow, flow_gt)
        mag = np.sqrt(np.sum(flow_gt**2, axis=-1))
        val = valid_gt >= 0.5
        out = (epe > 3.0) & ((epe / np.maximum(mag, 1e-9)) > 0.05)
        epe_list.append(epe[val].mean())
        out_list.append(out[val])
    epe = float(np.mean(epe_list))
    f1 = 100 * float(np.mean(np.concatenate(out_list)))
    print(f"Validation KITTI: EPE {epe:.4f}, F1-all {f1:.4f}")
    return {"kitti-epe": epe, "kitti-f1": f1}


def create_sintel_submission(
    fwd, dataset_by_sequence, output_path: str = "sintel_submission",
    warm_start: bool = False,
):
    """`evaluate.py:21-50`: write .flo per frame, optional warm-start across frames.

    dataset_by_sequence: iterable of (sequence_name, [(image1, image2, frame_id), ...]).
    """
    from raft_optical_flow_tpu_torch.data.frame_utils import write_flow

    for sequence, frames in dataset_by_sequence:
        flow_prev = None
        for image1, image2, frame_id in frames:
            flow, flow_low = _run_padded(
                fwd, image1, image2, mode="sintel", flow_init=flow_prev
            )
            if warm_start:
                flow_prev = forward_interpolate(flow_low)
            out_dir = os.path.join(output_path, sequence)
            os.makedirs(out_dir, exist_ok=True)
            write_flow(os.path.join(out_dir, f"frame{frame_id + 1:04d}.flo"), flow)


def create_kitti_submission(fwd, dataset, output_path: str = "kitti_submission"):
    """`evaluate.py:53-71`: write KITTI 16-bit pngs."""
    from raft_optical_flow_tpu_torch.data.frame_utils import write_flow_kitti

    os.makedirs(output_path, exist_ok=True)
    for image1, image2, frame_id in dataset:
        flow, _ = _run_padded(fwd, image1, image2, mode="kitti")
        write_flow_kitti(os.path.join(output_path, frame_id), flow)
