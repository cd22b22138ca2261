"""Optical-flow visualization: Middlebury color wheel (Baker et al. ICCV'07).

Counterpart of `raft_optical_flow_tpu/utils/flow_viz.py` (after
`core/utils/flow_viz.py:20-132`, the standard public Scharstein/Sun
coloring). Pure numpy; host-side only; the HSV variant converts through
`data/cv.py::hsv_to_rgb_u8` (cv2's uint8 HSV2RGB, without cv2).
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """55-color RY/YG/GC/CB/BM/MR wheel, shape [55, 3] (RGB, 0-255)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col : col + RY, 0] = 255
    wheel[col : col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr: bool = False) -> np.ndarray:
    """Color radius<=1 normalized flow components; [H, W] -> [H, W, 3] uint8."""
    img = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        inside = rad <= 1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75
        ch = 2 - i if convert_to_bgr else i
        img[:, :, ch] = np.floor(255 * col)
    return img


def flow_to_image(
    flow_uv: np.ndarray, clip_flow: float | None = None, convert_to_bgr: bool = False
) -> np.ndarray:
    """Normalize flow by max radius and colorize. flow_uv: [H, W, 2] -> [H, W, 3]."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2, "expected [H,W,2] flow"
    flow_uv = np.asarray(flow_uv)
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    rad_max = np.sqrt(u**2 + v**2).max()
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps), convert_to_bgr)


def flow_to_rgb_hsv(flow: np.ndarray) -> np.ndarray:
    """HSV-wheel flow visualization (`train_liteflownet3.py:88-102` variant).

    Hue = flow angle, saturation = 255, value = min(4*|flow|, 255), in
    OpenCV's uint8 HSV with hue in [0, 180).
    """
    from raft_optical_flow_tpu_torch.data.cv import hsv_to_rgb_u8

    h, w = flow.shape[:2]
    fx, fy = flow[:, :, 0], flow[:, :, 1]
    ang = np.arctan2(fy, fx) + np.pi
    v = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((h, w, 3), dtype=np.uint8)
    hsv[:, :, 0] = (ang * (180 / np.pi / 2)).astype(np.uint8)
    hsv[:, :, 1] = 255
    hsv[:, :, 2] = np.minimum(v * 4, 255).astype(np.uint8)
    return hsv_to_rgb_u8(hsv)
