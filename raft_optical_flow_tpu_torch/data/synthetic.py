"""Synthetic training pairs with exact ground-truth flow from real images.

Counterpart of `raft_optical_flow_tpu/data/synthetic.py` (pure numpy): crop a
real frame, draw a smooth random flow field g, and resample the crop
bilinearly so that image1(y) = crop(y + g(y)); the flow from image1 to the
crop is exactly g. Frames come from a list of [H, W, 3] arrays, by default
`image1` and `image2` of `tests/goldens/raft_small.npz` (192x320 real
frames), so no image decoder and no dataset on disk is needed.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_FRAMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                              "tests", "goldens", "raft_small.npz")


def default_frames() -> List[np.ndarray]:
    """The two 192x320 frames of the RAFT-small golden, float32 0-255."""
    g = np.load(DEFAULT_FRAMES)
    return [g["image1"].astype(np.float32), g["image2"].astype(np.float32)]


def _frames(frames: Optional[Sequence[np.ndarray]]) -> List[np.ndarray]:
    if frames is None:
        return default_frames()
    return [np.asarray(f, np.float32) for f in frames]


def _smooth_flow(rng, H: int, W: int, max_mag: float) -> np.ndarray:
    """Smooth random field: coarse noise bilinearly upsampled to [H, W, 2]."""
    coarse = rng.uniform(-max_mag, max_mag, (4, 5, 2)).astype(np.float32)
    ys = np.linspace(0, coarse.shape[0] - 1, H)
    xs = np.linspace(0, coarse.shape[1] - 1, W)
    y0 = np.clip(ys.astype(int), 0, coarse.shape[0] - 2)
    x0 = np.clip(xs.astype(int), 0, coarse.shape[1] - 2)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
            + wy * ((1 - wx) * c10 + wx * c11)).astype(np.float32)


def _bilinear_gather(img: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Sample img [H, W, C] at coords [h, w, 2] (x, y), border-clamped."""
    H, W = img.shape[:2]
    x = np.clip(coords[..., 0], 0, W - 1)
    y = np.clip(coords[..., 1], 0, H - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, H - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def _warped_pair(r: np.random.RandomState, frames, crop, max_flow):
    ch, cw = crop
    margin = int(np.ceil(max_flow)) + 2
    img = frames[r.randint(len(frames))]
    H, W = img.shape[:2]
    y0 = r.randint(margin, H - ch - margin)
    x0 = r.randint(margin, W - cw - margin)
    gy, gx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    g = _smooth_flow(r, ch, cw, max_flow)
    coords = np.stack([gx + x0 + g[..., 0], gy + y0 + g[..., 1]], axis=-1)
    image1 = _bilinear_gather(img, coords)
    image2 = img[y0 : y0 + ch, x0 : x0 + cw]
    return image1, image2, g


class SyntheticFlowDataset:
    """Warped-pair dataset, deterministic per index: `__getitem__(index, rng)`
    -> (image1, image2, flow, valid) float32, a pure function of the rng the
    loader hands it (`np.random.default_rng(index)` without one)."""

    def __init__(
        self,
        crop: Tuple[int, int] = (64, 96),
        length: int = 1024,
        max_flow: float = 6.0,
        frames: Optional[Sequence[np.ndarray]] = None,
    ):
        self.frames = _frames(frames)
        self.crop = tuple(crop)
        self.length = length
        self.max_flow = max_flow
        margin = int(np.ceil(max_flow)) + 2
        for f in self.frames:
            if f.shape[0] <= crop[0] + 2 * margin or f.shape[1] <= crop[1] + 2 * margin:
                raise ValueError(f"crop {crop} with margin {margin} does not fit a "
                                 f"{f.shape[0]}x{f.shape[1]} frame")

    def __len__(self):
        return self.length

    def __getitem__(self, index: int, rng=None):
        if rng is None:
            rng = np.random.default_rng(index)
        r = np.random.RandomState(int(rng.integers(2**31)))
        image1, image2, g = _warped_pair(r, self.frames, self.crop, self.max_flow)
        ch, cw = self.crop
        return (image1.astype(np.float32), image2.astype(np.float32), g,
                np.ones((ch, cw), np.float32))


def warped_pair_batches(
    batch_size: int,
    crop: Tuple[int, int] = (64, 96),
    max_flow: float = 6.0,
    seed: int = 0,
    frames: Optional[Sequence[np.ndarray]] = None,
) -> Iterator[dict]:
    """Endless {image1, image2, flow, valid} batches (0-255 images, exact flow)."""
    frames = _frames(frames)
    rng = np.random.RandomState(seed)
    ch, cw = crop
    while True:
        b = {"image1": [], "image2": [], "flow": [], "valid": []}
        for _ in range(batch_size):
            image1, image2, g = _warped_pair(rng, frames, crop, max_flow)
            b["image1"].append(image1)
            b["image2"].append(image2)
            b["flow"].append(g)
            b["valid"].append(np.ones((ch, cw), np.float32))
        yield {k: np.stack(v).astype(np.float32) for k, v in b.items()}
