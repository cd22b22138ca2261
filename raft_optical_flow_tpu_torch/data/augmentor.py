"""Dense and sparse flow augmentors (host-side numpy, no cv2).

Counterpart of `raft_optical_flow_tpu/data/augmentor.py`, itself after
`core/utils/augmentor.py`:
  - FlowAugmentor: ColorJitter(0.4, 0.4, 0.4, 0.5/3.14) with asymmetric
    p=0.2; eraser (1-2 mean-color rects 50-100 px on img2, p=0.5); spatial
    scale 2^U(min,max) with stretch p=0.8 (+-0.2), min-scale floored so the
    crop+8 fits, h-flip 0.5 / v-flip 0.1 with flow sign fix, random crop.
  - SparseFlowAugmentor: symmetric jitter (0.3/0.3/0.3/0.3/3.14),
    nearest-pixel scatter resize of valid flow points, crop margins y=20 /
    x=50.

The JAX package calls cv2 for the bilinear resize and the uint8 HSV hue
shift; here `data/cv.py` rebuilds both to OpenCV's rounding, so the same
np.random.Generator gives the same sample. Every draw comes from the
generator passed in, in the JAX package's order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from raft_optical_flow_tpu_torch.data.cv import hsv_to_rgb_u8, resize_linear, rgb_to_hsv_u8


class NumpyColorJitter:
    """torchvision.transforms.ColorJitter semantics on uint8 HWC numpy images."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _gray(img: np.ndarray) -> np.ndarray:
        return (
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        )[..., None]

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        x = img.astype(np.float32)
        order = rng.permutation(4)
        for op in order:
            if op == 0 and self.brightness > 0:
                f = rng.uniform(max(0.0, 1 - self.brightness), 1 + self.brightness)
                x = x * f
            elif op == 1 and self.contrast > 0:
                f = rng.uniform(max(0.0, 1 - self.contrast), 1 + self.contrast)
                mean = self._gray(np.clip(x, 0, 255)).mean()
                x = f * x + (1 - f) * mean
            elif op == 2 and self.saturation > 0:
                f = rng.uniform(max(0.0, 1 - self.saturation), 1 + self.saturation)
                gray = self._gray(np.clip(x, 0, 255))
                x = f * x + (1 - f) * gray
            elif op == 3 and self.hue > 0:
                f = rng.uniform(-self.hue, self.hue)
                u8 = np.clip(x, 0, 255).astype(np.uint8)
                hsv = rgb_to_hsv_u8(u8)
                # OpenCV uint8 hue is [0, 180); torchvision hue factor is a
                # fraction of the full circle
                h = (hsv[..., 0].astype(np.int32) + int(round(f * 180))) % 180
                hsv[..., 0] = h.astype(np.uint8)
                x = hsv_to_rgb_u8(hsv).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.uint8)


class FlowAugmentor:
    """Dense-flow augmentation (`core/utils/augmentor.py:15-166`)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = NumpyColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, rng)
            img2 = self.photo_aug(img2, rng)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = self.photo_aug(stack, rng)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, rng):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 8) / float(ht), (self.crop_size[1] + 8) / float(wd)
        )
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.v_flip_prob:
                img1 = img1[::-1, :]
                img2 = img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0])
        x0 = rng.integers(0, img1.shape[1] - self.crop_size[1])
        img1 = img1[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        img2 = img2[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        flow = flow[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
        )


class SparseFlowAugmentor:
    """Sparse-flow (KITTI/HD1K) augmentation (`core/utils/augmentor.py:168-372`)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = NumpyColorJitter(0.3, 0.3, 0.3, 0.3 / 3.14)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5

    def color_transform(self, img1, img2, rng):
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(stack, rng)
        img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, rng):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(50, 100)
                dy = rng.integers(50, 100)
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        """Scatter valid flow points to nearest pixels in the resized grid
        (`core/utils/augmentor.py:235-290`)."""
        ht, wd = flow.shape[:2]
        coords = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack(coords, axis=-1).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        valid_flat = valid.reshape(-1).astype(np.float32)

        coords0 = coords[valid_flat >= 1]
        flow0 = flow_flat[valid_flat >= 1]
        ht1 = int(round(ht * fy))
        wd1 = int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        xx, yy, flow1 = xx[v], yy[v], flow1[v]

        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yy, xx] = flow1
        valid_img[yy, xx] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 1) / float(ht), (self.crop_size[1] + 1) / float(wd)
        )
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)

        if self.do_flip and rng.random() < 0.5:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = rng.integers(-margin_x, img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))

        img1 = img1[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        img2 = img2[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        flow = flow[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        valid = valid[y0 : y0 + self.crop_size[0], x0 : x0 + self.crop_size[1]]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow, valid, rng)
        return (
            np.ascontiguousarray(img1),
            np.ascontiguousarray(img2),
            np.ascontiguousarray(flow),
            np.ascontiguousarray(valid),
        )
