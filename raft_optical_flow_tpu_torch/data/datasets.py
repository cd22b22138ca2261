"""Flow dataset index builders and sample readers (NHWC numpy).

Counterpart of `raft_optical_flow_tpu/data/datasets.py`, itself after
`core/datasets.py`:
  - FlowDataset.__getitem__: read image pair + flow (dense .flo/.pfm or
    sparse KITTI png), grayscale -> 3ch, augment, valid = provided or
    |flow| < 1000; test mode returns (img1, img2, extra_info).
  - RAM preload cache; `__rmul__` replication; `repeat`.
  - Dataset classes: MpiSintel (+ fixed 6-scene val split), FlyingChairs
    (chairs_split.txt), FlyingThings3D (into_future/into_past, left cam),
    KITTI (sparse), HD1K (sparse).
  - fetch_dataset: per-stage dataset mixes and augmentation ranges.

Files are read by the port's codecs (`data/frame_utils.py`: no PIL, no cv2)
and augmented by its augmentors (`data/augmentor.py`), each sample a pure
function of the np.random.Generator passed to `__getitem__(index, rng=)`;
`data/pipeline.py::FlowDataLoader` batches them.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_optical_flow_tpu_torch.data import frame_utils
from raft_optical_flow_tpu_torch.data.augmentor import FlowAugmentor, SparseFlowAugmentor


class FlowDataset:
    """Base dataset: index of (image pair, flow) paths + read/augment pipeline."""

    def __init__(self, aug_params=None, sparse=False, preload_data=False, repeat=1):
        self.augmentor = None
        self.sparse = sparse
        if aug_params is not None:
            if sparse:
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                self.augmentor = FlowAugmentor(**aug_params)

        self.is_test = False
        self.init_seed = False
        self.flow_list: List[str] = []
        self.image_list: List[List[str]] = []
        self.extra_info: List = []
        self.repeat = repeat
        self.preload_data = preload_data
        self._cache: Optional[List] = None

    # -- reading ------------------------------------------------------------

    def _read_raw(self, index):
        """Read (img1, img2, flow, valid_or_None) for a base (unreplicated) index."""
        if self._cache is not None:
            return self._cache[index]
        img1 = np.array(frame_utils.read_gen(self.image_list[index][0])).astype(np.uint8)
        img2 = np.array(frame_utils.read_gen(self.image_list[index][1])).astype(np.uint8)
        # a test split has no flow (the JAX package reads one there and fails)
        flow = valid = None
        if not self.is_test:
            if self.sparse:
                flow, valid = frame_utils.read_flow_kitti(self.flow_list[index])
            else:
                flow = frame_utils.read_gen(self.flow_list[index])
            flow = np.array(flow).astype(np.float32)

        # grayscale -> 3 channels (`core/datasets.py:128-133`)
        if len(img1.shape) == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]
        return img1, img2, flow, valid

    def preload_all(self):
        """Load every base sample into RAM up front (`core/datasets.py:40-83`)."""
        if self._cache is not None:
            return
        cache = []
        for i in range(len(self.image_list)):
            cache.append(self._read_raw(i))
        self._cache = cache

    def get_cache_info(self) -> Dict[str, float]:
        """Cache statistics (the reference's example doc referenced this but never
        implemented it — `example_memory_cache.py:54`; implemented here)."""
        if self._cache is None:
            return {"cached": 0, "total": len(self.image_list), "bytes": 0}
        nbytes = sum(
            sum(a.nbytes for a in sample if isinstance(a, np.ndarray))
            for sample in self._cache
        )
        return {"cached": len(self._cache), "total": len(self.image_list),
                "bytes": nbytes}

    def clear_cache(self):
        self._cache = None

    # -- indexing -----------------------------------------------------------

    def __getitem__(self, index, rng: Optional[np.random.Generator] = None):
        if self.is_test:
            img1, img2, *_ = self._read_raw(index % len(self.image_list))
            return (
                img1.astype(np.float32),
                img2.astype(np.float32),
                self.extra_info[index % len(self.image_list)],
            )

        rng = rng or np.random.default_rng()
        index = index % len(self.image_list)
        img1, img2, flow, valid = self._read_raw(index)
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)

        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow, valid, rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        flow = flow.astype(np.float32)
        if valid is not None:
            valid = valid.astype(np.float32)
        else:
            valid = (
                (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
            ).astype(np.float32)
        return img1, img2, flow, valid

    def __rmul__(self, v: int) -> "FlowDataset":
        out = CombinedDataset([self])
        out.multipliers = [v]
        return out

    def __add__(self, other) -> "FlowDataset":
        return CombinedDataset([self, other])

    def __len__(self):
        return len(self.image_list) * self.repeat


class CombinedDataset(FlowDataset):
    """Concatenation with per-dataset multipliers (replaces torch ConcatDataset)."""

    def __init__(self, datasets: Sequence[FlowDataset]):
        super().__init__()
        self.datasets = list(datasets)
        self.multipliers = [1] * len(self.datasets)

    def _spans(self):
        return [m * len(d) for d, m in zip(self.datasets, self.multipliers)]

    def __len__(self):
        return sum(self._spans())

    def __getitem__(self, index, rng=None):
        index = index % len(self)
        for d, span in zip(self.datasets, self._spans()):
            if index < span:
                return d.__getitem__(index % len(d), rng=rng)
            index -= span
        raise IndexError(index)

    def __add__(self, other):
        if isinstance(other, CombinedDataset):
            out = CombinedDataset(self.datasets + other.datasets)
            out.multipliers = self.multipliers + other.multipliers
        else:
            out = CombinedDataset(self.datasets + [other])
            out.multipliers = self.multipliers + [1]
        return out

    def __rmul__(self, v: int):
        out = CombinedDataset(self.datasets)
        out.multipliers = [v * m for m in self.multipliers]
        return out


class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training", root="datasets/Sintel",
                 dstype="clean", preload_data=False, repeat=5):
        super().__init__(aug_params, preload_data=preload_data, repeat=repeat)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        if split == "test":
            self.is_test = True
        for scene in sorted(os.listdir(image_root)):
            image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list += [[image_list[i], image_list[i + 1]]]
                self.extra_info += [(scene, i)]
            if split != "test":
                self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))
        if self.preload_data:
            self.preload_all()


SINTEL_VAL_SCENES = ("ambush_2", "bamboo_2", "cave_2", "market_2", "shaman_2",
                     "temple_2")


class MpiSintelVal(FlowDataset):
    """Fixed 6-scene validation split (`core/datasets.py:196-212`)."""

    def __init__(self, aug_params=None, split="training", root="datasets/Sintel",
                 dstype="clean", repeat=1):
        super().__init__(aug_params, repeat=repeat)
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        for scene in SINTEL_VAL_SCENES:
            image_list = sorted(glob(osp.join(image_root, scene, "*.png")))
            for i in range(len(image_list) - 1):
                self.image_list += [[image_list[i], image_list[i + 1]]]
                self.extra_info += [(scene, i)]
            self.flow_list += sorted(glob(osp.join(flow_root, scene, "*.flo")))


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, split="training",
                 root="datasets/FlyingChairs_release/data", split_file=None):
        super().__init__(aug_params)
        images = sorted(glob(osp.join(root, "*.ppm")))
        flows = sorted(glob(osp.join(root, "*.flo")))
        assert len(images) // 2 == len(flows)
        if split_file is None:
            split_file = osp.join(osp.dirname(root.rstrip("/")), "chairs_split.txt")
            if not osp.exists(split_file):
                split_file = "chairs_split.txt"
        split_list = np.loadtxt(split_file, dtype=np.int32)
        for i in range(len(flows)):
            xid = split_list[i]
            if (split == "training" and xid == 1) or (split == "validation" and xid == 2):
                self.flow_list += [flows[i]]
                self.image_list += [[images[2 * i], images[2 * i + 1]]]


class FlyingThings3D(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/FlyingThings3D",
                 dstype="frames_cleanpass"):
        super().__init__(aug_params)
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
                image_dirs = sorted([osp.join(f, cam) for f in image_dirs])
                flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted([osp.join(f, direction, cam) for f in flow_dirs])
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob(osp.join(idir, "*.png")))
                    flows = sorted(glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list += [[images[i], images[i + 1]]]
                            self.flow_list += [flows[i]]
                        else:
                            self.image_list += [[images[i + 1], images[i]]]
                            self.flow_list += [flows[i + 1]]


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training", root="datasets/KITTI"):
        super().__init__(aug_params, sparse=True)
        if split == "testing":
            self.is_test = True
        root = osp.join(root, split)
        images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
        for img1, img2 in zip(images1, images2):
            self.extra_info += [[img1.split("/")[-1]]]
            self.image_list += [[img1, img2]]
        if split == "training":
            self.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))


class HD1K(FlowDataset):
    def __init__(self, aug_params=None, root="datasets/HD1k"):
        super().__init__(aug_params, sparse=True)
        seq_ix = 0
        while True:
            flows = sorted(glob(osp.join(root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob(osp.join(root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if len(flows) == 0:
                break
            for i in range(len(flows) - 1):
                self.flow_list += [flows[i]]
                self.image_list += [[images[i], images[i + 1]]]
            seq_ix += 1


def fetch_dataset(stage: str, image_size: Tuple[int, int], roots: Optional[Dict[str, str]] = None):
    """Stage -> (dataset, aug ranges) exactly as `core/datasets.py:292-328`.

    roots: optional per-dataset root overrides
      {'chairs': ..., 'things': ..., 'sintel': ..., 'kitti': ..., 'hd1k': ...}.
    """
    roots = roots or {}
    if stage == "chairs":
        aug_params = {"crop_size": image_size, "min_scale": -0.1, "max_scale": 1.0,
                      "do_flip": True}
        kw = {"root": roots["chairs"]} if "chairs" in roots else {}
        return FlyingChairs(aug_params, split="training", **kw)
    if stage == "things":
        aug_params = {"crop_size": image_size, "min_scale": -0.4, "max_scale": 0.8,
                      "do_flip": True}
        kw = {"root": roots["things"]} if "things" in roots else {}
        clean = FlyingThings3D(aug_params, dstype="frames_cleanpass", **kw)
        final = FlyingThings3D(aug_params, dstype="frames_finalpass", **kw)
        return clean + final
    if stage == "sintel":
        aug_params = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.6,
                      "do_flip": True}
        kw = {"root": roots["sintel"]} if "sintel" in roots else {}
        clean = MpiSintel(aug_params, split="training", dstype="clean", **kw)
        final = MpiSintel(aug_params, split="training", dstype="final", **kw)
        return 100 * clean + 100 * final
    if stage == "kitti":
        aug_params = {"crop_size": image_size, "min_scale": -0.2, "max_scale": 0.4,
                      "do_flip": False}
        kw = {"root": roots["kitti"]} if "kitti" in roots else {}
        return KITTI(aug_params, split="training", **kw)
    raise ValueError(f"unknown stage {stage!r}")
