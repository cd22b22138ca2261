"""Miniature dataset trees on disk for the port's data-layer tests.

Each writer lays out the directory structure that the dataset class of
`data/datasets.py` (the JAX package's and the port's) indexes, with seeded
noise frames and flows: FlyingChairs (`.ppm` + `.flo` and
`chairs_split.txt`), FlyingThings3D (`.png` frames, 3-channel `.pfm`
flows), KITTI and HD1K (8-bit RGB frames and 16-bit flow PNGs, about half
the pixels valid). Sintel comes from `test_data_layer._make_mini_sintel`.
Files are written with the port's writers; the tests read them with both
packages.
"""

import os

import numpy as np

from raft_optical_flow_tpu_torch.data import frame_utils as fu


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "raft_small.npz")


def real_frames(n, hw):
    """n real uint8 frames [*hw, 3]: crops of the RAFT-small golden's 192x320
    pair, frame i from image i % 2 shifted by (2i, 3i) px. RAFT on noise
    frames is ill-conditioned (the JAX package against itself with its
    weights x (1 + 1e-7) moves flows by up to 2e-3 at 64x96), so model
    comparisons run on these."""
    g = np.load(GOLDEN)
    pair = (g["image1"], g["image2"])
    return [np.asarray(pair[i % 2][2 * i: 2 * i + hw[0], 3 * i: 3 * i + hw[1]]).astype(np.uint8)
            for i in range(n)]


def put_real_frames(sintel_root, scene, dstype="clean"):
    """Overwrite a Sintel scene's frames with `real_frames` of their size."""
    d = os.path.join(sintel_root, "training", dstype, scene)
    names = sorted(os.listdir(d))
    first = fu.read_png(os.path.join(d, names[0]))
    for name, img in zip(names, real_frames(len(names), first.shape[:2])):
        fu.write_png(os.path.join(d, name), img)


def _frame(rng, hw):
    return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)


def make_chairs(root, n=6, hw=(96, 128), split=(1, 1, 2, 1, 2, 1)):
    """`<root>/FlyingChairs_release/data/NNNNN_img{1,2}.ppm, NNNNN_flow.flo`
    and `<root>/FlyingChairs_release/chairs_split.txt`; returns the data dir."""
    rng = np.random.RandomState(11)
    data = os.path.join(root, "FlyingChairs_release", "data")
    os.makedirs(data, exist_ok=True)
    for i in range(n):
        fu.write_ppm(os.path.join(data, f"{i:05d}_img1.ppm"), _frame(rng, hw))
        fu.write_ppm(os.path.join(data, f"{i:05d}_img2.ppm"), _frame(rng, hw))
        fu.write_flow(os.path.join(data, f"{i:05d}_flow.flo"),
                      rng.uniform(-6, 6, (*hw, 2)).astype(np.float32))
    np.savetxt(os.path.join(root, "FlyingChairs_release", "chairs_split.txt"),
               np.array(split[:n]), fmt="%d")
    return data


def write_pfm(path, data):
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(b"%d %d\n-1.0\n" % (w, h))
        f.write(np.flipud(data).astype("<f4").tobytes())


def make_things(root, scenes=("A/0000", "B/0001"), frames=3, hw=(72, 96)):
    """FlyingThings3D: frames_{clean,final}pass/TRAIN/<scene>/left/*.png and
    optical_flow/TRAIN/<scene>/into_{future,past}/left/*.pfm."""
    rng = np.random.RandomState(12)
    for scene in scenes:
        for dstype in ("frames_cleanpass", "frames_finalpass"):
            d = os.path.join(root, dstype, "TRAIN", scene, "left")
            os.makedirs(d, exist_ok=True)
            for i in range(frames):
                fu.write_png(os.path.join(d, f"{i:04d}.png"), _frame(rng, hw))
        for direction in ("into_future", "into_past"):
            d = os.path.join(root, "optical_flow", "TRAIN", scene, direction, "left")
            os.makedirs(d, exist_ok=True)
            for i in range(frames):
                write_pfm(os.path.join(d, f"OpticalFlowInto_{i:04d}_L.pfm"),
                          rng.uniform(-5, 5, (*hw, 3)).astype(np.float32))
    return root


def _sparse_flow(rng, hw):
    flow = rng.uniform(-20, 20, (*hw, 2))
    flow = np.round(flow * 64) / 64  # on KITTI's 1/64 px grid
    valid = (rng.uniform(0, 1, hw) > 0.5).astype(np.float64)
    return flow, valid


def make_kitti(root, sizes=((40, 100), (38, 96), (44, 104))):
    """KITTI: training/image_2/NNNNNN_1{0,1}.png and flow_occ/NNNNNN_10.png
    (16-bit, about half the pixels valid), testing/image_2 the same frames."""
    rng = np.random.RandomState(13)
    for split in ("training", "testing"):
        os.makedirs(os.path.join(root, split, "image_2"), exist_ok=True)
    os.makedirs(os.path.join(root, "training", "flow_occ"), exist_ok=True)
    for i, hw in enumerate(sizes):
        for t in (10, 11):
            img = _frame(rng, hw)
            for split in ("training", "testing"):
                fu.write_png(os.path.join(root, split, "image_2", f"{i:06d}_{t}.png"), img)
        flow, valid = _sparse_flow(rng, hw)
        fu.write_flow_kitti(os.path.join(root, "training", "flow_occ", f"{i:06d}_10.png"),
                            flow, valid)
    return root


def make_hd1k(root, seqs=2, frames=3, hw=(48, 80)):
    """HD1K: hd1k_input/image_2/SSSSSS_FFFF.png, hd1k_flow_gt/flow_occ/SSSSSS_FFFF.png."""
    rng = np.random.RandomState(14)
    for sub in (("hd1k_input", "image_2"), ("hd1k_flow_gt", "flow_occ")):
        os.makedirs(os.path.join(root, *sub), exist_ok=True)
    for s in range(seqs):
        for f in range(frames):
            fu.write_png(os.path.join(root, "hd1k_input", "image_2", f"{s:06d}_{f:04d}.png"),
                         _frame(rng, hw))
            flow, valid = _sparse_flow(rng, hw)
            fu.write_flow_kitti(
                os.path.join(root, "hd1k_flow_gt", "flow_occ", f"{s:06d}_{f:04d}.png"),
                flow, valid)
    return root
