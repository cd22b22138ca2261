"""The data layer: codecs (no PIL or cv2), augmentors, dataset index
builders, synthetic warped pairs and the batch loader."""

from raft_optical_flow_tpu_torch.data.frame_utils import (
    read_disp_kitti,
    read_flow,
    read_flow_kitti,
    read_gen,
    read_pfm,
    write_flow,
    write_flow_kitti,
)

__all__ = [
    "read_flow",
    "write_flow",
    "read_pfm",
    "read_flow_kitti",
    "write_flow_kitti",
    "read_disp_kitti",
    "read_gen",
]
