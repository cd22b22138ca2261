"""The data layer: codecs (no PIL or cv2; JPEG and PNG decoded natively),
augmentors, dataset indexes, synthetic warped pairs and the batch
loaders (threads: `pipeline.py`; worker processes: `grain_pipeline.py`)."""

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
