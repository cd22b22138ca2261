"""Stage-curriculum training configs.

Counterpart of `raft_optical_flow_tpu/train/configs.py`: the reference RAFT's
chairs -> things -> sintel -> kitti schedules (`train_standard.sh`,
`train_mixed.sh`) with their per-stage lr, batch, crop and gamma.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StageConfig:
    name: str
    stage: str  # dataset stage: chairs | things | sintel | kitti
    num_steps: int
    batch_size: int
    lr: float
    image_size: Tuple[int, int]
    wdecay: float = 1e-4
    gamma: float = 0.8
    iters: int = 12
    clip: float = 1.0
    epsilon: float = 1e-8
    small: bool = False
    mixed_precision: bool = False
    add_noise: bool = False
    freeze_bn: bool = True  # the reference freezes BN on every stage except chairs
    val_freq: int = 5000
    restore_from: Optional[str] = None
    seed: int = 1234


# train_standard.sh
STANDARD_CURRICULUM = (
    StageConfig(
        name="raft-chairs", stage="chairs", num_steps=100_000, batch_size=10,
        lr=4e-4, image_size=(368, 496), wdecay=1e-4, freeze_bn=False,
    ),
    StageConfig(
        name="raft-things", stage="things", num_steps=100_000, batch_size=6,
        lr=1.25e-4, image_size=(400, 720), wdecay=1e-4, restore_from="raft-chairs",
    ),
    StageConfig(
        name="raft-sintel", stage="sintel", num_steps=100_000, batch_size=6,
        lr=1.25e-4, image_size=(368, 768), wdecay=1e-5, gamma=0.85,
        restore_from="raft-things",
    ),
    StageConfig(
        name="raft-kitti", stage="kitti", num_steps=50_000, batch_size=6,
        lr=1e-4, image_size=(288, 960), wdecay=1e-5, gamma=0.85,
        restore_from="raft-sintel",
    ),
)

# train_mixed.sh: one card, the bf16 policy
MIXED_CURRICULUM = tuple(
    dataclasses.replace(
        s,
        name=s.name + "-mixed",
        num_steps=(120_000 if s.stage != "kitti" else 50_000),
        batch_size=(8 if s.stage == "chairs" else 5),
        mixed_precision=True,
        restore_from=(s.restore_from + "-mixed" if s.restore_from else None),
    )
    for s in STANDARD_CURRICULUM
)
