"""Model export: `torch.export` programs saved as `.pt2`.

Counterpart of `raft_optical_flow_tpu/utils/export.py` (StableHLO through
`jax.export`, the reference's ONNX-export role for LiteFlowNet3): a
serving forward traced once at fixed shapes into an `ExportedProgram`,
saved with `torch.export.save` and loaded by `load_exported`. The
defaults are the JAX package's: batch 1, RAFT at 440x1024 with 20
iterations in test mode, LiteFlowNet3 at 384x1024.

RAFT's lookup goes into the program as the custom ops
`raft_port::corr_lookup_level` (K1) and `raft_port::corr_lookup_coarse_fused`
(K2) of `kernels/corr_lookup.py`: on the card the exported program launches
K1 and K2 `iters` times each per call, on the CPU it runs their plain
versions. Importing this module registers the ops, so `load_exported` works
in a fresh process. No `torch.compile` and no C++ extension: the program
runs eagerly, op by op, as the model does.

The fp32 policy is global state, not a graph op: the models' forward turns
TF32 off for cuBLAS and cuDNN (`models/layers.py::fp32_policy`) on every
call, and `torch.export` puts the flags back as they were when it returns.
So an fp32 program records its policy in the `.pt2` (an extra file), and
`load_exported` returns a module that sets it before each call, as the
eager model does. (Run with TF32 on, the fp32 program drifts from eager by
TF32's roundings, amplified by RAFT's iterations: 121 px on noise frames
at 440x1024, 20 iterations, NVIDIA H100 80GB HBM3, 700.00 W.)
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

import raft_optical_flow_tpu_torch.kernels.corr_lookup  # noqa: F401  (registers the ops)
from raft_optical_flow_tpu_torch.models.layers import fp32_policy
from raft_optical_flow_tpu_torch.models.liteflownet3 import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig

_POLICY_FILE = "compute_dtype"


class _RaftServe(nn.Module):
    """RAFT's test-mode forward, flow_up only: (image1, image2) [N, H, W, 3]
    in [0, 255] -> [N, H, W, 2]."""

    def __init__(self, model: RAFT, iters: int):
        super().__init__()
        self.model, self.iters = model, iters

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        return self.model(image1, image2, iters=self.iters, test_mode=True)[1]


class _Lfn3Serve(nn.Module):
    """LiteFlowNet3's forward: images [N, 2, H, W, 3] in [0, 1] -> (flows,
    confs)."""

    def __init__(self, model: LiteFlowNet3):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor):
        out = self.model(images)
        return out["flows"], out["confs"]


class ExportedFlow(nn.Module):
    """A loaded program as a callable module: `forward(*args)` sets the fp32
    policy first when the program was exported under it, then runs
    `program.module()`. `program` is the `ExportedProgram`."""

    def __init__(self, program: torch.export.ExportedProgram, compute_dtype: str):
        super().__init__()
        self.program = program
        self.fp32 = compute_dtype == "float32"
        self.graph_module = program.module()

    def forward(self, *args):
        if self.fp32:
            fp32_policy()
        return self.graph_module(*args)


def export_program(module: nn.Module, example_args, path: str,
                   compute_dtype: torch.dtype = torch.float32) -> str:
    """`torch.export.export(module, example_args)` saved to `path` (.pt2),
    with the policy it runs under (`compute_dtype`) beside it."""
    program = torch.export.export(module, tuple(example_args), strict=False)
    torch.export.save(program, path, extra_files={_POLICY_FILE: str(compute_dtype)[6:]})
    return path


def load_exported(path: str) -> ExportedFlow:
    """An exported program back from `path`, as a module to call."""
    extra = {_POLICY_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return ExportedFlow(program, extra[_POLICY_FILE])


def export_raft(state_dict: Mapping[str, torch.Tensor], path: str, *, small: bool = False,
                iters: int = 20, height: int = 440, width: int = 1024, device="cuda",
                compute_dtype: torch.dtype = torch.float32) -> str:
    """Export RAFT's test-mode forward (flow_up) at batch 1, height x width,
    `iters` iterations, with the port's `state_dict` loaded (strict)."""
    model = RAFT(RAFTConfig(small=small, compute_dtype=compute_dtype), device=device)
    model.load_state_dict(state_dict)
    # two tensors: one passed twice would be traced as one input
    ex = [torch.zeros(1, height, width, 3, device=device) for _ in range(2)]
    return export_program(_RaftServe(model, iters), ex, path, compute_dtype)


def export_lfn3(state_dict: Mapping[str, torch.Tensor], path: str, *,
                use_s_version: bool = False, use_pseudo_regularization: bool = False,
                height: int = 384, width: int = 1024, device="cuda",
                compute_dtype: torch.dtype = torch.float32) -> str:
    """Export LiteFlowNet3's forward (flows, confs) at batch 1, height x width."""
    model = LiteFlowNet3(LFN3Config(use_s_version=use_s_version,
                                    use_pseudo_regularization=use_pseudo_regularization,
                                    compute_dtype=compute_dtype), device=device)
    model.load_state_dict(state_dict)
    ex = torch.zeros(1, 2, height, width, 3, device=device)
    return export_program(_Lfn3Serve(model), (ex,), path, compute_dtype)
