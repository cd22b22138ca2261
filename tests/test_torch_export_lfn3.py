"""LiteFlowNet3 through `utils/export.py` on the CPU: the goldens' params,
exported at 48x64 (`torch.export`, as `export_lfn3` traces it), flows and
confs equal to the eager model's bit for bit. (The trace of LiteFlowNet3
takes about 20 s, so it has a file of its own.)"""

import os

import torch

from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.utils import export
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_lfn3_export_equals_eager():
    sd = load_flax_npz(os.path.join(REPO, "tests", "goldens", "lfn3_standard_params.npz"))
    model = LiteFlowNet3(LFN3Config(), device="cpu")
    model.load_state_dict(sd)
    ex = torch.zeros(1, 2, 48, 64, 3)
    program = torch.export.export(export._Lfn3Serve(model), (ex,), strict=False)
    images = torch.rand(1, 2, 48, 64, 3, generator=torch.Generator().manual_seed(1))
    flows, confs = program.module()(images)
    want = model(images)
    assert torch.equal(flows, want["flows"]) and torch.equal(confs, want["confs"])
