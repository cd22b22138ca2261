"""`utils/export.py` and the custom ops it exports K1 and K2 through, on the
CPU (where the ops run the kernels' plain versions).

  - RAFT-small (checkpoint) exported at 1x64x96 with 2 iterations, saved and
    loaded: the program holds 2 calls of each op, and its output equals the
    eager model's bit for bit;
  - (LiteFlowNet3's export: `test_torch_export_lfn3.py`);
  - the ops' fake implementations give the real shapes and dtypes (fp32 and
    bf16 volumes and outputs), and `torch.library.opcheck` passes.
"""

import collections
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps
from raft_optical_flow_tpu_torch.utils import export
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _op_calls(program):
    return collections.Counter(
        str(n.target) for m in program.graph_module.modules() for n in m.graph.nodes
        if n.op == "call_function" and "raft_port" in str(n.target))


def test_raft_small_export_round_trip_equals_eager(tmp_path):
    sd = load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    path = export.export_raft(sd, str(tmp_path / "raft.pt2"), small=True, iters=2, height=64,
                              width=96, device="cpu")
    program = export.load_exported(path)
    assert program.fp32
    assert _op_calls(program.program) == {"raft_port.corr_lookup_level.default": 2,
                                  "raft_port.corr_lookup_coarse_fused.default": 2}
    model = RAFT(RAFTConfig(small=True), device="cpu")
    model.load_state_dict(sd)
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    a = torch.from_numpy(g["image1"][:64, :96].copy())[None].float()
    b = torch.from_numpy(g["image2"][:64, :96].copy())[None].float()
    got = program(a, b)
    want = model(a, b, iters=2)[1]
    assert got.shape == (1, 64, 96, 2)
    assert torch.equal(got, want)


def _lookup_args(dtype, radius=3, B=2, h=6, w=8):
    f = torch.randn(B, h, w, 16, generator=torch.Generator().manual_seed(0))
    pyr = [c.to(dtype).contiguous() for c in build_corr_pyramid_from_fmaps(f, f.flip(1), 4)]
    coords = torch.rand(B, h * w, 2, generator=torch.Generator().manual_seed(1)) * 8 - 1
    return pyr, coords, radius


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_give_real_shapes_and_dtypes(dtype):
    pyr, coords, r = _lookup_args(dtype)
    real_l = torch.ops.raft_port.corr_lookup_level(pyr[0], coords, r, dtype)
    real_c = torch.ops.raft_port.corr_lookup_coarse_fused(pyr[1:], coords, r, dtype)
    assert torch.equal(real_l, ck.corr_lookup_level(pyr[0], coords, r, dtype))
    assert torch.equal(real_c, ck.corr_lookup_coarse_fused(pyr[1:], coords, r, dtype))
    with FakeTensorMode() as mode:
        fp = [mode.from_tensor(p) for p in pyr]
        fc = mode.from_tensor(coords)
        fake_l = torch.ops.raft_port.corr_lookup_level(fp[0], fc, r, dtype)
        fake_c = torch.ops.raft_port.corr_lookup_coarse_fused(fp[1:], fc, r, dtype)
    for fake, real in ((fake_l, real_l), (fake_c, real_c)):
        assert fake.shape == real.shape and fake.dtype == real.dtype == dtype
        assert fake.device == real.device


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_pass_opcheck(dtype):
    pyr, coords, r = _lookup_args(dtype)
    torch.library.opcheck(torch.ops.raft_port.corr_lookup_level.default,
                          (pyr[0], coords, r, dtype))
    torch.library.opcheck(torch.ops.raft_port.corr_lookup_coarse_fused.default,
                          (pyr[1:], coords, r, dtype))
