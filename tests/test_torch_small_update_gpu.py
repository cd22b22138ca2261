"""K9 (`kernels/small_update.py`) on the card: RAFT-small's update-block
convolutions against their plain version, against float64, and inside the
model.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture, so every worker collects the same tests). The file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_small_update_gpu.py

- Each convolution against the plain version, which multiplies as the kernel
  does (three TF32 passes, fp32 sums) in another sum order: max|d| within
  2e-5 of max|ref|, at a small shape with odd H and W.
- The precision gate, at the serving shape of the benchmark's RAFT-small
  cell (batch 16, 55 x 128, the GRU's 242 input channels): K9's largest
  error against a float64 convolution is at most twice cuDNN's fp32
  convolution's (TF32 off), and a one-pass TF32 product (K9 fed operands
  rounded to TF32, so that their lo parts are 0) fails that same gate.
- A RAFT-small forward through K9 against the module path on the reference
  frames and checkpoint: mean end-point error of flow_up at most 1e-4 px.
- With a gradient recorded (a training forward), K9 launches nothing; a
  serving forward launches it 8 times an iteration.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.kernels import small_update as su
from raft_optical_flow_tpu_torch.models.layers import fp32_policy
from raft_optical_flow_tpu_torch.models.update import SmallUpdateBlock

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fp32_policy()
    return torch.device("cuda")


def _case(device, B, H, W, seed):
    torch.manual_seed(seed)
    blk = SmallUpdateBlock(196, 96, 64).to(device).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    net = torch.tanh(torch.randn(B, 96, H, W, device=device, generator=g))
    inp = torch.relu(torch.randn(B, 64, H, W, device=device, generator=g))
    corr = torch.randn(B, H, W, 196, device=device, generator=g).permute(0, 3, 1, 2)
    flow = (4 * torch.randn(B, H, W, 2, device=device, generator=g)).permute(0, 3, 1, 2)
    return blk, net, inp, corr, flow


def _rel(a, ref):
    return float((a.double() - ref.double()).abs().max() / ref.double().abs().max())


def test_each_convolution_matches_plain(cuda):
    blk, net, inp, corr, flow = _case(cuda, 2, 13, 21, seed=0)
    p = su.block_params(blk)
    with torch.no_grad():
        cor = su.conv([corr], p["convc1"], "bias_relu")
        flo1 = su.conv([flow], p["convf1"], "bias_relu")
        flo = su.conv([flo1], p["convf2"], "bias_relu")
        out = su.conv([cor, flo], p["conv"], "bias_relu")
        z, rh = su.conv([net, inp, out, flow], p["gru_zr"], "gru_zr", h=net)
        h = su.conv([rh, inp, out, flow], p["gru_q"], "gru_q", h=net, z=z)
        fh = su.conv([h], p["head1"], "bias_relu")
        cases = {"convc1": ([corr], "bias_relu", {}), "convf1": ([flow], "bias_relu", {}),
                 "convf2": ([flo1], "bias_relu", {}), "conv": ([cor, flo], "bias_relu", {}),
                 "gru_zr": ([net, inp, out, flow], "gru_zr", {"h": net}),
                 "gru_q": ([rh, inp, out, flow], "gru_q", {"h": net, "z": z}),
                 "head1": ([h], "bias_relu", {}), "head2": ([fh], "bias", {})}
        for name, (segs, epilogue, kw) in cases.items():
            got = su.conv(segs, p[name], epilogue, **kw)
            want = su.conv_plain(segs, p[name], epilogue, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.isfinite(a).all(), name
                assert _rel(a, b) <= 2e-5, (name, _rel(a, b))


def test_precision_gate_separates_fp32_from_tf32(cuda):
    blk, net, inp, corr, flow = _case(cuda, 16, 55, 128, seed=1)
    p = su.block_params(blk)
    gru = blk.gru
    with torch.no_grad():
        out = torch.relu(blk.encoder(flow, corr)[:, :80])
        segs = [net, inp, out.contiguous(memory_format=torch.channels_last), flow]
        x = torch.cat(segs, 1)
        w = torch.cat([gru.convz.weight, gru.convr.weight])
        b = torch.cat([gru.convz.bias, gru.convr.bias])
        ref = F.conv2d(x.double(), w.double(), b.double(), padding=1)
        k9 = su.conv(segs, p["gru_zr"], "bias")  # z|r before the gates
        cudnn = F.conv2d(x, w, b, padding=1)  # fp32_policy: TF32 off
        hi = lambda t: su._split_tf32(t.contiguous())[0]  # noqa: E731
        tf32 = su.conv([hi(s) for s in segs],
                       su.ConvWeights.of(hi(w), b, p["gru_zr"].segments), "bias")
        torch.cuda.synchronize()
    gate = 2 * _rel(cudnn, ref)
    assert _rel(k9, ref) <= gate, (_rel(k9, ref), gate)
    assert _rel(tf32, ref) > gate, (_rel(tf32, ref), gate)


def _raft_small(device):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    model = RAFT(RAFTConfig(small=True), device=device)
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    img1 = torch.from_numpy(g["image1"]).float()[None].to(device)
    img2 = torch.from_numpy(g["image2"]).float()[None].to(device)
    return model, img1, img2, int(g["iters"])


def test_raft_small_forward_agrees_with_module_path(cuda, monkeypatch):
    model, img1, img2, iters = _raft_small(cuda)
    su.reset_launches()
    _, up_k9 = model(img1, img2, iters=iters)
    assert su.LAUNCHES["small_update_conv"] == 8 * iters
    monkeypatch.setattr(su, "declines", lambda *a: "module path")
    _, up_mod = model(img1, img2, iters=iters)
    assert su.LAUNCHES["small_update_conv"] == 8 * iters
    epe = torch.linalg.vector_norm(up_k9 - up_mod, dim=-1)
    assert float(epe.mean()) <= 1e-4, float(epe.mean())


def test_recorded_gradient_launches_no_k9(cuda):
    model, img1, img2, _ = _raft_small(cuda)
    su.reset_launches()
    preds = model(img1, img2, iters=2, test_mode=False)
    preds[-1].abs().mean().backward()
    torch.cuda.synchronize()
    assert su.LAUNCHES["small_update_conv"] == 0
    with torch.no_grad():
        model(img1, img2, iters=2)
    assert su.LAUNCHES["small_update_conv"] == 16
