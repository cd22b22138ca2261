"""The yardstick's counts: model FLOPs against torch's FlopCounterMode on the
reference, and the lookup kernels' bytes against the figures PERF.md §6
gives at their shapes (K1 39.11, K2 101.11, K3 67.01 MB)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flowbench import bytes as fbytes
from flowbench import flops
from flowbench.reference.raft import Arch, PlainRAFT
from flowbench.weights import make_weights


@pytest.mark.parametrize("small", [False, True])
def test_forward_flops_match_the_counter(small):
    """The reference's forward computes the mask head every iteration, so the
    counter sees forward_flops with mask_iters = iters; FlopCounterMode counts
    the same convs and products (the lookup's gathers and the upsampling are
    not products). Margin: 0.1%."""
    arch = Arch(small)
    w = make_weights(arch, 3, "cpu")
    i1 = torch.rand(1, 64, 96, 3) * 255
    with FlopCounterMode(display=False) as fc:
        PlainRAFT(arch, "fp32").forward(w, i1, i1, 3, test_mode=True)
    want = flops.forward_flops(arch, 1, 64, 96, 3, mask_iters=3)
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-3)


def test_flop_counts_at_the_cells():
    std, small = Arch(False), Arch(True)
    assert flops.serve_flops(std, 16, 440, 1024, 32) == pytest.approx(22.87e12, rel=1e-3)
    assert flops.serve_flops(small, 16, 440, 1024, 32) == pytest.approx(6.717e12, rel=1e-3)
    assert flops.train_flops(std, 5, 400, 720, 12) == pytest.approx(7.019e12, rel=1e-3)


def _uniform_coords(B, h, w, seed, max_disp=8.0):
    g = torch.Generator().manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    d = (torch.rand(B, h, w, 2, generator=g) * 2 - 1) * max_disp
    return (torch.stack([xs, ys], -1)[None] + d).reshape(B, h * w, 2)


@pytest.mark.parametrize("seed", [21, 22])
def test_lookup_bytes_at_the_serving_shape(seed):
    """K1 and K2 at batch 16, 1024x440 (levels 55x128 ... 6x16), bf16, radius
    4, on coordinates displaced uniformly by up to 8 px, as PERF.md's were
    (those were drawn on the card; the in-bounds count of another draw of
    the same distribution differs by under 0.03 MB)."""
    c = _uniform_coords(16, 55, 128, seed)
    levels = fbytes.level_shapes(55, 128, 4)
    assert levels == [(55, 128), (27, 64), (13, 32), (6, 16)]
    assert fbytes.k1_bytes(c, 0, levels[0], 4, 2, 2) / 1e6 == pytest.approx(39.11, abs=0.03)
    assert fbytes.k2_bytes(c, levels[1:], 4, 2, 2) / 1e6 == pytest.approx(101.11, abs=0.05)


def test_k3_bytes_at_the_training_shape():
    """K3 at batch 4, 368x496 (level 0 46x62), bf16: the dense gradient
    written once, the cotangent and the coordinates read once."""
    assert fbytes.k3_bytes(4 * 46 * 62, (46, 62), 4, 2, 2) / 1e6 == pytest.approx(67.01, abs=0.005)


def test_bounds_from_flows():
    """A zero flow puts every window at the grid: the bound is the bytes at
    HBM rate, summed over iterations and launches."""
    f = torch.zeros(2, 2, 10, 12)
    b1 = fbytes.serve_bound_s([f], 4, 4, 2)
    assert fbytes.serve_bound_s([f, f], 4, 4, 2) == pytest.approx(2 * b1)
    c = fbytes.coords_from_flow(f)
    shapes = fbytes.level_shapes(10, 12, 4)
    want = (fbytes.k1_bytes(c, 0, shapes[0], 4, 2, 2) + fbytes.k2_bytes(c, shapes[1:], 4, 2, 2))
    assert b1 == pytest.approx(want / 3.35e12)
    assert fbytes.train_bound_s([f], 4, 4, 2) > b1
