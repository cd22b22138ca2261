"""The port's UnFlow loss library (`losses/unflow.py`) and warp ops
(`ops/unflow_ops.py`) against the reference goldens and the JAX package's,
on the CPU.

  - Against `unflow_losses.npz` (the reference's torch implementation) at
    tests/test_unsup_losses.py's tolerances.
  - Against the jitted JAX functions in float64 on the same numpy inputs
    (one jit for the file): elementwise outputs within 1e-5 (of the output's largest
    magnitude where that is over 1), every loss term of `compute_losses`
    in its three `mask_occlusion` modes within rel 1e-5, their weighted
    sum's gradient with respect to both flows within max(2e-5, 2x its
    floor) of its largest (the floor: JAX against itself under a (1 +-
    1e-7) change of every flow value), and thresholded masks as a share of
    elements within 1e-5 of at least 0.999.
  - The splat (`forward_warp_op`) sums repeated targets, clamps the +1 taps
    into the image, and gives the same bits run after run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses import unflow as jun
from raft_optical_flow_tpu.ops import unflow_ops as juo
from raft_optical_flow_tpu_torch.losses import unflow as un
from raft_optical_flow_tpu_torch.ops import unflow_ops as uo
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MODES = {"none": "", "fb": "fb", "disocc": "disocc"}
TERM_WEIGHTS = {"photo": 1.0, "grad": 1.0, "smooth_1st": 3.0, "smooth_2nd": 3.0, "fb": 0.5,
                "ternary": 1.0, "occ": 0.1, "sym": 0.1}
MASKS = ("forward_warp_mask", "outgoing_mask", "occ_fw", "occ_bw", "occlusion_detection")


@pytest.fixture(scope="module")
def ng():
    return dict(np.load(os.path.join(GOLDENS, "unflow_losses.npz")))


def _outputs(lib, ops, g, differentiate):
    im1, im2, fw, bw = g["im1"], g["im2"], g["flow_fw"], g["flow_bw"]
    out = {"image_warp": lib.image_warp(im2, fw), "forward_warp": lib.forward_warp(fw),
           "backward_warp_op": ops.backward_warp_op(im2, fw),
           "occlusion_detection": ops.occlusion_detection(fw, bw),
           "outgoing_mask": lib.create_outgoing_mask(fw), "divergence": lib.divergence(fw),
           "charbonnier_truncated": lib.charbonnier_loss(fw, truncate=2.0),
           "ternary_2": lib.ternary_loss(im1, im2, lib.create_outgoing_mask(fw), max_distance=2)}
    out["forward_warp_mask"] = (out["forward_warp"] < lib.DISOCC_THRESH) * 1.0
    out["occ_fw"], out["occ_bw"] = lib.occlusion(fw, bw)
    for tag, mode in MODES.items():
        out.update({f"loss_{tag}_{k}": v for k, v in
                    lib.compute_losses(im1, im2, fw, bw, mask_occlusion=mode).items()})

    def weighted(f, b):
        losses = lib.compute_losses(im1, im2, f, b, mask_occlusion="fb")
        return sum(w * losses[k] for k, w in TERM_WEIGHTS.items())

    out["grad_fw"], out["grad_bw"] = differentiate(weighted, fw, bw)
    return out


def _jax_differentiate(fn, fw, bw):
    return jax.grad(fn, argnums=(0, 1))(fw, bw)


def _torch_differentiate(fn, fw, bw):
    fw, bw = fw.clone().requires_grad_(True), bw.clone().requires_grad_(True)
    return torch.autograd.grad(fn(fw, bw), (fw, bw))


@pytest.fixture(scope="module")
def jax_out(ng):
    """JAX's outputs in float64 (its fp32 sums of the Charbonnier terms read
    up to 1.3e-5 off their exact value here, the port's 1e-7), and each
    gradient's floor as "floor_grad_<fw|bw>"."""
    with jax.enable_x64(True):
        fn = jax.jit(lambda g: _outputs(jun, juo, g, _jax_differentiate))

        def run(g):
            x = {k: jnp.asarray(v, jnp.float64) for k, v in g.items()}
            return {k: np.asarray(v) for k, v in fn(x).items()}

        out = run(ng)
        signs = np.random.RandomState(1)
        nudged = run({k: v * (1 + 1e-7 * np.sign(signs.randn(*v.shape)))
                      if k.startswith("flow_") else v for k, v in ng.items()})
    for k in ("grad_fw", "grad_bw"):
        out[f"floor_{k}"] = np.abs(nudged[k] - out[k]).max() / np.abs(out[k]).max()
    return out


@pytest.fixture(scope="module")
def port_out(ng):
    out = _outputs(un, uo, {k: torch.from_numpy(v) for k, v in ng.items()}, _torch_differentiate)
    return {k: v.detach().numpy() for k, v in out.items()}


def test_every_output_matches_jax(jax_out, port_out):
    assert port_out.keys() | {"floor_grad_fw", "floor_grad_bw"} == jax_out.keys()
    for k, got in port_out.items():
        ref = jax_out[k]
        assert got.shape == ref.shape and got.dtype == np.float32, k
        if k.startswith("grad_"):
            gate = max(2e-5, 2 * float(jax_out[f"floor_{k}"]))
            assert np.abs(got - ref).max() <= gate * np.abs(ref).max(), (k, jax_out[f"floor_{k}"])
        elif ref.ndim == 0:
            assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)), k
        elif k in MASKS:
            assert np.mean(np.abs(got - ref) <= 1e-5) >= 0.999, k
        else:
            scale = max(1.0, float(np.abs(ref).max()))
            assert np.abs(got - ref).max() <= 1e-5 * scale, (k, float(np.abs(got - ref).max()))


def test_warps_match_goldens(ng):
    w = un.image_warp(torch.from_numpy(ng["im2"]), torch.from_numpy(ng["flow_fw"]))
    np.testing.assert_allclose(w.numpy(), ng["image_warp"], atol=1e-5)
    fw = un.forward_warp(torch.from_numpy(ng["flow_fw"]))
    np.testing.assert_allclose(fw.numpy(), ng["forward_warp"], atol=1e-4)
    m = uo.occlusion_detection(torch.from_numpy(ng["flow_fw"]), torch.from_numpy(ng["flow_bw"]))
    np.testing.assert_allclose(m.numpy(), ng["occ_det"], atol=1e-4)


@pytest.mark.parametrize("tag", sorted(MODES))
def test_compute_losses_match_goldens(ng, tag):
    t = {k: torch.from_numpy(ng[k]) for k in ("im1", "im2", "flow_fw", "flow_bw")}
    losses = un.compute_losses(t["im1"], t["im2"], t["flow_fw"], t["flow_bw"],
                               mask_occlusion=MODES[tag])
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(ng[f"loss_{tag}_{k}"]), rtol=2e-3,
                                   err_msg=f"{tag}/{k}")


def test_splat_sums_repeats_clamps_and_repeats_bit_for_bit():
    """Every pixel of a 3x4 image moved onto (1.5, 0.25): 12 points x the
    weights (1 - 0.5)(1 - 0.25) etc. at the four taps; in a 1x2 image a
    point moved to x = 1.5 puts all four taps on column 1 (the +1 taps
    clamped, y's too), one moved to x = 2 is out."""
    H, W = 3, 4
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    flow = torch.stack([1.5 - gx, 0.25 - gy], dim=-1)[None]
    d = uo.forward_warp_op(flow)[0, ..., 0]
    want = torch.zeros(H, W)
    want[0, 1] = want[0, 2] = 12 * 0.5 * 0.75
    want[1, 1] = want[1, 2] = 12 * 0.5 * 0.25
    assert torch.equal(d, want)
    edge = torch.zeros(1, 1, 2, 2)  # a 1x2 image: x = 1.5 is inside, x = 2 is not
    edge[0, 0, 0, 0], edge[0, 0, 1, 0] = 1.5, 1.0
    assert uo.forward_warp_op(edge)[0, 0, :, 0].tolist() == [0.0, 1.0]
    rng = np.random.RandomState(0)
    big = torch.from_numpy(rng.uniform(-6, 6, (2, 40, 56, 2)).astype(np.float32))
    assert torch.equal(uo.forward_warp_op(big), uo.forward_warp_op(big))
