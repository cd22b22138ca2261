"""The port's UFlow loss library (`losses/uflow.py`) against the reference
goldens and the JAX package's, on the CPU.

  - Against `uflow_losses.npz` and `uflow_supervised.npz` (the reference's
    torch implementation) at tests/test_unsup_losses.py's tolerances.
  - Against the jitted JAX functions on the same numpy inputs (one jit for
    the file): elementwise outputs within 1e-5 (of the output's largest
    magnitude where that is over 1: the squared flows), losses within rel 1e-5,
    the gradient of the full loss (photometric, both smoothness orders,
    SSIM, census and self-supervision, the wang masks) with respect to every
    flow within max(2e-5, 2x its floor) of its largest, the floor JAX against
    itself under a (1 +- 1e-7) change of every flow value (ROADMAP.md's rule
    for gradient comparisons: robust_l1's slope near a zero residual and
    census's x255 intensities amplify rounding), and thresholded masks as a
    share of elements within 1e-5 of at least 0.999 (a mask flips on a
    one-ulp difference).
  - `random_crop` and `random_shift` against slices and rolls at the offsets
    they return.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses import uflow as juf
from raft_optical_flow_tpu_torch.losses import uflow as uf
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ESTIMATORS = ("none", "brox", "fb_abs", "wang", "wang4", "wangthres", "wang4thres", "uflow")
# masks that jump at a threshold (uflow's is a sigmoid of 1000x its scores)
THRESHOLDED = ("brox", "fb_abs", "wangthres", "wang4thres", "uflow")
UFLOW_OCC = dict(occ_weights={"fb_abs": 1000.0, "forward_collision": 1000.0, "backward_zero": 1000.0},
                 occ_thresholds={"fb_abs": 1.5, "forward_collision": 0.4, "backward_zero": 0.25},
                 occ_clip_max={"fb_abs": 10.0, "forward_collision": 5.0})
WEIGHTS = {"photo": 1.0, "smooth1": 2.0, "smooth2": 4.0, "ssim": 0.5, "census": 1.0,
           "selfsup": 0.3, "edge_constant": 150.0}
CROP = 4


@pytest.fixture(scope="module")
def ug():
    return dict(np.load(os.path.join(GOLDENS, "uflow_losses.npz")))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flows(lib, fw, bw):
    """The six keys of a self-supervised step: the student pyramids, the
    teacher (the same flows, stopped) and the cropped student views (0.9x
    the teacher's flow cropped, so the two differ)."""
    stop = jax.lax.stop_gradient if lib is juf else (lambda x: x.detach())
    crops = lib.selfsup_crop_transforms(CROP, CROP)
    flows = {}
    for (i, j), pyr in (((0, 1), fw), ((1, 0), bw)):
        flows[(i, j, "augmented-student")] = pyr
        flows[(i, j, "original-teacher")] = [stop(x) for x in pyr]
        flows[(i, j, "transformed-student")] = [crops[lv](0.9 * x) for lv, x in enumerate(pyr)]
    return flows


def _full_loss(lib, images, fw, bw):
    flows = _flows(lib, fw, bw)
    warps, valid, _, occ, fb_sq, fb_sum = lib.compute_warps_and_occlusion(flows, "wang")
    aug = {k: v for k, v in warps.items() if k[2] == "augmented-student"}
    warped = lib.apply_warps_stop_grad(images, aug, level=0)
    return lib.compute_loss(WEIGHTS, images, flows, warps, valid, occ, fb_sq, fb_sum, warped,
                            selfsup_transform_fns=lib.selfsup_crop_transforms(CROP, CROP))


def _outputs(lib, g, differentiate):
    """Every function's outputs on the golden's inputs, as a flat dict."""
    im0, im1 = g["im0"], g["im1"]
    fw = [g[f"flow_fw_{i}"] for i in range(3)]
    bw = [g[f"flow_bw_{i}"] for i in range(3)]
    out = {}
    warp = lib.flow_to_warp(fw[0])
    out["warp"], out["resample"], out["mask_invalid"] = warp, lib.resample(im1, warp), lib.mask_invalid(warp)
    for df, bias, rsz in ((1, False, False), (1, True, True), (4, True, True), (4, False, False),
                          (2, True, False)):
        out[f"range_map_{df}_{bias}_{rsz}"] = lib.compute_range_map(bw[0], df, bias, rsz)
    flows = {(0, 1, "a"): fw, (1, 0, "a"): bw}
    for est in ESTIMATORS:
        kw = UFLOW_OCC if est == "uflow" else {}
        _, valid, _, occ, fb_sq, fb_sum = lib.compute_warps_and_occlusion(flows, est, **kw)
        out[f"occ_{est}"] = occ[(0, 1, "a")][0]
    for lv in range(3):
        out[f"fb_sq_diff_{lv}"], out[f"fb_sum_sq_{lv}"] = fb_sq[(1, 0, "a")][lv], fb_sum[(1, 0, "a")][lv]
        out[f"valid_{lv}"] = valid[(1, 0, "a")][lv]
    out["upsample"], out["downsample"] = lib.upsample(fw[1], True), lib.downsample(im0, False)
    out["resize_flow"] = lib.resize(fw[0], 20, 30, is_flow=True)
    out["resize_sparse"], out["resize_sparse_mask"] = lib.resize(fw[0], 16, 24, True, mask=g["mask"])
    # grey levels k / 256: the channel mean and its x255 are exact in both
    # (else they round apart by an ulp of 255, 3e-5 in the transform)
    grey = (im0[..., :1] * 256.0).round() / 256.0
    out["census_transform"] = lib.census_transform(grey + 0.0 * im0, 7)
    out["census_loss"] = lib.census_loss(im0, im1, g["mask"])
    out["ssim_err"], out["ssim_avgw"] = lib.weighted_ssim(im0, im1, g["mask"][..., 0])
    out["ddflow"], out["robust_l1"] = lib.abs_robust_loss(fw[0]), lib.robust_l1(fw[0])
    out["supervised"] = lib.supervised_loss({"supervision": 1.0}, fw[0], g["mask"],
                                            {(0, 1, "augmented"): [fw[1]]})["supervision"]
    losses = differentiate(
        lambda *f: _full_loss(lib, {0: im0, 1: im1}, list(f[:3]), list(f[3:])), fw + bw)
    out.update({k if k.startswith("grad_") else f"loss_{k}": v for k, v in losses.items()})
    return out


def _jax_differentiate(fn, flows):
    losses, vjp = jax.vjp(fn, *flows)
    grads = vjp({k: jnp.ones_like(v) if k == "total" else jnp.zeros_like(v) for k, v in losses.items()})
    return dict(losses, **{f"grad_{i}": g for i, g in enumerate(grads)})


def _torch_differentiate(fn, flows):
    flows = [f.detach().requires_grad_(True) for f in flows]
    losses = fn(*flows)
    grads = torch.autograd.grad(losses["total"], flows, allow_unused=True)
    return dict({k: v.detach() for k, v in losses.items()},
                **{f"grad_{i}": torch.zeros_like(f) if g is None else g
                   for i, (f, g) in enumerate(zip(flows, grads))})


@pytest.fixture(scope="module")
def jax_out(ug):
    """JAX's outputs, and each gradient's floor: JAX against itself with
    every flow value changed by (1 +- 1e-7) (ROADMAP.md's rule for gradient
    comparisons), as "floor_grad_<i>"."""
    fn = jax.jit(lambda g: _outputs(juf, g, _jax_differentiate))

    def run(g):
        return {k: np.asarray(v) for k, v in fn({k: jnp.asarray(v) for k, v in g.items()}).items()}

    out = run(ug)
    signs = np.random.RandomState(1)
    nudged = run({k: v * (1 + 1e-7 * np.sign(signs.randn(*v.shape))).astype(np.float32)
                  if k.startswith("flow_") else v for k, v in ug.items()})
    for k in [k for k in out if k.startswith("grad_")]:
        out[f"floor_{k}"] = np.abs(nudged[k] - out[k]).max() / max(np.abs(out[k]).max(), 1e-30)
    return out


@pytest.fixture(scope="module")
def port_out(ug):
    return {k: v.numpy() for k, v in _outputs(uf, {k: _t(v) for k, v in ug.items()},
                                             _torch_differentiate).items()}


def test_every_output_matches_jax(jax_out, port_out):
    assert {f"floor_{k}" for k in port_out if k.startswith("grad_")} | port_out.keys() == jax_out.keys()
    for k, got in port_out.items():
        ref = jax_out[k]
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        if k.startswith("grad_"):
            gate = max(2e-5, 2 * float(jax_out[f"floor_{k}"]))
            assert np.abs(got - ref).max() <= gate * np.abs(ref).max(), (k, jax_out[f"floor_{k}"])
        elif k.startswith("loss_") or ref.ndim == 0:
            assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)), k
        elif k.removeprefix("occ_") in THRESHOLDED or k.startswith(("valid_", "mask_", "resize_sparse_mask")):
            assert np.mean(np.abs(got - ref) <= 1e-5) >= 0.999, k
        else:
            scale = max(1.0, float(np.abs(ref).max()))
            assert np.abs(got - ref).max() <= 1e-5 * scale, (k, float(np.abs(got - ref).max()))


def test_the_selfsup_term_and_its_gradient_are_live(jax_out):
    assert jax_out["loss_selfsup"] > 0
    for i in (0, 2, 3, 5):  # level 1 takes no loss term, only the fb statistics
        assert np.abs(jax_out[f"grad_{i}"]).max() > 0


def test_ops_match_goldens(ug):
    warp = uf.flow_to_warp(_t(ug["flow_fw_0"]))
    np.testing.assert_allclose(warp.numpy(), ug["warp"], atol=1e-5)
    np.testing.assert_allclose(uf.resample(_t(ug["im1"]), warp).numpy(), ug["resampled"], atol=1e-5)
    np.testing.assert_allclose(uf.mask_invalid(warp).numpy(), ug["mask_invalid"], atol=1e-6)
    rm1 = uf.compute_range_map(_t(ug["flow_fw_0"]), 1)
    np.testing.assert_allclose(rm1.numpy(), ug["range_map_1"], atol=1e-4)
    rm4 = uf.compute_range_map(_t(ug["flow_fw_0"]), 4, True, True)
    np.testing.assert_allclose(rm4.numpy(), ug["range_map_4"], atol=1e-4)


@pytest.mark.parametrize("est", ["brox", "wang", "wang4thres", "fb_abs", "uflow"])
def test_occlusion_estimators_match_goldens(ug, est):
    flows = {(0, 1, "augmented-student"): [_t(ug[f"flow_fw_{i}"]) for i in range(3)],
             (1, 0, "augmented-student"): [_t(ug[f"flow_bw_{i}"]) for i in range(3)]}
    kw = UFLOW_OCC if est == "uflow" else {}
    occ = uf.compute_warps_and_occlusion(flows, est, **kw)[3]
    np.testing.assert_allclose(occ[(0, 1, "augmented-student")][0].numpy(), ug[f"occ_{est}"], atol=1e-4)


def test_losses_match_goldens(ug):
    im0, im1, mask = _t(ug["im0"]), _t(ug["im1"]), _t(ug["mask"])
    np.testing.assert_allclose(float(uf.census_loss(im0, im1, mask)), float(ug["census"]), rtol=1e-4)
    err, avg_w = uf.weighted_ssim(im0, im1, mask[..., 0])
    np.testing.assert_allclose(err.numpy(), ug["ssim_err"], atol=1e-4)
    np.testing.assert_allclose(avg_w.numpy(), ug["ssim_avgw"], atol=1e-5)
    flows = {(0, 1, "augmented-student"): [_t(ug[f"flow_fw_{i}"]) for i in range(3)],
             (1, 0, "augmented-student"): [_t(ug[f"flow_bw_{i}"]) for i in range(3)]}
    images = {0: im0, 1: im1}
    weights = {"photo": 1.0, "smooth1": 2.0, "smooth2": 4.0, "ssim": 0.5, "census": 1.0,
               "edge_constant": 150.0}
    warps, valid, _, occ, fb_sq, fb_sum = uf.compute_warps_and_occlusion(flows, "wang")
    warped = uf.apply_warps_stop_grad(images, warps, level=0)
    losses = uf.compute_loss(weights, images, flows, warps, valid, occ, fb_sq, fb_sum, warped,
                             smoothness_at_level=2)
    for k in ["photo", "smooth1", "smooth2", "ssim", "census", "total"]:
        np.testing.assert_allclose(float(losses[k]), float(ug[f"loss_{k}"]), rtol=2e-3, err_msg=k)
    g = np.load(os.path.join(GOLDENS, "uflow_supervised.npz"))
    sup = uf.supervised_loss({"supervision": 1.0}, _t(g["gt"]), _t(g["valid"]),
                             {(0, 1, "augmented"): [_t(g["pred"])]})
    np.testing.assert_allclose(float(sup["supervision"]), float(g["loss"]), rtol=1e-4)


def test_random_crop_and_shift_are_slices_and_rolls():
    x = torch.arange(3 * 20 * 24 * 2, dtype=torch.float32).reshape(3, 20, 24, 2)
    gen = torch.Generator().manual_seed(0)
    cropped, offsets = uf.random_crop(gen, x, 6, 8)
    assert cropped.shape == (3, 14, 16, 2) and offsets.shape == (3, 2)
    for b, (h0, w0) in enumerate(offsets.tolist()):
        assert 0 <= h0 <= 6 and 0 <= w0 <= 8
        assert torch.equal(cropped[b], x[b, h0:h0 + 14, w0:w0 + 16])
    shifted, shifts = uf.random_shift(gen, x, 5, 7)
    for b, (s0, s1) in enumerate(shifts.tolist()):
        assert -5 <= s0 <= 5 and -7 <= s1 <= 7
        assert torch.equal(shifted[b], torch.from_numpy(np.roll(x[b].numpy(), (s0, s1), (0, 1))))
    again, again_offsets = uf.random_crop(torch.Generator().manual_seed(0), x, 6, 8)
    assert torch.equal(again_offsets, offsets) and torch.equal(again, cropped)
