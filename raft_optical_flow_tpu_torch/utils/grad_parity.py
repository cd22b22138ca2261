"""Gradient-parity checks of the correlation kernels' backward passes.

Counterpart of `raft_optical_flow_tpu/utils/grad_parity.py`: each check
takes one gradient of a scalarized lookup, <lookup(inputs), cotangent>,
through the port's kernel VJP and through autograd of the plain version,
on the same device, and reads the largest max|d| / max|ref| over the input
gradients (`utils/grad_check.py::layer_max_rel`, each tensor on its own
scale). On the card the kernel VJPs are:

  - `lookup_vjp`, `lookup_vjp_bf16`: K3, the backward of K1
    (`kernels/corr_lookup.py::corr_pyramid_lookup_cuda`, a level at a
    time), against autograd of `ops/corr.py::corr_pyramid_lookup`, in fp32
    and with a bf16 volume and cotangent (the oracle in fp32 on the same
    bf16 values);
  - `ondemand_vjp`: K5 (the fmap1 gradient) and K6 with its prepass (the
    fmap2 levels' gradients), the backward of K4
    (`kernels/corr_ondemand.py::ondemand_corr_pyramid_cuda`), fp32 fmaps
    (K4 and K5 on tiles of 4x16 queries, fp32 products as three TF32
    passes of `mma.sync`); against autograd of `corr_ondemand_fwd_plain`;
  - `ondemand_vjp_stream`: the JAX package's h-streaming route has no
    counterpart here (one kernel per function covers every frame size), so
    this entry runs the port's other dtype: bf16 fmaps, on which K4 and K5
    take the same tiles with bf16 products, held to the bf16 bar.

Inputs are built as the JAX checks build them (`np.random.default_rng(0)`
for the lookup, `default_rng(1)` for on-demand, in the same order), so a
CPU test can feed JAX the same arrays. The kernels take C in (128, 256),
so the on-demand checks run at C = 128 on the card (the JAX package's
default is 64). On the CPU every wrapper runs its plain version.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from raft_optical_flow_tpu_torch.kernels.corr_lookup import corr_pyramid_lookup_cuda
from raft_optical_flow_tpu_torch.kernels.corr_ondemand import (
    corr_ondemand_fwd_plain,
    ondemand_corr_pyramid_cuda,
)
from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup
from raft_optical_flow_tpu_torch.utils.grad_check import layer_max_rel

# fp32 kernel VJPs against the fp32 plain autograd: agreement is limited by
# the sums' order, ~1e-6 relative; 2e-5 still catches any wrong tap or level
DEFAULT_TOL = 2e-5
# a bf16 volume or fmaps add a few bf16 roundings (each <= 2^-8 relative) of
# the cotangent and the gradients; a structural defect reads O(1)
BF16_TOL = 3e-2
VJP_TOL = {torch.float32: DEFAULT_TOL, torch.bfloat16: BF16_TOL}


def _max_rel(got, ref) -> float:
    """The largest max|d| / max|ref| over paired gradient tensors."""
    names = [f"g{i}.grad" for i in range(len(ref))]
    return max(layer_max_rel(dict(zip(names, got)), dict(zip(names, ref))).values())


def lookup_inputs(B=1, h=24, w=32, radius=4, levels=4):
    """(pyramid, coords, cotangent) as numpy fp32, `check_lookup_grad`'s draws."""
    rng = np.random.default_rng(0)
    Q = h * w
    pyr = [rng.normal(size=(B, Q, h // 2**lvl, w // 2**lvl)).astype(np.float32)
           for lvl in range(levels)]
    coords = rng.uniform(1, min(h, w) - 2, size=(B, h, w, 2)).astype(np.float32)
    cot = rng.normal(size=(B, h, w, levels * (2 * radius + 1) ** 2)).astype(np.float32)
    return pyr, coords, cot


def ondemand_inputs(B=1, h=24, w=32, C=128, radius=4, levels=2):
    """(fmap1, fmap2 levels, coords, cotangent) as numpy fp32,
    `check_ondemand_grad`'s draws."""
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(B, h, w, C)).astype(np.float32)
    f2s = [rng.normal(size=(B, h // 2**lvl, w // 2**lvl, C)).astype(np.float32)
           for lvl in range(levels)]
    coords = rng.uniform(1, min(h, w) - 2, size=(B, h, w, 2)).astype(np.float32)
    cot = rng.normal(size=(B, h, w, levels * (2 * radius + 1) ** 2)).astype(np.float32)
    return f1, f2s, coords, cot


def _grads(loss_fn, tensors):
    tensors = [t.detach().clone().requires_grad_(True) for t in tensors]
    loss_fn(tensors).backward()
    return [t.grad.float() for t in tensors]


def check_lookup_grad(B=1, h=24, w=32, radius=4, levels=4, volume_dtype=torch.float32,
                      device="cuda") -> float:
    """K3 (through `corr_pyramid_lookup_cuda`) against autograd of the plain
    lookup: the largest max_rel over the levels' volume gradients. The
    volume and cotangent are rounded to `volume_dtype` first, so that both
    sides see the same values; the oracle runs in fp32 on them."""
    pyr, coords, cot = lookup_inputs(B, h, w, radius, levels)
    pyr = [torch.from_numpy(p).to(device, volume_dtype) for p in pyr]
    coords = torch.from_numpy(coords).to(device)
    cot = torch.from_numpy(cot).to(device, volume_dtype)

    def kernel(p):
        out = corr_pyramid_lookup_cuda(p, coords, radius, out_dtype=volume_dtype)
        return (out.float() * cot.float()).sum()

    def plain(p):
        return (corr_pyramid_lookup([x.float() for x in p], coords, radius) * cot.float()).sum()

    return _max_rel(_grads(kernel, pyr), _grads(plain, pyr))


def check_ondemand_grad(B=1, h=24, w=32, C=128, radius=4, levels=2, stream=False,
                        device="cuda") -> float:
    """K5 and K6 (through `ondemand_corr_pyramid_cuda`) against autograd of
    the plain K4: the largest max_rel over the fmap1 and fmap2 levels'
    gradients. `stream`: bf16 fmaps (K4's and K5's tensor-core tiles; see
    the module's note), rounded before both sides see them."""
    dtype = torch.bfloat16 if stream else torch.float32
    f1, f2s, coords, cot = ondemand_inputs(B, h, w, C, radius, levels)
    f1 = torch.from_numpy(f1).to(device, dtype)
    f2s = [torch.from_numpy(f).to(device, dtype) for f in f2s]
    coords = torch.from_numpy(coords).to(device)
    cot = torch.from_numpy(cot).to(device)

    def kernel(t):  # the windows in the fmaps' dtype, as the training path makes them
        out = ondemand_corr_pyramid_cuda(t[0], t[1:], coords, radius, out_dtype=dtype)
        return (out.float() * cot).sum()

    def plain(t):
        f1p = t[0].float().reshape(B, h * w, C)
        out = corr_ondemand_fwd_plain(f1p, [f.float() for f in t[1:]],
                                      coords.reshape(B, h * w, 2), radius)
        return (out.reshape(B, h, w, -1) * cot).sum()

    return _max_rel(_grads(kernel, [f1, *f2s]), _grads(plain, [f1, *f2s]))


def run_all(device="cuda", tol: float = DEFAULT_TOL) -> Dict[str, Dict]:
    """Every check at its default shapes: {name: {"max_rel", "tol", "ok"}};
    bf16 entries are held to BF16_TOL, fp32 ones to `tol`. On the CPU (the
    plain versions) the four take about 2 s."""
    results = {}
    for name, fn, t in (
        ("lookup_vjp", lambda: check_lookup_grad(device=device), tol),
        ("lookup_vjp_bf16", lambda: check_lookup_grad(volume_dtype=torch.bfloat16,
                                                      device=device), BF16_TOL),
        ("ondemand_vjp", lambda: check_ondemand_grad(stream=False, device=device), tol),
        ("ondemand_vjp_stream", lambda: check_ondemand_grad(stream=True, device=device),
         BF16_TOL),
    ):
        rel = fn()
        results[name] = {"max_rel": float(rel), "tol": t, "ok": bool(rel < t)}
    return results
