"""Fused SepConvGRU: both directional GRU passes, each one CUDA launch.

Counterpart of `raft_optical_flow_tpu/kernels/gru_fused.py`. One CUDA kernel
(`csrc/gru_fused.cu`, built by `_build.py`, bound through ctypes):

  - K7 `sepconv_gru_pass`: one directional pass of the three gates (replaces
    `_gru_pass_kernel`), launched once for the horizontal 1x5 pass and once
    for the vertical 5x1 pass. In bf16 it runs on the tensor cores (`wgmma`,
    the weights streamed through shared memory), after a small kernel that
    lays the pass's weights out as the tiles they read; in fp32 on the CUDA
    cores, as two GEMM kernels (z|r, then q and the update) with r * h
    between them in a scratch buffer.

Parameters are the port's modules' own: `params` maps `convz1`, `convr1`,
`convq1` (1x5) and `convz2`, `convr2`, `convq2` (5x1) to (weight [D, D+X, kh,
kw] OIHW over cat(h, x), bias [D]), as `models/update.py::SepConvGRU` holds
them. The public functions take the JAX package's NHWC layout (h [B, H, W, D],
x [B, H, W, X]).

  - `sepconv_gru_reference`: the unfused math (convs over cat(h, x), in the
    parameters' dtype); the function the backward differentiates;
  - `sepconv_gru_plain`: K7's plain version, rounding where the kernel rounds;
  - `sepconv_gru_cuda`: K7 on a CUDA tensor (two launches), the plain version
    on a CPU tensor;
  - `SepConvGRUFused`: the autograd Function the model calls, forward K7,
    backward autograd of the reference (the JAX package's `_sepconv_gru_bwd`;
    it has no backward kernel, so neither has the port).

`SepConvGRUFused` takes NCHW-shaped tensors, the model's layout, and hands
the kernel their NHWC view: for a channels-last tensor (what K7 returns,
carried as the GRU state) that view is the tensor itself, so the model pays
no permute per iteration for h. Each wrapper launch counts in `LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launches(); plain runs do not count
LAUNCHES: Dict[str, int] = {"sepconv_gru_pass": 0}

GATES = ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2")
KERNEL_HIDDEN = 128  # the kernel's D (RAFT-standard's hidden_dim)
# the bf16 kernel's widest x: 132 staged rows of h|x and two 16 KB weight
# slots in a block's 227 KB of shared memory (csrc/gru_fused.cu)
KERNEL_MAX_X_BF16 = 608
_TAPS = 5
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raft_sepconv_gru_pass.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.raft_sepconv_gru_pass.restype = I
        lib.raft_sepconv_gru_scratch_bytes.argtypes = [I, I, I, I, I, I]
        lib.raft_sepconv_gru_scratch_bytes.restype = ctypes.c_int64
        _lib = lib
    return _lib


@contextlib.contextmanager
def _full_fp32():
    """cuDNN convs and cuBLAS matmuls in full fp32 (no TF32) inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _flat(params: Params) -> Tuple[torch.Tensor, ...]:
    return tuple(t for name in GATES for t in params[name])


def pass_weights(weights: Sequence[torch.Tensor], dtype: torch.dtype):
    """(w [5, D+X, 3D] in `dtype`, bias [3D] fp32) of one pass from its
    (weight_z, bias_z, weight_r, bias_r, weight_q, bias_q): columns z | r | q,
    tap t at offset t - 2 along the pass axis."""
    wz, bz, wr, br, wq, bq = weights
    w = torch.cat([wz, wr, wq], dim=0)  # [3D, C, kh, kw], kh * kw = 5
    w = w.reshape(w.shape[0], w.shape[1], _TAPS).permute(2, 1, 0).to(dtype).contiguous()
    return w, torch.cat([bz, br, bq]).float().contiguous()


def _check_pass(h, x, w, b, axis):
    if h.dim() != 4 or x.dim() != 4 or h.shape[:3] != x.shape[:3]:
        raise ValueError(f"h [B, H, W, D] and x [B, H, W, X] must share B, H, W, got "
                         f"{tuple(h.shape)} and {tuple(x.shape)}")
    if h.dtype not in _DTYPE_CODE or x.dtype != h.dtype:
        raise TypeError(f"h and x must both be float32 or both bfloat16, got {h.dtype}, {x.dtype}")
    if x.device != h.device or w.device != h.device or b.device != h.device:
        raise ValueError("h, x, the weights and the bias must be on one device")
    if not (h.is_contiguous() and x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("h, x (NHWC), the weights and the bias must be contiguous")
    D, C = h.shape[3], h.shape[3] + x.shape[3]
    if tuple(w.shape) != (_TAPS, C, 3 * D) or w.dtype != h.dtype:
        raise ValueError(f"w must be {h.dtype} [5, {C}, {3 * D}], got {w.dtype} {tuple(w.shape)}")
    if tuple(b.shape) != (3 * D,) or b.dtype != torch.float32:
        raise ValueError(f"bias must be float32 [{3 * D}], got {b.dtype} {tuple(b.shape)}")
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (5x1 pass) or 2 (1x5 pass), got {axis}")


def gru_pass_plain(h, x, w, b, axis):
    """Plain version of K7, one pass, NHWC: the kernel's roundings. Operands in
    h's dtype (the weights rounded to it), fp32 sums, z and r fp32, rh = r
    rounded to the dtype times h in the dtype, q fp32, h' rounded once."""
    dt, D = h.dtype, h.shape[3]
    n = h.shape[axis]
    wf = w.float()

    def gates(a, cols):  # sum_t shift(a, t - 2) @ w[t][:, cols] + b[cols], fp32
        zeros = a.new_zeros(a.shape[:axis] + (2,) + a.shape[axis + 1:])
        padded = torch.cat([zeros, a, zeros], dim=axis)
        acc = sum(padded.narrow(axis, t, n) @ wf[t][:, cols] for t in range(_TAPS))
        return acc + b[cols]

    with _full_fp32():
        hf, xf = h.float(), x.float()
        zr = torch.sigmoid(gates(torch.cat([hf, xf], dim=-1), slice(0, 2 * D)))
        z, r = zr[..., :D], zr[..., D:]
        rh = r.to(dt) * h
        q = torch.tanh(gates(torch.cat([rh.float(), xf], dim=-1), slice(2 * D, 3 * D)))
    return ((1 - z) * hf + z * q).to(dt)


def gru_pass(h: torch.Tensor, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             axis: int) -> torch.Tensor:
    """K7: one directional SepConvGRU pass.

    h [B, H, W, D], x [B, H, W, X]: contiguous NHWC, both fp32 or both bf16;
    w [5, D+X, 3D] in their dtype and b [3D] fp32 from `pass_weights`; axis 2
    the 1x5 pass, 1 the 5x1 pass. Returns h' [B, H, W, D] in h's dtype. The
    kernel takes D = 128 and X a multiple of 16 (bf16: at most 608); a CPU
    tensor runs the plain version at any width. In bf16 the launch first lays
    w out in a scratch buffer as the tiles the tensor cores read; in fp32 the
    scratch buffer holds r * h between the pass's two GEMMs.
    """
    _check_pass(h, x, w, b, axis)
    if not h.is_cuda:
        return gru_pass_plain(h, x, w, b, axis)
    B, H, W, D = h.shape
    X = x.shape[3]
    if D != KERNEL_HIDDEN or X <= 0 or X % 16:
        raise ValueError(f"the kernel takes D = {KERNEL_HIDDEN} and X a multiple of 16, "
                         f"got D = {D}, X = {X}")
    if h.dtype == torch.bfloat16 and X > KERNEL_MAX_X_BF16:
        raise ValueError(f"the bf16 kernel takes X at most {KERNEL_MAX_X_BF16}, got X = {X}")
    if any(t.data_ptr() % 16 for t in (h, x)):
        raise ValueError("h and x must be 16-byte aligned")
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    lib = _kernels()
    code = _DTYPE_CODE[h.dtype]
    scratch = torch.empty(lib.raft_sepconv_gru_scratch_bytes(B, H, W, D, X, code),
                          dtype=torch.uint8, device=h.device)
    with torch.cuda.device(h.device):
        err = lib.raft_sepconv_gru_pass(
            h.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), B, H, W, D, X, axis, code, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sepconv_gru_pass: CUDA error {err} at launch")
    LAUNCHES["sepconv_gru_pass"] += 1
    return out


def _two_passes(h, x, weights, pass_fn):
    w1, b1 = pass_weights(weights[:6], h.dtype)
    w2, b2 = pass_weights(weights[6:], h.dtype)
    return pass_fn(pass_fn(h, x, w1, b1, 2), x, w2, b2, 1)


def sepconv_gru_plain(h: torch.Tensor, x: torch.Tensor, params: Params) -> torch.Tensor:
    """Plain version of K7 over both passes (1x5, then 5x1), NHWC."""
    return _two_passes(h, x, _flat(params), gru_pass_plain)


def sepconv_gru_cuda(h: torch.Tensor, x: torch.Tensor, params: Params) -> torch.Tensor:
    """The fused SepConvGRU step, NHWC, counterpart of `sepconv_gru_pallas`:
    two K7 launches (1x5, then 5x1) on CUDA tensors, the plain version on CPU
    tensors. h [B, H, W, D], x [B, H, W, X] contiguous, one dtype (fp32 or
    bf16); returns h' in h's dtype."""
    return _two_passes(h, x, _flat(params), gru_pass)


def _reference_nchw(h, x, weights):
    """The unfused SepConvGRU on NCHW tensors, convs in the parameters' dtype."""
    for i, pad in ((0, (0, 2)), (6, (2, 0))):
        wz, bz, wr, br, wq, bq = weights[i:i + 6]
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(F.conv2d(hx.to(wz.dtype), wz, bz, padding=pad))
        r = torch.sigmoid(F.conv2d(hx.to(wr.dtype), wr, br, padding=pad))
        rhx = torch.cat([r * h, x], dim=1)
        q = torch.tanh(F.conv2d(rhx.to(wq.dtype), wq, bq, padding=pad))
        h = (1 - z) * h + z * q
    return h


def sepconv_gru_reference(h: torch.Tensor, x: torch.Tensor, params: Params) -> torch.Tensor:
    """The JAX package's `sepconv_gru_reference`, NHWC: convs over cat(h, x)
    with the input cast to the parameters' dtype (fp32 out for fp32 params)."""
    out = _reference_nchw(h.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), _flat(params))
    return out.permute(0, 2, 3, 1)


BF16_TRAINING_REFUSED = (
    "fused_gru has no bf16 training semantics: the JAX package's K7 backward "
    "casts the cotangent to bfloat16 while the reference it differentiates "
    "returns float32 (reference fault 2, ROADMAP.md Queue 3); train fused_gru "
    "in float32, or train bf16 without fused_gru"
)


class SepConvGRUFused(torch.autograd.Function):
    """apply(h, x, *weights) -> h'. h [B, D, H, W], x [B, X, H, W] (NCHW shape,
    any memory format; channels-last is free); weights: the 12 tensors
    (weight, bias) of `GATES` in order. Returns h' [B, D, H, W] channels-last.

    Forward: K7 twice. Backward: `sepconv_gru_reference` recomputed on the
    saved inputs under autograd, differentiated against the cotangent; a
    bf16 backward raises ValueError (no semantics to port:
    `BF16_TRAINING_REFUSED`; the model refuses bf16 fused training before it
    starts).
    """

    @staticmethod
    def forward(ctx, h, x, *weights):
        ctx.save_for_backward(h, x, *weights)
        hn = h.permute(0, 2, 3, 1).contiguous()
        xn = x.permute(0, 2, 3, 1).contiguous()
        return _two_passes(hn, xn, weights, gru_pass).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors  # read once: under checkpointing a second read raises
        if saved[0].dtype != torch.float32:
            raise ValueError(BF16_TRAINING_REFUSED)
        leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            out = _reference_nchw(leaves[0], leaves[1], leaves[2:])
            grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)
