"""RAFT-small's update block on the card: K9, one implicit-GEMM convolution
kernel in fp32 with the ConvGRU's gates in its epilogue.

One CUDA kernel (`csrc/small_update.cu`, built by `_build.py`, bound through
ctypes):

  - K9 `small_update_conv`: a ksize x ksize convolution (ksize odd, at most
    7, zero padding ksize // 2) over the channel concatenation of up to four
    NCHW-shaped segments, each read in place (NCHW- or channels-last-
    contiguous), into N <= 192 channels-last output channels; products
    fp32-accurate on the tensor cores (three TF32 passes on hi/lo parts),
    fp32 sums; epilogue `bias`, `bias_relu`, `gru_zr` (sigmoid; z out, r * h
    out) or `gru_q` (tanh; h' = (1 - z) * h + z * q out).

It replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
Under the fp32 policy (TF32 off) cuDNN runs them as FFT convolutions, which
took 97% of a RAFT-small serving call's device time at the Sintel batch-16
shape; the source note gives the bound and the design.

`SmallUpdateBlock` (`models/update.py`) takes this path when `declines`
finds no reason against it (fp32 CUDA inputs, no gradient recorded, not
exporting): `small_update_step` runs the block as 8 launches (the motion
encoder's four convolutions, the GRU's two gate launches, the flow head's
two), with nothing concatenated in memory. Each launch counts in
`LAUNCHES`.

  - `ConvWeights`: one convolution's weights laid out for K9 (per tap, each
    segment's channels padded to groups of 8; columns padded to the tile
    width);
  - `conv_plain`: K9's plain version (the same laid-out weights, products as
    the kernel's three TF32 passes, fp32 sums, the same epilogues);
  - `conv`: K9 on CUDA tensors, the plain version on CPU tensors;
  - `block_params`, `small_update_step`: the block's eight convolutions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.kernels import _build
from raft_optical_flow_tpu_torch.kernels.gru_fused import _full_fp32

# launches of the kernel since the last reset_launches(); plain runs do not count
LAUNCHES: Dict[str, int] = {"small_update_conv": 0}

EPILOGUES = ("bias", "bias_relu", "gru_zr", "gru_q")
# the kernel's tile widths (csrc/small_update.cu::raft_small_update_conv)
TILE_WIDTHS = (8, 16, 32, 64, 80, 96, 128, 192)
GROUP = 8  # channels of a K group (one mma k-step)
STAGE_ROWS = 4 * GROUP  # K rows of a stage (csrc/small_update.cu::kBK): weights come in whole stages
MAX_GROUPS = 512  # K groups of a launch, the last stage's padding included (::kMaxGroups)
MAX_SEGMENTS = 4
MAX_KSIZE = 7
_lib: Optional[ctypes.CDLL] = None


class _Seg(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_int64), ("sh", ctypes.c_int64),
                ("sw", ctypes.c_int64), ("sc", ctypes.c_int64), ("c", ctypes.c_int32),
                ("vec", ctypes.c_int32)]


class _Args(ctypes.Structure):
    _fields_ = [("seg", _Seg * MAX_SEGMENTS), ("h", _Seg), ("w", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("out", ctypes.c_void_p), ("out2", ctypes.c_void_p),
                ("z", ctypes.c_void_p), ("nseg", ctypes.c_int32), ("B", ctypes.c_int32),
                ("H", ctypes.c_int32), ("W", ctypes.c_int32), ("N", ctypes.c_int32),
                ("ksize", ctypes.c_int32), ("epilogue", ctypes.c_int32), ("bn", ctypes.c_int32),
                ("gpt", ctypes.c_int32), ("gstart", ctypes.c_int32 * (MAX_SEGMENTS + 1))]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load()
        lib.raft_small_update_conv.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.raft_small_update_conv.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile_width(n: int) -> int:
    """The kernel's tile width for N output channels."""
    for bn in TILE_WIDTHS:
        if n <= bn:
            return bn
    raise ValueError(f"K9 takes at most {TILE_WIDTHS[-1]} output channels, got {n}")


def _groups(c: int) -> int:
    return -(-c // GROUP)


def row_stride(bn: int) -> int:
    """The weight rows' length for tile width bn (csrc/small_update.cu::
    ldb_of): 8 or 24 floats past a multiple of 32, so that the kernel's
    fragment reads from shared memory are free of bank conflicts."""
    return bn if bn % 32 in (8, 24) else bn + (40 - bn % 32) % 32


@dataclasses.dataclass(frozen=True)
class ConvWeights:
    """One convolution laid out for K9.

    w [rows, row_stride(bn)] fp32: K in the kernel's order (tap-major, then
    each segment's channels in groups of 8, the last group of a segment
    padded with zero rows), rows padded to whole stages of 32, columns past n
    zero, so that a stage's weights are one contiguous block that the kernel
    copies into shared memory as it is; bn = tile_width(n); b [n] fp32;
    `segments` the input channels of each segment.
    """

    w: torch.Tensor
    b: torch.Tensor
    n: int
    ksize: int
    segments: Tuple[int, ...]

    @staticmethod
    def of(weight: torch.Tensor, bias: torch.Tensor, segments: Sequence[int]) -> "ConvWeights":
        """From an OIHW conv weight [n, sum(segments), k, k] and its bias [n]."""
        n, cin, kh, kw = weight.shape
        segments = tuple(int(c) for c in segments)
        if kh != kw or kh % 2 == 0 or kh > MAX_KSIZE:
            raise ValueError(f"K9 takes square odd kernels up to {MAX_KSIZE}, got {kh}x{kw}")
        if not 1 <= len(segments) <= MAX_SEGMENTS or min(segments) < 1 or sum(segments) != cin:
            raise ValueError(f"segments {segments} must be 1 to {MAX_SEGMENTS} positive channel "
                             f"counts summing to the weight's {cin} input channels")
        if tuple(bias.shape) != (n,):
            raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
        ldb = row_stride(tile_width(n))
        taps = weight.detach().float().permute(2, 3, 1, 0).reshape(kh * kw, cin, n)
        parts, c0 = [], 0
        for c in segments:
            parts.append(F.pad(taps[:, c0:c0 + c], (0, ldb - n, 0, _groups(c) * GROUP - c)))
            c0 += c
        w = torch.cat(parts, dim=1).reshape(-1, ldb)
        rows = -(-w.shape[0] // STAGE_ROWS) * STAGE_ROWS
        if rows // GROUP > MAX_GROUPS:
            raise ValueError(f"K9 takes at most {MAX_GROUPS} groups of {GROUP} input channels "
                             f"over the taps, got {rows // GROUP} ({kh}x{kw}, {segments})")
        w = F.pad(w, (0, 0, 0, rows - w.shape[0])).contiguous()
        return ConvWeights(w, bias.detach().float().contiguous(), n, kh, segments)


def _layout(t: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """(sb, sh, sw, sc) of an NCHW-shaped tensor that is NCHW- or channels-
    last-contiguous (channels-last first), else None."""
    if t.is_contiguous(memory_format=torch.channels_last) or t.is_contiguous():
        sb, sc, sh, sw = t.stride()
        return sb, sh, sw, sc
    return None


def _seg(t: torch.Tensor) -> _Seg:
    sb, sh, sw, sc = _layout(t)
    B, C, H, W = t.shape
    # 16-byte copies of 4 channels: unit channel stride, every stride used a
    # multiple of 4 floats, the base 16-byte aligned
    used = [s for s, n in ((sb, B), (sh, H), (sw, W)) if n > 1]
    vec = C % 4 == 0 and sc == 1 and all(s % 4 == 0 for s in used) and t.data_ptr() % 16 == 0
    return _Seg(t.data_ptr(), sb, sh, sw, sc, C, int(vec))


def _check(segs, cw: ConvWeights, epilogue: str, h, z):
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"K9 takes 1 to {MAX_SEGMENTS} input segments, got {len(segs)}")
    ref = segs[0]
    for t in segs:
        if t.dtype != torch.float32:
            raise TypeError(f"K9's inputs must be float32, got {t.dtype}")
        if t.dim() != 4 or t.shape[0] != ref.shape[0] or t.shape[2:] != ref.shape[2:]:
            raise ValueError(f"segments must be [B, C, H, W] with one B, H, W, got "
                             f"{[tuple(s.shape) for s in segs]}")
        if t.device != ref.device:
            raise ValueError("the segments must be on one device")
        if _layout(t) is None:
            raise ValueError(f"segment {tuple(t.shape)} with strides {t.stride()} must be "
                             "contiguous, NCHW or channels-last")
    if tuple(t.shape[1] for t in segs) != cw.segments:
        raise ValueError(f"segments of {tuple(t.shape[1] for t in segs)} channels, the weights "
                         f"were laid out for {cw.segments}")
    for name, t in (("w", cw.w), ("b", cw.b)):
        if t.dtype != torch.float32 or t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"the laid-out {name} must be contiguous float32 on the segments' "
                             f"device, got {t.dtype} on {t.device}")
    B, _, H, W = ref.shape
    gated = epilogue.startswith("gru")
    D = cw.n // 2 if epilogue == "gru_zr" else cw.n
    if epilogue == "gru_zr" and cw.n % 2:
        raise ValueError(f"gru_zr needs an even width (z | r), got {cw.n}")
    if gated:
        if h is None or h.dtype != torch.float32 or tuple(h.shape) != (B, D, H, W) \
                or h.device != ref.device or _layout(h) is None:
            raise ValueError(f"{epilogue} needs h: contiguous float32 [{B}, {D}, {H}, {W}] "
                             f"on the segments' device")
    if epilogue == "gru_q":
        if z is None or z.dtype != torch.float32 or tuple(z.shape) != (B, D, H, W) \
                or z.device != ref.device or not z.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"gru_q needs z: channels-last float32 [{B}, {D}, {H}, {W}] as "
                             "gru_zr wrote it")
    return B, H, W, D


def _split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operand parts: hi = x rounded to TF32 (to nearest, ties
    away), lo = x - hi truncated to TF32 (what the mma reads of it)."""
    hi = ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _im2col(segs, cw: ConvWeights) -> torch.Tensor:
    """[B*H*W, rows]: each pixel's K in the kernel's order, zero where the
    tap falls off the frame or the group is padded."""
    B, _, H, W = segs[0].shape
    p = cw.ksize // 2
    padded = [F.pad(F.pad(t.float(), (p, p, p, p)), (0, 0, 0, 0, 0, _groups(c) * GROUP - c))
              for t, c in zip(segs, cw.segments)]
    cols = [t[:, :, ky:ky + H, kx:kx + W] for ky in range(cw.ksize) for kx in range(cw.ksize)
            for t in padded]
    a = torch.cat(cols, dim=1).permute(0, 2, 3, 1).reshape(B * H * W, -1)
    return F.pad(a, (0, cw.w.shape[0] - a.shape[1]))


def conv_plain(segs: Sequence[torch.Tensor], cw: ConvWeights, epilogue: str,
               h: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """Plain version of K9 on the laid-out weights: the products as the
    kernel's three TF32 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32
    sums in another order), then the epilogue. Returns what `conv` returns."""
    B, H, W, D = _check(segs, cw, epilogue, h, z)
    with _full_fp32():
        a_hi, a_lo = _split_tf32(_im2col(segs, cw))
        b_hi, b_lo = _split_tf32(cw.w)
        acc = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    v = acc[:, :cw.n] + cw.b

    def nchw(t):
        return t.reshape(B, H, W, -1).permute(0, 3, 1, 2)

    if epilogue == "bias":
        return nchw(v)
    if epilogue == "bias_relu":
        return nchw(torch.relu(v))
    hv = h.permute(0, 2, 3, 1).reshape(-1, D)
    if epilogue == "gru_zr":
        s = torch.sigmoid(v)
        return nchw(s[:, :D].contiguous()), nchw(s[:, D:] * hv)
    zv = z.permute(0, 2, 3, 1).reshape(-1, D)
    return nchw((1 - zv) * hv + zv * torch.tanh(v))


def conv(segs: Sequence[torch.Tensor], cw: ConvWeights, epilogue: str,
         h: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None):
    """K9: one convolution over the channel concatenation of `segs` (1 to 4
    float32 [B, C_i, H, W], each NCHW- or channels-last-contiguous), with
    the weights `cw` laid out for exactly those segments.

    Returns [B, n, H, W] channels-last (`bias`, `bias_relu`); (z, r * h),
    each [B, n / 2, H, W] channels-last (`gru_zr`, which needs h [B, n / 2,
    H, W]); h' [B, n, H, W] channels-last (`gru_q`, which needs h and the z
    of `gru_zr`). A CPU tensor runs the plain version.
    """
    B, H, W, D = _check(segs, cw, epilogue, h, z)
    if not segs[0].is_cuda:
        return conv_plain(segs, cw, epilogue, h, z)
    dev = segs[0].device
    out = torch.empty(B, H, W, D, device=dev)
    out2 = torch.empty(B, H, W, D, device=dev) if epilogue == "gru_zr" else None
    outs = (out.permute(0, 3, 1, 2),) + (() if out2 is None else (out2.permute(0, 3, 1, 2),))
    if out.numel() == 0:
        return outs[0] if len(outs) == 1 else outs
    args = _Args()
    for i, t in enumerate(segs):
        args.seg[i] = _seg(t)
    for i in range(len(segs), MAX_SEGMENTS):
        args.seg[i] = args.seg[0]
    if h is not None:
        args.h = _seg(h)
    gstart = [0]
    for c in cw.segments:
        gstart.append(gstart[-1] + _groups(c))
    args.gpt = gstart[-1]
    gstart += [gstart[-1]] * (MAX_SEGMENTS + 1 - len(gstart))
    for i, v in enumerate(gstart):
        args.gstart[i] = v
    args.w, args.bias = cw.w.data_ptr(), cw.b.data_ptr()
    args.out = out.data_ptr()
    args.out2 = 0 if out2 is None else out2.data_ptr()
    args.z = 0 if z is None else z.data_ptr()
    args.nseg, args.B, args.H, args.W = len(segs), B, H, W
    args.N, args.ksize, args.epilogue = cw.n, cw.ksize, EPILOGUES.index(epilogue)
    args.bn = tile_width(cw.n)
    with torch.cuda.device(dev):
        err = _kernels().raft_small_update_conv(ctypes.byref(args),
                                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"small_update_conv: CUDA error {err} at launch")
    LAUNCHES["small_update_conv"] += 1
    return outs[0] if len(outs) == 1 else outs


def block_params(block) -> Dict[str, ConvWeights]:
    """The eight convolutions of a `models/update.py::SmallUpdateBlock`,
    laid out for K9 with the segments `small_update_step` feeds them."""
    enc, gru, head = block.encoder, block.gru, block.flow_head
    hidden = gru.convz.out_channels
    enc_out = enc.conv.out_channels
    context = gru.convz.in_channels - hidden - enc_out - 2
    gru_segments = (hidden, context, enc_out, 2)  # cat(h | r * h, inp, out, flow)

    def cw(c, segments, weight=None, bias=None):
        return ConvWeights.of(c.weight if weight is None else weight,
                              c.bias if bias is None else bias, segments)

    return {
        "convc1": cw(enc.convc1, (enc.convc1.in_channels,)),
        "convf1": cw(enc.convf1, (2,)),
        "convf2": cw(enc.convf2, (enc.convf1.out_channels,)),
        "conv": cw(enc.conv, (enc.convc1.out_channels, enc.convf2.out_channels)),
        "gru_zr": cw(gru.convz, gru_segments, torch.cat([gru.convz.weight, gru.convr.weight]),
                     torch.cat([gru.convz.bias, gru.convr.bias])),
        "gru_q": cw(gru.convq, gru_segments),
        "head1": cw(head.conv1, (hidden,)),
        "head2": cw(head.conv2, (head.conv1.out_channels,)),
    }


def small_update_step(params: Dict[str, ConvWeights], net: torch.Tensor, inp: torch.Tensor,
                      corr: torch.Tensor, flow: torch.Tensor,
                      conv_fn: Callable = conv) -> Tuple[torch.Tensor, torch.Tensor]:
    """SmallUpdateBlock's step as eight K9 launches (`conv_fn` = `conv`; the
    plain version with `conv_plain`). NCHW-shaped in (net [B, D, H, W], inp
    [B, X - 82, H, W], corr [B, L(2r+1)^2, H, W], flow [B, 2, H, W]), (net',
    delta) out, both channels-last."""
    cor = conv_fn([corr], params["convc1"], "bias_relu")
    flo = conv_fn([conv_fn([flow], params["convf1"], "bias_relu")], params["convf2"], "bias_relu")
    out = conv_fn([cor, flo], params["conv"], "bias_relu")
    z, rh = conv_fn([net, inp, out, flow], params["gru_zr"], "gru_zr", h=net)
    net = conv_fn([rh, inp, out, flow], params["gru_q"], "gru_q", h=net, z=z)
    delta = conv_fn([conv_fn([net], params["head1"], "bias_relu")], params["head2"], "bias")
    return net, delta


def declines(tensors: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> Optional[str]:
    """Why a block call keeps its module path, or None where K9 takes it:
    "dtype" (an input not float32), "gradient" (a gradient is recorded:
    K9 has no backward), "export" (torch.export or torch.compile is
    tracing), "device" (an input not on a CUDA device)."""
    if any(t.dtype != torch.float32 for t in tensors):
        return "dtype"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, *params)):
        return "gradient"
    if torch.compiler.is_exporting() or torch.compiler.is_compiling():
        return "export"
    if not all(t.is_cuda for t in tensors):
        return "device"
    return None
