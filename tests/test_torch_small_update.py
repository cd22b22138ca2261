"""K9 (`kernels/small_update.py`), RAFT-small's update-block convolutions, on
the CPU: its plain version against the block's module path, the block's
dispatch, and the wrapper's refusals.

The plain version takes the same laid-out weights as the kernel and
multiplies as the kernel does (three TF32 passes on hi/lo parts, fp32 sums):
each product within 2^-21 of its fp32 value and sums of at most 2,232
terms, so it agrees with the module path's fp32 convolutions to 1e-5 at
these magnitudes (outputs of order 1). Shapes are small, with odd H and W,
and the GRU's 242 input channels and the 196 correlation channels are no
multiples of 16. The card's tests are in `test_torch_small_update_gpu.py`.
"""

import pytest
import torch

from raft_optical_flow_tpu_torch.kernels import small_update as su
from raft_optical_flow_tpu_torch.models.update import SmallUpdateBlock
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
B, H, W = 2, 7, 9
CORR, HIDDEN, CONTEXT = 196, 96, 64


def _block(seed=0):
    torch.manual_seed(seed)
    return SmallUpdateBlock(CORR, HIDDEN, CONTEXT).eval()


def _inputs(seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    net = torch.tanh(torch.randn(B, HIDDEN, H, W, generator=g))
    inp = torch.relu(torch.randn(B, CONTEXT, H, W, generator=g))
    # the model's corr and flow are NHWC tensors seen as NCHW
    corr = torch.randn(B, H, W, CORR, generator=g).permute(0, 3, 1, 2)
    flow = (3 * torch.randn(B, H, W, 2, generator=g)).permute(0, 3, 1, 2)
    return tuple(t.to(dtype) for t in (net, inp, corr, flow))


def _module_step(blk, net, inp, corr, flow):
    """The block's module path, spelled out (what forward runs off K9)."""
    x = torch.cat([inp, blk.encoder(flow, corr)], dim=1)
    net = blk.gru(net, x)
    return net, blk.flow_head(net)


def _instances(blk, net, inp, corr, flow):
    """Each of K9's eight convolutions: (segments, epilogue, h, z) and the
    module path's value of the same."""
    enc, gru, head = blk.encoder, blk.gru, blk.flow_head
    cor = torch.relu(enc.convc1(corr))
    flo1 = torch.relu(enc.convf1(flow))
    flo = torch.relu(enc.convf2(flo1))
    out = torch.relu(enc.conv(torch.cat([cor, flo], 1)))
    hx = torch.cat([net, inp, out, flow], 1)
    z, r = torch.sigmoid(gru.convz(hx)), torch.sigmoid(gru.convr(hx))
    rh = r * net
    q = torch.tanh(gru.convq(torch.cat([rh, inp, out, flow], 1)))
    h = (1 - z) * net + z * q
    fh = torch.relu(head.conv1(h))
    return {
        "convc1": (([corr], "bias_relu", None, None), cor),
        "convf1": (([flow], "bias_relu", None, None), flo1),
        "convf2": (([flo1], "bias_relu", None, None), flo),
        "conv": (([cor, flo], "bias_relu", None, None), out),
        "gru_zr": (([net, inp, out, flow], "gru_zr", net, None), (z, rh)),
        # z as gru_zr hands it over: channels-last
        "gru_q": (([rh, inp, out, flow], "gru_q", net,
                   z.contiguous(memory_format=torch.channels_last)), h),
        "head1": (([h], "bias_relu", None, None), fh),
        "head2": (([fh], "bias", None, None), head.conv2(fh)),
    }


@pytest.mark.parametrize("case", ["convc1", "convf1", "convf2", "conv", "gru_zr", "gru_q",
                                  "head1", "head2", "step", "step_channels_last_h"])
def test_plain_matches_module_path(case):
    blk = _block()
    net, inp, corr, flow = _inputs()
    params = su.block_params(blk)
    with torch.no_grad():
        if case.startswith("step"):
            if case == "step_channels_last_h":  # the state K9 hands the next iteration
                net = net.contiguous(memory_format=torch.channels_last)
            got = su.small_update_step(params, net, inp, corr, flow, su.conv_plain)
            want = _module_step(blk, net, inp, corr, flow)
            for t in got:
                assert t.is_contiguous(memory_format=torch.channels_last)
        else:
            (segs, epilogue, h, z), want = _instances(blk, net, inp, corr, flow)[case]
            got = su.conv_plain(segs, params[case], epilogue, h=h, z=z)
            # on a CPU tensor the wrapper runs the plain version
            again = su.conv(segs, params[case], epilogue, h=h, z=z)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            again if isinstance(again, tuple) else (again,)):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


def test_split_tf32_parts():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * torch.logspace(-20, 20, 4096)
    hi, lo = su._split_tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 10-bit mantissa
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0  # what the mma reads
    assert float(((x - hi - lo).abs() / x.abs()).max()) <= 2.0 ** -21
    # hi is x to nearest: never further than half a TF32 step (2^-11 relative)
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("case", ["cpu", "gradient", "export", "bfloat16", "float64"])
def test_dispatch_keeps_module_path(case, monkeypatch):
    dtype = {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(case, torch.float32)
    blk = _block().to(dtype)
    args = _inputs(dtype=dtype)
    reasons = []
    declines = su.declines

    def spy(tensors, params):
        reasons.append(declines(tensors, params))
        return reasons[-1]

    monkeypatch.setattr(su, "declines", spy)
    if case == "export":
        class Serve(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.blk = blk

            def forward(self, *a):
                with torch.no_grad():
                    net, _, delta = self.blk(*a)
                return net, delta

        args = tuple(t.contiguous() for t in args)
        torch.export.export(Serve(), args)
        assert reasons and set(reasons) == {"export"}
        return
    if case == "gradient":
        got = blk(*args)
    else:
        with torch.no_grad():
            got = blk(*args)
    want = {"cpu": "device", "gradient": "gradient", "bfloat16": "dtype",
            "float64": "dtype"}[case]
    assert reasons == [want]
    with torch.no_grad():
        ref = _module_step(blk, *args)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[2], ref[1], rtol=0, atol=0)
    assert got[1] is None
    assert (case == "gradient") == got[0].requires_grad


def test_layout_follows_parameter_updates():
    blk = _block()
    first = blk._k9_params()
    assert blk._k9_params() is first  # unchanged parameters: laid out once
    with torch.no_grad():
        blk.flow_head.conv2.weight.add_(1.0)
    second = blk._k9_params()
    assert second is not first
    torch.testing.assert_close(
        second["head2"].w, su.ConvWeights.of(blk.flow_head.conv2.weight,
                                             blk.flow_head.conv2.bias, (128,)).w,
        rtol=0, atol=0)


def _refusal_case(case):
    blk = _block()
    net, inp, corr, flow = _inputs()
    p = su.block_params(blk)
    cl = torch.channels_last
    z = torch.zeros(B, HIDDEN, H, W).contiguous(memory_format=cl)
    out = torch.zeros(B, 80, H, W)
    return {
        "dtype": (lambda: su.conv([corr.double()], p["convc1"], "bias_relu"), TypeError,
                  "float32"),
        "shape": (lambda: su.conv([corr, flow[:, :, :5]], p["conv"], "bias_relu"), ValueError,
                  "one B, H, W"),
        "not_contiguous": (lambda: su.conv([corr[:, :, ::2]], p["convc1"], "bias_relu"),
                           ValueError, "contiguous"),
        "segment_channels": (lambda: su.conv([flow], p["convc1"], "bias_relu"), ValueError,
                             "laid out for"),
        "epilogue": (lambda: su.conv([corr], p["convc1"], "gelu"), ValueError, "epilogue"),
        "no_h": (lambda: su.conv([net, inp, out, flow], p["gru_zr"],
                                 "gru_zr"), ValueError, "needs h"),
        "z_layout": (lambda: su.conv([net, inp, out, flow], p["gru_q"],
                                     "gru_q", h=net, z=z.contiguous()), ValueError, "needs z"),
        "five_segments": (lambda: su.ConvWeights.of(torch.zeros(8, 5, 3, 3), torch.zeros(8),
                                                    (1, 1, 1, 1, 1)), ValueError, "segments"),
        "too_wide": (lambda: su.ConvWeights.of(torch.zeros(193, 4, 3, 3), torch.zeros(193), (4,)),
                     ValueError, "at most 192"),
        "even_kernel": (lambda: su.ConvWeights.of(torch.zeros(8, 4, 2, 2), torch.zeros(8), (4,)),
                        ValueError, "odd"),
        "too_many_groups": (lambda: su.ConvWeights.of(torch.zeros(8, 200, 7, 7), torch.zeros(8),
                                                      (200,)), ValueError, "at most 512 groups"),
    }[case]


@pytest.mark.parametrize("case", ["dtype", "shape", "not_contiguous", "segment_channels",
                                  "epilogue", "no_h", "z_layout", "five_segments", "too_wide",
                                  "even_kernel", "too_many_groups"])
def test_wrapper_refuses(case):
    fn, exc, words = _refusal_case(case)
    with pytest.raises(exc, match=words):
        fn()
