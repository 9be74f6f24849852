"""The conv epilogue of YOLOv4's folded forward (ops/cuda_epilogue.py) on the
CPU: the bias add and Mish or leaky 0.1 in place, after each ConvBN conv
run without its bias.

- the plain version equals the chain it replaces (the conv output plus
  its bias in the tensor's dtype, then layers.mish / F.leaky_relu(·,
  0.1)) bit for bit, in bf16 and f32, on negative, zero, large (> 20) and
  every bf16 value;
- it works in place, and a CPU tensor counts no launch;
- the bf16 Mish table the kernel reads holds F.mish of each bf16 value
  at that value's bits;
- the checks the kernel's wrapper makes before a launch;
- YOLOv4's folded f32 forward runs each ConvBN through it, and gives the
  raw heads of the chain written out bit for bit;
- the 107 conv outputs' shapes at 416: the bytes the epilogue moves.

The kernel itself runs on the card: tests/test_torch_cuda.py -k epilogue.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from grid_vision_tpu_torch.models import layers, weights, yolov4
from grid_vision_tpu_torch.ops import cuda_epilogue
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "weights", "yolov4_seeded.npz")
DTYPES = [torch.bfloat16, torch.float32]


def _chain(y, bias, act):
    """The old path after the conv: the bias add, then the activation."""
    s = y + bias.view(1, -1, 1, 1)
    return layers.mish(s) if act == "mish" else F.leaky_relu(s, 0.1)


def _output(dtype, c=16, side=6, seed=0):
    """A channels-last (2, c, side, side) conv output: normal values at
    spread 8, with zeros, negative zeros, and values near and beyond 20
    (where softplus is nearly the identity) planted."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((2, c, side, side), generator=g) * 8
    y.view(-1)[:12] = torch.tensor([0.0, -0.0, 20.0, -20.0, 20.5, 25.0,
                                    -25.0, 90.0, -90.0, 1e-3, -1e-3, 9.0])
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("act", cuda_epilogue.ACTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_equals_chain(dtype, act):
    y = _output(dtype)
    bias = torch.randn(16, generator=torch.Generator().manual_seed(1)) * 4
    bias[:2] = 0                     # the planted zeros stay zero sums
    bias = bias.to(dtype)
    want = _chain(y, bias, act)
    got = cuda_epilogue.bias_act_plain(y.clone(), bias, act)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    s = y + bias.view(1, -1, 1, 1)
    assert (s > 20).any() and (s < -20).any() and (s == 0).any()


@pytest.mark.parametrize("act", cuda_epilogue.ACTS)
def test_plain_equals_chain_on_every_bf16_value(act):
    """Every finite bf16 value as the conv output, the bias zero and not."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    y = bits.view(torch.bfloat16)
    y = y[torch.isfinite(y)]
    y = y[:y.numel() // 8 * 8].view(1, 8, -1, 1).contiguous(
        memory_format=torch.channels_last)
    for bias in (torch.zeros(8), torch.linspace(-3, 3, 8)):
        bias = bias.to(torch.bfloat16)
        got = cuda_epilogue.bias_act_plain(y.clone(), bias, act)
        assert torch.equal(got, _chain(y, bias, act))


def test_mish_lut_is_indexed_by_bits():
    """The table has 65536 bf16 entries; entry i is F.mish of the bf16
    value whose bits read i, for every finite value."""
    lut = cuda_epilogue.mish_lut("cpu")
    assert lut.dtype == torch.bfloat16 and lut.shape == (65536,)
    bits = torch.arange(0, 2 ** 16, dtype=torch.int32)
    x = bits.to(torch.int16).view(torch.bfloat16)
    finite = torch.isfinite(x)
    assert torch.equal(lut[finite], F.mish(x[finite]))
    assert lut[0].item() == 0.0 and lut[0x3F80].item() == F.mish(
        torch.tensor(1.0, dtype=torch.bfloat16)).item()


def test_in_place_and_no_launch_on_cpu():
    y = _output(torch.bfloat16)
    bias = torch.ones(16, dtype=torch.bfloat16)
    before = cuda_epilogue.launches
    out = cuda_epilogue.bias_act(y, bias, "mish")
    assert out is y
    assert cuda_epilogue.launches == before
    assert torch.equal(y, _chain(_output(torch.bfloat16), bias, "mish"))


def test_unknown_activation_raises():
    y = _output(torch.float32)
    with pytest.raises(ValueError):
        cuda_epilogue.bias_act(y, torch.zeros(16), "relu")


def test_check_accepts_the_kernels_inputs():
    for dtype in DTYPES:
        y = _output(dtype, c=32)
        cuda_epilogue.check(y, torch.zeros(32, dtype=dtype), "leaky")
    # one pixel: contiguous in both layouts
    cuda_epilogue.check(torch.zeros(3, 8, 1, 1), torch.zeros(8), "mish")


@pytest.mark.parametrize("case", ["nchw", "c12", "bias_len", "bias_dtype",
                                  "bias_strided", "int8", "3d", "act",
                                  "unaligned"])
def test_check_raises(case):
    y = _output(torch.float32)
    bias = torch.zeros(16)
    act = "mish"
    if case == "nchw":
        y = y.contiguous()
    elif case == "c12":
        y = _output(torch.float32, c=12)
        bias = torch.zeros(12)
    elif case == "bias_len":
        bias = torch.zeros(8)
    elif case == "bias_dtype":
        bias = torch.zeros(16, dtype=torch.bfloat16)
    elif case == "bias_strided":
        bias = torch.zeros(32)[::2]
    elif case == "int8":
        y = y.to(torch.int8)
    elif case == "3d":
        y = y[0]
    elif case == "act":
        act = "relu"
    elif case == "unaligned":
        # a channels-last view 4 bytes into its storage
        y = torch.zeros(2 * 16 * 6 * 6 + 1)[1:].view(2, 6, 6, 16) \
            .permute(0, 3, 1, 2)
        assert y.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        cuda_epilogue.check(y, bias, act)


def _heads(model, folded, x, conv=None, monkeypatch=None):
    if conv is not None:
        monkeypatch.setattr(yolov4.YoloV4, "_conv", conv)
    with torch.no_grad():
        return model.heads(model.features(x, folded), folded)


def test_folded_forward_goes_through_the_epilogue(monkeypatch):
    """The f32 folded forward at input 64: every ConvBN's output passes
    through bias_act once (72 Mish, 35 leaky), and the raw heads equal
    those of the chain written out (the conv without its bias, the bias
    add, the activation) bit for bit; and those of the old _conv, which
    passed the bias to F.conv2d, to 5e-4 (oneDNN adds the bias inside some
    CPU convs, an ulp off the separate add; over 107 layers and the heads'
    logit gain of 8 that reads ~6e-5 on these frames)."""
    model = weights.load_module(
        yolov4.YoloV4(yolov4.YoloV4Config(input_size=64)),
        weights.expand_yolov4_recipe(
            checkpoint.load_npz_tree(RECIPE)["params"]["recipe"])).eval()
    folded = yolov4.fold(model)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator()
                   .manual_seed(2))
    calls = []
    bias_act = cuda_epilogue.bias_act

    def counted(y, bias, act):
        calls.append(act)
        return bias_act(y, bias, act)

    monkeypatch.setattr(cuda_epilogue, "bias_act", counted)
    got = _heads(model, folded, x)
    assert calls.count("mish") == 72 and calls.count("leaky") == 35
    assert len(calls) == 107

    def written_out(self, l, x, folded):
        w, b = folded[l.name]
        return _chain(F.conv2d(x, w, None, l.stride, l.size // 2), b, l.act)

    def old_conv(self, l, x, folded):
        w, b = folded[l.name]
        y = F.conv2d(x, w, b, l.stride, l.size // 2)
        return layers.mish(y) if l.act == "mish" else F.leaky_relu(y, 0.1)

    want = _heads(model, folded, x, written_out, monkeypatch)
    old = _heads(model, folded, x, old_conv, monkeypatch)
    assert len(calls) == 107
    for g, w, o in zip(got, want, old):
        assert torch.equal(g, w)
        torch.testing.assert_close(g, o, rtol=0, atol=5e-4)


def test_conv_outputs_at_416():
    """The 107 ConvBN outputs at 416, a frame in bf16: the Mish convs' 88.8
    MB and the leaky convs' 16.5 MB (2 x their sum at 128 frames, over
    3.35 TB/s, is the epilogue's byte bound of 8.05 ms a tick); the heads'
    inputs at 52, 26 and 13."""
    layers_ = yolov4.darknet_layers()
    side = yolov4.out_sides(layers_, 416)
    mb = {"mish": 0, "leaky": 0}
    specs = yolov4.conv_specs()
    for _, _, c_out, _, _, act, i in specs:
        if act != "linear":
            mb[act] += 2 * c_out * side[i] ** 2
    assert mb == {"mish": 88777728, "leaky": 16526848}
    assert [side[i] for _, _, _, _, _, act, i in specs
            if act == "linear"] == [52, 26, 13]
    assert side[0] == 416 and side[yolov4.BACKBONE_END] == 13
    bound_ms = 2 * 128 * (mb["mish"] + mb["leaky"]) / 3.35e12 * 1e3
    assert 8.04 < bound_ms < 8.06
