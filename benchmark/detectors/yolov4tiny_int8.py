"""The plain reference of the int8 detector (the engine's
detector_precision="int8"): YOLOv4-tiny with its 19 ConvBNs quantized, in
plain torch and numpy. It imports nothing of the program; the float
weights are the shipped npz that reference.load_net reads (nets.det).

  - BatchNorm folds into each conv on the host in f32 numpy:
    s = scale / sqrt(var + eps), w * s, b = bias - mean * s.
  - The weights quantize to symmetric int8 per output channel:
    sw = max|w| / 127 (at least 1e-12), wq = clip(round(w / sw), +-127),
    numpy's round (half to even).
  - Each conv's input quantizes per sample: sx = max|x| over the sample
    times f32(1 / 127) (at least 1e-12), xq = clip(round(x / sx), +-127):
    a true division, rounded half to even.
  - The sums are exact: float64 convs of the integer codes (|acc| <= 127^2
    x 4608 < 2^27, every partial sum an integer below 2^53), rounded to
    the integer they are.
  - The requant: acc * (sx * sw) + b, then leaky 0.1 in f32.
  - The two 1x1 heads stay float (an f32 conv, then the bias), and the
    decode is the tiny net's (reference._decode_head).

Where this departs from a literal reading, it follows the arithmetic
that models/yolov4_int8.py states for the program (and the JAX package):
  - the accumulator is cast to f32 before the requant (exact below 2^24;
    above, rounded to f32's 24 bits), as the JAX package's astype does;
  - the requant's product is exact in float64 (24 + 24 bits) and its sum
    is rounded twice, to float64 and then to f32, where a fused
    multiply-add rounds once: the two differ only on a tie at f32's last
    bit;
  - the frames are resized one at a time, the longer x axis contracted
    first, then divided by 255, as the program's preprocess does (the
    float reference resizes the batch at once);
  - the layout is NCHW (the program's is NHWC): the same values; the
    heads read their input channels-last, as the program's do.

The float layers (the heads, and in a control the rest of the tick)
round as nets.mode says. The controls (control()): "int4" is this
detector with 7 levels in place of 127 (symmetric int4: the precision
below int8), every float layer and value in TF32; "float" is the float
net (reference.detect_dense) in f32, the quantization left out; any
other mode (the "fp8" control) is the float net in that mode's rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import counts
from benchmark import reference as ref

# the largest code: int8, and the int4 control's
QMAX, QMAX_INT4 = 127, 7
# the quantized convs: every ConvBN of the tiny net
LAYERS = tuple(f"ConvBN_{i}" for i in range(10)) + tuple(
    f"CSPBlock_{b}/ConvBN_{i}" for b in range(3) for i in range(3))


# model operations a frame: the tiny net's, quantized or not
detector_ops = counts.detector_ops


def quantize(det: dict, qmax: int) -> dict:
    """{layer: (wq (O, I, kh, kw) integer codes in float64, sw (O,) f32,
    b (O,) f32)} on det's device, from the float weights (load_net's
    OIHW), folded and quantized on the host in f32 numpy."""
    out = {}
    for name in LAYERS:
        g = {k: det[f"{name}/{k}"].cpu().numpy() for k in (
            "Conv_0/kernel", "BatchNorm_0/scale", "BatchNorm_0/bias",
            "BatchNorm_0/mean", "BatchNorm_0/var")}
        s = g["BatchNorm_0/scale"] / np.sqrt(g["BatchNorm_0/var"]
                                             + ref.BN_EPS)
        w = (g["Conv_0/kernel"] * s[:, None, None, None]).astype(np.float32)
        b = (g["BatchNorm_0/bias"] - g["BatchNorm_0/mean"] * s).astype(
            np.float32)
        sw = np.maximum(np.max(np.abs(w), axis=(1, 2, 3)) / float(qmax),
                        1e-12)
        wq = np.clip(np.round(w / sw[:, None, None, None]), -qmax, qmax)
        dev = det[f"{name}/Conv_0/kernel"].device
        out[name] = (torch.as_tensor(wq.astype(np.float64), device=dev),
                     torch.as_tensor(sw.astype(np.float32), device=dev),
                     torch.as_tensor(b, device=dev))
    return out


def _layers(nets, qmax: int) -> dict:
    """quantize(nets.det, qmax), once for each nets."""
    cache = nets.__dict__.setdefault("int8_layers", {})
    if qmax not in cache:
        cache[qmax] = quantize(nets.det, qmax)
    return cache[qmax]


def qconv(x: torch.Tensor, layer, stride: int, qmax: int) -> torch.Tensor:
    """x (B, C, H, W) f32 -> leaky_0.1(requant(the exact int conv of x's
    per-sample codes)), f32, SAME as flax pads."""
    wq, sw, b = layer
    inv = torch.full((), 1.0 / qmax, dtype=torch.float32, device=x.device)
    sx = torch.clamp(x.abs().amax(dim=(1, 2, 3), keepdim=True) * inv,
                     min=1e-12)
    xq = torch.clamp(torch.round(x / sx), -qmax, qmax).double()
    k = wq.shape[-1]
    py, px = (ref.same_pad(x.shape[2], k, stride),
              ref.same_pad(x.shape[3], k, stride))
    acc = torch.round(F.conv2d(F.pad(xq, (px[0], px[1], py[0], py[1])), wq,
                               stride=stride))
    scale = (sx * sw[None, :, None, None]).double()
    y = acc.float().double() * scale + b[None, :, None, None].double()
    return F.leaky_relu(y.float(), 0.1)


def _resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, 3, size, size) in [0, 1],
    one frame at a time."""
    h, w = images.shape[1:3]
    wy = torch.as_tensor(ref.axis_resize_weights(h, size),
                         device=images.device)
    wx = torch.as_tensor(ref.axis_resize_weights(w, size),
                         device=images.device)
    out = []
    for im in images:
        tmp = torch.einsum("jx,yxc->yjc", wx, im.float())
        out.append(torch.einsum("iy,yjc->ijc", wy, tmp) / 255.0)
    return torch.stack(out).permute(0, 3, 1, 2).contiguous()


def _head(nets, x: torch.Tensor, name: str) -> torch.Tensor:
    p = nets.det
    y = nets.conv(x.contiguous(memory_format=torch.channels_last),
                  p[f"{name}/kernel"], 1)
    return y + p[f"{name}/bias"][None, :, None, None]


def control(mode: str):
    """A Control mode -> (its detect_dense, reference.Nets's mode)."""
    if mode == "int4":
        return functools.partial(detect_dense, qmax=QMAX_INT4), "tf32"
    if mode == "float":
        return ref.detect_dense, "f32"
    return ref.detect_dense, mode


@torch.no_grad()
def detect_dense(nets, images: torch.Tensor, size: int, qmax: int = QMAX):
    """(B, H, W, 3) frames in [0, 255] -> every anchor's (boxes (B, A, 4)
    normalized xyxy, confs (B, A, C)), the 13-grid head first, as
    reference.detect_dense but with the ConvBNs quantized to +-qmax."""
    q = _layers(nets, qmax)

    def cb(name, x, stride=1):
        return qconv(x, q[name], stride, qmax)

    def csp(blk, x):
        half = x.shape[1] // 2
        p = f"CSPBlock_{blk}/ConvBN_"
        x1 = cb(p + "0", x[:, half:])
        x2 = cb(p + "1", x1)
        x3 = cb(p + "2", torch.cat([x2, x1], 1))
        return torch.cat([x, x3], 1), x3

    x = _resize(images, size)
    x = cb("ConvBN_1", cb("ConvBN_0", x, 2), 2)
    x, _ = csp(0, cb("ConvBN_2", x))
    x = F.max_pool2d(x, 2, 2)
    x, _ = csp(1, cb("ConvBN_3", x))
    x = F.max_pool2d(x, 2, 2)
    x, tap = csp(2, cb("ConvBN_4", x))
    x = F.max_pool2d(x, 2, 2)
    neck = cb("ConvBN_6", cb("ConvBN_5", x))
    h1 = _head(nets, cb("ConvBN_7", neck), "head_13")
    up = cb("ConvBN_8", neck).repeat_interleave(2, 2).repeat_interleave(2, 3)
    h2 = _head(nets, cb("ConvBN_9", torch.cat([up, tap], 1)), "head_26")
    b1, c1 = ref._decode_head(h1, ref.ANCHORS[13], size)
    b2, c2 = ref._decode_head(h2, ref.ANCHORS[26], size)
    return torch.cat([b1, b2], 1), torch.cat([c1, c2], 1)
