"""YOLOv4 (CSPDarknet53 backbone, SPP, PANet neck, three YOLO heads) as a
torch module: darknet ``cfg/yolov4.cfg`` (github.com/AlexeyAB/darknet;
Bochkovskiy et al., arXiv:2004.10934) with ``classes`` from the config
(10, the node's taxonomy). The reference node ships this net as
``weights/yolov4_1_3_416_416_static.onnx``; the JAX package has no YOLOv4.

The layers, cfg section by section (darknet's layer index first; conv:
filters, size/stride, activation; every conv pads (size - 1) / 2 on each
side, darknet's ``pad=1``; "route a,b" concatenates the outputs of layers
a, b on channels in that order, one source passes it through; "shortcut"
adds layer i - 3's output, linear):

  CSPDarknet53, Mish on every conv (layers 0-104, 72 convs)
    0 conv 32 3/1            1 conv 64 3/2
    2 conv 64 1/1            3 route 1              4 conv 64 1/1
    5 conv 32 1/1            6 conv 64 3/1          7 shortcut 4
    8 conv 64 1/1            9 route 8,2           10 conv 64 1/1
   stage(c, n) at c = 128, 256, 512, 1024 and n = 2, 8, 8, 4, from its
   first layer i (11, 24, 55, 86):
    i conv c 3/2             i+1 conv c/2 1/1      i+2 route i
    i+3 conv c/2 1/1
    n residual blocks: conv c/2 1/1, conv c/2 3/1, shortcut (3 layers)
    j conv c/2 1/1 (j = i+4+3n)   j+1 route j,i+1   j+2 conv c 1/1
   so the stage outputs are layers 23 (128 ch), 54 (256), 85 (512) and
   104 (1024).
  SPP, leaky 0.1 from here on
  105 conv 512 1/1         106 conv 1024 3/1      107 conv 512 1/1
  108 maxpool 5/1          109 route 107          110 maxpool 9/1
  111 route 107            112 maxpool 13/1       113 route 112,110,108,107
  PANet, top-down
  114 conv 512 1/1         115 conv 1024 3/1      116 conv 512 1/1
  117 conv 256 1/1         118 upsample 2         119 route 85
  120 conv 256 1/1         121 route 120,118
  122-126 conv 256 1/1, 512 3/1, 256 1/1, 512 3/1, 256 1/1
  127 conv 128 1/1         128 upsample 2         129 route 54
  130 conv 128 1/1         131 route 130,128
  132-136 conv 128 1/1, 256 3/1, 128 1/1, 256 3/1, 128 1/1
  PANet, bottom-up, and the heads (1x1, bias, linear; 3 x (5 + classes))
  137 conv 256 3/1         138 head (stride 8)    139 yolo 0,1,2
  140 route 136            141 conv 256 3/2       142 route 141,126
  143-147 conv 256 1/1, 512 3/1, 256 1/1, 512 3/1, 256 1/1
  148 conv 512 3/1         149 head (stride 16)   150 yolo 3,4,5
  151 route 147            152 conv 512 3/2       153 route 152,116
  154-158 conv 512 1/1, 1024 3/1, 512 1/1, 1024 3/1, 512 1/1
  159 conv 1024 3/1        160 head (stride 32)   161 yolo 6,7,8

110 convs: 107 conv + BatchNorm + activation blocks (``ConvBN_0`` ..
``ConvBN_106`` in cfg order) and the three heads (``head_52``,
``head_26``, ``head_13``: their grid at 416). The YOLO layers: anchors
(12,16) (19,36) (40,28) | (36,75) (76,55) (72,146) | (142,110) (192,243)
(459,401), ``scale_x_y`` 1.2 / 1.1 / 1.05; 10647 anchors at 416, the
stride-8 head first (the node's ONNX export concatenates them so), each
head anchor-major then row-major (ops/decode.decode_head).

Mish is x * tanh(softplus(x)) (layers.mish). The padding is darknet's
symmetric (k - 1) / 2, not the flax SAME (0, 1) that the tiny net copies
from the JAX package: there is no JAX twin, so this net follows the
published model. Public inputs are NHWC; the convs run NCHW on the
permuted (channels-last) tensor, as the tiny's do. The serving forward
takes the BatchNorms folded into the convs (``fold``: w * s and b - mean
* s, s = scale / sqrt(var + eps), in f32, then cast to the compute dtype):
each of the 107 convs runs without its bias, and one pass adds the bias
and applies Mish or leaky in place (ops/cuda_epilogue.bias_act: the
hand-written kernel on the card, bit for bit the bias add and activation
it replaces); without folded weights it runs the unfolded blocks.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import ieee_convs
from ..ops import cuda_epilogue
from ..ops.decode import decode_head
from ..utils import stats
from .layers import ConvBN, fold_bn

ANCHORS = np.array([[12, 16], [19, 36], [40, 28], [36, 75], [76, 55],
                    [72, 146], [142, 110], [192, 243], [459, 401]],
                   np.float32)
# per head, stride 8 first: (anchor mask, scale_x_y, stride, module name)
HEADS = (((0, 1, 2), 1.2, 8, "head_52"), ((3, 4, 5), 1.1, 16, "head_26"),
         ((6, 7, 8), 1.05, 32, "head_13"))
# the SPP max pools
SPP_SIZES = (5, 9, 13)
BACKBONE_END = 104              # the last backbone layer (darknet index)

# one darknet layer: kind ("conv", "head", "route", "shortcut", "maxpool",
# "upsample", "yolo"), filters, size, stride, activation, its sources
# (absolute layer indices; a yolo layer's: its anchor mask) and, for a conv
# or head, its module name
Layer = collections.namedtuple("Layer", "kind filters size stride act src "
                                        "name")


def darknet_layers(num_classes: int = 10) -> Tuple[Layer, ...]:
    """yolov4.cfg's 162 layers in order, as the module docstring lists
    them."""
    layers: List[Layer] = []
    n_conv = [0]

    def add(kind, filters=0, size=0, stride=1, act="", src=(), name=""):
        layers.append(Layer(kind, filters, size, stride, act, tuple(src),
                            name))

    def conv(filters, size, stride=1, act="mish"):
        add("conv", filters, size, stride, act, name=f"ConvBN_{n_conv[0]}")
        n_conv[0] += 1

    def route(*rel):
        i = len(layers)
        add("route", src=[r if r >= 0 else i + r for r in rel])

    def stage(c, c_part, c_inner, n):
        conv(c, 3, 2)
        first = len(layers)
        conv(c_part, 1)
        route(-2)
        conv(c_part, 1)
        for _ in range(n):
            conv(c_inner, 1)
            conv(c_part, 3)
            add("shortcut", src=[len(layers) - 3])
        conv(c_part, 1)
        route(-1, first)
        conv(c, 1)

    conv(32, 3)
    stage(64, 64, 32, 1)
    for c, n in ((128, 2), (256, 8), (512, 8), (1024, 4)):
        stage(c, c // 2, c // 2, n)
    assert len(layers) - 1 == BACKBONE_END

    def leaky(*convs):
        for filters, size in convs:
            conv(filters, size, act="leaky")

    leaky((512, 1), (1024, 3), (512, 1))
    for k, back in zip(SPP_SIZES, (-1, -2, -4)):
        if back != -1:
            route(back)
        add("maxpool", size=k)
    route(-1, -3, -5, -6)
    leaky((512, 1), (1024, 3), (512, 1), (256, 1))
    add("upsample", stride=2)
    route(85)
    leaky((256, 1))
    route(-1, -3)
    leaky((256, 1), (512, 3), (256, 1), (512, 3), (256, 1), (128, 1))
    add("upsample", stride=2)
    route(54)
    leaky((128, 1))
    route(-1, -3)
    leaky((128, 1), (256, 3), (128, 1), (256, 3), (128, 1))
    n_out = 3 * (5 + num_classes)
    for h, (mask, _, _, name) in enumerate(HEADS):
        if h:
            c = HEADS[h][2] * 32
            route(-4)
            conv(c // 2, 3, 2, act="leaky")
            route(-1, -16 if h == 1 else -37)
            leaky((c // 2, 1), (c, 3), (c // 2, 1), (c, 3), (c // 2, 1))
            leaky((c, 3))
        else:
            leaky((256, 3))
        add("head", n_out, 1, name=name)
        add("yolo", src=mask)
    return tuple(layers)


def out_channels(layers: Sequence[Layer]) -> List[int]:
    """Each layer's output channels, from a 3-channel input."""
    out: List[int] = []
    for i, l in enumerate(layers):
        if l.kind in ("conv", "head"):
            out.append(l.filters)
        elif l.kind == "route":
            out.append(sum(out[s] for s in l.src))
        elif l.kind == "yolo":
            out.append(0)
        else:
            out.append(out[i - 1])
    return out


def out_sides(layers: Sequence[Layer], size: int) -> List[int]:
    """Each layer's output side (height and width) at input `size`, a
    multiple of 32."""
    out: List[int] = []
    for i, l in enumerate(layers):
        prev = out[i - 1] if i else size
        if l.kind == "conv":
            out.append(prev // l.stride)
        elif l.kind == "upsample":
            out.append(prev * 2)
        elif l.kind == "route":
            out.append(out[l.src[0]])
        else:
            out.append(prev)
    return out


def conv_specs(num_classes: int = 10):
    """The 110 convs in cfg order: (name, c_in, c_out, size, stride, act,
    darknet layer index); act "linear" for a head."""
    layers = darknet_layers(num_classes)
    chans = out_channels(layers)
    specs = []
    for i, l in enumerate(layers):
        if l.kind in ("conv", "head"):
            c_in = 3 if i == 0 else chans[i - 1]
            specs.append((l.name, c_in, l.filters, l.size, l.stride,
                          l.act or "linear", i))
    return specs


def residual_ends(num_classes: int = 10) -> Tuple[str, ...]:
    """The ConvBN that ends each residual branch (the conv just before a
    shortcut)."""
    layers = darknet_layers(num_classes)
    return tuple(layers[i - 1].name for i, l in enumerate(layers)
                 if l.kind == "shortcut")


@dataclasses.dataclass(frozen=True)
class YoloV4Config:
    num_classes: int = 10
    input_size: int = 416


class YoloV4(nn.Module):
    """The 107 ConvBN blocks and three heads. ``forward`` is the unfolded
    net (BatchNorm after each conv); ``features`` and ``heads`` run either
    form."""

    def __init__(self, cfg: YoloV4Config = YoloV4Config()):
        super().__init__()
        self.cfg = cfg
        self.layers = darknet_layers(cfg.num_classes)
        for name, c_in, c_out, k, s, act, _ in conv_specs(cfg.num_classes):
            if act == "linear":
                setattr(self, name, nn.Conv2d(c_in, c_out, 1))
            else:
                setattr(self, name, ConvBN(c_in, c_out, k, s, act=act))
        self._free = _free_after(self.layers)
        for mask, _, _, name in HEADS:
            self.register_buffer(f"anchors_{name[5:]}",
                                 torch.as_tensor(ANCHORS[list(mask)]),
                                 persistent=False)

    def forward(self, x: torch.Tensor):
        """NHWC input -> the three raw heads, NHWC f32, stride 8 first
        (the unfolded net)."""
        return self.heads(self.features(x, None), None)

    def features(self, x: torch.Tensor, folded):
        """The backbone and the neck (SPP, PANet) on NHWC x in its dtype,
        each in a span of the recorder: [(head name, its input)], stride
        8 first. folded: fold()'s {name: (w, b)}, or None for the
        unfolded blocks."""
        x = x.permute(0, 3, 1, 2)
        outs: List[torch.Tensor | None] = []
        taps: List[Tuple[str, torch.Tensor]] = []
        with stats.span("detect_backbone"):
            x = self._layers(0, BACKBONE_END + 1, x, outs, taps, folded)
        with stats.span("detect_neck"):
            self._layers(BACKBONE_END + 1, len(self.layers), x, outs, taps,
                         folded)
        return taps

    def _layers(self, lo: int, hi: int, x, outs, taps, folded):
        """Layers lo..hi-1: each output kept until its last reader ran; a
        head's input goes to taps, the head itself waits for heads()."""
        for i in range(lo, hi):
            l = self.layers[i]
            y = None
            if l.kind == "conv":
                y = self._conv(l, x, folded)
            elif l.kind == "head":
                taps.append((l.name, x))
            elif l.kind == "route":
                parts = [outs[s] for s in l.src]
                y = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            elif l.kind == "shortcut":
                y = x + outs[l.src[0]]
            elif l.kind == "maxpool":
                y = F.max_pool2d(x, l.size, 1, l.size // 2)
            elif l.kind == "upsample":
                y = F.interpolate(x, scale_factor=2, mode="nearest")
            outs.append(y)
            for j in self._free.get(i, ()):
                outs[j] = None
            if y is not None:
                x = y
        return x

    def heads(self, taps, folded):
        """The three 1x1 heads on their inputs -> raw NHWC maps in f32,
        the bias added in the compute dtype."""
        out = []
        for name, x in taps:
            w, b = (folded[name] if folded is not None else
                    (getattr(self, name).weight, getattr(self, name).bias))
            y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype))
            out.append(y.float().permute(0, 2, 3, 1))
        return out

    def _conv(self, l: Layer, x: torch.Tensor, folded) -> torch.Tensor:
        if folded is None:
            return getattr(self, l.name)(x, pad=l.size // 2)
        w, b = folded[l.name]
        y = F.conv2d(x, w, None, l.stride, l.size // 2)
        return cuda_epilogue.bias_act(y, b, l.act)


def _free_after(layers: Sequence[Layer]):
    """{layer i: the earlier outputs that no layer after i reads}. A
    conv, head, max pool, upsample or shortcut reads the layer before it
    (a shortcut also its source), a route its sources, a yolo layer
    nothing."""
    last = {}
    for i, l in enumerate(layers):
        srcs = list(l.src) if l.kind in ("route", "shortcut") else []
        if l.kind not in ("route", "yolo"):
            srcs.append(i - 1)
        for s in srcs:
            if s >= 0:
                last[s] = i
    out = {}
    for j, i in last.items():
        out.setdefault(i, []).append(j)
    return out


@torch.no_grad()
def fold(model: YoloV4, dtype=torch.float32):
    """{name: (weight, bias)} of every conv in `dtype`: a ConvBN's
    BatchNorm folded in f32 (layers.fold_bn), a head's own weight and
    bias."""
    out = {}
    for name, _, _, _, _, act, _ in conv_specs(model.cfg.num_classes):
        m = getattr(model, name)
        if act == "linear":
            w, b = m.weight, m.bias
        else:
            s, b = fold_bn(m.BatchNorm_0)
            w = m.Conv_0.weight * s[:, None, None, None]
        out[name] = (w.detach().to(dtype).contiguous(memory_format=
                                                     torch.channels_last),
                     b.detach().to(dtype))
    return out


def decode(model: YoloV4, heads):
    """The three raw heads (B, H, W, 3 * (5 + C)), stride 8 first ->
    (boxes (B, N, 4) normalized xyxy, confs (B, N, C)), in that order."""
    cfg = model.cfg
    out = [decode_head(raw, getattr(model, f"anchors_{name[5:]}"),
                       cfg.input_size, cfg.num_classes, scale)
           for raw, (_, scale, _, name) in zip(heads, HEADS)]
    return (torch.cat([b for b, _ in out], 1),
            torch.cat([c for _, c in out], 1))


@ieee_convs()
def forward(model: YoloV4, images: torch.Tensor, dtype=torch.float32,
            folded=None):
    """images (B, S, S, 3) in [0, 1] -> (boxes (B, N, 4), confs (B, N, C))
    in f32: the net in `dtype` (its f32 convs in IEEE f32), on fold()'s
    weights where given, then the three heads' decode (in the heads'
    span)."""
    taps = model.features(images.to(dtype), folded)
    with stats.span("detect_heads"):
        return decode(model, model.heads(taps, folded))
