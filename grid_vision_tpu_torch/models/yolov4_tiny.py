"""YOLOv4-tiny (CSPOSANet backbone, two YOLO heads) as a torch module
(counterpart of grid_vision_tpu/models/yolov4_tiny.py; reference
object_detection.cpp:41-91).

The output contract is the JAX package's: for a 416 input, boxes (2535, 4)
normalized xyxy and confs (2535, 10) = sigmoid(obj) * sigmoid(cls), the
13-grid head first, anchor-major. Public inputs are NHWC like the JAX
package; the convs run NCHW inside. Module names follow the flax tree
(ConvBN_0..9, CSPBlock_0..2, head_13, head_26) so shipped npz weights load
key for key, and ``init_params`` draws flax's init. In train mode
(``model.train()``) every BatchNorm uses the batch's statistics with the
JAX package's momentum of 0.9 (models/layers.BatchNorm).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import ieee_convs
from .layers import ConvBN, conv2d, flax_init

# darknet yolov4-tiny anchors (pixels at 416); head masks (3,4,5)/(1,2,3).
ANCHORS = np.array([[10, 14], [23, 27], [37, 58],
                    [81, 82], [135, 169], [344, 319]], np.float32)
HEAD_MASKS = ((3, 4, 5), (1, 2, 3))
SCALE_XY = 1.05


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 10
    input_size: int = 416
    # the trainer's compute dtype (the JAX package's YoloConfig default);
    # the serving pipeline passes its own (GridVisionConfig.compute_dtype)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def num_anchors_total(self) -> int:
        s = self.input_size
        return 3 * ((s // 32) ** 2 + (s // 16) ** 2)


class CSPBlock(nn.Module):
    """split -> two 3x3 convs -> partial concat -> 1x1 transition -> full
    concat; returns (2*ch output, the 1x1 transition tap)."""

    def __init__(self, ch: int):
        super().__init__()
        half = ch // 2
        self.half = half
        self.ConvBN_0 = ConvBN(half, half, 3)
        self.ConvBN_1 = ConvBN(half, half, 3)
        self.ConvBN_2 = ConvBN(ch, ch, 1)

    def forward(self, x):
        x1 = self.ConvBN_0(x[:, self.half:])
        x2 = self.ConvBN_1(x1)
        x3 = self.ConvBN_2(torch.cat([x2, x1], dim=1))
        return torch.cat([x, x3], dim=1), x3


class YoloV4Tiny(nn.Module):
    """Backbone + FPN + 2 raw heads. forward: NHWC in [0, 1] -> two raw
    NHWC head maps. stem_external=True: the input is the post-ConvBN_1
    (B, S/4, S/4, 64) NHWC activation of the fused stem kernel
    (ops/cuda_stem.py), which reads ConvBN_0/1's weights itself.
    front_external=True: the input is the post-first-max-pool
    (B, S/8, S/8, 128) activation of the CSP-stage kernel
    (ops/cuda_csp.py), which also ran ConvBN_2, CSPBlock_0 and the pool.
    s2d_stem=True: ConvBN_0 and ConvBN_1 (3x3/s2) run as space-to-depth
    and a 2x2 conv (layers.s2d_conv; the same math and parameters; the
    JAX package's YoloConfig.s2d_stem).
    The net computes in its input's dtype (f32, or bf16 as the JAX
    package's compute_dtype="bfloat16"); the heads come back in f32."""

    def __init__(self, cfg: YoloConfig = YoloConfig()):
        super().__init__()
        self.cfg = cfg
        n_out = 3 * (5 + cfg.num_classes)
        self.ConvBN_0 = ConvBN(3, 32, 3, 2)
        self.ConvBN_1 = ConvBN(32, 64, 3, 2)
        self.ConvBN_2 = ConvBN(64, 64, 3)
        self.CSPBlock_0 = CSPBlock(64)
        self.ConvBN_3 = ConvBN(128, 128, 3)
        self.CSPBlock_1 = CSPBlock(128)
        self.ConvBN_4 = ConvBN(256, 256, 3)
        self.CSPBlock_2 = CSPBlock(256)
        self.ConvBN_5 = ConvBN(512, 512, 3)
        self.ConvBN_6 = ConvBN(512, 256, 1)
        self.ConvBN_7 = ConvBN(256, 512, 3)
        self.head_13 = nn.Conv2d(512, n_out, 1)
        self.ConvBN_8 = ConvBN(256, 128, 1)
        self.ConvBN_9 = ConvBN(384, 256, 3)
        self.head_26 = nn.Conv2d(256, n_out, 1)
        # each head's (3, 2) anchors on the net's device, so the decode
        # copies nothing from the host (a constant of the net: not saved)
        for name, mask in zip(("anchors_13", "anchors_26"), HEAD_MASKS):
            self.register_buffer(name, torch.as_tensor(ANCHORS[list(mask)]),
                                 persistent=False)

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """ConvBN_2 + CSPBlock_0 + the first 2x2 max pool, NCHW: what the
        CSP-stage kernel computes."""
        x, _ = self.CSPBlock_0(self.ConvBN_2(x))
        return F.max_pool2d(x, 2, 2)

    def forward(self, x: torch.Tensor, stem_external: bool = False,
                front_external: bool = False, s2d_stem: bool = False):
        x = x.permute(0, 3, 1, 2)
        if not front_external:
            if not stem_external:
                x = self.ConvBN_0(x, s2d=s2d_stem)
                x = self.ConvBN_1(x, s2d=s2d_stem)          # 104
            x = self.front(x)                               # 52, 128ch
        x = self.ConvBN_3(x)
        x, _ = self.CSPBlock_1(x)
        x = F.max_pool2d(x, 2, 2)                           # 26, 256ch
        x = self.ConvBN_4(x)
        x, fpn_tap = self.CSPBlock_2(x)
        x = F.max_pool2d(x, 2, 2)                           # 13, 512ch
        x = self.ConvBN_5(x)
        neck = self.ConvBN_6(x)
        head1 = self._head(self.head_13, self.ConvBN_7(neck))
        up = F.interpolate(self.ConvBN_8(neck), scale_factor=2,
                           mode="nearest")
        h2 = self.ConvBN_9(torch.cat([up, fpn_tap], dim=1))
        head2 = self._head(self.head_26, h2)
        return head1.permute(0, 2, 3, 1), head2.permute(0, 2, 3, 1)

    @staticmethod
    def _head(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 head conv with its bias in the compute dtype, as f32."""
        return conv2d(x, conv.weight, conv.bias).float()


def decode_head(raw: torch.Tensor, anchors: torch.Tensor, input_size: int,
                num_classes: int):
    """One head (B, H, W, 3*(5+C)) -> boxes (B, 3*H*W, 4) normalized xyxy
    and confs (B, 3*H*W, C), flattened anchor-major then row-major."""
    b, h, w, _ = raw.shape
    a = anchors.shape[0]
    raw = raw.reshape(b, h, w, a, 5 + num_classes).permute(0, 3, 1, 2, 4)
    dev = raw.device
    grid_y, grid_x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    s = SCALE_XY
    bx = (torch.sigmoid(raw[..., 0]) * s - 0.5 * (s - 1.0) + grid_x) / w
    by = (torch.sigmoid(raw[..., 1]) * s - 0.5 * (s - 1.0) + grid_y) / h
    an_w = anchors[:, 0][None, :, None, None] / input_size
    an_h = anchors[:, 1][None, :, None, None] / input_size
    bw = torch.exp(raw[..., 2]) * an_w
    bh = torch.exp(raw[..., 3]) * an_h
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                        dim=-1)
    confs = torch.sigmoid(raw[..., 4])[..., None] * torch.sigmoid(raw[..., 5:])
    n = a * h * w
    return boxes.reshape(b, n, 4), confs.reshape(b, n, num_classes)


def decode(model: YoloV4Tiny, head1: torch.Tensor, head2: torch.Tensor):
    """Both heads of `model` -> (B, N, 4) boxes + (B, N, C) confs, 13-grid
    first."""
    cfg = model.cfg
    b1, c1 = decode_head(head1, model.anchors_13, cfg.input_size,
                         cfg.num_classes)
    b2, c2 = decode_head(head2, model.anchors_26, cfg.input_size,
                         cfg.num_classes)
    return torch.cat([b1, b2], dim=1), torch.cat([c1, c2], dim=1)


def init_params(key: torch.Tensor, cfg: YoloConfig = YoloConfig()
                ) -> YoloV4Tiny:
    """flax's ``YoloV4Tiny(cfg).init(key, ...)`` as a module on key's
    device (layers.flax_init: the same tree, leaf for leaf)."""
    return flax_init(YoloV4Tiny(cfg).to(key.device), key)


@ieee_convs()
def forward(model: YoloV4Tiny, images: torch.Tensor,
            stem_external: bool = False, front_external: bool = False,
            dtype=torch.float32, s2d_stem: bool = False):
    """images (B, S, S, 3) in [0, 1] (or the stem / CSP-stage activation)
    -> (boxes (B, N, 4), confs (B, N, C)) in f32; the net computes in
    `dtype`, its f32 convs in IEEE f32 (device.ieee_convs)."""
    h1, h2 = model(images.to(dtype), stem_external, front_external, s2d_stem)
    return decode(model, h1, h2)
