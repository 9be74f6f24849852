"""The MultiBin 3D-box regression net (the VisionOrientation model) as a
torch module (counterpart of grid_vision_tpu/models/orientation_net.py; I/O
contract of the reference's TensorRT engine, vision_orientation.cpp:
192-239): standardized (N, S, S, 3) crops -> orientation (N, 2, 2) cos/sin
per bin, bin confidence (N, 2), dimension residuals (N, 3).

Two archs, as in the JAX package (``make_model``). "s2d" (the default): a
space-to-depth(4) stem conv (with s2d_fold=True, the serving default, run
as the exact equivalent 12x12/s8 conv on raw crops; with s2d_fold=False,
the form the JAX trainer builds, the repack then a 3x3/s2 conv; a forward
call may pick either, the parameter is the same), then a stride-2 conv
ladder down to 7 (or less), one stride-1 conv, global mean, and the three
MultiBin heads. "resnet": a ResNet-18 (7x7/s2 stem, 3x3/s2 max pool, four
stages of two ResBlocks) and the same heads, kept for checkpoints trained
against it. Names follow the flax tree (ConvBN_i / Conv_0, BatchNorm_0,
ResBlock_i, MultiBinHeads_0), and ``init_params`` draws flax's init. Every
BatchNorm has flax's default momentum of 0.99 (train mode,
models/layers.BatchNorm).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import ieee_convs
from .layers import BatchNorm, ConvBN, conv2d_same, flax_init, same_pad

_MOMENTUM = 0.99                    # flax nn.BatchNorm's default


@dataclasses.dataclass(frozen=True)
class OrientationConfig:
    bins: int = 2
    input_size: int = 224
    width: int = 64
    arch: str = "s2d"
    s2d_fold: bool = True
    # the trainer's compute dtype (the JAX package's default); the serving
    # pipeline passes its own (GridVisionConfig.orientation_compute)
    compute_dtype: torch.dtype = torch.bfloat16


class MultiBinHeads(nn.Module):
    """orientation (bins, 2) L2-normalized, bin confidence (bins,),
    dimension residuals (3,)."""

    def __init__(self, c_in: int, bins: int = 2):
        super().__init__()
        self.bins = bins
        self.orient_fc1 = nn.Linear(c_in, 256)
        self.orient_fc2 = nn.Linear(256, bins * 2)
        self.conf_fc1 = nn.Linear(c_in, 256)
        self.conf_fc2 = nn.Linear(256, bins)
        self.dim_fc1 = nn.Linear(c_in, 512)
        self.dim_fc2 = nn.Linear(512, 3)

    def forward(self, x):
        orient = self.orient_fc2(F.relu(self.orient_fc1(x)))
        orient = orient.reshape(x.shape[0], self.bins, 2)
        norm = torch.sqrt(torch.sum(orient * orient, dim=-1, keepdim=True))
        orient = orient / torch.clamp(norm, min=1e-8)
        conf = self.conf_fc2(F.relu(self.conf_fc1(x)))
        dims = self.dim_fc2(F.relu(self.dim_fc1(x)))
        return orient, conf, dims


class OrientationNetS2D(nn.Module):
    """Folded s2d(4) stem + stride-2 ladder with channels (4w, 8w, 8w...)."""

    def __init__(self, cfg: OrientationConfig = OrientationConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        stage_ch = (4 * w, 8 * w, 8 * w, 8 * w, 8 * w)
        # the stem's parameter is the post-s2d (F, 48, 3, 3) kernel either
        # way; folded, the conv reads the raw pixels in 4x4 blocks
        block = 4 if cfg.s2d_fold else 1
        self.ConvBN_0 = ConvBN(3 * 16 // block ** 2, stage_ch[0], 3, 2,
                               act="relu", block=block, momentum=_MOMENTUM)
        # spatial size after the stem: SAME on the 4-pixel block grid
        n = -(-(cfg.input_size // 4) // 2)
        c, i = stage_ch[0], 1
        while n > 7:
            f = stage_ch[min(i, len(stage_ch) - 1)]
            setattr(self, f"ConvBN_{i}", ConvBN(c, f, 3, 2, act="relu",
                                                momentum=_MOMENTUM))
            c, n, i = f, -(-n // 2), i + 1
        setattr(self, f"ConvBN_{i}", ConvBN(c, 8 * w, 3, 1, act="relu",
                                            momentum=_MOMENTUM))
        self.n_conv = i + 1
        self.MultiBinHeads_0 = MultiBinHeads(8 * w, cfg.bins)

    def forward(self, x: torch.Tensor, stem_external: bool = False,
                s2d_fold: bool | None = None):
        """x: (N, S, S, 3) standardized crops (NHWC), or with stem_external
        ConvBN_0's (N, S/8, S/8, 4w) output (the orientation-front kernel,
        ops/cuda_orient.py); the parameter tree is the same either way.
        s2d_fold: the stem's form for this call (default cfg.s2d_fold). The
        convs compute in x's dtype; the pooled features go to the heads in
        f32 (in bf16 the pool is rounded to bf16 first, as jnp.mean of a
        bf16 array is)."""
        fold = self.cfg.s2d_fold if s2d_fold is None else s2d_fold
        if not (stem_external or fold):
            x = space_to_depth(x, 4)
        x = x.permute(0, 3, 1, 2)
        if not stem_external:
            x = self.ConvBN_0(x, block=4 if fold else 1)
        for i in range(1, self.n_conv):
            x = getattr(self, f"ConvBN_{i}")(x)
        return self.MultiBinHeads_0(_pool(x))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """Global mean of NCHW features as f32 (in bf16 rounded to bf16 first,
    as jnp.mean of a bf16 array is)."""
    return x.float().mean(dim=(2, 3)).to(x.dtype).float()


class ResBlock(nn.Module):
    """3x3 conv (stride) + BN + relu -> 3x3 conv + BN, plus the input (a
    1x1 conv at stride + BN where the shapes differ), relu; NCHW in the
    input's dtype."""

    def __init__(self, c_in: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.Conv_0 = nn.Conv2d(c_in, features, 3, stride, bias=False)
        self.BatchNorm_0 = BatchNorm(features, _MOMENTUM)
        self.Conv_1 = nn.Conv2d(features, features, 3, bias=False)
        self.BatchNorm_1 = BatchNorm(features, _MOMENTUM)
        # the JAX block projects where residual.shape != y.shape: a stride
        # of 2 here always comes with doubled channels
        self.project = stride != 1 or c_in != features
        if self.project:
            self.Conv_2 = nn.Conv2d(c_in, features, 1, stride, bias=False)
            self.BatchNorm_2 = BatchNorm(features, _MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        y = conv2d_same(x, self.Conv_0.weight, self.stride, round_out=False)
        y = F.relu(self.BatchNorm_0(y, dtype))
        y = conv2d_same(y, self.Conv_1.weight, 1, round_out=False)
        y = self.BatchNorm_1(y, dtype)
        if self.project:
            x = conv2d_same(x, self.Conv_2.weight, self.stride,
                            round_out=False)
            x = self.BatchNorm_2(x, dtype)
        return F.relu(y + x)


class OrientationNet(nn.Module):
    """The "resnet" arch: 7x7/s2 conv + BN + relu, 3x3/s2 max pool (SAME,
    -inf padding), stages of width w * (1, 2, 4, 8) with two ResBlocks each
    (the first of stages 2-4 at stride 2), global mean, MultiBin heads."""

    def __init__(self, cfg: OrientationConfig = OrientationConfig()):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.Conv_0 = nn.Conv2d(3, w, 7, 2, bias=False)
        self.BatchNorm_0 = BatchNorm(w, _MOMENTUM)
        c = w
        for i, mult in enumerate((1, 2, 4, 8)):
            setattr(self, f"ResBlock_{2 * i}",
                    ResBlock(c, w * mult, 1 if i == 0 else 2))
            setattr(self, f"ResBlock_{2 * i + 1}", ResBlock(w * mult,
                                                            w * mult))
            c = w * mult
        self.MultiBinHeads_0 = MultiBinHeads(c, cfg.bins)

    def forward(self, x: torch.Tensor, stem_external: bool = False,
                s2d_fold: bool | None = None):
        """x: (N, S, S, 3) standardized crops (NHWC); the convs compute in
        x's dtype. The resnet has no external stem; s2d_fold does not
        apply to it (ignored, as the JAX net ignores it)."""
        if stem_external:
            raise ValueError("the resnet arch has no external stem")
        dtype = x.dtype
        x = x.permute(0, 3, 1, 2)
        x = conv2d_same(x, self.Conv_0.weight, 2, round_out=False)
        x = F.relu(self.BatchNorm_0(x, dtype))
        py, px = same_pad(x.shape[2], 3, 2), same_pad(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (px[0], px[1], py[0], py[1]),
                               value=float("-inf")), 3, 2)
        for i in range(8):
            x = getattr(self, f"ResBlock_{i}")(x)
        return self.MultiBinHeads_0(_pool(x))


def make_model(cfg: OrientationConfig) -> nn.Module:
    """The net of cfg.arch ("s2d" or "resnet")."""
    if cfg.arch == "s2d":
        return OrientationNetS2D(cfg)
    if cfg.arch == "resnet":
        return OrientationNet(cfg)
    raise ValueError(f"unknown orientation arch {cfg.arch!r}")


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, C*b*b) lossless repack; channel index
    (py*b + px)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               c * block * block)


def init_params(key: torch.Tensor,
                cfg: OrientationConfig = OrientationConfig()) -> nn.Module:
    """flax's ``make_model(cfg).init(key, ...)`` as a module on key's
    device (layers.flax_init: the same tree, leaf for leaf)."""
    return flax_init(make_model(cfg).to(key.device), key)


@ieee_convs()
def forward(model: nn.Module, crops: torch.Tensor,
            stem_external: bool = False, dtype=torch.float32,
            s2d_fold: bool | None = None):
    """crops (N, S, S, 3) (or ConvBN_0's output with stem_external) ->
    (orient (N, 2, 2), conf (N, 2), dims (N, 3)) in f32; the convs compute
    in `dtype`, f32 ones in IEEE f32 (device.ieee_convs). s2d_fold: the s2d
    stem's form (default the model's; GridVisionConfig.orientation_s2d_fold
    in the pipeline)."""
    return model(crops.to(dtype), stem_external, s2d_fold)
