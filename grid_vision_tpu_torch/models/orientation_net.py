"""The MultiBin 3D-box regression net (the VisionOrientation model) as a
torch module (counterpart of grid_vision_tpu/models/orientation_net.py; I/O
contract of the reference's TensorRT engine, vision_orientation.cpp:
192-239): standardized (N, S, S, 3) crops -> orientation (N, 2, 2) cos/sin
per bin, bin confidence (N, 2), dimension residuals (N, 3).

The port has the "s2d" arch: a space-to-depth(4) stem conv (with
s2d_fold=True, the serving default, run as the exact equivalent 12x12/s8
conv on raw crops; with s2d_fold=False, the form the JAX trainer builds,
the repack then a 3x3/s2 conv), then a stride-2 conv ladder down to 7 (or
less), one stride-1 conv, global mean, and the three MultiBin heads. Names
follow the flax tree (ConvBN_i, MultiBinHeads_0), the same either way, and
``init_params`` draws flax's init. Every BatchNorm has flax's default
momentum of 0.99 (train mode, models/layers.BatchNorm).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..device import ieee_convs
from .layers import ConvBN, flax_init

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
        if cfg.arch != "s2d":
            raise NotImplementedError(
                "the torch port has the s2d arch only")
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

    def forward(self, x: torch.Tensor, stem_external: bool = False):
        """x: (N, S, S, 3) standardized crops (NHWC), or with stem_external
        ConvBN_0's (N, S/8, S/8, 4w) output (the orientation-front kernel,
        ops/cuda_orient.py); the parameter tree is the same either way. The
        convs compute in x's dtype; the pooled features go to the heads in
        f32 (in bf16 the pool is rounded to bf16 first, as jnp.mean of a
        bf16 array is)."""
        if not (stem_external or self.cfg.s2d_fold):
            x = space_to_depth(x, 4)
        x = x.permute(0, 3, 1, 2)
        for i in range(1 if stem_external else 0, self.n_conv):
            x = getattr(self, f"ConvBN_{i}")(x)
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        return self.MultiBinHeads_0(pooled)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/b, W/b, C*b*b) lossless repack; channel index
    (py*b + px)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                               c * block * block)


def init_params(key: torch.Tensor,
                cfg: OrientationConfig = OrientationConfig()
                ) -> OrientationNetS2D:
    """flax's ``make_model(cfg).init(key, ...)`` as a module on key's
    device (layers.flax_init: the same tree, leaf for leaf)."""
    return flax_init(OrientationNetS2D(cfg).to(key.device), key)


@ieee_convs()
def forward(model: OrientationNetS2D, crops: torch.Tensor,
            stem_external: bool = False, dtype=torch.float32):
    """crops (N, S, S, 3) (or ConvBN_0's output with stem_external) ->
    (orient (N, 2, 2), conf (N, 2), dims (N, 3)) in f32; the convs compute
    in `dtype`, f32 ones in IEEE f32 (device.ieee_convs)."""
    return model(crops.to(dtype), stem_external)
