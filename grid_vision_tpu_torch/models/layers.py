"""Shared layers of the two nets: flax-compatible SAME padding, inference
BatchNorm and the conv + BN + activation block.

The compute dtype is the activation's: an f32 input runs in f32, a bf16
input in the JAX package's bf16 mode (flax modules with dtype=bf16, as XLA
compiles them): conv operands rounded to bf16 with f32 sums, BatchNorm on
those sums in f32 as flax's _normalize does ((x - mean) * (rsqrt(var +
eps) * scale) + bias, not the folded x * s + b) and rounded to bf16 once,
the activation on the bf16 value (flax's leaky slope rounded to bf16). On
the card the convs are cuDNN's bf16 convs, whose output is rounded to bf16
before the BatchNorm.

In train mode (``module.train()``) BatchNorm normalizes with the batch's
own statistics as flax's train-mode BatchNorm does (below) and keeps the
new running statistics aside for the trainer (``new_batch_stats``).

Module attribute names follow the flax parameter tree (``Conv_0``,
``BatchNorm_0``) so a flax path maps onto a state-dict key one to one
(models/weights.params_from_jax); ``flax_init`` draws flax's init of
that tree from the same key.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import prng

BN_EPS = 1e-5                       # flax nn.BatchNorm's default epsilon
_SLOPE = 0.1                        # leaky (flax rounds it to bf16 there)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           round_out: bool = True) -> torch.Tensor:
    """F.conv2d in the input's dtype. bf16 (flax's bf16 Conv as XLA
    compiles it): operands rounded to bf16, f32 sums, the bias rounded to
    bf16 and added, the result rounded to bf16 once; round_out=False keeps
    the sums for a consumer that rounds (the BatchNorm of ConvBN). On the
    card the sums are cuDNN's bf16 conv, whose output is already rounded."""
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, bias, stride=stride)
    w = weight.to(x.dtype)
    if x.is_cuda:
        y = F.conv2d(x, w, stride=stride)
    else:
        y = F.conv2d(x.float(), w.float(), stride=stride)
    if bias is not None:
        y = y + bias.to(x.dtype).to(y.dtype)[:, None, None]
    return y.to(x.dtype) if round_out else y


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding (lo, hi) of one axis. For a 3x3/s2 conv on
    an even input it is (0, 1), not the (1, 1) of padding=1."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
                bias: torch.Tensor | None = None, block: int = 1,
                round_out: bool = True) -> torch.Tensor:
    """NCHW conv with SAME padding. block > 1: the padding is computed on a
    grid of block x block pixel blocks and scaled to pixels (the folded s2d
    stem of the orientation net); weight is then (F, C, k*block, k*block)
    and stride is in pixels."""
    kh = weight.shape[-1] // block
    sh = stride // block
    py = same_pad(x.shape[2] // block, kh, sh)
    px = same_pad(x.shape[3] // block, kh, sh)
    x = F.pad(x, (px[0] * block, px[1] * block, py[0] * block, py[1] * block))
    return conv2d(x, weight, bias, stride, round_out)


def s2d_conv(x: torch.Tensor, weight: torch.Tensor,
             round_out: bool = True) -> torch.Tensor:
    """A 3x3/s2 SAME conv on an even-sized NCHW input as space-to-depth(2)
    and a 2x2/s1 conv: x[2p + dy, 2q + dx] lies in phase (dy % 2, dx % 2)
    at offset (dy // 2, dx // 2), so the (F, C, 3, 3) kernel maps onto a
    (F, 4C, 2, 2) one over the four phase images (channel (py * 2 + px) * C
    + c; the (odd, offset 1) quarter is zero). flax's SAME padding, (0, 1),
    falls on the high edge of the even phases."""
    b, c, h, w = x.shape
    w2 = weight.new_zeros((weight.shape[0], 4 * c, 2, 2))
    for dy in range(3):
        for dx in range(3):
            ci = ((dy % 2) * 2 + dx % 2) * c
            w2[:, ci:ci + c, dy // 2, dx // 2] = weight[:, :, dy, dx]
    xs = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    xs = xs.reshape(b, 4 * c, h // 2, w // 2)
    return conv2d(F.pad(xs, (0, 1, 0, 1)), w2, round_out=round_out)


class BatchNorm(nn.Module):
    """BatchNorm with flax's parameters: weight (flax ``scale``), bias,
    running_mean / running_var (flax ``batch_stats``). momentum is flax's:
    the new running value is momentum * old + (1 - momentum) * batch."""

    def __init__(self, features: int, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = momentum
        self.new_stats = None

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """BN of x in `dtype` (default x's): f32 as F.batch_norm, bf16 as
        flax's _normalize in f32, rounded to bf16 once. In train mode with
        the batch's statistics (train_forward)."""
        dtype = dtype or x.dtype
        if self.training:
            return self.train_forward(x, dtype)
        if dtype != torch.float32:
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            y = ((x.float() - self.running_mean.view(shape))
                 * mul.view(shape) + self.bias.view(shape))
            return y.to(dtype)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)

    def train_forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """flax's train-mode BatchNorm: mean and E[x^2] over (N, H, W) in
        f32 whatever x's dtype, the biased variance E[x^2] - mean^2 clipped
        at 0, (x - mean) * (rsqrt(var + eps) * scale) + bias rounded to
        `dtype` once; gradients flow through the statistics. The new running
        statistics (momentum * running + (1 - momentum) * batch; the biased
        variance, not F.batch_norm's unbiased one) wait in new_stats for
        new_batch_stats."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        m = self.momentum
        with torch.no_grad():
            self.new_stats = (m * self.running_mean + (1.0 - m) * mean,
                              m * self.running_var + (1.0 - m) * var)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(dtype)


def new_batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics that module's last train-mode forward
    computed, as state-dict entries (flax's mutated ``batch_stats``); each
    BatchNorm's pending values are taken (cleared)."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm) and m.new_stats is not None:
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = \
                m.new_stats
            m.new_stats = None
    return out


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose stddev divides by the stddev of a standard normal cut at +-2
_TRUNC_STD = np.float32(.87962566103423978)


@torch.no_grad()
def flax_init(module: nn.Module, key: torch.Tensor) -> nn.Module:
    """flax's init of module's parameter tree from the key given to
    ``model.init`` (module on key's device): every conv and dense kernel
    lecun-normal (a truncated normal in flax's (kh, kw, in, out) or
    (in, out) layout, times sqrt(1 / fan_in) / 0.8796), biases zero,
    BatchNorm the identity. A parameter's key follows flax's rng tree: the
    key folded in once with the SHA-1 of its module path and the scope's
    call counter (LazyRng; a kernel is its scope's first parameter, 1)."""
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        if leaf == "weight" and p.dim() > 1:
            flax_shape = ((p.shape[2], p.shape[3], p.shape[1], p.shape[0])
                          if p.dim() == 4 else (p.shape[1], p.shape[0]))
            var = np.float32(1.0 / math.prod(flax_shape[:-1]))
            std = float(np.sqrt(var) / _TRUNC_STD)
            w = prng.truncated_normal(prng.fold_in_str(key, *mods, 1),
                                      -2.0, 2.0, flax_shape) * std
            p.copy_(w.permute(3, 2, 0, 1) if p.dim() == 4 else w.T)
        elif leaf == "weight":                     # BatchNorm scale
            p.fill_(1.0)
        else:
            p.zero_()
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


def fold_bn(bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> per-channel (scale, shift) in f32."""
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias.detach() - bn.running_mean * scale


class ConvBN(nn.Module):
    """Conv (no bias, SAME) + BatchNorm + activation, NCHW, in the input's
    dtype. act: "leaky" (slope 0.1, the detector) or "relu" (the
    orientation net).

    block > 1 (the orientation net's s2d_fold stem): the input is the RAW
    (N, C, H, W) image, Conv_0 holds the canonical post-space-to-depth
    (F, C*block*block, k, k) kernel, and the conv runs as the exact
    equivalent (k*block)-square conv at stride*block on the raw pixels. A
    call may pass its own block (1: the unfolded stem on the repacked
    image), as the parameter is the same either way."""

    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 stride: int = 1, act: str = "leaky", block: int = 1,
                 momentum: float = 0.9):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in * block * block, features, kernel,
                                stride, bias=False)
        self.BatchNorm_0 = BatchNorm(features, momentum)
        self.stride = stride
        self.act = act
        self.block = block

    def conv_weight(self, block: int | None = None) -> torch.Tensor:
        w = self.Conv_0.weight
        b = self.block if block is None else block
        if b == 1:
            return w
        f, cbb, k, _ = w.shape
        cin = cbb // (b * b)
        # s2d input channel index is (py*b + px)*C + c
        hwio = w.permute(2, 3, 1, 0).reshape(k, k, b, b, cin, f)
        big = hwio.permute(0, 2, 1, 3, 4, 5).reshape(k * b, k * b, cin, f)
        return big.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, block: int | None = None,
                s2d: bool = False) -> torch.Tensor:
        """block: the stem's fold for this call (default the module's).
        s2d: a 3x3/s2 conv on an even-sized input runs as s2d_conv (the
        detector's detector_s2d_stem; the same math)."""
        dtype = x.dtype
        b = self.block if block is None else block
        w = self.conv_weight(b)
        if (s2d and self.stride == 2 and w.shape[-1] == 3 and b == 1
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
            x = s2d_conv(x, w, round_out=False)
        else:
            x = conv2d_same(x, w, self.stride * b, block=b, round_out=False)
        x = self.BatchNorm_0(x, dtype)
        if self.act != "leaky":
            return F.relu(x)
        if x.dtype == torch.float32:
            return F.leaky_relu(x, _SLOPE)
        return torch.where(x >= 0, x,
                           x * torch.full((), _SLOPE, dtype=x.dtype,
                                          device=x.device))
