"""int8-quantized YOLOv4-tiny inference (counterpart of
grid_vision_tpu/models/yolov4_int8.py; GridVisionConfig(
detector_precision="int8", compat=False), an extension-mode knob).

BatchNorm folds into each conv, the weights quantize offline to symmetric
per-output-channel int8 (``quantize_detector``: on the host in f32 numpy,
as the JAX package does, so ``wq`` and ``sw`` are its bits), and each
conv's input quantizes at run time with a per-sample max-abs scale
(``_qconv``). The two 1x1 heads stay float, and the decode is the float
net's (yolov4_tiny.decode_head): the 2535-anchor output contract holds.

The int8 conv: on a CUDA tensor each conv is one launch of the
hand-written s8 implicit-GEMM kernel of ``ops/cuda_int8.py``
(``csrc/cuda_int8.cu``, the counterpart of tools/bench_int8_mxu.py's
Pallas GEMM): the taps brought from the NHWC int8 activation into shared
memory (by TMA im2col or tiled copies, or gathered; the route by
``cuda_int8.int8_plan``), exact int32 sums on the tensor cores (wgmma),
and in ``_qconv`` the requant and leaky in the kernel's epilogue
(``int8_conv_requant``, f32 out, 19 launches a forward); ``int8_conv``
writes the int32 accumulators.
``launches`` counts the kernel launches these convs make. On a CPU tensor,
and as the card's reference, the plain versions: ``int8_conv_plain``, the
same conv in float64 F.conv2d on the int8 values, exact (|acc| <= 127^2 *
4608 < 2^27), then ``requant``. ``tap_matrix`` (the (M, K) tap matrix
that torch._int_mm multiplies) is on no path: it is the library
yardstick's gather.

Rounding follows jitted XLA, which the JAX package's pipeline runs this
under: the requant ``acc.f32 * (sx * sw) + b`` is one fused multiply-add
(computed in float64, rounded once); ``max|x| / 127.0`` is a multiply by
the f32 reciprocal of 127 (XLA rewrites a division by a constant so);
``x / sx`` is a true division (sx is no constant; its divisor is a device
tensor); torch.round rounds half to even as jnp.round does. Activations
are NHWC throughout, as the JAX module's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import ieee_convs
from ..ops import cuda_int8
# the plain versions, named here too: the model's reference on the card
from ..ops.cuda_int8 import int8_conv_plain, out_size, requant  # noqa: F401
from .layers import BN_EPS, same_pad
from .yolov4_tiny import ANCHORS, HEAD_MASKS, YoloConfig, decode_head

# kernel launches made by the convs (one per conv on a CUDA tensor)
launches = 0

# the quantized convs in the JAX module's order: the 19 calibration sites
LAYERS = tuple(f"ConvBN_{i}" for i in range(10)) + tuple(
    f"CSPBlock_{b}/ConvBN_{i}" for b in range(3) for i in range(3))
HEADS = ("head_13", "head_26")


def fold_bn(detector) -> Dict[str, Dict[str, np.ndarray]]:
    """Inference BatchNorm folded into each ConvBN's conv, on the host in
    f32 numpy as the JAX package's fold_bn: {layer path: {"w" (cout, cin,
    kh, kw), "b" (cout,)}} and the two heads' conv and bias verbatim."""
    sd = {k: v.detach().cpu().numpy()
          for k, v in detector.state_dict().items()}
    folded = {}
    for path in LAYERS:
        p = path.replace("/", ".")
        s = sd[f"{p}.BatchNorm_0.weight"] / np.sqrt(
            sd[f"{p}.BatchNorm_0.running_var"] + BN_EPS)
        folded[path] = {
            "w": (sd[f"{p}.Conv_0.weight"] * s[:, None, None, None]
                  ).astype(np.float32),
            "b": (sd[f"{p}.BatchNorm_0.bias"]
                  - sd[f"{p}.BatchNorm_0.running_mean"] * s
                  ).astype(np.float32)}
    for head in HEADS:
        folded[head] = {"w": sd[f"{head}.weight"].astype(np.float32),
                        "b": sd[f"{head}.bias"].astype(np.float32)}
    return folded


def _quantize_np(w: np.ndarray):
    """(cout, cin, kh, kw) f32 -> (wq int8, sw (cout,) f32): symmetric
    per-output-channel, the JAX package's numpy steps (np.round rounds half
    to even)."""
    sw = np.max(np.abs(w), axis=(1, 2, 3)) / 127.0
    sw = np.maximum(sw, 1e-12)
    wq = np.clip(np.round(w / sw[:, None, None, None]), -127, 127)
    return wq.astype(np.int8), sw


def _gemm_weights(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 -> the kernel's (cout, Kp) weight matrix, k in (ty, tx, c)
    order, K padded with zero columns to a multiple of 16 (the kernel's
    16-byte copies)."""
    cout = wq.shape[0]
    wt = wq.permute(0, 2, 3, 1).reshape(cout, -1)
    return F.pad(wt, (0, -wt.shape[1] % 16)).contiguous()


def _device_layers(q_np: Dict[str, Dict[str, np.ndarray]],
                   device) -> Dict[str, Any]:
    """Host numpy {layer: {"wq", "sw", "b"} | head: {"w", "b"}} in OIHW ->
    the port's quantized detector on `device`: each layer also carries its
    GEMM matrix "wt"; the heads' anchors ride along for the decode."""
    out: Dict[str, Any] = {}
    for name, d in q_np.items():
        t = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in d.items()}
        if "wq" in t:
            t["wt"] = _gemm_weights(t["wq"])
        out[name] = t
    for name, mask in zip(("anchors_13", "anchors_26"), HEAD_MASKS):
        out[name] = torch.as_tensor(ANCHORS[list(mask)]).to(device)
    return out


def quantize_detector(detector) -> Dict[str, Any]:
    """Offline weight quantization of a YoloV4Tiny, on the host, the result
    on the detector's device: {layer: {"wq" int8 (cout, cin, kh, kw), "sw"
    f32 (cout,), "b" f32 (cout,), "wt"}, head: {"w", "b"}}. The heads stay
    float (their outputs feed exp / sigmoid)."""
    q = {}
    for name, wb in fold_bn(detector).items():
        if name in HEADS:
            q[name] = wb
            continue
        wq, sw = _quantize_np(wb["w"])
        q[name] = {"wq": wq, "sw": sw, "b": wb["b"]}
    return _device_layers(q, next(detector.parameters()).device)


def qparams_from_jax(q: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The JAX package's quantize_detector output (HWIO kernels, numpy or
    jax arrays) in this module's layout on `device` (weights.params_from_jax
    for the int8 detector)."""
    out = {}
    for name, d in q.items():
        d = {k: np.asarray(v) for k, v in d.items()}
        for k in ("wq", "w"):
            if k in d:
                d[k] = d[k].transpose(3, 2, 0, 1)            # HWIO -> OIHW
        out[name] = d
    return _device_layers(out, device)


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-sample activation scale max|x| / 127 over (H, W, C), >= 1e-12:
    (B, 1, 1, 1); the division as jitted XLA does it, times f32(1 / 127)."""
    m = torch.amax(torch.abs(x), dim=(1, 2, 3), keepdim=True)
    inv = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=x.device)
    return torch.clamp(m * inv, min=1e-12)


def quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """round(x / sx) clipped to [-127, 127] as int8 (zero-point 0, so SAME
    zero padding stays exact)."""
    return torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)


def tap_matrix(xq: torch.Tensor, k: int, stride: int,
               k_pad: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> the (B*Ho*Wo, k_pad) int8 matrix of the conv's
    taps, k in (ty, tx, c) order, zero columns up to k_pad: what
    torch._int_mm would multiply with the layer's wt.t() (the library
    yardstick of the conv; on no path)."""
    b, h, w, c = xq.shape
    ho, wo = out_size(h, stride), out_size(w, stride)
    if k == 1 and stride == 1:
        cols = [xq]
    else:
        py, px = same_pad(h, k, stride), same_pad(w, k, stride)
        xp = F.pad(xq, (0, 0, px[0], px[1], py[0], py[1]))
        cols = [xp[:, ty:ty + stride * (ho - 1) + 1:stride,
                   tx:tx + stride * (wo - 1) + 1:stride]
                for ty in range(k) for tx in range(k)]
    extra = k_pad - k * k * c
    if extra:
        cols.append(xq.new_zeros((b, ho, wo, extra)))
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, k_pad)


def int8_conv(xq: torch.Tensor, layer: Dict[str, torch.Tensor],
              stride: int) -> torch.Tensor:
    """(B, H, W, Cin) int8 -> (B, Ho, Wo, Cout) int32 accumulator of the
    layer's SAME conv: the kernel on a CUDA tensor (any shape),
    int8_conv_plain on a CPU tensor."""
    global launches
    n0 = cuda_int8.launches
    acc = cuda_int8.int8_conv(xq, layer, stride)
    launches += cuda_int8.launches - n0
    return acc


def int8_conv_requant(xq: torch.Tensor, sx: torch.Tensor,
                      layer: Dict[str, torch.Tensor],
                      stride: int) -> torch.Tensor:
    """requant(int8_conv(xq, layer, stride), sx, layer): one kernel launch
    on a CUDA tensor (the requant in its epilogue), the plain versions on
    a CPU tensor. sx: (B, 1, 1, 1) per sample, or a 0-d static scale."""
    global launches
    n0 = cuda_int8.launches
    y = cuda_int8.int8_conv_requant(xq, sx, layer, stride)
    launches += cuda_int8.launches - n0
    return y


def _qconv(x: torch.Tensor, layer: Dict[str, torch.Tensor],
           stride: int) -> torch.Tensor:
    """Dynamic-act-quantized conv + folded bias + leaky(0.1), f32 out; x
    (B, H, W, C) float. The scale is per sample, so a frame quantizes alike
    alone and in a fleet batch."""
    sx = act_scale(x)
    return int8_conv_requant(quantize_act(x, sx), sx, layer, stride)


def _fconv(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Float 1x1 head conv + bias (no activation), NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), layer["w"])
    return y.permute(0, 2, 3, 1) + layer["b"]


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max pool, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :h - h % 2, :w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


@torch.no_grad()
@ieee_convs()
def _topology(q: Dict[str, Any], images: torch.Tensor, cfg: YoloConfig,
              qconv):
    """The shared layer graph. `qconv(x, site, layer, stride)` is the
    quantized-conv hook: dynamic scales (forward_int8), static calibrated
    scales (forward_int8_static), or a recording calibrator
    (calibrate_scales)."""

    def csp(x, blk, ch):
        half = ch // 2
        p = f"CSPBlock_{blk}/ConvBN_"
        x1 = qconv(x[..., half:], p + "0", q[p + "0"], 1)
        x2 = qconv(x1, p + "1", q[p + "1"], 1)
        x3 = qconv(torch.cat([x2, x1], dim=-1), p + "2", q[p + "2"], 1)
        return torch.cat([x, x3], dim=-1), x3

    x = images.float()
    x = qconv(x, "ConvBN_0", q["ConvBN_0"], 2)            # 208
    x = qconv(x, "ConvBN_1", q["ConvBN_1"], 2)            # 104
    x = qconv(x, "ConvBN_2", q["ConvBN_2"], 1)
    x, _ = csp(x, 0, 64)
    x = _maxpool(x)                                       # 52
    x = qconv(x, "ConvBN_3", q["ConvBN_3"], 1)
    x, _ = csp(x, 1, 128)
    x = _maxpool(x)                                       # 26
    x = qconv(x, "ConvBN_4", q["ConvBN_4"], 1)
    x, fpn_tap = csp(x, 2, 256)
    x = _maxpool(x)                                       # 13
    x = qconv(x, "ConvBN_5", q["ConvBN_5"], 1)

    neck = qconv(x, "ConvBN_6", q["ConvBN_6"], 1)
    h1 = qconv(neck, "ConvBN_7", q["ConvBN_7"], 1)
    head1 = _fconv(h1, q["head_13"])

    up = qconv(neck, "ConvBN_8", q["ConvBN_8"], 1)
    up = up.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    h2 = qconv(torch.cat([up, fpn_tap], dim=-1), "ConvBN_9", q["ConvBN_9"], 1)
    head2 = _fconv(h2, q["head_26"])
    b1, c1 = decode_head(head1, q["anchors_13"], cfg.input_size,
                         cfg.num_classes)
    b2, c2 = decode_head(head2, q["anchors_26"], cfg.input_size,
                         cfg.num_classes)
    return torch.cat([b1, b2], dim=1), torch.cat([c1, c2], dim=1)


def forward_int8(q: Dict[str, Any], images: torch.Tensor,
                 cfg: YoloConfig = YoloConfig()):
    """images (B, S, S, 3) in [0, 1] -> (boxes (B, N, 4), confs (B, N, C)),
    layer for layer the int8 twin of yolov4_tiny.forward (dynamic
    per-sample activation scales)."""
    return _topology(q, images, cfg,
                     lambda x, _site, layer, stride: _qconv(x, layer, stride))


def forward_int8_static(q: Dict[str, Any],
                        act_scales: Dict[str, torch.Tensor],
                        images: torch.Tensor,
                        cfg: YoloConfig = YoloConfig()):
    """The static-scale twin: every conv quantizes its input with its
    site's calibrated scale (calibrate_scales) instead of a per-sample
    max-abs reduction."""

    def qconv(x, site, layer, stride):
        sx = act_scales[site]
        return int8_conv_requant(quantize_act(x, sx), sx, layer, stride)

    return _topology(q, images, cfg, qconv)


def calibrate_scales(q: Dict[str, Any], image_batches: Iterable,
                     cfg: YoloConfig = YoloConfig(),
                     headroom: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per-site static activation scales: max |x| over the calibration set
    at every conv input, times headroom, / 127, as 0-d f32 tensors on the
    detector's device (each site's max is read back to the host)."""
    maxes: Dict[str, float] = {}

    def qconv(x, site, layer, stride):
        m = float(torch.amax(torch.abs(x)))
        maxes[site] = max(maxes.get(site, 0.0), m)
        return _qconv(x, layer, stride)

    device = q["ConvBN_0"]["sw"].device
    for images in image_batches:
        _topology(q, torch.as_tensor(images, device=device), cfg, qconv)
    return {site: torch.tensor(np.float32(max(m * headroom, 1e-9) / 127.0),
                               device=device)
            for site, m in maxes.items()}
