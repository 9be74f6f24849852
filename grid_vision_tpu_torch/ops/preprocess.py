"""Image preprocessing on tensors: the detector resize and the per-box
crop / resize / standardize of the orientation branch (counterpart of
grid_vision_tpu/ops/preprocess.py; reference object_detection.cpp:6-24,
vision_orientation.cpp:94-166).

Layouts follow the JAX package: images are (H, W, 3) float RGB in
[0, 255], crops come out (D, S, S, 3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..types import Boxes


@functools.lru_cache(maxsize=None)
def _axis_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an antialiased linear (triangle kernel)
    resize of one axis: the formula of jax.image.resize('linear'), which
    the JAX package's detector resize uses. A copy of the JAX package's
    NumPy code, so both packages resample with the same weights."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)        # antialias (downscale)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None]
               - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)                # triangle kernel
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total == 0.0, 1.0, total), 0.0)
    ok = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return (w * ok[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_resize_weights(n_in: int, n_out: int,
                           device: torch.device) -> torch.Tensor:
    """_axis_resize_weights on `device`, copied there once (a host copy in
    a loop would synchronize the card)."""
    return torch.as_tensor(_axis_resize_weights(n_in, n_out), device=device)


def einsum_in(dtype, equation: str, a: torch.Tensor, b: torch.Tensor,
              out_dtype=None) -> torch.Tensor:
    """einsum of a and b rounded to `dtype`, summed in f32, returned in
    out_dtype (default f32): the JAX package's einsums with operands in the
    compute dtype and preferred_element_type f32. bf16 products are exact in
    f32, so off the card this is an f32 einsum of the rounded operands; on
    the card, where the result is rounded to bf16 anyway, a bf16 einsum
    (f32 accumulation: the reduced-precision reduction is switched off)."""
    out_dtype = out_dtype or torch.float32
    if dtype == torch.float32:
        return torch.einsum(equation, a.float(), b.float()).to(out_dtype)
    a, b = a.to(dtype), b.to(dtype)
    if a.is_cuda and out_dtype == dtype:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        return torch.einsum(equation, a, b)
    return torch.einsum(equation, a.float(), b.float()).to(out_dtype)


def preprocess_detector_image(image: torch.Tensor, size: int,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """(..., H, W, 3) float RGB in [0, 255] -> (..., size, size, 3) in
    [0, 1], a frame or a batch of frames: two interpolation matmuls against
    the constant weight matrices (the longer x axis contracted first), then
    /255. In bf16 the frame and the weights are rounded to bf16 and each
    product's result (f32 sums) too, as the JAX package's bf16 einsums
    do."""
    h, w, _ = image.shape[-3:]
    wy = _device_resize_weights(h, size, image.device)
    wx = _device_resize_weights(w, size, image.device)
    if compute_dtype != torch.float32:
        tmp = einsum_in(compute_dtype, "jx,...yxc->...yjc", wx, image,
                        compute_dtype)
        resized = einsum_in(compute_dtype, "iy,...yjc->...ijc", wy, tmp,
                            compute_dtype)
        # by a tensor: a CUDA tensor divided by a Python scalar is
        # multiplied by its reciprocal
        return (resized / torch.full((), 255.0, dtype=compute_dtype,
                                     device=image.device)).contiguous()
    tmp = torch.einsum("jx,...yxc->...yjc", wx, image.float())
    resized = torch.einsum("iy,...yjc->...ijc", wy, tmp)
    # a batch comes out of the einsum frame-minor: the nets' convs take
    # frames laid out one after another
    return (resized / 255.0).contiguous()


def _bilinear_sample_axis(length_in: int, start, extent, n_out: int):
    """cv2-style half-pixel sample positions along one axis, clamped to
    the crop. start / extent: (D,) f32. Returns (lo, hi, frac), (D, n_out)."""
    i = torch.arange(n_out, dtype=torch.float32, device=start.device)
    # divide by a tensor on the device: by a Python scalar a CUDA tensor is
    # multiplied by the reciprocal, an ulp off the CPU's (and the
    # orientation-front kernel's) true division
    step = extent[:, None] / torch.full((), float(n_out),
                                        device=start.device)
    pos = start[:, None] + (i[None, :] + 0.5) * step - 0.5
    pos = torch.minimum(torch.maximum(pos, start[:, None]),
                        start[:, None] + extent[:, None] - 1.0)
    lo = torch.floor(pos)
    frac = pos - lo
    lo_i = lo.to(torch.int64).clamp(0, length_in - 1)
    hi_i = (lo_i + 1).clamp(0, length_in - 1)
    return lo_i, hi_i, frac


def _interp_weights(length_in: int, lo, hi, frac) -> torch.Tensor:
    """(D, out) index/frac triplets -> (D, out, length_in) weights with
    (1 - frac) at column lo and frac at column hi (weight 1 when lo == hi)."""
    cols = torch.arange(length_in, device=lo.device)
    return ((cols == lo[..., None]) * (1.0 - frac[..., None])
            + (cols == hi[..., None]) * frac[..., None]).float()


def box_axis_samples(xyxy: torch.Tensor, h: int, w: int, out_size: int):
    """Per-box bilinear sample triplets ((ylo, yhi, fy), (xlo, xhi, fx)),
    each (D, out), with the getNetworkBoundingBox crop semantics: corners
    truncated toward zero and clamped to the image, the max column
    excluded (cv::Rect)."""
    t = torch.trunc(xyxy).to(torch.int32)
    xmin = t[:, 0].clamp(min=0)
    ymin = t[:, 1].clamp(min=0)
    xmax = t[:, 2].clamp(max=w - 1)
    ymax = t[:, 3].clamp(max=h - 1)
    bw = (xmax - xmin).clamp(min=1).float()
    bh = (ymax - ymin).clamp(min=1).float()
    return (_bilinear_sample_axis(h, ymin.float(), bh, out_size),
            _bilinear_sample_axis(w, xmin.float(), bw, out_size))


def _box_weights(xyxy: torch.Tensor, h: int, w: int, out_size: int):
    """Per-box bilinear weight matrices ((D, out, h), (D, out, w)) from
    box_axis_samples."""
    (ylo, yhi, fy), (xlo, xhi, fx) = box_axis_samples(xyxy, h, w, out_size)
    return (_interp_weights(h, ylo, yhi, fy),
            _interp_weights(w, xlo, xhi, fx))


def crop_resize(image: torch.Tensor, boxes: Boxes, out_size: int,
                compute_dtype=torch.float32, out_dtype=None) -> torch.Tensor:
    """(H, W, 3) image + padded Boxes -> (D, out, out, 3) bilinear crops,
    as two interpolation-weight matmuls (x contracted first). The frame
    and the weights go in as compute_dtype with f32 sums; in bf16 the first
    product is rounded to bf16 before the second. The crops come out f32,
    or in out_dtype."""
    h, w, _ = image.shape
    wy, wx = _box_weights(boxes.xyxy, h, w, out_size)
    if compute_dtype != torch.float32:
        tmp = einsum_in(compute_dtype, "djx,yxc->dyjc", wx, image,
                        compute_dtype)
        return einsum_in(compute_dtype, "diy,dyjc->dijc", wy, tmp,
                         out_dtype)
    tmp = torch.einsum("djx,yxc->dyjc", wx, image.float())
    crops = torch.einsum("diy,dyjc->dijc", wy, tmp)
    return crops if out_dtype is None else crops.to(out_dtype)


def _standardize(crops: torch.Tensor, valid: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """Per-crop per-channel (x - mean) / std with the crop's own population
    statistics (quirk Q10); invalid crops -> 0. f32 crops: two-pass in f32.
    bf16 crops (the JAX package's reduced-precision branch): single-pass
    moments E[x^2] - E[x]^2 accumulated in f32, then the normalize in bf16
    with the mean and 1 / std rounded to bf16. The result in out_dtype
    (default: the crops' dtype)."""
    if crops.dtype == torch.float32:
        mean = crops.mean(dim=(1, 2), keepdim=True)
        var = ((crops - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        out = (crops - mean) / torch.clamp(torch.sqrt(var), min=1e-6)
        out = torch.where(valid[:, None, None, None], out,
                          torch.zeros((), device=crops.device))
        return out if out_dtype is None else out.to(out_dtype)
    mean, inv = single_pass_stats(crops)
    dt = crops.dtype
    out = (crops - mean.to(dt)) * inv.to(dt)
    out = torch.where(valid[:, None, None, None], out,
                      torch.zeros((), dtype=dt, device=crops.device))
    return out if out_dtype is None else out.to(out_dtype)


def single_pass_stats(crops: torch.Tensor):
    """Per-crop per-channel mean and 1 / std of (N, S, S, 3) crops from
    single-pass f32 moments, each (N, 1, 1, 3) f32: var = max(E[x^2] -
    E[x]^2, 0), 1 / max(sqrt(var), 1e-6)."""
    x = crops.float()
    mean = x.mean(dim=(1, 2), keepdim=True)
    ex2 = (x * x).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    return mean, 1.0 / torch.clamp(torch.sqrt(var), min=1e-6)


def crop_resize_standardize(image: torch.Tensor, boxes: Boxes,
                            out_size: int, compute_dtype=torch.float32,
                            out_dtype=None) -> torch.Tensor:
    """crop_resize then _standardize: (D, out, out, 3) standardized crops;
    invalid boxes yield zero crops. In bf16 the crops are rounded to bf16
    before the statistics, as in the JAX package."""
    crops = crop_resize(image, boxes, out_size, compute_dtype,
                        out_dtype=compute_dtype)
    return _standardize(crops, boxes.valid, out_dtype)
