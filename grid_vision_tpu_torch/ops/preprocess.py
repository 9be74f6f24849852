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


def preprocess_detector_image(image: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, 3) float RGB in [0, 255] -> (size, size, 3) in [0, 1]: two
    interpolation matmuls against the constant weight matrices (the longer
    x axis contracted first), then /255."""
    h, w, _ = image.shape
    wy = torch.as_tensor(_axis_resize_weights(h, size), device=image.device)
    wx = torch.as_tensor(_axis_resize_weights(w, size), device=image.device)
    tmp = torch.einsum("jx,yxc->yjc", wx, image.float())
    resized = torch.einsum("iy,yjc->ijc", wy, tmp)
    return resized / 255.0


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


def crop_resize(image: torch.Tensor, boxes: Boxes,
                out_size: int) -> torch.Tensor:
    """(H, W, 3) image + padded Boxes -> (D, out, out, 3) bilinear crops,
    as two interpolation-weight matmuls (x contracted first)."""
    h, w, _ = image.shape
    wy, wx = _box_weights(boxes.xyxy, h, w, out_size)
    tmp = torch.einsum("djx,yxc->dyjc", wx, image.float())
    return torch.einsum("diy,dyjc->dijc", wy, tmp)


def _standardize(crops: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-crop per-channel (x - mean) / std with the crop's own population
    statistics (quirk Q10), two-pass in f32; invalid crops -> 0."""
    mean = crops.mean(dim=(1, 2), keepdim=True)
    var = ((crops - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    out = (crops - mean) / torch.clamp(torch.sqrt(var), min=1e-6)
    return torch.where(valid[:, None, None, None], out,
                       torch.zeros((), device=crops.device))


def crop_resize_standardize(image: torch.Tensor, boxes: Boxes,
                            out_size: int) -> torch.Tensor:
    """crop_resize then _standardize: (D, out, out, 3) standardized crops;
    invalid boxes yield zero crops."""
    return _standardize(crop_resize(image, boxes, out_size), boxes.valid)
