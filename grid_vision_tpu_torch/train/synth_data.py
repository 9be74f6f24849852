"""On-device synthetic detection data: rendering and target assignment on
tensors (counterpart of grid_vision_tpu/train/synth_data.py).

A frame is a gray background with a brighter upper half and up to four
class-colored rectangles plus noise, drawn from a threefry key exactly as
the JAX package draws it (utils/prng: the same randint, uniform and normal
bits), so a key gives the same frame in both packages: the boxes, labels
and valid flags bit for bit, the pixels to the noise's last ulps (XLA's
log1p inside erfinv). Every function takes keys with a leading batch axis
and renders the whole batch at once on the keys' device; nothing goes to
the host, so a training step that draws its batch here does not
synchronize the card.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..models.yolov4_tiny import ANCHORS, HEAD_MASKS, YoloConfig
from ..ops.preprocess import preprocess_detector_image
from ..utils import prng
from ..utils.prng import f32, fma
from .targets import _ANCHOR_USABLE, head_offsets

# Label palette: (class id, RGB), all ten reference classes
# (object_detection.hpp:12-25), pairwise channel distance >= ~30.
CLASS_COLORS = np.array([
    [9, 220, 60, 50],     # vehicle: red-ish
    [2, 40, 200, 80],     # person: green-ish
    [0, 60, 80, 230],     # bike: blue-ish
    [1, 200, 180, 40],    # motorbike: yellow-ish
    [3, 150, 255, 20],    # green light: lime
    [4, 250, 130, 20],    # orange light: orange
    [5, 230, 40, 160],    # red light: magenta-ish
    [6, 40, 220, 220],    # sign 30: cyan-ish
    [7, 130, 60, 150],    # sign 60: purple
    [8, 240, 240, 240],   # sign 90: white
], np.int32)

# the box-size range in log space, as f32 (jnp.log of the Python floats)
_LOG_WH = (float(np.log(np.float32(0.018))), float(np.log(np.float32(0.45))))

# XLA's f32 exp on the CPU (Cephes' polynomial; every step below that reads
# a * b + c is one fused multiply-add there)
_EXP_P = (1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3,
          4.1665795894E-2, 1.6666665459E-1, 5.0000001201E-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor as jitted XLA computes it on the CPU, bit for
    bit (torch.exp and a correctly rounded exp differ in ~10 % of the
    values): n = floor(x log2 e + 1/2), a = x - n ln 2 in two fused steps,
    e^a by a degree-7 polynomial, times 2^n."""
    x = torch.clamp(x, f32(-87.8), f32(88.8))
    n = torch.floor(fma(x, f32(1.44269504088896341), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    a = fma(n, -f32(0.693359375), x)
    a = fma(n, -f32(-2.12194440e-4), a)
    z = fma(a, f32(_EXP_P[0]), f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        z = fma(z, a, f32(c))
    z = fma(z, a * a, a)
    return (1.0 + z) * torch.exp2(n)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """The palette, anchors, usable-anchor mask and head masks on `device`,
    copied there once (a host copy inside a training chunk would
    synchronize it)."""
    return (torch.as_tensor(CLASS_COLORS, device=device),
            torch.as_tensor(ANCHORS, device=device),
            torch.as_tensor(_ANCHOR_USABLE, device=device),
            [torch.as_tensor(m, device=device) for m in HEAD_MASKS])


def render_image(keys: torch.Tensor, height: int, width: int,
                 max_objects: int = 4):
    """Synthetic frames for (B, 2) keys: gray background + colored class
    rectangles (large ones painted first, so every labeled object stays
    visible) + noise of sigma 4.

    Returns (images (B, H, W, 3) f32 in [0, 255], boxes_norm (B, G, 4) xyxy
    in [0, 1], labels (B, G) int32, valid (B, G) bool)."""
    dev = keys.device
    g = max_objects
    k_n, _, k_xy, k_wh, k_cls, k_noise = prng.split(keys, 6).unbind(-2)
    n_obj = prng.randint(k_n, (), 1, g + 1)                       # (B,)
    cxy = prng.uniform(k_xy, (g, 2), 0.08, 0.92)
    wh = exp_f32(prng.uniform(k_wh, (g, 2), *_LOG_WH))
    x0 = torch.clamp(cxy[..., 0] - wh[..., 0] / 2, 0.0, 1.0)
    x1 = torch.clamp(cxy[..., 0] + wh[..., 0] / 2, 0.0, 1.0)
    y0 = torch.clamp(cxy[..., 1] - wh[..., 1] / 2, 0.0, 1.0)
    y1 = torch.clamp(cxy[..., 1] + wh[..., 1] / 2, 0.0, 1.0)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1)
    palette = _consts(dev)[0]
    cls_row = prng.randint(k_cls, (g,), 0, CLASS_COLORS.shape[0]).long()
    labels = palette[cls_row, 0]
    colors = palette[cls_row, 1:].float()                         # (B, G, 3)
    valid = torch.arange(g, device=dev) < n_obj[:, None]

    yy = (torch.arange(height, dtype=torch.float32, device=dev)
          / height)[:, None]                                       # (H, 1)
    xx = (torch.arange(width, dtype=torch.float32, device=dev)
          / width)[None, :]                                        # (1, W)
    b = keys.shape[0]
    img = torch.where(yy < 0.5, 136.0, 96.0).expand(height, width)
    img = img[None, :, :, None].expand(b, height, width, 3)
    order = torch.argsort(-(x1 - x0) * (y1 - y0), dim=-1, stable=True)
    rows = torch.arange(b, device=dev)
    for i in range(g):
        j = order[:, i]
        bx0, bx1, by0, by1 = (t[rows, j][:, None, None]
                              for t in (x0, x1, y0, y1))
        inside = ((xx >= bx0) & (xx < bx1) & (yy >= by0) & (yy < by1)
                  & valid[rows, j][:, None, None])
        img = torch.where(inside[..., None], colors[rows, j][:, None, None],
                          img)
    img = img + prng.normal(k_noise, (height, width, 3)) * 4.0
    return torch.clamp(img, 0.0, 255.0), boxes, labels, valid


def assign_targets_batch(boxes: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor, cfg: YoloConfig):
    """train.targets.assign_targets for a batch on the card: boxes (B, G, 4)
    normalized xyxy -> dense (B, N, 4) / (B, N) / (B, N) targets in decode
    row order (the shared anchor trains both heads). Where two boxes of an
    image land on one row the later box wins, as XLA's scatter does."""
    dev = boxes.device
    b, g = labels.shape
    n = cfg.num_anchors_total
    _, anchors, usable, masks = _consts(dev)
    wh = (boxes[..., 2:4] - boxes[..., 0:2]) * cfg.input_size    # (B, G, 2)
    inter = (torch.minimum(wh[..., None, 0], anchors[:, 0])
             * torch.minimum(wh[..., None, 1], anchors[:, 1]))
    union = (wh[..., 0:1] * wh[..., 1:2] + anchors[:, 0] * anchors[:, 1]
             - inter)
    iou = torch.where(usable, inter / torch.clamp(union, min=1e-9), -1.0)
    best = torch.argmax(iou, dim=-1)                              # (B, G)

    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    ok = (valid & (wh[..., 0] > 0) & (wh[..., 1] > 0) & (cx >= 0) & (cx < 1)
          & (cy >= 0) & (cy < 1))

    # one spare row takes the writes of unused boxes
    tgt_boxes = torch.zeros((b, n + 1, 4), device=dev)
    tgt_class = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    tgt_pos = torch.zeros((b, n + 1), device=dev)
    rows_b = torch.arange(b, device=dev)
    for head, (mask, off) in enumerate(zip(masks, head_offsets(cfg))):
        s = cfg.input_size // (32, 16)[head]
        hit = best[..., None] == mask
        a = torch.argmax(hit.to(torch.int32), dim=-1)
        gx = torch.clamp((cx * s).to(torch.int32), max=s - 1)
        gy = torch.clamp((cy * s).to(torch.int32), max=s - 1)
        use = ok & hit.any(dim=-1)
        row = torch.where(use, off + a * s * s + gy * s + gx, n).long()
        for i in range(g):
            tgt_boxes[rows_b, row[:, i]] = boxes[:, i]
            tgt_class[rows_b, row[:, i]] = labels[:, i]
            tgt_pos[rows_b, row[:, i]] = use[:, i].float()
    return tgt_boxes[:, :n], tgt_class[:, :n], tgt_pos[:, :n]


def make_batch_on_device(key: torch.Tensor, batch: int, cfg: YoloConfig,
                         render_hw: Tuple[int, int] = (480, 640)):
    """A training batch from one key, on the key's device: split(key,
    batch) frames, each resized to the net's input (the detector's
    antialiased linear resize) / 255, with dense targets. Returns
    (images (B, S, S, 3) in [0, 1], tgt_boxes, tgt_class, tgt_pos)."""
    img, boxes, labels, valid = render_image(prng.split(key, batch),
                                             *render_hw)
    return (preprocess_detector_image(img, cfg.input_size),
            *assign_targets_batch(boxes, labels, valid, cfg))
