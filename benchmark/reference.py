"""The plain reference of the fleet tick, in PyTorch, that decides `correct`.

It imports nothing of the program: the nets are built from the shipped
npz weights here, and every stage is written out in plain torch from the
reference node's semantics as the program's plain ("xla") path states
them: the detector's antialiased resize, YOLOv4-tiny with flax SAME
padding, decode and greedy Fast NMS; the kNN median depth of the static
boxes; the fleet-wide orientation budget, the bilinear crops, the
orientation net and the MultiBin location solve (every bin and each of
the 64 constraint combinations kept for the judge); the depth refine;
the raycast carve and the log-odds grid.

Convs and matmuls run in IEEE float32 (the TF32 switches are turned off).
`mode` selects the operand precision of the two nets' convs and dense
layers: "f32"; "tf32" (operands rounded to TF32's 10-bit mantissa) and
"fp8" (e4m3, scaled by the tensor's or the output channel's largest
magnitude) are the controls: the precision below float32 and below
bfloat16.

The detector is a parameter of the tick (`detect`, core.detector): this
module's detect_dense, YOLOv4-tiny in float, unless the configuration
names a module of its own.
"""

from __future__ import annotations

import math
import re
import types

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
ANCHORS = {13: [[81, 82], [135, 169], [344, 319]],
           26: [[23, 27], [37, 58], [81, 82]]}
SCALE_XY = 1.05
DYNAMIC = (9, 0, 1, 2)                       # vehicle, bike, motorbike, person
AVG_DIMS = {9: (3.884, 1.629, 1.526), 0: (1.763, 0.597, 1.737),
            1: (2.2, 0.8, 1.5), 2: (0.842, 0.660, 1.761)}
ANGLE_BINS = np.array([np.pi / 2.0, 3.0 * np.pi / 2.0], np.float32)
N_BINS = 4096


def ieee() -> None:
    """float32 convs and matmuls in IEEE float32 (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------- precision

def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    amax = (x.abs().amax() if dim is None else
            x.abs().amax(dim=[d for d in range(x.dim()) if d != dim],
                         keepdim=True))
    s = torch.clamp(amax, min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def round_values(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Each value rounded to `mode` unscaled (fp8 e4m3 holds +-448): the
    control's arithmetic outside the nets (points, log-odds)."""
    if mode == "tf32":
        return _round_tf32(x)
    if mode == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    return x


def rounding(mode: str):
    """(activation rounder, weight rounder with the output axis)."""
    if mode == "f32":
        return (lambda x: x), (lambda w, dim: w)
    if mode == "tf32":
        return _round_tf32, (lambda w, dim: _round_tf32(w))
    if mode == "fp8":
        return _round_fp8, (lambda w, dim: _round_fp8(w, dim))
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------- weights

def load_net(path: str, device) -> dict:
    """A flax npz checkpoint as {"ConvBN_0/Conv_0/kernel": tensor, ...}:
    conv kernels OIHW, dense kernels (in, out), BN scale / bias / mean /
    var."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            parts = re.findall(r"\['([^']*)'\]", key)
            arr = np.asarray(z[key], np.float32)
            if parts[-1] == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            out["/".join(parts[1:])] = torch.as_tensor(arr, device=device)
    return out


def same_pad(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Nets:
    """The two nets' weights and the operand precision they run in."""

    def __init__(self, det_path: str, ori_path: str, device, mode="f32"):
        self.det = load_net(det_path, device)
        self.ori = load_net(ori_path, device)
        self.mode = mode
        self.ract, self.rw = rounding(mode)

    def conv(self, x, w, stride, bias=None):
        return F.conv2d(self.ract(x), self.rw(w, 0), bias, stride=stride)

    def dense(self, x, w, b):
        return self.ract(x) @ self.rw(w, 1) + b

    def conv_bn(self, p, name, x, stride, act):
        w = p[f"{name}/Conv_0/kernel"]
        k = w.shape[-1]
        py, px = same_pad(x.shape[2], k, stride), same_pad(x.shape[3], k,
                                                            stride)
        y = self.conv(F.pad(x, (px[0], px[1], py[0], py[1])), w, stride)
        y = F.batch_norm(y, p[f"{name}/BatchNorm_0/mean"],
                         p[f"{name}/BatchNorm_0/var"],
                         p[f"{name}/BatchNorm_0/scale"],
                         p[f"{name}/BatchNorm_0/bias"], False, 0.0, BN_EPS)
        return F.leaky_relu(y, 0.1) if act == "leaky" else F.relu(y)


# ---------------------------------------------------------------- detector

def axis_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an antialiased linear resize (triangle
    kernel), the formula of jax.image.resize('linear')."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None]
               - np.arange(n_in, dtype=np.float64)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total == 0.0, 1.0, total), 0.0)
    ok = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return (w * ok[:, None]).astype(np.float32)


def _csp(nets, p, name, x):
    half = x.shape[1] // 2
    x1 = nets.conv_bn(p, f"{name}/ConvBN_0", x[:, half:], 1, "leaky")
    x2 = nets.conv_bn(p, f"{name}/ConvBN_1", x1, 1, "leaky")
    x3 = nets.conv_bn(p, f"{name}/ConvBN_2", torch.cat([x2, x1], 1), 1,
                      "leaky")
    return torch.cat([x, x3], 1), x3


def _decode_head(raw, anchors, size):
    b, c, h, w = raw.shape
    raw = raw.permute(0, 2, 3, 1).reshape(b, h, w, 3, c // 3)
    raw = raw.permute(0, 3, 1, 2, 4)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=raw.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=raw.device), indexing="ij")
    s = SCALE_XY
    bx = (torch.sigmoid(raw[..., 0]) * s - 0.5 * (s - 1.0) + gx) / w
    by = (torch.sigmoid(raw[..., 1]) * s - 0.5 * (s - 1.0) + gy) / h
    an = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    bw = torch.exp(raw[..., 2]) * (an[:, 0] / size)[None, :, None, None]
    bh = torch.exp(raw[..., 3]) * (an[:, 1] / size)[None, :, None, None]
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                        -1)
    confs = torch.sigmoid(raw[..., 4:5]) * torch.sigmoid(raw[..., 5:])
    return boxes.reshape(b, -1, 4), confs.reshape(b, -1, confs.shape[-1])


def detect_dense(nets: Nets, images: torch.Tensor, size: int):
    """(B, H, W, 3) frames in [0, 255] -> every anchor's (boxes (B, A, 4)
    normalized xyxy, confs (B, A, C) = sigmoid(obj) * sigmoid(cls)), the
    13-grid head first."""
    h, w = images.shape[1:3]
    wy = torch.as_tensor(axis_resize_weights(h, size), device=images.device)
    wx = torch.as_tensor(axis_resize_weights(w, size), device=images.device)
    x = torch.einsum("iy,byjc->bijc", wy,
                     torch.einsum("jx,byxc->byjc", wx, images.float()))
    x = (x / 255.0).permute(0, 3, 1, 2).contiguous()
    p = nets.det
    cb = nets.conv_bn
    x = cb(p, "ConvBN_1", cb(p, "ConvBN_0", x, 2, "leaky"), 2, "leaky")
    x, _ = _csp(nets, p, "CSPBlock_0", cb(p, "ConvBN_2", x, 1, "leaky"))
    x = F.max_pool2d(x, 2, 2)
    x, _ = _csp(nets, p, "CSPBlock_1", cb(p, "ConvBN_3", x, 1, "leaky"))
    x = F.max_pool2d(x, 2, 2)
    x, tap = _csp(nets, p, "CSPBlock_2", cb(p, "ConvBN_4", x, 1, "leaky"))
    x = F.max_pool2d(x, 2, 2)
    neck = cb(p, "ConvBN_6", cb(p, "ConvBN_5", x, 1, "leaky"), 1, "leaky")
    h1 = nets.conv(cb(p, "ConvBN_7", neck, 1, "leaky"),
                   p["head_13/kernel"], 1, p["head_13/bias"])
    up = F.interpolate(cb(p, "ConvBN_8", neck, 1, "leaky"), scale_factor=2,
                       mode="nearest")
    h2 = nets.conv(cb(p, "ConvBN_9", torch.cat([up, tap], 1), 1, "leaky"),
                   p["head_26/kernel"], 1, p["head_26/bias"])
    b1, c1 = _decode_head(h1, ANCHORS[13], size)
    b2, c2 = _decode_head(h2, ANCHORS[26], size)
    return torch.cat([b1, b2], 1), torch.cat([c1, c2], 1)


def to_pixels(xyxy_norm: torch.Tensor, c: dict) -> torch.Tensor:
    """Normalized xyxy -> pixels, truncated toward zero."""
    size = float(c["detection_network_input_size"])
    sx = size * (float(c["camera_image_width"]) / size)
    sy = size * (float(c["camera_image_height"]) / size)
    return torch.trunc(xyxy_norm * torch.tensor(
        [sx, sy, sx, sy], dtype=xyxy_norm.dtype, device=xyxy_norm.device))


def cross_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a[..., 2], b[..., 2])
                     - torch.maximum(a[..., 0], b[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., 3], b[..., 3])
                     - torch.maximum(a[..., 1], b[..., 1]), min=0.0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    denom = area_a + area_b - inter
    return torch.where(denom > 0, inter / torch.where(denom == 0, 1.0, denom),
                       torch.zeros_like(denom))


def extract_boxes(boxes_norm, confs, c: dict):
    """Threshold, the top max_candidates by confidence, greedy NMS (a kept
    box suppresses every later box with IoU > iou_threshold; class-aware
    with class_aware_nms), the first max_detections kept, in pixels.
    Returns (namespace xyxy / confidence / label / valid, the count of
    above-threshold anchors beyond max_candidates)."""
    dev = boxes_norm.device
    max_conf = confs.max(dim=-1).values
    label = torch.argmax((confs == max_conf[..., None]).to(torch.uint8),
                         dim=-1).to(torch.int32)
    passed = max_conf >= c["confidence_threshold"]
    k = min(c["max_candidates"], boxes_norm.shape[-2])
    s = torch.sort(torch.where(passed, max_conf, float("-inf")), dim=-1,
                   descending=True, stable=True)
    cand_conf, cand_idx = s.values[..., :k], s.indices[..., :k]
    cand_valid = cand_conf > float("-inf")
    cand_xyxy = torch.take_along_dim(boxes_norm, cand_idx[..., None], -2)
    cand_label = torch.take_along_dim(label, cand_idx, -1)
    # the greedy scan as the fixed point of keep = valid & ~any(keep_i &
    # suppresses_ij) over the strictly-upper suppression matrix
    n = k
    sup = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1) & (
        cross_iou(cand_xyxy, cand_xyxy) > c["iou_threshold"])
    if c["class_aware_nms"]:
        sup = sup & (cand_label[..., :, None] == cand_label[..., None, :])
    keep = cand_valid
    for _ in range(n + 1):
        new = cand_valid & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    take = torch.sort((~keep).to(torch.uint8), dim=-1,
                      stable=True).indices[..., :c["max_detections"]]
    valid = torch.take_along_dim(keep, take, -1)
    xyxy = to_pixels(torch.take_along_dim(cand_xyxy, take[..., None], -2), c)
    zero = torch.zeros((), device=dev)
    boxes = types.SimpleNamespace(
        xyxy=torch.where(valid[..., None], xyxy, zero),
        confidence=torch.where(valid, torch.take_along_dim(cand_conf, take,
                                                           -1), zero),
        label=torch.where(valid, torch.take_along_dim(cand_label, take, -1),
                          torch.full((), 10, dtype=torch.int32, device=dev)),
        valid=valid)
    overflow = torch.clamp(passed.sum(-1).to(torch.int32) - k, min=0)
    return boxes, overflow


def is_dynamic(label: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(label, dtype=torch.bool)
    for d in DYNAMIC:
        out = out | (label == d)
    return out


def avg_dims(label: torch.Tensor) -> torch.Tensor:
    table = torch.zeros((11, 3), dtype=torch.float32, device=label.device)
    for k, v in AVG_DIMS.items():
        table[k] = torch.tensor(v)
    return table[label.long().clamp(0, 10)]


# ---------------------------------------------------------------- geometry

def intrinsics(c: dict, device):
    K = torch.tensor([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]],
                      [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
    K_inv = torch.stack([
        torch.stack([1.0 / K[0, 0], K.new_zeros(()), -K[0, 2] / K[0, 0]]),
        torch.stack([K.new_zeros(()), 1.0 / K[1, 1], -K[1, 2] / K[1, 1]]),
        torch.tensor([0.0, 0.0, 1.0], device=device)])
    return K, K_inv


def transform(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    return xyz @ T[:3, :3].T + T[:3, 3]


def project(xyz: torch.Tensor, K: torch.Tensor):
    """(u, v, z) with each row summed as (x k0 + y k1) + z k2."""
    x, y, z = xyz.unbind(-1)
    rows = [(x * K[i, 0] + y * K[i, 1]) + z * K[i, 2] for i in range(3)]
    zz = torch.where(rows[2] == 0, torch.ones_like(rows[2]), rows[2])
    return rows[0] / zz, rows[1] / zz, z


def centers(xyxy: torch.Tensor) -> torch.Tensor:
    lo, hi = xyxy[..., 0:2], xyxy[..., 2:4]
    return lo + (hi - lo) / 2.0


def quat_from_pitch(angle: torch.Tensor) -> torch.Tensor:
    half = -angle / 2.0
    z = torch.zeros_like(angle)
    return torch.stack([z, torch.sin(half), z, torch.cos(half)], -1)


# ---------------------------------------------------------------- static

def knn_depth(xyz_cam, count, boxes_xyxy, query_valid, k: int, K):
    """The kNN median depth of each query box centre over the projected
    cloud ((u, v, depth) points, the query at depth 0; ties to the lower
    point index), -1 where the box is no query or no point exists.
    xyz_cam (R, P, 3), count (R,), boxes (R, D, 4), query_valid (R, D)."""
    u, v, z = project(xyz_cam, K)
    p = xyz_cam.shape[1]
    valid = (torch.arange(p, device=xyz_cam.device) < count[:, None]) & (
        z > 0.0)
    sentinel = torch.full((), 1.0e8, device=xyz_cam.device)
    uvd = torch.where(valid[..., None], torch.stack([u, v, z], -1), sentinel)
    cen = centers(boxes_xyxy)
    du = cen[..., :, None, 0] - uvd[..., None, :, 0]
    dv = cen[..., :, None, 1] - uvd[..., None, :, 1]
    zz = uvd[..., None, :, 2]
    d2 = torch.where(valid[:, None, :], (du * du + dv * dv) + zz * zz,
                     float("inf"))
    order = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    d2_sel = torch.gather(d2, -1, order)
    z_sel = torch.gather(zz.expand(d2.shape), -1, order)
    found = torch.isfinite(d2_sel)
    n_found = found.sum(-1)
    srt = torch.sort(torch.where(found, z_sel, float("inf")), dim=-1).values
    med = torch.gather(srt, -1, torch.clamp(n_found // 2, 0, k - 1)[..., None])
    depth = torch.where(n_found > 0, med[..., 0], -1.0)
    return torch.where(query_valid, depth, -1.0)


def static_branch(boxes, xyz_cam, count, c, K, K_inv, T_cb):
    """Each box's kNN depth (compacted to max_static_depth static queries
    unless the depth refine needs every box) and the static boxes' base
    points. Returns (depths (R, D), static_points (R, D, 3), the static
    count beyond max_static_depth (R,))."""
    static = boxes.valid & ~is_dynamic(boxes.label)
    refine = c["vision_depth_refine"] and c["use_vision_orientation"]
    d = boxes.valid.shape[-1]
    if c["max_static_depth"] < d and not refine:
        score = torch.where(static, boxes.confidence, -1.0)
        take = torch.sort(score, dim=-1, descending=True,
                          stable=True).indices[..., :c["max_static_depth"]]
        qv = torch.take_along_dim(static, take, -1)
        qd = knn_depth(xyz_cam, count,
                       torch.take_along_dim(boxes.xyxy, take[..., None], -2),
                       qv, c["k_near"], K)
        depths = torch.full(static.shape, -1.0,
                            device=static.device).scatter(-1, take, qd)
        clamped = torch.clamp(static.sum(-1).to(torch.int32)
                              - c["max_static_depth"], min=0)
    else:
        depths = knn_depth(xyz_cam, count, boxes.xyxy, boxes.valid,
                           c["k_near"], K)
        clamped = torch.zeros(static.shape[:-1], dtype=torch.int32,
                              device=static.device)
    homog = torch.cat([centers(boxes.xyxy),
                       torch.ones_like(depths[..., None])], -1)
    pts = transform(T_cb, depths[..., None] * (homog @ K_inv.T))
    return depths, torch.where(static[..., None], pts, 0.0), clamped


# ---------------------------------------------------------------- poses

def dynamic_slots(boxes, cap: int):
    """The first `cap` dynamic boxes of each rig in confidence order:
    (slot -> box index (R, cap), slot valid (R, cap))."""
    dyn = boxes.valid & is_dynamic(boxes.label)
    order = torch.sort((~dyn).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :cap]
    return order, torch.take_along_dim(dyn, order, -1)


def budget_keep(boxes, order, slot_valid, budget: int):
    """The fleet-wide orientation budget: the `budget` most confident
    valid slots over all rigs (ties to the lower slot). Returns kept
    (R, cap) bool."""
    r, cap = slot_valid.shape
    conf = torch.take_along_dim(boxes.confidence, order, -1)
    score = torch.where(slot_valid, conf, -1.0).reshape(-1)
    budget = min(budget, r * cap)
    top = torch.sort(score, descending=True, stable=True).indices[:budget]
    kept = torch.zeros(r * cap, dtype=torch.bool, device=score.device)
    kept[top] = slot_valid.reshape(-1)[top]
    return kept.reshape(r, cap)


def crops(images, xyxy, rig, size: int):
    """Bilinear (half-pixel, clamped to the box) crops of boxes (N, 4) of
    frames images[rig] (N,), standardized per crop and channel with the
    crop's own statistics: ((N, size, size, 3) f32, each crop's least
    channel standard deviation (N,) before standardizing)."""
    h, w = images.shape[1:3]
    t = torch.trunc(xyxy).to(torch.int32)
    x0, y0 = t[:, 0].clamp(min=0), t[:, 1].clamp(min=0)
    x1, y1 = t[:, 2].clamp(max=w - 1), t[:, 3].clamp(max=h - 1)

    def samples(start, ext, length):
        i = torch.arange(size, dtype=torch.float32, device=xyxy.device)
        step = ext[:, None] / torch.full((), float(size), device=xyxy.device)
        pos = start[:, None] + (i[None, :] + 0.5) * step - 0.5
        pos = torch.minimum(torch.maximum(pos, start[:, None]),
                            start[:, None] + ext[:, None] - 1.0)
        lo = torch.floor(pos)
        lo_i = lo.to(torch.int64).clamp(0, length - 1)
        return lo_i, (lo_i + 1).clamp(0, length - 1), pos - lo

    ylo, yhi, fy = samples(y0.float(), (y1 - y0).clamp(min=1).float(), h)
    xlo, xhi, fx = samples(x0.float(), (x1 - x0).clamp(min=1).float(), w)
    img = images[rig.long()].float()                      # (N, H, W, 3)
    n = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def row(yi):
        a = img[n, yi[:, :, None], xlo[:, None, :]]
        b = img[n, yi[:, :, None], xhi[:, None, :]]
        return a * (1.0 - fx)[:, None, :, None] + b * fx[:, None, :, None]

    c = row(ylo) * (1.0 - fy)[:, :, None, None] + \
        row(yhi) * fy[:, :, None, None]
    mean = c.mean(dim=(1, 2), keepdim=True)
    std = torch.sqrt(((c - mean) ** 2).mean(dim=(1, 2), keepdim=True))
    return (c - mean) / torch.clamp(std, min=1e-6), std.flatten(1).amin(-1)


def orientation(nets: Nets, x: torch.Tensor):
    """(N, S, S, 3) standardized crops -> (orient (N, 2, 2) unit cos / sin
    a bin, bin logits (N, 2), dimension residuals (N, 3)): the s2d(4)
    stem, a stride-2 ladder down to 7, one stride-1 conv, the global mean,
    the MultiBin heads."""
    n, s = x.shape[0], x.shape[1]
    x = x.reshape(n, s // 4, 4, s // 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(n, s // 4, s // 4, 48).permute(0, 3, 1, 2)
    p = nets.ori
    x = nets.conv_bn(p, "ConvBN_0", x, 2, "relu")
    i = 1
    while x.shape[-1] > 7:
        x = nets.conv_bn(p, f"ConvBN_{i}", x, 2, "relu")
        i += 1
    x = nets.conv_bn(p, f"ConvBN_{i}", x, 1, "relu").mean(dim=(2, 3))

    def head(name, width):
        y = F.relu(nets.dense(x, p[f"MultiBinHeads_0/{name}_fc1/kernel"],
                              p[f"MultiBinHeads_0/{name}_fc1/bias"]))
        return nets.dense(y, p[f"MultiBinHeads_0/{name}_fc2/kernel"],
                          p[f"MultiBinHeads_0/{name}_fc2/bias"])

    orient = head("orient", 4).reshape(n, 2, 2)
    orient = orient / torch.clamp(
        torch.sqrt((orient * orient).sum(-1, keepdim=True)), min=1e-8)
    return orient, head("conf", 2), head("dim", 3)


def _combos(dx, dy, dz, lm, rm, sm):
    """(..., 64, 4, 3): left(2) x top(4) x right(2) x bottom(4)."""
    cidx = np.arange(64)
    li, ti, ri, bi = cidx // 32, (cidx // 8) % 4, (cidx // 4) % 2, cidx % 4
    pm = torch.tensor([-1.0, 1.0], device=dx.device)
    e2, e4 = torch.ones(2, device=dx.device), torch.ones(4, device=dx.device)
    u = lambda t: t[..., None]                                     # noqa
    left = torch.stack([u(lm * dx) * e2, pm * u(dy), u(-sm * dz) * e2], -1)
    right = torch.stack([u(rm * dx) * e2, pm * u(dy), u(sm * dz) * e2], -1)
    ii, jj = pm.repeat_interleave(2), pm.repeat(2)
    top = torch.stack([ii * u(dx), u(-dy) * e4, jj * u(dz)], -1)
    bottom = torch.stack([ii * u(dx), u(dy) * e4, jj * u(dz)], -1)
    return torch.stack([left[..., li, :], top[..., ti, :],
                        right[..., ri, :], bottom[..., bi, :]], -2)


def _inv3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def multibin_candidates(orient, conf, dims, xyxy, label, c, K):
    """MultiBin for each box under each bin: alpha = the bin's angle + its
    centre - pi, the yaw alpha + theta_ray, the dims (class average +
    residual), and for each of the 64 constraint combinations the least
    squares location and its residual. Returns a namespace of (N, 2)
    yaw, (N, 3) dims (length, width, height), (N, 2, 64, 3) locations,
    (N, 2, 64) residuals, (N, 2) logit gap to the best bin."""
    bins = torch.as_tensor(ANGLE_BINS, device=orient.device)
    alpha = torch.atan2(orient[..., 1], orient[..., 0]) + bins - np.float32(
        np.pi)                                                    # (N, 2)
    fovx = 2.0 * np.arctan(c["camera_image_width"] / (2.0 * c["fx"]))
    dx_c = (xyxy[:, 0] + xyxy[:, 2]) / 2.0 - c["camera_image_width"] / 2.0
    theta = torch.where(dx_c < 0, -1.0, 1.0) * torch.atan(
        (2.0 * torch.abs(dx_c) * float(np.tan(fovx / 2.0)))
        / c["camera_image_width"])
    avg = avg_dims(label)
    length = dims[:, 2] + avg[:, 0]
    width = dims[:, 0] + avg[:, 1]
    height = dims[:, 1] + avg[:, 2]
    yaw = alpha + theta[:, None]
    cs, sn = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(cs), torch.ones_like(cs)
    R = torch.stack([torch.stack([cs, z, sn], -1), torch.stack([z, o, z], -1),
                     torch.stack([-sn, z, cs], -1)], -2)       # (N, 2, 3, 3)
    d88, d90, d92 = (v * np.pi / 180.0 for v in (88.0, 90.0, 92.0))
    p90 = (alpha < d92) & (alpha > d88)
    m90 = (alpha < -d88) & (alpha > -d92)
    front = (alpha < d90) & (alpha > -d90)
    lm = torch.where(p90, 1.0, torch.where(m90, -1.0, torch.where(
        front, -1.0, 1.0)))
    rm = torch.where(p90, 1.0, torch.where(m90, -1.0, torch.where(
        front, 1.0, -1.0)))
    sm = torch.where(alpha > 0, 1.0, -1.0)
    X = _combos((length / 2.0)[:, None].expand_as(alpha),
                (width / 2.0)[:, None].expand_as(alpha),
                (height / 2.0)[:, None].expand_as(alpha), lm, rm, sm)
    KRX = (X @ R.transpose(-1, -2)[:, :, None]) @ K.T           # (N,2,64,4,3)
    rows = torch.tensor([0, 1, 0, 1], device=K.device)
    A = K[rows][None] - xyxy[:, :, None] * K[2][None, None, :]  # (N, 4, 3)
    b = xyxy[:, None, None, :] * KRX[..., 2] - torch.gather(
        KRX, -1, rows.view(1, 1, 1, 4, 1).expand(KRX.shape[:-1] + (1,)))[
            ..., 0]                                               # (N,2,64,4)
    s = 1.0 / 1024.0
    A_s, b_s = A * s, b * s
    AtA = A_s.transpose(-1, -2) @ A_s                            # (N, 3, 3)
    locs = (b_s @ A_s[:, None]) @ _inv3(AtA).transpose(-1, -2)[:, None]
    resid = A_s[:, None, None] @ locs[..., None] - b_s[..., None]
    err = (resid[..., 0] ** 2).sum(-1)                           # (N, 2, 64)
    return types.SimpleNamespace(
        yaw=yaw, length=length, width=width, height=height, locs=locs,
        err=err, logit_gap=conf.max(-1, keepdim=True).values - conf,
        xyxy=xyxy)


def refine(cand, depth, has_cloud, K):
    """The depth refine over every candidate location: each moved along
    its ray to the kNN depth (or the height cue fy * H / h_px where no
    cloud depth exists or it is clearly nearer), plus half the yaw-
    projected footprint. depth (N,) the box's kNN depth."""
    px, z = cand.locs[..., 0], cand.locs[..., 2]
    o = cand.yaw[..., None].expand_as(px)
    L, W, H = (t[:, None, None].expand_as(px)
               for t in (cand.length, cand.width, cand.height))
    r = torch.sqrt(px * px + z * z)
    ux, uz = px / torch.clamp(r, min=0.5), z / torch.clamp(r, min=0.5)
    half = 0.5 * (torch.abs(ux * torch.cos(o) - uz * torch.sin(o)) * L
                  + torch.abs(ux * torch.sin(o) + uz * torch.cos(o)) * W)
    dep = depth[:, None, None].expand_as(px)
    ok_knn = (dep > 0.0) & (z > 0.5) & has_cloud
    h_px = (cand.xyxy[:, 3] - cand.xyxy[:, 1])[:, None, None].expand_as(px)
    mono = K[1, 1] * H / torch.clamp(h_px, min=1.0)
    ok_mono = (h_px > 4.0) & (z > 0.5)
    knn_c, mono_c = dep + half, mono + half
    use_knn = ok_knn & ((knn_c > 0.8 * mono_c) | ~ok_mono)
    safe = torch.clamp(z, min=0.5)
    scale = torch.where(use_knn, knn_c / safe,
                        torch.where(ok_mono, mono_c / safe,
                                    torch.ones_like(z)))
    return cand.locs * scale[..., None]


# ---------------------------------------------------------------- grid

def grid_update(log_odds, occupancy, poses, xyz_base, count, c, carve):
    """The grid tick of R rigs from their pre-tick grid and base-frame
    poses (position, length, width, valid): with `carve` the polar
    raycast carve first, then decay, the axis-aligned footprint hits, one
    clamp, the sigmoid, the int8 export. Returns (log_odds, occupancy,
    occupancy_i8)."""
    dev = log_odds.device
    gx, gy, res = float(c["grid_x"]), float(c["grid_y"]), c["resolution"]
    h, w = int(round(gx / res)), int(round(gy / res))
    center = torch.tensor([float(c["grid_x"] // 3), 0.0], device=dev)
    length = torch.tensor([gx, gy], device=dev)
    size = torch.round(length / res).to(torch.int32)
    max_corner = center + 0.5 * length
    lo = log_odds
    if carve:
        rows = torch.arange(h, dtype=torch.int32, device=dev)
        cols = torch.arange(w, dtype=torch.int32, device=dev)
        idx = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), -1)
        cell = max_corner - (idx.to(torch.float32) + 0.5) * res
        cbin = torch.clamp(((torch.atan2(cell[..., 1], cell[..., 0])
                             + math.pi) * (N_BINS / (2.0 * math.pi)))
                           .to(torch.int32), 0, N_BINS - 1)
        cr = torch.sqrt(cell[..., 0] * cell[..., 0]
                        + cell[..., 1] * cell[..., 1])
        pts = xyz_base[..., :2]
        valid = torch.arange(pts.shape[1], device=dev) < count[:, None]
        r = torch.sqrt(pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1])
        pbin = torch.clamp(((torch.atan2(pts[..., 1], pts[..., 0]) + math.pi)
                            * (N_BINS / (2.0 * math.pi))).to(torch.int32),
                           0, N_BINS - 1)
        ranges = torch.zeros((pts.shape[0], N_BINS), device=dev)
        ranges.scatter_reduce_(-1, pbin.long(),
                               torch.where(valid, r, torch.zeros_like(r)),
                               "amax", include_self=True)
        ranges = torch.stack([torch.roll(ranges, s, dims=-1)
                              for s in range(-2, 3)]).amax(dim=0)
        cell_range = ranges[..., cbin.long()]
        mask = ((cr < cell_range - res * 1.5) & (cell_range > 0)).float()
        lo = lo + (-0.4) * mask
    px, py = poses.position[..., 0], poses.position[..., 1]
    hl, hw = poses.length / 2.0, poses.width / 2.0
    corners = torch.stack([torch.stack([px - hl, py - hw], -1),
                           torch.stack([px + hl, py - hw], -1),
                           torch.stack([px + hl, py + hw], -1),
                           torch.stack([px - hl, py + hw], -1)], -2)
    cidx = torch.floor((max_corner - corners) / res).to(torch.int32)
    ok = poses.valid & torch.all(torch.all((cidx >= 0) & (cidx < size), -1),
                                 -1)
    lo_i, hi_i = cidx.amin(dim=-2), cidx.amax(dim=-2)
    rows = torch.arange(h, dtype=torch.int32, device=dev)
    cols = torch.arange(w, dtype=torch.int32, device=dev)
    rmask = ((rows >= lo_i[..., 0:1]) & (rows <= hi_i[..., 0:1])
             & ok[..., None]).float()
    cmask = ((cols >= lo_i[..., 1:2]) & (cols <= hi_i[..., 1:2])).float()
    counts = torch.einsum("...dh,...dw->...hw", rmask, cmask)
    hit = float(torch.tensor(c["log_odds_hit"], dtype=torch.float32))
    lo = ((lo + c["log_odds_decay"]).double() + hit * counts.double()).float()
    lo = torch.clamp(lo, c["min_log_odds"], c["max_log_odds"])
    occ = 1.0 / (1.0 + torch.exp(-lo))
    return lo, occ, torch.round(torch.clamp(occ, 0.0, 1.0) * 100.0).to(
        torch.int8)


# ---------------------------------------------------------------- the tick

def fleet_tick(nets: Nets, state, obs, c: dict, budget: int, T_lc, T_cb,
               detect=detect_dense):
    """The whole fleet tick computed by the reference in nets.mode: the
    control that stands in the program's place. state: log_odds,
    occupancy (R, H, W); obs: image (R, H, W, 3), xyz (R, P, 3), count
    (R,); detect: the detector's detect_dense (core.detector). Returns
    (state', outputs) with the program's field names."""
    dev = obs.image.device
    K, K_inv = intrinsics(c, dev)
    dense = [detect(nets, obs.image[i:i + 32],
                    c["detection_network_input_size"])
             for i in range(0, obs.image.shape[0], 32)]
    boxes, overflow = extract_boxes(torch.cat([d[0] for d in dense]),
                                    torch.cat([d[1] for d in dense]), c)
    xyz_cam = transform(T_lc, obs.xyz)
    # the control's points in its precision (the padding rows kept)
    pad = torch.arange(xyz_cam.shape[1], device=dev) >= obs.count[:, None]
    xyz_cam = torch.where(pad[..., None], xyz_cam,
                          round_values(xyz_cam, nets.mode))
    depths, static_points, static_clamped = static_branch(
        boxes, xyz_cam, obs.count, c, K, K_inv, T_cb)
    cap = c["max_orientation_batch"]
    order, slot_valid = dynamic_slots(boxes, cap)
    kept = budget_keep(boxes, order, slot_valid, budget)
    r_idx, j_idx = kept.nonzero(as_tuple=True)
    bidx = order[r_idx, j_idx]
    xyxy = boxes.xyxy[r_idx, bidx]
    label = boxes.label[r_idx, bidx]
    nb = xyxy.shape[0]
    o, cf, dm = (orientation(nets, crops(obs.image, xyxy, r_idx,
                                         c["network_height"])[0])
                 if nb else (torch.zeros((0, 2, 2), device=dev),
                             torch.zeros((0, 2), device=dev),
                             torch.zeros((0, 3), device=dev)))
    cand = multibin_candidates(o, cf, dm, xyxy, label, c, K)
    locs = cand.locs
    if c["vision_depth_refine"]:
        locs = refine(cand, depths[r_idx, bidx],
                      torch.ones((), dtype=torch.bool, device=dev), K)
    ar = torch.arange(nb, device=dev)
    kbin = torch.argmax(cf, -1) if nb else torch.zeros(0, dtype=torch.long,
                                                       device=dev)
    best = torch.argmin(cand.err[ar, kbin], -1)
    pos = transform(T_cb, locs[ar, kbin, best])
    r_n = obs.image.shape[0]

    def scatter(x, fill):
        out = torch.full((r_n, cap) + x.shape[1:], fill, dtype=x.dtype,
                         device=dev)
        out[r_idx, j_idx] = x
        return out

    poses = types.SimpleNamespace(
        position=scatter(pos, 0.0),
        quat=scatter(quat_from_pitch(cand.yaw[ar, kbin]), 0.0),
        length=scatter(cand.length, 0.0), width=scatter(cand.width, 0.0),
        height=scatter(cand.height, 0.0), label=scatter(label, 0),
        valid=scatter(torch.ones(nb, dtype=torch.bool, device=dev), False))
    xyz_base = transform(T_cb, xyz_cam)
    lo, occ, i8 = grid_update(state.log_odds, state.occupancy, poses,
                              xyz_base, obs.count, c,
                              c["raycast_free_space"])
    # the control's log-odds in its precision
    lo = round_values(lo, nets.mode)
    occ = 1.0 / (1.0 + torch.exp(-lo))
    i8 = torch.round(torch.clamp(occ, 0.0, 1.0) * 100.0).to(torch.int8)
    n_dyn = (boxes.valid & is_dynamic(boxes.label)).sum(-1).to(torch.int32)
    sat = types.SimpleNamespace(
        prenms_overflow=overflow,
        orientation_clamped=torch.clamp(n_dyn - cap, min=0),
        box_cloud_truncated=torch.zeros_like(n_dyn),
        orientation_dropped=(slot_valid.sum(-1) - kept.sum(-1)).to(
            torch.int32),
        static_depth_clamped=static_clamped)
    out = types.SimpleNamespace(boxes=boxes, poses=poses,
                                static_points=static_points,
                                static_depths=depths, occupancy_i8=i8,
                                saturation=sat)
    return types.SimpleNamespace(log_odds=lo, occupancy=occ), out
