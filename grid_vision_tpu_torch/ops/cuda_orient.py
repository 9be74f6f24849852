"""The orientation net's fused front end: the
``orientation_stem_backend="pallas"`` path of the fleet tick.

Counterpart of grid_vision_tpu/ops/pallas_orient.py (orient_front_pallas):
(R, H, W, 3) frames + the fleet-compacted (N, 4) boxes, their validity and
each box's rig index -> bilinear crop-resize to S x S -> per-crop
per-channel standardization (quirk Q10) -> ConvBN_0 of OrientationNetS2D
(the folded 12x12/s8 s2d stem, BN, relu) -> the (N, S/8, S/8, 4w) NHWC
activation the net takes with stem_external=True. On a CUDA tensor
``orient_front_cuda`` launches the hand-written kernels of
``csrc/cuda_orient.cu`` (its note says what bounds them and how: the crop
kernel computes its own sample positions from the boxes, the conv runs on
the tensor cores in 3xTF32 from weights split and packed here once per
model); on a CPU tensor it runs ``orient_front_plain``: per crop,
crop_resize against its rig's frame, _standardize, then the module's
ConvBN_0.

The bf16 form (constants from ``prepare_orient_constants(model,
torch.bfloat16)``, bf16 frames, a bf16 activation out) rounds where the
Pallas kernel rounds at compute_dtype=bf16: the interpolation weights and
each resize product's result are bf16 (the bf16 crop), the statistics are
single-pass f32 moments of that crop, the standardized crop
((x - mean) * inv in f32) is rounded to bf16, the conv weights are bf16
without the BN scale, the sums f32, BN and relu f32 rounded once. Its twin
computes the same with the bf16 crop_resize, single_pass_stats and F.conv2d
on the bf16-rounded operands. On the card it is one launch of
``csrc/cuda_orient_bf16.cu`` (a thread-block cluster a crop, the crop kept
in shared memory, the conv on wgmma), planned by ``orient_bf16_plan``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

import torch.nn.functional as F

from ..models.layers import fold_bn, same_pad
from ..types import Boxes
from . import bf16mma, cuda_build, tf32x3
from .preprocess import _standardize, crop_resize, single_pass_stats

S2D_BLOCK = 4           # the net's s2d_fold block (ConvBN_0, block=4)
RUN = 40                # one kernel row on a crop row: 12 px x 3 ch, padded
TAPS = 12 * 12 * 3      # the folded conv's K, unpadded in the bf16 form
MAX_F = 128             # the channels a conv block of the kernel holds
# Kernel calls made by orient_front_cuda (one per call): of the f32 form
# (two launches of csrc/cuda_orient.cu) and of the bf16 form (one launch of
# csrc/cuda_orient_bf16.cu).
launches = 0
launches_bf16 = 0

# csrc/cuda_orient_bf16.cu's plan (make_plan): B of wgmma a 64-channel half
# (27 k steps of 2048 bytes), the BN constants and the barrier / partial
# sums, one block's shared memory, the m64 tiles of its four warpgroups,
# the rows of the x pass's buffer.
_HALF_BYTES = TAPS // 16 * 2048
_HEAD_BYTES = 2 * MAX_F * 4 + 512
_MAX_SHARED_BYTES = 232448
_MAX_TILES = 4
_BUF_ROWS = (4, 16)


def prepare_orient_constants(model, dtype=torch.float32
                             ) -> Dict[str, torch.Tensor]:
    """Fold ConvBN_0 of an OrientationNetS2D once (Engine init), on the
    net's device: wfrag (60, F / 8, 32, 4), the 12x12x3 folded kernel as a
    (12 * 40, F) matrix (row uy * 40 + ux * 3 + c; each run of 36 padded to
    40 with zero rows, a multiple of the mma's k = 8), BN scale folded in,
    split into TF32 hi and lo and packed in mma fragment order
    (tf32x3.pack_b_fragments); and the BN shift t (F,).

    dtype=torch.bfloat16, the bf16 form: wwg (27, ceil(F / 64), 8, 2, 8, 8)
    bf16, the kernel as a (432, F) matrix (row uy * 36 + ux * 3 + c, no
    padding) without the BN scale, laid out for wgmma by
    bf16mma.pack_wgmma_b_halves; the BN scale s and shift t; w_oihw, the
    folded 12x12 kernel in bf16 for the twin; dtype."""
    if dtype == torch.bfloat16:
        with torch.no_grad():
            conv = model.ConvBN_0
            w = conv.conv_weight().detach()                  # (F, 3, 12, 12)
            f = w.shape[0]
            scale, shift = fold_bn(conv.BatchNorm_0)
            return dict(wwg=bf16mma.pack_wgmma_b_halves(
                w.permute(2, 3, 1, 0).reshape(TAPS, f)),
                s=scale.contiguous(), t=shift.contiguous(),
                w_oihw=w.to(torch.bfloat16).contiguous(),
                dtype=torch.bfloat16)
    with torch.no_grad():
        wmat, t = tf32x3.folded_matrix(model.ConvBN_0)       # (432, F)
        f = wmat.shape[1]
        rows = wmat.reshape(12, 36, f)
        padded = torch.cat([rows, rows.new_zeros((12, RUN - 36, f))], dim=1)
        return dict(wfrag=tf32x3.pack_b_fragments(padded.reshape(12 * RUN,
                                                                 f)),
                    t=t.contiguous())


def orient_bf16_plan(size: int, f: int):
    """(cluster, rows, crop_rows, stride, buf_rows, shared_bytes): how the
    bf16 kernel (csrc/cuda_orient_bf16.cu, make_plan) takes crops of `size`
    at width f. A cluster of `cluster` blocks a crop, block b owning output
    rows [rows b, rows b + rows) of the size / 8 and holding the 8 rows + 4
    crop rows they read, each `stride` bf16 long (size + 4 pixels: the
    right SAME padding is 4 zero pixels); the x pass's buffer holds
    buf_rows frame rows; a block's dynamic shared memory. The smallest
    cluster whose block fits: its pixels in four m64 tiles, its shared
    memory (B, the constants, the tap tables, the buffer of at least 4
    rows, the crop rows) in one block's. Raises where none does."""
    if size <= 0 or size % 8 or f <= 0 or f % 16 or f > MAX_F:
        raise ValueError(f"the bf16 orientation kernel takes size % 8 == 0 "
                         f"and F % 16 == 0, F <= {MAX_F} (size {size}, "
                         f"F {f})")
    q = size // 8
    for cluster in (1, 2, 4, 8):
        rows = -(-q // cluster)
        if -(-(rows * q) // 64) > _MAX_TILES:
            continue
        crop_rows = 8 * rows + 4
        stride = 3 * size + 12
        fixed = (-(-f // 64) * _HALF_BYTES + _HEAD_BYTES
                 + 16 * (size + crop_rows) + 2 * crop_rows * stride)
        buf = min(_BUF_ROWS[1], (_MAX_SHARED_BYTES - fixed) // (8 * size))
        if buf >= _BUF_ROWS[0]:
            return cluster, rows, crop_rows, stride, buf, fixed + 8 * size * buf
    raise ValueError(
        f"{size} x {size} crops do not fit the bf16 orientation kernel: a "
        f"block of a cluster of 8 needs more than {_MAX_SHARED_BYTES} bytes "
        "of shared memory or four m64 tiles")


def bf16_plan_on_card(size: int, f: int):
    """The bf16 kernel's own plan (gv_orient_bf16_plan) and the clusters of
    it resident on the card at once: (cluster, rows, crop_rows, stride,
    buf_rows, shared_bytes, resident_clusters): the check of
    orient_bf16_plan (a check, not a path)."""
    plan = (ctypes.c_int * 7)()
    fn = cuda_build.load("cuda_orient_bf16").gv_orient_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cuda_build.check(fn(size, f, ctypes.addressof(plan)),
                     "gv_orient_bf16_plan")
    return tuple(plan)


def _pad_lo(size: int) -> int:
    """Low SAME pad in pixels of the folded stem: computed on the 4-pixel
    block grid (models/layers.conv2d_same with block=4), (0, 4) at 224."""
    return same_pad(size // S2D_BLOCK, 3, 2)[0] * S2D_BLOCK


def crops_by_rig(images: torch.Tensor, xyxy: torch.Tensor,
                 rig: torch.Tensor, size: int,
                 dtype=torch.float32) -> torch.Tensor:
    """(N, S, S, 3) bilinear crops (crop_resize in `dtype`, the crops in
    it too), each cut from its rig's frame of the (R, H, W, 3) images."""
    n = xyxy.shape[0]
    crops = torch.zeros((n, size, size, 3), dtype=dtype,
                        device=images.device)
    boxes = Boxes(xyxy=xyxy, confidence=torch.zeros_like(xyxy[:, 0]),
                  label=torch.zeros_like(rig, dtype=torch.int32),
                  valid=torch.ones_like(rig, dtype=torch.bool))
    for r in range(images.shape[0]):
        idx = torch.nonzero(rig == r)[:, 0]
        if idx.numel():
            crops[idx] = crop_resize(images[r], boxes.take(idx), size,
                                     dtype, out_dtype=dtype)
    return crops


def _orient_plain_bf16(images, xyxy, valid, rig, consts, size):
    crops = crops_by_rig(images, xyxy, rig, size, torch.bfloat16)
    mean, inv = single_pass_stats(crops)
    std = ((crops.float() - mean) * inv).to(torch.bfloat16)
    std = torch.where(valid[:, None, None, None], std.float(),
                      torch.zeros((), device=std.device))
    lo, hi = (S2D_BLOCK * p for p in same_pad(size // S2D_BLOCK, 3, 2))
    y = F.conv2d(F.pad(std.permute(0, 3, 1, 2), (lo, hi, lo, hi)),
                 consts["w_oihw"].float(), stride=2 * S2D_BLOCK)
    s, t = consts["s"], consts["t"]
    y = torch.relu(y * s[None, :, None, None] + t[None, :, None, None])
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def orient_front_plain(images: torch.Tensor, xyxy: torch.Tensor,
                       valid: torch.Tensor, rig: torch.Tensor, model,
                       size: int, consts=None) -> torch.Tensor:
    """The kernel's plain twin, (N, S/8, S/8, F) NHWC. f32: each crop cut
    from its rig's frame (crop_resize), standardized (_standardize), then
    the module's ConvBN_0. bf16 (bf16 consts): the bf16 crops, single-pass
    statistics, the standardized crop rounded to bf16, the conv from the
    bf16 weights in consts, rounded where the kernel rounds."""
    if consts is not None and \
            cuda_build.consts_dtype(consts) == torch.bfloat16:
        return _orient_plain_bf16(images, xyxy, valid, rig, consts, size)
    std = _standardize(crops_by_rig(images, xyxy, rig, size), valid)
    return model.ConvBN_0(std.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).contiguous()


def _launch(images: torch.Tensor, xyxy: torch.Tensor, valid: torch.Tensor,
            rig: torch.Tensor, consts, size: int) -> torch.Tensor:
    global launches, launches_bf16
    dev = images.device
    dt = cuda_build.consts_dtype(consts)
    if (images.dtype != dt or images.dim() != 4
            or images.shape[-1] != 3 or not images.is_contiguous()):
        raise ValueError(f"images must be a contiguous (R, H, W, 3) {dt} "
                         "tensor (the form of the constants)")
    n = xyxy.shape[0]
    if (xyxy.dtype != torch.float32 or xyxy.shape != (n, 4)
            or valid.shape != (n,) or valid.dtype != torch.bool
            or rig.shape != (n,)
            or rig.dtype not in (torch.int32, torch.int64)):
        raise ValueError("boxes (N, 4) float32, valid (N,) bool and rig "
                         "(N,) int32 or int64 are required")
    if any(t.device != dev or not t.is_contiguous()
           for t in (xyxy, valid, rig)):
        raise ValueError("boxes, valid and rig must be contiguous, on the "
                         "frames' device")
    if size % (2 * S2D_BLOCK):
        raise ValueError(f"size {size} must be a multiple of "
                         f"{2 * S2D_BLOCK}")
    _, h, w, _ = images.shape
    t = consts["t"]
    f = t.shape[0]
    if dt == torch.bfloat16:
        orient_bf16_plan(size, f)                   # raises what it refuses
        cuda_build.check_constants(consts, dict(
            wwg=((TAPS // 16, -(-f // 64), 8, 2, 8, 8), torch.bfloat16),
            s=((f,), torch.float32), t=((f,), torch.float32)), dev,
            "orientation")
        if images.data_ptr() % 4:
            raise ValueError("bf16 frames must start at a 4-byte boundary "
                             "(the kernel reads them 4 bytes at a time)")
        if any(x.data_ptr() % 16 for x in (consts["wwg"], consts["s"], t)):
            raise ValueError("the bf16 constants must start at a 16-byte "
                             "boundary (the kernel copies them in bulk)")
    else:
        wfrag = consts["wfrag"]
        if (f % 16 or f > MAX_F
                or wfrag.shape != (12 * RUN // 8, f // 8, 32, 4)
                or any(a.device != dev or a.dtype != torch.float32
                       or not a.is_contiguous() for a in (wfrag, t))):
            raise ValueError(
                "orientation constants must be contiguous float32 wfrag "
                f"({12 * RUN // 8}, F / 8, 32, 4) and t (F,) with F % 16 == 0"
                f" and F <= {MAX_F}, on the frames' device")
    q = -(-(size // S2D_BLOCK) // 2)
    out = torch.empty((n, q, q, f), dtype=dt, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (h, w, rig.data_ptr(), int(rig.dtype == torch.int64),
            valid.data_ptr(), xyxy.data_ptr(), n, size)
    if dt == torch.bfloat16:
        fn = cuda_build.load("cuda_orient_bf16").gv_orient_front_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [P, I, I, I, P, I, P, P, I, I, P, I, P, P, P, P]
        cuda_build.check(fn(images.data_ptr(), images.shape[0], *head,
                            consts["wwg"].data_ptr(), f,
                            consts["s"].data_ptr(), t.data_ptr(),
                            out.data_ptr(), stream), "gv_orient_front_bf16")
        launches_bf16 += 1
        return out
    crops = torch.empty((n, size, size, 3), dtype=dt, device=dev)
    stats = torch.empty((n, 6), dtype=torch.float32, device=dev)
    fn = cuda_build.load("cuda_orient").gv_orient_front
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I, I, P, I, P, P, I, I, I, I, P, I, P, P, P, P, P]
    cuda_build.check(fn(images.data_ptr(), *head, q, _pad_lo(size),
                        consts["wfrag"].data_ptr(), f, t.data_ptr(),
                        crops.data_ptr(), stats.data_ptr(), out.data_ptr(),
                        stream), "gv_orient_front")
    launches += 1
    return out


def wgmma_product_bf16_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) on the card through the wgmma path of the bf16
    kernels (bf16 operands, f32 sums; B laid out by bf16mma.pack_wgmma_b at
    N = 32 and 96 (m64n32k16, m64n96k16: the CSP stage's conv a and conv b
    take N = 96), else by
    pack_wgmma_b_halves, which at N <= 64 is pack_wgmma_b's layout, and
    brought into shared memory by cp.async.bulk, A from registers in its k
    order): the check of the layout that the bf16 stem's conv1, the bf16
    orientation conv and the bf16 CSP stage's convs give wgmma, against a
    plain product (no path calls it). M % 64 == 0, K % 16 == 0, K <= 576,
    N % 16 == 0, N <= 128; the result is f32."""
    k = a.shape[1] if a.dim() == 2 else 0
    if (a.device.type != "cuda" or b.device != a.device or a.dim() != 2
            or b.dim() != 2 or b.shape[0] != k or a.shape[0] % 64
            or k % 16 or k > 576 or b.shape[1] % 16 or b.shape[1] > MAX_F):
        raise ValueError(f"a (M, K) and b (K, N) must be CUDA matrices, "
                         f"M % 64 == 0, K % 16 == 0, K <= 576, N % 16 "
                         f"== 0, N <= {MAX_F}")
    n = b.shape[1]
    a16 = a.to(torch.bfloat16).contiguous()
    if n in (32, 96):
        bw, width = bf16mma.pack_wgmma_b(b), n
    else:
        bw = bf16mma.pack_wgmma_b_halves(b)
        width = 64 * bw.shape[1]
    c = torch.empty((a.shape[0], width), dtype=torch.float32,
                    device=a.device)
    fn = cuda_build.load("cuda_orient_bf16").gv_wgmma_product_bf16
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, I, P, P]
    cuda_build.check(
        fn(a16.data_ptr(), a.shape[0], k, bw.data_ptr(), width,
           c.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream),
        "gv_wgmma_product_bf16")
    return c[:, :n]


def box_axis_samples_cuda(xyxy: torch.Tensor, h: int, w: int, size: int):
    """The crop kernel's own sample tables ((ylo, yhi, fy), (xlo, xhi,
    fx)), each (N, size), for (N, 4) boxes on the card: what it computes
    in place of preprocess.box_axis_samples (a check, not a path)."""
    if (xyxy.device.type != "cuda" or xyxy.dtype != torch.float32
            or xyxy.dim() != 2 or xyxy.shape[1] != 4
            or not xyxy.is_contiguous()):
        raise ValueError("boxes must be a contiguous (N, 4) float32 CUDA "
                         "tensor")
    n = xyxy.shape[0]
    ints = [torch.empty((n, size), dtype=torch.int32, device=xyxy.device)
            for _ in range(4)]
    fracs = [torch.empty((n, size), dtype=torch.float32, device=xyxy.device)
             for _ in range(2)]
    fn = cuda_build.load("cuda_orient").gv_orient_samples
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, I] + [P] * 7
    (ylo, yhi, xlo, xhi), (yfr, xfr) = ints, fracs
    cuda_build.check(
        fn(xyxy.data_ptr(), n, h, w, size, ylo.data_ptr(), yhi.data_ptr(),
           yfr.data_ptr(), xlo.data_ptr(), xhi.data_ptr(), xfr.data_ptr(),
           torch.cuda.current_stream(xyxy.device).cuda_stream),
        "gv_orient_samples")
    return (ylo, yhi, yfr), (xlo, xhi, xfr)


def orient_front_cuda(images: torch.Tensor, xyxy: torch.Tensor,
                      valid: torch.Tensor, rig: torch.Tensor, model,
                      consts, size: int) -> torch.Tensor:
    """(R, H, W, 3) [0, 255] frames + (N, 4) boxes, (N,) validity and (N,)
    rig indices in [0, R) -> (N, S/8, S/8, F) post-ConvBN_0 activations:
    the kernels on a CUDA tensor (consts: prepare_orient_constants on its
    device), the plain twin for a CPU tensor. The form of consts (f32 or
    bf16) is the frames' and the activation's dtype; frames of another
    dtype raise."""
    if images.device.type == "cpu":
        dt = cuda_build.consts_dtype(consts)
        if images.dtype != dt:
            raise ValueError(f"images must be {dt}, the form of the "
                             "constants")
        return orient_front_plain(images, xyxy, valid, rig, model, size,
                                  consts)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    return _launch(images, xyxy, valid, rig, consts, size)
