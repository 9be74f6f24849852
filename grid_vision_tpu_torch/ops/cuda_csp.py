"""The detector's first CSP stage: the ``detector_stem_backend="pallas2"``
and ``"pallas3"`` paths (both run this one kernel).

Counterpart of grid_vision_tpu/ops/pallas_csp.py (detector_csp_pallas and
detector_csp_flat, two TPU layouts of one function): the (B, S/4, S/4, 64)
stem activation -> ConvBN_2 -> CSPBlock_0 -> 2x2/s2 max pool -> the
(B, S/8, S/8, 128) NHWC activation that YoloV4Tiny takes with
front_external=True. On a CUDA tensor ``detector_csp_cuda`` launches the
hand-written kernels of ``csrc/cuda_csp.cu`` (its note says what bounds
them and how: the convs run on the tensor cores in 3xTF32, from weights
split and packed here once per model); on a CPU tensor it runs
``detector_csp_plain``, the detector module's own ConvBN_2 -> CSPBlock_0 ->
max_pool2d.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build, tf32x3

# Kernel calls made by detector_csp_cuda (one per call; a call is four
# launches of csrc/cuda_csp.cu).
launches = 0


def prepare_csp_constants(detector) -> Dict[str, torch.Tensor]:
    """Fold ConvBN_2 and CSPBlock_0 of a YoloV4Tiny once (Engine init), on
    the detector's device. Each conv's (k * k * C_in, C_out) matrix in
    (ty, tx, c) row order, BN scale folded in, split into TF32 hi and lo
    and packed in mma fragment order (tf32x3.pack_b_fragments): w2
    (72, 8, 32, 4), wa / wb (36, 4, 32, 4), wc (8, 8, 32, 4); and each
    conv's BN shift b2, ba, bb, bc."""
    with torch.no_grad():
        csp = detector.CSPBlock_0
        out = {}
        for key, conv_bn in (("2", detector.ConvBN_2), ("a", csp.ConvBN_0),
                             ("b", csp.ConvBN_1), ("c", csp.ConvBN_2)):
            wmat, shift = tf32x3.folded_matrix(conv_bn)
            out[f"w{key}"] = tf32x3.pack_b_fragments(wmat)
            out[f"b{key}"] = shift.contiguous()
        return out


_SHAPES = dict(w2=(72, 8, 32, 4), b2=(64,), wa=(36, 4, 32, 4), ba=(32,),
               wb=(36, 4, 32, 4), bb=(32,), wc=(8, 8, 32, 4), bc=(64,))


def detector_csp_plain(x: torch.Tensor, detector) -> torch.Tensor:
    """The kernel's plain twin: the module's ConvBN_2 -> CSPBlock_0 ->
    max_pool2d, NHWC in and out."""
    return detector.front(x.permute(0, 3, 1, 2)).permute(0, 2, 3,
                                                          1).contiguous()


def _launch(x: torch.Tensor, consts) -> torch.Tensor:
    global launches
    dev = x.device
    if (x.dtype != torch.float32 or x.dim() != 4 or x.shape[-1] != 64
            or not x.is_contiguous()):
        raise ValueError("x must be a contiguous (B, H, W, 64) float32 "
                         "tensor")
    for name, shape in _SHAPES.items():
        t = consts[name]
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"CSP constant {name} must be a contiguous "
                             f"{shape} float32 tensor on {dev}")
    b, h, w, _ = x.shape
    y = torch.empty_like(x)
    xcat = torch.empty_like(x)
    out = torch.empty((b, h // 2, w // 2, 128), dtype=torch.float32,
                      device=dev)
    lib = cuda_build.load("cuda_csp")
    fn = lib.gv_detector_csp
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I] + [P] * 8 + [P, P, P, P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(x.data_ptr(), b, h, w,
           *(consts[k].data_ptr() for k in _SHAPES),
           y.data_ptr(), xcat.data_ptr(), out.data_ptr(), stream),
        "gv_detector_csp")
    launches += 1
    return out


def mma_product_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) on the card through the kernels' 3xTF32 tile
    product, one warp per 16 x 8 tile (the check of gv_mma.cuh's fragment
    layout and of tf32x3.pack_b_fragments against a library product; no
    path calls it). M % 16 == N % 16 == K % 8 == 0."""
    if (a.device.type != "cuda" or b.device != a.device
            or a.dtype != torch.float32 or b.dtype != torch.float32
            or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.shape[0] % 16 or not a.is_contiguous()):
        raise ValueError("a (M, K) and b (K, N) must be float32 CUDA "
                         "matrices, a contiguous, M % 16 == 0")
    bfrag = tf32x3.pack_b_fragments(b)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    fn = cuda_build.load("cuda_csp").gv_mma_product
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, P]
    cuda_build.check(
        fn(a.data_ptr(), bfrag.data_ptr(), c.data_ptr(), a.shape[0],
           b.shape[1], a.shape[1],
           torch.cuda.current_stream(a.device).cuda_stream),
        "gv_mma_product")
    return c


def detector_csp_cuda(x: torch.Tensor, detector, consts) -> torch.Tensor:
    """(B, H, W, 64) stem activation -> (B, H/2, W/2, 128): the kernels on
    a CUDA tensor (consts: prepare_csp_constants on its device), the plain
    twin on the detector's modules for a CPU tensor."""
    if x.device.type == "cpu":
        return detector_csp_plain(x, detector)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, consts)
