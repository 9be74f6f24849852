"""The int8 detector's conv: an s8 implicit-GEMM kernel with the requant
fused into its epilogue, and the same kernel as a plain GEMM.

Counterpart of tools/bench_int8_mxu.py's build_matmul (the whole-K and the
K-blocked Pallas kernels, s8 x s8 -> s32 and bf16 x bf16 -> f32 on
detector-shaped GEMMs), which gated a fused int8 detector: on a CUDA
tensor every function here launches the hand-written kernel of
``csrc/cuda_int8.cu`` (its note says what bounds it and how: persistent
blocks, a producer warpgroup staging A and B through a ring of 128-byte
swizzled stages by TMA, two consumer warpgroups on wgmma, the requant in
an epilogue staged through shared memory); on a CPU tensor it runs its
plain version.

- ``int8_conv(xq, layer, stride)``: (B, H, W, Cin) int8 -> (B, Ho, Wo,
  Cout) int32 accumulators of the layer's SAME conv (flax padding; a
  layer of yolov4_int8: OIHW ``wq`` and its (Cout, Kp) GEMM matrix ``wt``,
  k in (ty, tx, c) order). Plain: ``int8_conv_plain``, float64 F.conv2d,
  exact.
- ``int8_conv_requant(xq, sx, layer, stride)``: the f32 outputs
  leaky_0.1(acc * (sx * sw) + b) of ``requant`` bit for bit, from the
  accumulators in registers; sx per sample (B, 1, 1, 1), or one scale
  (the static-scale forward's 0-d scale, expanded here). Plain:
  ``int8_conv_requant_plain``.
- ``int8_matmul(a, b)`` / ``bf16_matmul(a, b)``: (M, K) x (K, N) ->
  int32 / f32, the tool's two products: the kernel's 1x1, stride-1 form
  over a (1, M, 1, K) view. b's column-major form (b.t() contiguous, the
  conv's weight layout) is used as it is; any other b is copied into it.

``launches`` counts kernel launches (one a call on a CUDA tensor).
``int8_plan`` is the rule by which the wrapper picks the kernel's tile,
the route by which A reaches shared memory and the persistent grid;
``force_plan`` overrides it (the measuring tools).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import same_pad
from . import cuda_build

# Kernel launches made by this module's functions (one per call on a CUDA
# tensor).
launches = 0

# csrc/cuda_int8.cu: 128 output rows a tile (two consumer warpgroups of
# 64); its N tile 256, 128, 64 or 32 (bf16 up to 128); K in stages of 128
# bytes (the 128-byte swizzle's row), at most MAX_STAGES in the ring,
# within a block's MAX_SMEM bytes of dynamic shared memory.
TILE_M = 128
TILE_N = (256, 128, 64, 32)
TILE_N_BF16 = (128, 64, 32)
STAGE_K = 128
MAX_SMEM = 232448
MAX_STAGES = 8
# the fixed shared memory beside the ring: the epilogue's staging (a 64 x
# 32 chunk of 4-byte outputs a consumer warpgroup), the gather's row
# table, the requant's sx, sw (f32) and bias (f64) for up to 768 frames
# and channels, the barriers, the alignment
SMEM_FIXED = 2 * 64 * 128 + TILE_M * 16 + 4 * 768 * 4 + 256 + 1024
# The card's SMs (an H100 SXM); the wrapper reads the device's own count.
SMS = 132
# A tile's cost in int8_plan: one column of the tile a unit, this many for
# its fixed part (the epilogue's barriers, the pipeline's fill)
TILE_COST = 64
# How A reaches shared memory (the kernel's route argument, in order): by
# a TMA tiled copy (1x1, stride 1), TMA im2col copies (C a multiple of 128
# bytes: a copy a stage; s8 C of 32 or 64: a copy a tap, two or four a
# stage), 16-byte cp.async pieces (C a multiple of 16 bytes), ConvBN_0's
# three runs of nine bytes (C = 3, k = 3), or byte by byte (any other C).
ROUTES = ("tiled", "im2col", "gather", "runs", "bytes")


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    route: str
    tile_n: int
    tiles: int          # output tiles, TILE_M x tile_n
    blocks: int         # the persistent grid: one block an SM at most
    stages: int         # the ring's stages
    smem: int           # a block's dynamic shared memory (bytes)


def ring_stages(bn: int) -> int:
    """The ring's stages at N tile bn (the kernel's Smem<BN>::kStages)."""
    stage = TILE_M * STAGE_K + bn * STAGE_K
    return min(MAX_STAGES, (MAX_SMEM - SMEM_FIXED) // stage)


def smem_bytes(bn: int) -> int:
    """A block's dynamic shared memory at N tile bn (Smem<BN>::kBytes)."""
    return ring_stages(bn) * (TILE_M + bn) * STAGE_K + SMEM_FIXED


def routes_for(c: int, ksize: int, stride: int, size: int = 1,
               aligned: bool = True) -> Tuple[str, ...]:
    """The routes the kernel can take for A of a ksize x ksize conv of
    stride over C channels of `size` bytes (x 16-byte aligned or not),
    the rule's first."""
    out = []
    if aligned and c * size % 16 == 0:
        if ksize == 1 and stride == 1:
            out.append("tiled")
        if c * size % STAGE_K == 0 or (size == 1 and c in (32, 64)):
            out.append("im2col")
        out.append("gather")
    if size == 1:
        if c == 3 and ksize == 3:
            out.append("runs")
        out.append("bytes")
    return tuple(out)


def int8_plan(m: int, n: int, k: int, c: int = 0, ksize: int = 1,
              stride: int = 1, size: int = 1, aligned: bool = True,
              sms: int = SMS, tile_n: Optional[int] = None,
              route: Optional[str] = None) -> Int8Plan:
    """The kernel's plan for an (m, n) output over K = k elements of a
    ksize x ksize conv of stride over c channels (c = k: a GEMM) of
    `size` bytes. The N tile: of the widths not above the narrowest that
    covers n, the one whose blocks take the fewest tile-costs, ceil(tiles
    / sms) x (width + TILE_COST), the wider on a tie (so the 13 x 13
    layers at one frame still spread over the card); the route: the
    first of routes_for. tile_n / route force either (or force_plan)."""
    return _plan(m, n, k, c or k, ksize, stride, size, aligned, sms,
                 tile_n or _forced.get("tile_n"),
                 route or _forced.get("route"))


@functools.lru_cache(maxsize=4096)
def _plan(m, n, k, c, ksize, stride, size, aligned, sms, tile_n, route):
    widths = TILE_N if size == 1 else TILE_N_BF16
    allowed = routes_for(c, ksize, stride, size, aligned)
    if not allowed:
        raise ValueError(f"no route for {c} channels of {size} bytes "
                         f"(aligned {aligned})")
    if route is None:
        route = allowed[0]
    elif route not in allowed:
        raise ValueError(f"route {route!r} cannot take a {ksize}x{ksize} "
                         f"conv of stride {stride} over {c} channels of "
                         f"{size} bytes: {allowed}")
    m_tiles = -(-m // TILE_M)
    if tile_n is None:
        top = next((w for w in reversed(widths) if w >= n), widths[0])
        best = None
        for w in widths:
            if w > top:
                continue
            cost = -(-(m_tiles * -(-n // w)) // sms) * (w + TILE_COST)
            if best is None or cost < best[0]:
                best = (cost, w)
        tile_n = best[1]
    elif tile_n not in widths:
        raise ValueError(f"tile_n {tile_n} is not one of {widths}")
    tiles = m_tiles * -(-n // tile_n)
    return Int8Plan(route=route, tile_n=tile_n, tiles=tiles,
                    blocks=max(1, min(tiles, sms)),
                    stages=ring_stages(tile_n), smem=smem_bytes(tile_n))


_forced: Dict[str, object] = {}


@contextlib.contextmanager
def force_plan(tile_n: Optional[int] = None, route: Optional[str] = None):
    """Within the block every launch takes this N tile and / or route
    (int8_plan raises where the route cannot take a layer)."""
    saved = dict(_forced)
    _forced.clear()
    _forced.update({k: v for k, v in (("tile_n", tile_n), ("route", route))
                    if v is not None})
    try:
        yield
    finally:
        _forced.clear()
        _forced.update(saved)


def out_size(n: int, stride: int) -> int:
    return -(-n // stride)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """The int8 conv's plain version: (B, H, W, Cin) int8 with OIHW int8
    weights, SAME as flax pads -> (B, Ho, Wo, Cout) int32, computed in
    float64 F.conv2d (exact: every sum is an integer below 2^53)."""
    k = wq.shape[-1]
    py = same_pad(xq.shape[1], k, stride)
    px = same_pad(xq.shape[2], k, stride)
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (px[0], px[1], py[0], py[1]))
    y = F.conv2d(x, wq.double(), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def requant(acc: torch.Tensor, sx: torch.Tensor,
            layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """int32 accumulator -> leaky_0.1(acc.f32 * (sx * sw) + b), the
    multiply-add rounded once (jitted XLA fuses it)."""
    scale = (sx * layer["sw"]).double()
    y = acc.float().double() * scale + layer["b"].double()
    return F.leaky_relu(y.float(), 0.1)


def int8_conv_requant_plain(xq: torch.Tensor, sx: torch.Tensor,
                            layer: Dict[str, torch.Tensor],
                            stride: int) -> torch.Tensor:
    """int8_conv_requant's plain version: requant(int8_conv_plain(...))."""
    return requant(int8_conv_plain(xq, layer["wq"], stride), sx, layer)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, in float64 (exact below
    2^53, i.e. K < 5e11; torch has no int64 matmul on the card)."""
    return (a.double() @ b.double()).to(torch.int32)


def bf16_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (K, N) bf16 -> (M, N) f32: float64 sums of the bf16
    values, rounded once."""
    return (a.double() @ b.double()).float()


def f32_sum_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) bound on the error of an f32 sum of a @ b's exact products:
    K u (|a| @ |b|), u = 2^-24, the first-order bound of any order of K
    round-to-nearest f32 additions. It covers bf16_matmul's roundings (2
    K / 16: a k-16 step's truncating sum on the tensor core counts 2 u, its
    addition to the running sum u). Its bar at K = 2304, where unit-normal
    sums of f32 roundings alone pass 1e-4."""
    return (a.double().abs() @ b.double().abs()) * (a.shape[1] * 2.0 ** -24)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_int8").gv_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p] * 5
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, wt: torch.Tensor, k: int,
             stride: int) -> Int8Plan:
    """int8_plan of the kernel's launch on x (B, H, W, C) and wt (N, Kp)
    (the card's SM count on a CUDA tensor, SMS otherwise)."""
    b, h, w, c = x.shape
    sms = _sms(x.device.index or 0) if x.device.type == "cuda" else SMS
    return int8_plan(b * out_size(h, stride) * out_size(w, stride),
                     wt.shape[0], k * k * c, c, k, stride,
                     x.element_size(), x.data_ptr() % 16 == 0, sms)


def _launch(x: torch.Tensor, wt: torch.Tensor, k: int, stride: int,
            requant_by: Optional[Tuple[torch.Tensor, ...]] = None
            ) -> torch.Tensor:
    """The kernel on x (B, H, W, C) and wt (N, Kp), both int8 or both
    bf16: the (B, Ho, Wo, N) accumulators (int32; f32 in bf16), or with
    requant_by = (sx (B,), sw (N,), bias (N,)) the requantized f32."""
    global launches
    dev = x.device
    if x.dtype not in (torch.int8, torch.bfloat16) or x.dim() != 4:
        raise ValueError("x must be a (B, H, W, C) int8 or bf16 tensor")
    if wt.dtype != x.dtype or wt.dim() != 2 or wt.device != dev:
        raise ValueError("wt must be an (N, Kp) tensor of x's dtype on its "
                         "device")
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("x and wt must be contiguous")
    b, h, w, c = x.shape
    n, kp = wt.shape
    size = x.element_size()
    if k < 1 or stride < 1 or k * k * c > kp or kp * size % 16:
        raise ValueError(f"wt ({n}, {kp}) does not hold a {k}x{k} conv of "
                         f"{c} channels padded to 16 bytes")
    if wt.data_ptr() % 16:
        raise ValueError("wt must be 16-byte aligned (its TMA tensor map)")
    if x.dtype == torch.bfloat16 and (c * size % 16 or x.data_ptr() % 16):
        raise ValueError("a bf16 x needs C a multiple of 8, 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError("x has 2^31 elements or more")
    ho, wo = out_size(h, stride), out_size(w, stride)
    py, px = same_pad(h, k, stride), same_pad(w, k, stride)
    plan = plan_for(x, wt, k, stride)
    sx = sw = bias = None
    if requant_by is not None:
        if x.dtype != torch.int8:
            raise ValueError("the requant epilogue is int8 only")
        sx, sw, bias = requant_by
        for name, t, length in (("sx", sx, b), ("sw", sw, n),
                                ("bias", bias, n)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (length,)
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous ({length},) "
                                 f"float32 tensor on {dev}")
    out = torch.empty((b, ho, wo, n), device=dev,
                      dtype=torch.int32 if requant_by is None
                      and x.dtype == torch.int8 else torch.float32)
    cuda_build.check(
        _entry()(x.data_ptr(), wt.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(requant_by is not None), b, h, w, c, ho, wo, k, stride,
                 py[0], px[0], n, kp, plan.tile_n,
                 ROUTES.index(plan.route), plan.blocks,
                 None if sx is None else sx.data_ptr(),
                 None if sw is None else sw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
        "gv_int8_conv")
    launches += 1
    return out


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def int8_conv(xq: torch.Tensor, layer: Dict[str, torch.Tensor],
              stride: int) -> torch.Tensor:
    """(B, H, W, Cin) int8 -> (B, Ho, Wo, Cout) int32 accumulators of the
    layer's SAME conv: the kernel on a CUDA tensor, int8_conv_plain on a
    CPU tensor."""
    if not _on_card(xq):
        return int8_conv_plain(xq, layer["wq"], stride)
    return _launch(xq, layer["wt"], layer["wq"].shape[-1], stride)


def per_sample(sx: torch.Tensor, batch: int) -> torch.Tensor:
    """A scale per sample (B, 1, 1, 1) or one scale (0-d, or one element)
    -> the kernel's contiguous (B,) f32 vector."""
    if sx.dtype != torch.float32 or sx.numel() not in (1, batch):
        raise ValueError(f"sx must be float32 with 1 or {batch} elements")
    return sx.reshape(-1).expand(batch).contiguous()


def int8_conv_requant(xq: torch.Tensor, sx: torch.Tensor,
                      layer: Dict[str, torch.Tensor],
                      stride: int) -> torch.Tensor:
    """requant(int8_conv(xq, layer, stride), sx, layer) in one launch on a
    CUDA tensor (the requant in the kernel's epilogue, bit for bit);
    int8_conv_requant_plain on a CPU tensor."""
    if not _on_card(xq):
        return int8_conv_requant_plain(xq, sx, layer, stride)
    return _launch(xq, layer["wt"], layer["wq"].shape[-1], stride,
                   (per_sample(sx, xq.shape[0]), layer["sw"], layer["b"]))


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    if (a.dtype != dtype or b.dtype != dtype or a.dim() != 2 or b.dim() != 2
            or a.shape[1] != b.shape[0]):
        raise ValueError(f"a (M, K) and b (K, N) must be {dtype} matrices")
    if b.device != a.device:
        raise ValueError("a and b must share a device")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    m, k = a.shape
    wt = b.t() if b.t().is_contiguous() else b.t().contiguous()
    pad = -k % (16 // a.element_size())
    if pad:                       # the kernel's weight rows: 16-byte pieces
        wt = F.pad(wt, (0, pad))
    return _launch(a.view(1, m, 1, k), wt, 1, 1).view(m, b.shape[1])


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact: the kernel on a
    CUDA tensor (the tool's s8 -> s32 product), int8_matmul_plain on a CPU
    tensor."""
    if not _on_card(a):
        return int8_matmul_plain(a, b)
    return _matmul(a, b, torch.int8)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (K, N) bf16 -> (M, N) f32: the kernel on a CUDA tensor
    (the tool's bf16 -> f32 product, K a multiple of 8), bf16_matmul_plain
    on a CPU tensor."""
    if not _on_card(a):
        return bf16_matmul_plain(a, b)
    return _matmul(a, b, torch.bfloat16)
