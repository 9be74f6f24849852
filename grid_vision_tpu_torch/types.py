"""Fixed-shape, mask-carrying value types of the engine, as dataclasses of
tensors (counterpart of grid_vision_tpu/types.py).

Reference counterparts:
  Boxes      <-> std::vector<BoundingBox>   (object_detection.hpp:27-32)
  PointCloud <-> pcl::PointCloud<PointXYZI> (grid_vision_node.hpp:61)
  LShapePoses<-> std::vector<LShapePose>    (cloud_detections.hpp:19-25)
  GridState  <-> OccupancyGridMap.grid_map_ (occupancy_grid.hpp:22)
  Obs        <-> (init_image_, cloud_) latest-frame buffers

Every ``create``/``empty`` takes an explicit ``device``. The fleet path
carries the same types with a leading rig axis on every tensor
(``GridState.create_batch``, ``stack``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import GridVisionConfig
from .utils import prng


def _map(obj, fn):
    """Apply fn to every tensor field (recursing into nested types)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = fn(v) if isinstance(v, torch.Tensor) else _map(v, fn)
    return type(obj)(**kw)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...], :] along the axis idx indexes (the last axis of
    idx); leading axes broadcast, trailing axes of x ride along."""
    extra = x.dim() - idx.dim()
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * extra),
                                dim=idx.dim() - 1)


class _Tensors:
    def to(self, device):
        return _map(self, lambda t: t.to(device))

    def select(self, i):
        """Rig i of a stacked value (every tensor indexed on axis 0)."""
        return _map(self, lambda t: t[i])


def stack(values):
    """Stack same-typed values along a new leading rig axis."""
    first = values[0]
    kw = {}
    for f in dataclasses.fields(first):
        parts = [getattr(v, f.name) for v in values]
        kw[f.name] = (torch.stack(parts) if isinstance(parts[0], torch.Tensor)
                      else stack(parts))
    return type(first)(**kw)


tree_stack = stack     # the JAX package's name (types.tree_stack)


@dataclasses.dataclass(frozen=True)
class Boxes(_Tensors):
    """Padded 2D detections in pixel space: xyxy (D, 4) f32, confidence
    (D,) f32, label (D,) int32, valid (D,) bool."""

    xyxy: torch.Tensor
    confidence: torch.Tensor
    label: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "Boxes":
        return Boxes(
            xyxy=torch.zeros((capacity, 4), dtype=torch.float32,
                             device=device),
            confidence=torch.zeros((capacity,), dtype=torch.float32,
                                   device=device),
            label=torch.full((capacity,), 10, dtype=torch.int32,
                             device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.xyxy.shape[-2]

    def count(self) -> torch.Tensor:
        """Valid boxes (int32), per rig where boxes carry a rig axis."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    def take(self, idx: torch.Tensor, valid=None) -> "Boxes":
        """Slots idx of every field (valid overridable). idx indexes the
        slot axis and may carry leading rig axes: (R, K) picks K slots of
        each rig."""
        return Boxes(xyxy=_take_rows(self.xyxy, idx),
                     confidence=_take_rows(self.confidence, idx),
                     label=_take_rows(self.label, idx),
                     valid=(_take_rows(self.valid, idx) if valid is None
                            else valid))

    def centers(self) -> torch.Tensor:
        """``min + (max - min)/2`` (cloud_detections.cpp:57-58)."""
        lo = self.xyxy[..., 0:2]
        hi = self.xyxy[..., 2:4]
        return lo + (hi - lo) / 2.0


@dataclasses.dataclass(frozen=True)
class PointCloud(_Tensors):
    """Padded point cloud packed valid-first: xyz (P, 3), intensity (P,),
    count () int32. Rows >= count hold PAD_SENTINEL."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    count: torch.Tensor

    PAD_SENTINEL = 1.0e8

    @staticmethod
    def empty(capacity: int, device=None) -> "PointCloud":
        return PointCloud(
            xyz=torch.full((capacity, 3), PointCloud.PAD_SENTINEL,
                           dtype=torch.float32, device=device),
            intensity=torch.zeros((capacity,), dtype=torch.float32,
                                  device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def pack_host(xyz: np.ndarray, intensity: np.ndarray | None,
                  capacity: int):
        """Pure-numpy packer: drop non-finite points, stride-subsample an
        overflow, pad with the sentinel. Returns (xyz (cap, 3) f32,
        intensity (cap,) f32, n, dropped)."""
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        if intensity is None:
            intensity = np.zeros((xyz.shape[0],), np.float32)
        intensity = np.asarray(intensity, np.float32).reshape(-1)
        finite = np.isfinite(xyz).all(axis=1)
        xyz, intensity = xyz[finite], intensity[finite]
        dropped = max(0, xyz.shape[0] - capacity)
        if xyz.shape[0] > capacity:
            idx = np.linspace(0, xyz.shape[0] - 1, capacity).astype(np.int64)
            xyz, intensity = xyz[idx], intensity[idx]
        n = xyz.shape[0]
        out_xyz = np.full((capacity, 3), PointCloud.PAD_SENTINEL, np.float32)
        out_int = np.zeros((capacity,), np.float32)
        out_xyz[:n] = xyz[:n]
        out_int[:n] = intensity[:n]
        return out_xyz, out_int, n, dropped

    @staticmethod
    def pack_numpy(xyz: np.ndarray, intensity: np.ndarray | None,
                   capacity: int, device=None):
        """pack_host onto `device`; returns (PointCloud, dropped)."""
        out_xyz, out_int, n, dropped = PointCloud.pack_host(
            xyz, intensity, capacity)
        return PointCloud(
            xyz=torch.as_tensor(out_xyz, device=device),
            intensity=torch.as_tensor(out_int, device=device),
            count=torch.tensor(n, dtype=torch.int32, device=device),
        ), dropped

    @staticmethod
    def from_numpy(xyz, intensity, capacity: int, device=None):
        return PointCloud.pack_numpy(xyz, intensity, capacity, device)[0]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.xyz.device)
                < self.count[..., None])


@dataclasses.dataclass(frozen=True)
class LShapePoses(_Tensors):
    """Padded 3D object poses: position (N, 3), quat (N, 4) xyzw,
    length/width/height (N,), label (N,) int32, valid (N,) bool."""

    position: torch.Tensor
    quat: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    label: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "LShapePoses":
        f32 = dict(dtype=torch.float32, device=device)
        quat = torch.zeros((capacity, 4), **f32)
        quat[:, 3] = 1.0
        return LShapePoses(
            position=torch.zeros((capacity, 3), **f32), quat=quat,
            length=torch.zeros((capacity,), **f32),
            width=torch.zeros((capacity,), **f32),
            height=torch.zeros((capacity,), **f32),
            label=torch.full((capacity,), 10, dtype=torch.int32,
                             device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.position.shape[-2]


@dataclasses.dataclass(frozen=True)
class GridState(_Tensors):
    """The engine's persistent state: log_odds / occupancy (H, W) f32 in
    grid_map buffer order, rng, step () int32.

    rng is the JAX package's threefry key layout, a (2,) uint32 tensor
    (jax.random.PRNGKey(seed)); every tick splits it as the JAX package
    does (utils/prng.py)."""

    log_odds: torch.Tensor
    occupancy: torch.Tensor
    rng: torch.Tensor
    step: torch.Tensor

    @staticmethod
    def create(cfg: GridVisionConfig, seed: int = 0,
               device=None) -> "GridState":
        h, w = cfg.grid_size
        return GridState(
            log_odds=torch.full((h, w), cfg.log_odds_prior,
                                dtype=torch.float32, device=device),
            occupancy=torch.full((h, w), cfg.init_probability,
                                 dtype=torch.float32, device=device),
            rng=prng.prng_key(seed, device=device),
            step=torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def create_batch(cfg: GridVisionConfig, n: int, seed: int = 0,
                     device=None) -> "GridState":
        """n stacked rig states; rig r's key is PRNGKey(seed + r)."""
        h, w = cfg.grid_size
        return GridState(
            log_odds=torch.full((n, h, w), cfg.log_odds_prior,
                                dtype=torch.float32, device=device),
            occupancy=torch.full((n, h, w), cfg.init_probability,
                                 dtype=torch.float32, device=device),
            rng=torch.stack([prng.prng_key(seed + r, device=device)
                             for r in range(n)]),
            step=torch.zeros((n,), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class Obs(_Tensors):
    """One fused observation: image (H, W, 3) RGB in [0, 255] (f32; uint8
    when unpacked from the rgb8 wire), cloud, has_image / has_cloud () bool
    (quirk Q1 gate inputs)."""

    image: torch.Tensor
    cloud: PointCloud
    has_image: torch.Tensor
    has_cloud: torch.Tensor

    @staticmethod
    def create(cfg: GridVisionConfig, image=None, cloud=None,
               device=None) -> "Obs":
        if image is None:
            image = torch.zeros((cfg.camera_image_height,
                                 cfg.camera_image_width, 3),
                                dtype=torch.float32, device=device)
            has_image = torch.tensor(False, device=device)
        else:
            image = torch.as_tensor(image, dtype=torch.float32,
                                    device=device)
            has_image = torch.tensor(True, device=device)
        if cloud is None:
            cloud = PointCloud.empty(cfg.max_points, device=device)
            has_cloud = torch.tensor(False, device=device)
        else:
            has_cloud = cloud.count > 0
        return Obs(image=image, cloud=cloud, has_image=has_image,
                   has_cloud=has_cloud)

    # ------------------------------------------------------------------
    # Packed wire format: ONE contiguous uint8 buffer per observation, one
    # host->device transfer instead of six typed tensors. Layout
    # (little-endian), as the JAX package's Obs.pack_bytes writes it:
    #   [0:4)  int32  count        [4] u8 has_image   [5] u8 has_cloud
    #   [6:8)  pad
    #   [8 : 8+img_n)              image: rgb8, or yuv420 (Y, then U, V
    #                              at half resolution)
    #   [.. : ..+P*12)             xyz float32 (sentinel-padded), or
    #   [.. : ..+P*6)              xyz float16 (wire_cloud_dtype)
    #   [.. : ..+P*4)              intensity float32, or P bytes of u8
    # ------------------------------------------------------------------

    @staticmethod
    def _wire_sizes(cfg: GridVisionConfig):
        h, w, p = (cfg.camera_image_height, cfg.camera_image_width,
                   cfg.max_points)
        img = (h * w * 3 if cfg.wire_image_codec == "rgb8"
               else h * w + 2 * (h // 2) * (w // 2))      # yuv420
        cloud = (p * 16 if cfg.wire_cloud_dtype == "float32"
                 else p * 7)                               # f16 xyz + u8 i
        return img, cloud

    @staticmethod
    def packed_nbytes(cfg: GridVisionConfig) -> int:
        img, cloud = Obs._wire_sizes(cfg)
        return 8 + img + cloud

    # f16 can't hold the 1e8 pad sentinel; padded rows are rewritten from
    # `count` on unpack, so the wire value only needs to be finite.
    _F16_PAD = 60000.0

    @staticmethod
    def pack_bytes(image_u8: np.ndarray, xyz: np.ndarray,
                   intensity: np.ndarray, count: int, has_image: bool,
                   has_cloud: bool, cfg: GridVisionConfig) -> np.ndarray:
        """Host-side pack (numpy), byte for byte the JAX package's.
        image_u8: (H, W, 3) uint8; xyz / intensity already fixed-capacity
        sentinel-padded float32 arrays (PointCloud.pack_host output)."""
        h, w = cfg.camera_image_height, cfg.camera_image_width
        img_n, _ = Obs._wire_sizes(cfg)
        buf = np.empty(Obs.packed_nbytes(cfg), np.uint8)
        buf[0:4].view(np.int32)[0] = count
        buf[4] = 1 if has_image else 0
        buf[5] = 1 if has_cloud else 0
        buf[6:8] = 0
        o = 8
        img = np.ascontiguousarray(image_u8, np.uint8)
        if cfg.wire_image_codec == "rgb8":
            buf[o:o + img_n] = img.reshape(-1)
        else:
            y, u, v = rgb_to_yuv420(img)
            buf[o:o + h * w] = y.reshape(-1)
            buf[o + h * w:o + h * w + u.size] = u.reshape(-1)
            buf[o + h * w + u.size:o + img_n] = v.reshape(-1)
        _pack_cloud_bytes(buf, o + img_n, xyz, intensity, cfg)
        return buf

    @staticmethod
    def unpack(buf: torch.Tensor, cfg: GridVisionConfig) -> "Obs":
        """Device-side unpack of one packed buffer (a 1-D uint8 tensor),
        an Obs on the buffer's device with no host sync. With the rgb8
        codec the image stays uint8 (every consumer casts it to its
        compute dtype, exactly); yuv420 decodes to float32 RGB."""
        h, w = cfg.camera_image_height, cfg.camera_image_width
        img_n, _ = Obs._wire_sizes(cfg)
        o = 8
        if cfg.wire_image_codec == "rgb8":
            image = buf[o:o + img_n].view(h, w, 3)
        else:
            cn = (h // 2) * (w // 2)
            y = buf[o:o + h * w].view(h, w)
            u = buf[o + h * w:o + h * w + cn].view(h // 2, w // 2)
            v = buf[o + h * w + cn:o + img_n].view(h // 2, w // 2)
            image = yuv420_to_rgb(y, u, v)
        count = _bitcast(buf[0:4], torch.int32).reshape(())
        cloud = _unpack_cloud(buf, o + img_n, count, cfg)
        return Obs(image=image, cloud=cloud, has_image=buf[4] > 0,
                   has_cloud=buf[5] > 0)


def _pack_cloud_bytes(buf: np.ndarray, o: int, xyz: np.ndarray,
                      intensity: np.ndarray, cfg: GridVisionConfig) -> None:
    """Write the cloud section of a wire buffer at byte o (numpy)."""
    p = cfg.max_points
    xyz = np.ascontiguousarray(xyz, np.float32)
    inten = np.ascontiguousarray(intensity, np.float32)
    if cfg.wire_cloud_dtype == "float32":
        buf[o:o + p * 12].view(np.float32)[:] = xyz.reshape(-1)
        o += p * 12
        buf[o:o + p * 4].view(np.float32)[:] = inten.reshape(-1)
    else:
        x16 = np.clip(xyz, -Obs._F16_PAD, Obs._F16_PAD).astype(np.float16)
        buf[o:o + p * 6].view(np.float16)[:] = x16.reshape(-1)
        o += p * 6
        buf[o:o + p] = np.clip(inten, 0, 255).astype(np.uint8)


def _bitcast(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 1-D uint8 slice reinterpreted as `dtype` (jax.lax.
    bitcast_convert_type). A view needs the slice's byte offset to be a
    multiple of the element size: at an unaligned offset (the cloud of a
    375x1242 rgb8 frame starts at byte 1397258) the bytes are copied to a
    fresh tensor first."""
    size = torch.empty((), dtype=dtype).element_size()
    if raw.storage_offset() % size or raw.data_ptr() % size:
        raw = raw.clone()
    return raw.view(dtype)


def _unpack_cloud(buf: torch.Tensor, o: int, count: torch.Tensor,
                  cfg: GridVisionConfig) -> "PointCloud":
    """The cloud section of a wire buffer at byte o, on buf's device. The
    f16 wire's padded rows get the sentinel back from `count`."""
    p = cfg.max_points
    if cfg.wire_cloud_dtype == "float32":
        xyz = _bitcast(buf[o:o + p * 12], torch.float32).view(p, 3)
        intensity = _bitcast(buf[o + p * 12:o + p * 16], torch.float32)
    else:
        x16 = _bitcast(buf[o:o + p * 6], torch.float16).view(p, 3)
        valid = (torch.arange(p, device=buf.device) < count)[:, None]
        xyz = torch.where(valid, x16.float(),
                          torch.full((), PointCloud.PAD_SENTINEL,
                                     device=buf.device))
        intensity = buf[o + p * 6:o + p * 7].float()
    return PointCloud(xyz=xyz, intensity=intensity, count=count)


# ----------------------------------------------------------------------
# ROI-delta input wire: between consecutive camera frames only the moving
# objects change, so a delta record ships a FIXED-SIZE ROI window (half
# the frame each axis) positioned over the changed region, patched on the
# device into the previous frame. When the change exceeds the window the
# encoder falls back to a keyframe (the full Obs.pack_bytes buffer). The
# cloud ships whole in every record. Layout (little-endian):
#   [0:4)  i32 count   [4] u8 has_image  [5] u8 has_cloud  [6:8) pad
#   [8:12) i32 roi_y0  [12:16) i32 roi_x0
#   [16 : 16+Hr*Wr*3)  ROI rgb8
#   [..]               cloud (same wire dtype rules as Obs.pack_bytes)
# ----------------------------------------------------------------------

def delta_roi_shape(cfg: GridVisionConfig):
    """Fixed delta ROI window: half the frame each axis."""
    return cfg.camera_image_height // 2, cfg.camera_image_width // 2


def delta_nbytes(cfg: GridVisionConfig) -> int:
    hr, wr = delta_roi_shape(cfg)
    _, cloud = Obs._wire_sizes(cfg)
    return 16 + hr * wr * 3 + cloud


def pack_delta_bytes(roi_u8: np.ndarray, y0: int, x0: int,
                     xyz: np.ndarray, intensity: np.ndarray, count: int,
                     has_image: bool, has_cloud: bool,
                     cfg: GridVisionConfig) -> np.ndarray:
    """Host-side delta pack (numpy), byte for byte the JAX package's.
    roi_u8: (Hr, Wr, 3) uint8 window content at (y0, x0) of the NEW frame
    (delta_roi_shape dims). Requires wire_image_codec == 'rgb8'."""
    hr, wr = delta_roi_shape(cfg)
    buf = np.empty(delta_nbytes(cfg), np.uint8)
    buf[0:4].view(np.int32)[0] = count
    buf[4] = 1 if has_image else 0
    buf[5] = 1 if has_cloud else 0
    buf[6:8] = 0
    buf[8:12].view(np.int32)[0] = y0
    buf[12:16].view(np.int32)[0] = x0
    o = 16
    buf[o:o + hr * wr * 3] = np.ascontiguousarray(
        roi_u8, np.uint8).reshape(-1)
    _pack_cloud_bytes(buf, o + hr * wr * 3, xyz, intensity, cfg)
    return buf


def unpack_delta(buf: torch.Tensor, prev_image_u8: torch.Tensor,
                 cfg: GridVisionConfig) -> "Obs":
    """Device-side delta unpack: patch the ROI into the carried previous
    frame (a new tensor; prev_image_u8 is not modified) and decode the
    cloud as Obs.unpack does. The window's start follows
    lax.dynamic_update_slice (a negative start counts from the end, then
    it is clamped so that the window fits) and is applied as a scatter
    with device indices: no host sync. Returns an Obs whose
    image is the FULL updated uint8 frame (the next call's
    prev_image_u8)."""
    h, w = cfg.camera_image_height, cfg.camera_image_width
    hr, wr = delta_roi_shape(cfg)
    dev = buf.device
    y0, x0 = _bitcast(buf[8:16], torch.int32).long()
    # lax.dynamic_update_slice's rule: a negative start counts from the
    # end, then the start is clamped so that the window fits
    y0 = torch.where(y0 < 0, y0 + h, y0).clamp(0, h - hr)
    x0 = torch.where(x0 < 0, x0 + w, x0).clamp(0, w - wr)
    rows = y0 + torch.arange(hr, device=dev)
    cols = x0 + torch.arange(wr, device=dev)
    flat = ((rows[:, None, None] * w + cols[None, :, None]) * 3
            + torch.arange(3, device=dev)).reshape(-1)
    roi = buf[16:16 + hr * wr * 3]
    image = prev_image_u8.reshape(-1).scatter(0, flat, roi).view(h, w, 3)
    count = _bitcast(buf[0:4], torch.int32).reshape(())
    cloud = _unpack_cloud(buf, 16 + hr * wr * 3, count, cfg)
    return Obs(image=image, cloud=cloud, has_image=buf[4] > 0,
               has_cloud=buf[5] > 0)


_YUV_M = np.array([[0.299, 0.587, 0.114],
                   [-0.168736, -0.331264, 0.5],
                   [0.5, -0.418688, -0.081312]], np.float32).T


def rgb_to_yuv420(rgb: np.ndarray):
    """Host-side full-range BT.601 4:2:0 encode (numpy, the JAX package's
    arithmetic). Returns (Y (H, W), U (H/2, W/2), V (H/2, W/2)) uint8.
    Chroma is computed after the 2x2 box subsample (the map is affine, so
    it commutes with the block mean)."""
    rgbf = rgb.astype(np.float32)
    y = rgbf @ _YUV_M[:, 0]
    sub = (rgbf[0::2, 0::2] + rgbf[0::2, 1::2]
           + rgbf[1::2, 0::2] + rgbf[1::2, 1::2]) * 0.25
    cbcr = sub @ _YUV_M[:, 1:] + 128.0
    to8 = lambda a: np.clip(a + 0.5, 0, 255).astype(np.uint8)
    return to8(y), to8(cbcr[..., 0]), to8(cbcr[..., 1])


def _f32_const(x: float) -> float:
    """x rounded to float32, as a Python float (exact in float64)."""
    return float(np.float32(x))


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Device-side decode: nearest-neighbour chroma upsample and the
    inverse BT.601 full-range matrix, float32 RGB in [0, 255].

    Rounded as the JAX package's jitted unpack computes it on the CPU: XLA
    contracts each channel into fused multiply-adds, r = fma(1.402, v, y),
    b = fma(1.772, u, y), g = fma(-0.714136, v, fma(-0.344136, u, y)). In
    float64 each product of an f32 constant and a byte and each sum with a
    byte or an f32 is exact, so one rounding to float32 per fma gives the
    fused result bit for bit, on the CPU and on the card alike."""
    yd = y.double()
    ud = (u.double() - 128.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
    vd = (v.double() - 128.0).repeat_interleave(2, 0).repeat_interleave(2, 1)
    r = (yd + _f32_const(1.402) * vd).float()
    g1 = (yd - _f32_const(0.344136) * ud).float().double()
    g = (g1 - _f32_const(0.714136) * vd).float()
    b = (yd + _f32_const(1.772) * ud).float()
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


@dataclasses.dataclass(frozen=True)
class Extrinsics(_Tensors):
    """4x4 homogeneous transforms replacing the reference's TF2 lookups:
    p_cam = lidar_to_camera @ p_lidar, p_base = camera_to_base @ p_cam."""

    lidar_to_camera: torch.Tensor
    camera_to_base: torch.Tensor

    @staticmethod
    def identity(device=None) -> "Extrinsics":
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return Extrinsics(lidar_to_camera=eye, camera_to_base=eye.clone())


@dataclasses.dataclass(frozen=True)
class SaturationStats(_Tensors):
    """Capacity-saturation counters, int32 scalars per step (see the JAX
    package's SaturationStats for each one's meaning)."""

    prenms_overflow: torch.Tensor
    orientation_clamped: torch.Tensor
    box_cloud_truncated: torch.Tensor
    orientation_dropped: torch.Tensor
    static_depth_clamped: torch.Tensor

    @staticmethod
    def zeros(device=None) -> "SaturationStats":
        """Every counter an int32 zero scalar."""
        z = torch.zeros((), dtype=torch.int32, device=device)
        return SaturationStats(prenms_overflow=z, orientation_clamped=z,
                               box_cloud_truncated=z, orientation_dropped=z,
                               static_depth_clamped=z)


@dataclasses.dataclass(frozen=True)
class StepOutput(_Tensors):
    """Everything the reference publishes per tick: boxes, base-frame
    poses, static_points / static_depths (-1.0 sentinel where no depth),
    static_boxes, occupancy_i8 (int8 0..100) and saturation counters."""

    boxes: Boxes
    poses: LShapePoses
    static_points: torch.Tensor
    static_depths: torch.Tensor
    static_boxes: Boxes
    occupancy_i8: torch.Tensor
    saturation: SaturationStats
