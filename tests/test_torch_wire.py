"""The packed wire formats of the port (types.py) against the JAX
package's: Obs.pack_bytes, pack_delta_bytes and rgb_to_yuv420 give the
same bytes from the same numpy inputs (made from a seed), and Obs.unpack /
unpack_delta give what JAX's jitted unpack gives (as step_packed runs it):
the uint8 image, xyz, intensity, count and flags exactly, the f16 wire's
padded rows with the sentinel restored, and the YUV420 decode bit for bit
(jitted XLA on the CPU contracts the decode into fused multiply-adds; the
port computes them exactly in float64, see types.yuv420_to_rgb). At 375x1242, KITTI's camera, the cloud
starts at unaligned byte offsets (rgb8: 1397258, 2 mod 4; the ROI delta:
348397, odd), which the port's unpack copies before it reinterprets."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import types as jtypes
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu_torch import types
from grid_vision_tpu_torch.config import GridVisionConfig

torch.set_num_threads(1)

SMALL = dict(max_points=512, camera_image_height=96, camera_image_width=128,
             fx=64.0, fy=64.0, cx=64.0, cy=48.0, grid_x=24, grid_y=12,
             resolution=0.25)
KITTI = dict(SMALL, camera_image_height=375, camera_image_width=1242,
             max_points=2048)
MODES = [("rgb8", "float32"), ("rgb8", "float16"), ("yuv420", "float32"),
         ("yuv420", "float16")]


def _cfgs(base, codec, cloud):
    kw = dict(base, wire_image_codec=codec, wire_cloud_dtype=cloud)
    if codec == "yuv420" and kw["camera_image_height"] % 2:
        kw["camera_image_height"] -= 1        # the codec needs even dims
    return JaxConfig(**kw), GridVisionConfig(**kw)


def _frame(cfg, seed, n=300):
    """A random uint8 frame and a sentinel-padded cloud of n points with
    intensities (some out of the u8 range, some coordinates beyond f16)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (cfg.camera_image_height,
                                cfg.camera_image_width, 3), np.uint8)
    pts = rng.uniform(-40, 60, (n, 3)).astype(np.float32)
    pts[:3] *= 3000.0
    inten = rng.uniform(-20, 300, n).astype(np.float32)
    xyz, it, count, _ = types.PointCloud.pack_host(pts, inten,
                                                   cfg.max_points)
    return img, xyz, it, count


def _assert_obs_equal(got: types.Obs, ref, what):
    ref_img = np.asarray(ref.image)
    assert got.image.dtype == {np.uint8: torch.uint8,
                               np.float32: torch.float32}[ref_img.dtype.type]
    np.testing.assert_array_equal(got.image.numpy(), ref_img,
                                  err_msg=f"{what}: image")
    for name in ("xyz", "intensity", "count"):
        np.testing.assert_array_equal(
            getattr(got.cloud, name).numpy(),
            np.asarray(getattr(ref.cloud, name)), err_msg=f"{what}: {name}")
    assert got.cloud.count.dtype == torch.int32 and got.cloud.count.dim() == 0
    assert bool(got.has_image) == bool(ref.has_image)
    assert bool(got.has_cloud) == bool(ref.has_cloud)


@pytest.mark.parametrize("codec,cloud", MODES)
@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_pack_bytes_equal_to_jax(codec, cloud, flags):
    jcfg, cfg = _cfgs(SMALL, codec, cloud)
    img, xyz, inten, n = _frame(cfg, seed=1)
    got = types.Obs.pack_bytes(img, xyz, inten, n, *flags, cfg)
    ref = jtypes.Obs.pack_bytes(img, xyz, inten, n, *flags, jcfg)
    assert got.dtype == np.uint8
    assert got.shape == (types.Obs.packed_nbytes(cfg),)
    assert types.Obs.packed_nbytes(cfg) == jtypes.Obs.packed_nbytes(jcfg)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cloud", ["float32", "float16"])
def test_pack_delta_bytes_equal_to_jax(cloud):
    jcfg, cfg = _cfgs(SMALL, "rgb8", cloud)
    img, xyz, inten, n = _frame(cfg, seed=2)
    hr, wr = types.delta_roi_shape(cfg)
    assert (hr, wr) == jtypes.delta_roi_shape(jcfg)
    assert types.delta_nbytes(cfg) == jtypes.delta_nbytes(jcfg)
    roi = img[7:7 + hr, 9:9 + wr]
    got = types.pack_delta_bytes(roi, 7, 9, xyz, inten, n, True, False, cfg)
    ref = jtypes.pack_delta_bytes(roi, 7, 9, xyz, inten, n, True, False,
                                  jcfg)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(96, 128), (374, 1242)])
def test_rgb_to_yuv420_equal_to_jax(shape):
    img = np.random.default_rng(3).integers(0, 256, shape + (3,), np.uint8)
    for got, ref in zip(types.rgb_to_yuv420(img), jtypes.rgb_to_yuv420(img)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("base", ["small", "kitti"])
@pytest.mark.parametrize("codec,cloud", MODES)
def test_unpack_equal_to_jitted_jax(base, codec, cloud):
    jcfg, cfg = _cfgs(SMALL if base == "small" else KITTI, codec, cloud)
    img, xyz, inten, n = _frame(cfg, seed=4)
    buf = types.Obs.pack_bytes(img, xyz, inten, n, True, True, cfg)
    ref = jax.jit(lambda b: jtypes.Obs.unpack(b, jcfg))(jnp.asarray(buf))
    got = types.Obs.unpack(torch.from_numpy(buf), cfg)
    _assert_obs_equal(got, ref, f"{base} {codec} {cloud}")
    p = cfg.max_points
    if cloud == "float16":
        assert (got.cloud.xyz[n:] == types.PointCloud.PAD_SENTINEL).all()
        assert got.cloud.xyz[:n].abs().max() <= types.Obs._F16_PAD
    else:
        np.testing.assert_array_equal(got.cloud.xyz.numpy(), xyz)
    if codec == "rgb8":
        np.testing.assert_array_equal(got.image.numpy(), img)
    assert got.cloud.xyz.shape == (p, 3) and got.cloud.intensity.shape == (p,)


def test_kitti_cloud_offsets_are_unaligned():
    """The case the copy before the bitcast exists for."""
    _, cfg = _cfgs(KITTI, "rgb8", "float32")
    img_n, _ = types.Obs._wire_sizes(cfg)
    assert (8 + img_n) % 4 == 2
    hr, wr = types.delta_roi_shape(cfg)
    assert (16 + hr * wr * 3) % 2 == 1


@pytest.mark.parametrize("base", ["small", "kitti"])
@pytest.mark.parametrize("cloud", ["float32", "float16"])
@pytest.mark.parametrize("corner", [(11, 17), (-5, 3), (90, 500)])
def test_unpack_delta_equal_to_jitted_jax(base, cloud, corner):
    """Corners outside the frame are clamped so the window fits, as
    lax.dynamic_update_slice clamps them."""
    jcfg, cfg = _cfgs(SMALL if base == "small" else KITTI, "rgb8", cloud)
    prev, xyz, inten, n = _frame(cfg, seed=5)
    new, *_ = _frame(cfg, seed=6)
    hr, wr = types.delta_roi_shape(cfg)
    roi = new[:hr, :wr]
    buf = types.pack_delta_bytes(roi, *corner, xyz, inten, n, True, True,
                                 cfg)
    ref = jax.jit(lambda b, p: jtypes.unpack_delta(b, p, jcfg))(
        jnp.asarray(buf), jnp.asarray(prev))
    prev_t = torch.from_numpy(prev.copy())
    got = types.unpack_delta(torch.from_numpy(buf), prev_t, cfg)
    _assert_obs_equal(got, ref, f"delta {base} {cloud} {corner}")
    np.testing.assert_array_equal(prev_t.numpy(), prev)    # not modified


def test_yuv420_decode_bit_equal_to_jitted_jax():
    """Every (Y, U, V) byte triple through the unpack of a 512x512 yuv420
    frame: 256 luma values against all 65536 chroma pairs."""
    jcfg, cfg = _cfgs(dict(SMALL, camera_image_height=512,
                           camera_image_width=512), "yuv420", "float32")
    y = np.random.default_rng(7).integers(0, 256, (512, 512), np.uint8)
    y[:256, :256] = np.arange(256, dtype=np.uint8)[:, None]
    u = np.tile(np.arange(256, dtype=np.uint8), (256, 1))
    v = np.ascontiguousarray(u.T)
    buf = np.zeros(types.Obs.packed_nbytes(cfg), np.uint8)
    buf[8:8 + y.size] = y.reshape(-1)
    buf[8 + y.size:8 + y.size + u.size] = u.reshape(-1)
    buf[8 + y.size + u.size:8 + y.size + 2 * u.size] = v.reshape(-1)
    ref = jax.jit(lambda b: jtypes.Obs.unpack(b, jcfg).image)(
        jnp.asarray(buf))
    got = types.Obs.unpack(torch.from_numpy(buf), cfg).image
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    direct = types.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(u),
                                 torch.from_numpy(v))
    assert torch.equal(direct, got)


def test_unpack_is_views_when_aligned():
    """rgb8 / f32 at 96x128: the image and the f32 cloud alias the buffer
    (no copy); the count is the buffer's first word."""
    _, cfg = _cfgs(SMALL, "rgb8", "float32")
    img, xyz, inten, n = _frame(cfg, seed=8)
    buf = torch.from_numpy(types.Obs.pack_bytes(img, xyz, inten, n, True,
                                                True, cfg))
    obs = types.Obs.unpack(buf, cfg)
    for t in (obs.image, obs.cloud.xyz, obs.cloud.intensity,
              obs.cloud.count):
        assert t.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()


def test_f16_wire_is_smaller_and_close():
    _, lossless = _cfgs(SMALL, "rgb8", "float32")
    _, wire = _cfgs(SMALL, "yuv420", "float16")
    assert (types.Obs.packed_nbytes(wire)
            < 0.6 * types.Obs.packed_nbytes(lossless))
    img, xyz, inten, n = _frame(wire, seed=9)
    xyz[:n] = np.clip(xyz[:n], -100, 100)
    obs = types.Obs.unpack(torch.from_numpy(types.Obs.pack_bytes(
        img, xyz, inten, n, True, True, wire)), wire)
    np.testing.assert_allclose(obs.cloud.xyz[:n].numpy(), xyz[:n],
                               rtol=1e-3, atol=0.05)
    np.testing.assert_array_equal(
        obs.cloud.intensity[:n].numpy(),
        np.clip(inten[:n], 0, 255).astype(np.uint8).astype(np.float32))


def test_create_and_dataclass_fields_unchanged():
    """Obs.create still casts a given image to f32 (the typed path)."""
    cfg = GridVisionConfig(**SMALL)
    img = np.zeros((96, 128, 3), np.uint8)
    obs = types.Obs.create(cfg, img, device="cpu")
    assert obs.image.dtype == torch.float32
    assert [f.name for f in dataclasses.fields(types.Obs)] == [
        "image", "cloud", "has_image", "has_cloud"]
