"""The port's CUDA kernels against their plain torch twins, on the card.

Needs an NVIDIA card and nvcc (a CUDA kernel has no CPU mode): every test
is marked ``cuda`` and skips without a card. Imports neither JAX nor the
JAX package, so it runs where only torch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import orientation_net, weights
from grid_vision_tpu_torch.ops import (association, cuda_csp, cuda_grid,
                                       cuda_knn, cuda_orient, cuda_raycast,
                                       cuda_stem, preprocess, rasterize,
                                       raycast, tf32x3)
from grid_vision_tpu_torch.types import LShapePoses, PointCloud

torch.set_num_threads(1)

CFG = GridVisionConfig()
K_NP = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]],
                np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _poses(rng, n, device):
    e = LShapePoses.empty(n, device=device)
    pos = rng.uniform([-15, -15, 0], [50, 15, 0], (n, 3)).astype(np.float32)
    pos[1] = pos[0]                                     # overlapping boxes
    pos[2] = pos[0]
    return dataclasses.replace(
        e, position=torch.as_tensor(pos, device=device),
        length=torch.as_tensor(rng.uniform(0.3, 6, n).astype(np.float32),
                               device=device),
        width=torch.as_tensor(rng.uniform(0.3, 3, n).astype(np.float32),
                              device=device),
        valid=torch.ones(n, dtype=torch.bool, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_boxes", [0, 8, 64])
def test_grid_kernel_bit_equal_to_twin(cuda_device, n_boxes):
    rng = np.random.default_rng(n_boxes)
    lo = torch.as_tensor(rng.uniform(-2, 3.6, CFG.grid_size)
                         .astype(np.float32), device=cuda_device)
    ranges = cuda_grid.box_index_ranges(
        _poses(rng, max(n_boxes, 3), cuda_device), CFG)[:n_boxes]
    ranges = ranges.contiguous()
    n0 = cuda_grid.launches
    lo_k, occ_k = cuda_grid.grid_update(lo, ranges, CFG)
    torch.cuda.synchronize()
    assert cuda_grid.launches == n0 + 1
    lo_p, occ_p = cuda_grid.grid_update_plain(lo, ranges, CFG)
    assert torch.equal(lo_k, lo_p)
    torch.testing.assert_close(occ_k, occ_p, rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_grid_wrapper_rejects_bad_inputs(cuda_device):
    lo = torch.zeros(CFG.grid_size, device=cuda_device)
    bad = torch.zeros((65, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        cuda_grid.grid_update(lo, bad, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_grid.grid_update(lo.t(), bad[:8], CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8])
def test_knn_kernel_equals_twin_on_tied_cloud(cuda_device, k):
    rng = np.random.default_rng(k)
    xyz = rng.integers(-4, 5, size=(16384, 3)).astype(np.float32)
    xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0                 # many equal d2
    cloud = PointCloud.from_numpy(xyz[:15000], None, 16384,
                                  device=cuda_device)
    uvd, valid = association.project_cloud_to_image(
        cloud, torch.as_tensor(K_NP, device=cuda_device))
    centers = torch.as_tensor(
        rng.uniform(-50, 700, (64, 2)).astype(np.float32), device=cuda_device)
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, k)
    torch.cuda.synchronize()
    ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, k)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_knn_kernel_empty_cloud(cuda_device):
    cloud = PointCloud.empty(256, device=cuda_device)
    uvd, valid = association.project_cloud_to_image(
        cloud, torch.as_tensor(K_NP, device=cuda_device))
    centers = torch.zeros((4, 2), device=cuda_device)
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, 4)
    assert torch.equal(got.cpu(), torch.full((4,), -1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,size", [(480, 640, 416), (96, 128, 64),
                                      (100, 130, 68)])
def test_stem_kernel_matches_twin(cuda_device, h, w, size):
    """atol = rtol = 1e-4, the JAX package's own bar for its stem kernel
    (f32 sums in another order; TF32 off for the twin's convs)."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz",
                           detection_network_input_size=size)
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_stem.prepare_stem_constants(det)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    img = torch.rand((2, h, w, 3), generator=g, device=cuda_device) * 255
    got = cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    ref = cuda_stem.detector_stem_plain(img, consts, size)
    assert got.shape == (2, -(-size // 4), -(-size // 4), 64)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,size", [(200, 260, 148), (120, 160, 150)])
def test_stem_kernel_ragged_tiles_batch_3(cuda_device, h, w, size):
    """Batch 3 at sizes whose conv0 (74, 75) and conv1 (37, 38) outputs are
    no multiple of the kernels' 8 x 32 and 8 x 16 tiles in either axis; 150
    is no multiple of 4 either, so ConvBN_1 sees an odd input and pads
    (1, 1). atol = rtol = 1e-4 as at full size."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz",
                           detection_network_input_size=size)
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_stem.prepare_stem_constants(det)
    g = torch.Generator(device=cuda_device).manual_seed(size)
    img = torch.rand((3, h, w, 3), generator=g, device=cuda_device) * 255
    n0 = cuda_stem.launches
    got = cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    assert cuda_stem.launches == n0 + 1
    ref = cuda_stem.detector_stem_plain(img, consts, size)
    s1 = -(-(-(-size // 2)) // 2)
    assert got.shape == (3, s1, s1, 64)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    # a frame's result does not depend on its place in the batch
    one = cuda_stem.detector_stem_cuda(img[1:2].contiguous(), consts, size)
    assert torch.equal(one[0], got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0.0, 255.0])
def test_stem_kernel_constant_frames(cuda_device, level):
    """An all-zero and an all-255 frame: the resize's weights sum to 1, so
    the padding and the tap windows at the frame's edges show."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_stem.prepare_stem_constants(det)
    img = torch.full((1, 480, 640, 3), level, device=cuda_device)
    got = cuda_stem.detector_stem_cuda(img, consts, 416)
    torch.cuda.synchronize()
    ref = cuda_stem.detector_stem_plain(img, consts, 416)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def _tied_fleet_cloud(rng, n_rigs, p, device):
    """(R, P, 3) grid-quantized clouds (many equal d2) projected to the
    image; rig 0 holds no valid point and the last rig fewer than k where
    there is more than one rig, and about a tenth of the rest is invalid."""
    xyz = rng.integers(-4, 5, size=(n_rigs, p, 3)).astype(np.float32)
    xyz[..., 2] = np.abs(xyz[..., 2]) + 1.0
    uvds, valids = [], []
    for r in range(n_rigs):
        n = p - p // 10
        if n_rigs > 1 and r == 0:
            n = 0
        elif n_rigs > 1 and r == n_rigs - 1:
            n = 3
        cloud = PointCloud.from_numpy(xyz[r, :n], None, p, device=device)
        uvd, valid = association.project_cloud_to_image(
            cloud, torch.as_tensor(K_NP, device=device))
        uvds.append(uvd)
        valids.append(valid)
    return torch.stack(uvds), torch.stack(valids)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rigs,p,d", [(1, 16384, 64), (64, 8192, 16),
                                        (64, 8192, 64), (3, 1000, 5)])
@pytest.mark.parametrize("k", [4, 8])
def test_knn_kernel_equals_twin_at_the_ticks_shapes(cuda_device, n_rigs, p, d,
                                                    k):
    """The shapes of the single-rig, fleet and extension fleet ticks and an
    odd one (P no multiple of 16: the narrow copies), tied clouds, an empty
    rig and one with fewer than k points: equal to the twin, atol = 0. Two
    calls back to back on one stream give the same result."""
    rng = np.random.default_rng(n_rigs + p + d + k)
    uvd, valid = _tied_fleet_cloud(rng, n_rigs, p, cuda_device)
    centers = torch.as_tensor(rng.uniform(-50, 700, (n_rigs, d, 2))
                              .astype(np.float32), device=cuda_device)
    n0 = cuda_knn.launches
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, k)
    again = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, k)
    torch.cuda.synchronize()
    assert cuda_knn.launches == n0 + 2
    ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, k)
    assert got.shape == (n_rigs, d)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert torch.equal(again, got)
    if n_rigs > 1:
        assert torch.equal(got[0], torch.full_like(got[0], -1.0))
        assert (got[-1] > 0).all()                  # 3 points: their median
    # the model of the kernel's partition agrees on the card too
    n_slices, _ = cuda_knn.knn_split(n_rigs, p, d, k)
    model = cuda_knn.knn_partition_model(uvd, valid, centers, k, n_slices,
                                         group=cuda_knn.center_group(k))
    assert torch.equal(model, ref)


@pytest.mark.cuda
def test_batched_grid_kernel_bit_equal_and_r1_equals_single(cuda_device):
    rng = np.random.default_rng(5)
    lo = torch.as_tensor(rng.uniform(-2, 3.6, (4,) + CFG.grid_size)
                         .astype(np.float32), device=cuda_device)
    ranges = torch.stack([cuda_grid.box_index_ranges(
        _poses(rng, 8, cuda_device), CFG) for _ in range(4)]).contiguous()
    n0 = cuda_grid.launches
    lo_k, occ_k = cuda_grid.grid_update(lo, ranges, CFG)
    torch.cuda.synchronize()
    assert cuda_grid.launches == n0 + 1
    lo_p, occ_p = cuda_grid.grid_update_plain(lo, ranges, CFG)
    assert torch.equal(lo_k, lo_p)
    torch.testing.assert_close(occ_k, occ_p, rtol=0, atol=1e-7)
    lo1, occ1 = cuda_grid.grid_update(lo[2:3].contiguous(),
                                      ranges[2:3].contiguous(), CFG)
    lo_s, occ_s = cuda_grid.grid_update(lo[2].contiguous(),
                                        ranges[2].contiguous(), CFG)
    assert torch.equal(lo1[0], lo_s) and torch.equal(occ1[0], occ_s)
    assert torch.equal(lo1[0], lo_k[2])


@pytest.mark.cuda
def test_batched_knn_kernel_equals_twin_and_r1_equals_single(cuda_device):
    rng = np.random.default_rng(6)
    uvds, valids = [], []
    for r in range(4):
        xyz = rng.integers(-4, 5, size=(8192, 3)).astype(np.float32)
        xyz[:, 2] = np.abs(xyz[:, 2]) + 1.0             # many equal d2
        cloud = PointCloud.from_numpy(xyz[:6000 + 500 * r], None, 8192,
                                      device=cuda_device)
        uvd, valid = association.project_cloud_to_image(
            cloud, torch.as_tensor(K_NP, device=cuda_device))
        uvds.append(uvd)
        valids.append(valid)
    uvd, valid = torch.stack(uvds), torch.stack(valids)
    centers = torch.as_tensor(rng.uniform(-50, 700, (4, 16, 2))
                              .astype(np.float32), device=cuda_device)
    n0 = cuda_knn.launches
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, 4)
    torch.cuda.synchronize()
    assert cuda_knn.launches == n0 + 1 and got.shape == (4, 16)
    ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, 4)
    assert torch.equal(got, ref)
    one = cuda_knn.knn_median_depth_centers_cuda(
        uvd[1:2].contiguous(), valid[1:2].contiguous(),
        centers[1:2].contiguous(), 4)
    single = cuda_knn.knn_median_depth_centers_cuda(
        uvd[1].contiguous(), valid[1].contiguous(), centers[1].contiguous(),
        4)
    assert torch.equal(one[0], single) and torch.equal(single, got[1])


@pytest.mark.cuda
def test_csp_kernel_matches_twin(cuda_device):
    """rtol = atol = 1e-4 on the shipped detector (f32 sums in another
    order; TF32 off for the twin's convs)."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_csp.prepare_csp_constants(det)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((2, 104, 104, 64), generator=g, device=cuda_device) * 4
    n0 = cuda_csp.launches
    with torch.no_grad():
        got = cuda_csp.detector_csp_cuda(x, det, consts)
        torch.cuda.synchronize()
        ref = cuda_csp.detector_csp_plain(x, det)
    assert cuda_csp.launches == n0 + 1
    assert got.shape == (2, 52, 52, 128)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_orient_kernel_matches_twin(cuda_device):
    """Interior, clamped, tiny and invalid boxes over three frames, atol =
    rtol = 1e-3; a flat (sub-pixel) crop is held only to finiteness."""
    cfg = GridVisionConfig(vision_weights_file="weights/orientation.npz")
    net = weights.load_all(cfg, device=cuda_device)["orientation"]
    consts = cuda_orient.prepare_orient_constants(net)
    rng = np.random.default_rng(7)
    images = torch.as_tensor(rng.uniform(0, 255, (3, 480, 640, 3))
                             .astype(np.float32), device=cuda_device)
    xyxy = np.array([[-30, -20, 200, 180], [500, 300, 700, 520],
                     [100.2, 100.7, 106.4, 105.1], [50, 60, 350, 300],
                     [10, 400, 90, 470], [300, 100, 330, 400],
                     [100, 100, 100.4, 100.4]], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    rig = np.array([0, 2, 1, 1, 0, 2, 1], np.int32)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (xyxy, valid, rig)]
    n0 = cuda_orient.launches
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, *args, net, consts, 224)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, *args, net, 224)
    assert cuda_orient.launches == n0 + 1
    assert got.shape == (7, 28, 28, 128)
    torch.testing.assert_close(got[:6], ref[:6], rtol=1e-3, atol=1e-3)
    assert torch.isfinite(got[6]).all()
    torch.testing.assert_close(
        got[5], torch.relu(consts["t"]).expand(28, 28, 128), rtol=0,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(16, 16, 8), (64, 96, 432)])
def test_mma_tile_product_matches_matmul(cuda_device, m, n, k):
    """The 3xTF32 warp-tile product of csrc/gv_mma.cuh (fragment layout,
    host packing, the three mma.sync) against torch.matmul in f64: f32
    accuracy, rtol = atol = 1e-5, where one TF32 product is ~1e-3 off."""
    rng = np.random.default_rng(m + n + k)
    a = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                        device=cuda_device)
    b = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32),
                        device=cuda_device)
    got = cuda_csp.mma_product_cuda(a, b)
    torch.cuda.synchronize()
    exact = a.double() @ b.double()
    torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
    # and equal to the CPU emulation's split and order up to f32 summation
    b_hi, b_lo = tf32x3.split_tf32(b)
    torch.testing.assert_close(got, tf32x3.matmul_3xtf32(a, b_hi, b_lo),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,batch", [(16, 16, 1), (16, 16, 3), (24, 32, 1),
                                       (24, 32, 3), (18, 22, 2)])
def test_csp_kernel_ragged_tiles(cuda_device, h, w, batch):
    """Frames smaller than, and not a multiple of, the kernels' 8 x 16 and
    16 x 16 pixel tiles; rtol = atol = 1e-4 as at full size."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_csp.prepare_csp_constants(det)
    g = torch.Generator(device=cuda_device).manual_seed(h + w + batch)
    x = torch.rand((batch, h, w, 64), generator=g, device=cuda_device) * 4
    with torch.no_grad():
        got = cuda_csp.detector_csp_cuda(x, det, consts)
        torch.cuda.synchronize()
        ref = cuda_csp.detector_csp_plain(x, det)
    assert got.shape == (batch, h // 2, w // 2, 128)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_orient_sample_positions_bit_equal_to_box_axis_samples(cuda_device):
    """The crop kernel computes its sample tables from the boxes itself:
    lo, hi and frac equal preprocess.box_axis_samples bit for bit on
    interior, clamped (every edge, fully outside), sliver and fractional
    boxes, so kernel and twin sample the same pixels."""
    rng = np.random.default_rng(9)
    xy = rng.uniform(-60, 660, (200, 2))
    wh = rng.uniform(0.2, 400, (200, 2))
    xyxy = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    xyxy[:8] = [[-30, -20, 200, 180], [500, 300, 700, 520],
                [100.2, 100.7, 106.4, 105.1], [100, 100, 100.4, 100.4],
                [0, 0, 640, 480], [639, 479, 700, 500], [-50, -50, -10, -10],
                [17.9, 33.1, 18.2, 300.7]]
    boxes = torch.as_tensor(xyxy, device=cuda_device)
    for h, w, size in ((480, 640, 224), (96, 128, 64)):
        got = cuda_orient.box_axis_samples_cuda(boxes, h, w, size)
        torch.cuda.synchronize()
        want = preprocess.box_axis_samples(boxes, h, w, size)
        for (lo, hi, fr), (wlo, whi, wfr) in zip(got, want):
            assert torch.equal(lo, wlo.to(torch.int32))
            assert torch.equal(hi, whi.to(torch.int32))
            assert torch.equal(fr, wfr)


@pytest.mark.cuda
def test_orient_kernel_takes_int64_rigs_and_rejects_bad_inputs(cuda_device):
    cfg = GridVisionConfig(vision_weights_file="weights/orientation.npz")
    net = weights.load_all(cfg, device=cuda_device)["orientation"]
    consts = cuda_orient.prepare_orient_constants(net)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    images = torch.rand((2, 480, 640, 3), generator=g,
                        device=cuda_device) * 255
    xyxy = torch.tensor([[40.0, 50, 300, 260], [600, 400, 700, 500],
                         [10, 10, 90, 200]], device=cuda_device)
    valid = torch.tensor([True, True, True], device=cuda_device)
    rig = torch.tensor([0, 1, 1], device=cuda_device)          # int64
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, 224)
        same = cuda_orient.orient_front_cuda(images, xyxy, valid,
                                             rig.to(torch.int32), net,
                                             consts, 224)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             224)
    assert torch.equal(got, same)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_orient.orient_front_cuda(images, xyxy.t().contiguous().t(),
                                      valid, rig, net, consts, 224)
    with pytest.raises(ValueError, match="orientation constants"):
        cuda_orient.orient_front_cuda(
            images, xyxy, valid, rig, net,
            dict(consts, wfrag=consts["wfrag"][:-1]), 224)


@pytest.mark.cuda
@pytest.mark.parametrize("size,width,h,w", [(64, 8, 96, 128),
                                            (240, 4, 300, 400),
                                            (32, 12, 50, 60)])
def test_orient_kernel_other_sizes_and_widths(cuda_device, size, width, h, w):
    """Crops smaller than one 4 x 28 band of outputs, wider than one (240:
    30 columns), and 32, 16 and 48 channels on a randomly initialized net
    with non-trivial BN; rtol = atol = 1e-3 as at full size."""
    torch.manual_seed(size)
    net = orientation_net.OrientationNetS2D(orientation_net.OrientationConfig(
        input_size=size, width=width)).eval()
    bn = net.ConvBN_0.BatchNorm_0
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.5)
        bn.running_mean.normal_(0, 0.3)
        bn.running_var.uniform_(0.5, 2.0)
    net = net.to(cuda_device)
    consts = cuda_orient.prepare_orient_constants(net)
    rng = np.random.default_rng(size)
    images = torch.as_tensor(rng.uniform(0, 255, (2, h, w, 3))
                             .astype(np.float32), device=cuda_device)
    xyxy = torch.tensor([[-10.0, -6, 50, 40], [20, 10, 48, 45],
                         [20.2, 20.7, 26.4, 25.1], [5, 5, 30, 30]],
                        device=cuda_device)
    valid = torch.tensor([True, True, True, False], device=cuda_device)
    rig = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, size)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             size)
    assert got.shape == (4, size // 8, size // 8, 4 * width)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
    assert torch.equal(got[3], torch.relu(consts["t"]).expand_as(got[3]))


def _scan(rng, lead, n_pts, device):
    """Ray endpoints around the sensor, some invalid: (lead..., P, 2)."""
    pts = np.stack([rng.uniform(-20, 45, lead + (n_pts,)),
                    rng.uniform(-9, 9, lead + (n_pts,))], -1)
    valid = rng.random(lead + (n_pts,)) < 0.9
    return (torch.as_tensor(pts.astype(np.float32), device=device),
            torch.as_tensor(valid, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("rigs", [None, 1, 64])
def test_carve_kernel_bit_equal_to_twin(cuda_device, rigs):
    """Log-odds bit-equal, occupancy atol 1e-7 (expf against torch.exp),
    at a single (H, W) grid, one rig and 64 rigs; a scan with no valid
    point equals the hit-only grid kernel bit for bit."""
    rng = np.random.default_rng(11)
    lead = () if rigs is None else (rigs,)
    lo = torch.as_tensor(rng.uniform(-2, 3.6, lead + CFG.grid_size)
                         .astype(np.float32), device=cuda_device)
    poses = [_poses(rng, 8, cuda_device) for _ in range(rigs or 1)]
    box_ranges = torch.stack([cuda_grid.box_index_ranges(p, CFG)
                              for p in poses]).contiguous()
    if rigs is None:
        box_ranges = box_ranges[0].contiguous()
    origin = torch.tensor([1.5, 0.0], device=cuda_device)
    pts, valid = _scan(rng, lead, 4000, cuda_device)
    ranges = raycast.range_profile(origin, pts, valid)
    cbin, cr = raycast.cell_polar_maps(origin, CFG)
    n0 = cuda_raycast.launches
    lo_k, occ_k = cuda_raycast.fused_carve_update_cuda(lo, box_ranges, ranges,
                                                       cbin, cr, CFG)
    torch.cuda.synchronize()
    assert cuda_raycast.launches == n0 + 1
    lo_p, occ_p = cuda_raycast.carve_update_plain(lo, box_ranges, ranges,
                                                  cbin, cr, CFG)
    assert torch.equal(lo_k, lo_p)
    torch.testing.assert_close(occ_k, occ_p, rtol=0, atol=1e-7)
    hit_lo, hit_occ = cuda_grid.grid_update(lo, box_ranges, CFG)
    assert (lo_k < hit_lo - 0.3).float().mean() > 0.05         # it carved
    lo_n, occ_n = cuda_raycast.fused_carve_update_cuda(
        lo, box_ranges, torch.zeros_like(ranges), cbin, cr, CFG)
    assert torch.equal(lo_n, hit_lo) and torch.equal(occ_n, hit_occ)
    # a bin outside the table reads as range 0, in the kernel as in the twin
    bad = cbin.clone()
    bad[::2] = -1
    bad[1::2] = ranges.shape[-1]
    lo_b, _ = cuda_raycast.fused_carve_update_cuda(lo, box_ranges, ranges,
                                                   bad, cr, CFG)
    assert torch.equal(lo_b, hit_lo)


@pytest.mark.cuda
def test_carve_wrapper_rejects_bad_inputs(cuda_device):
    lo = torch.zeros(CFG.grid_size, device=cuda_device)
    box = torch.zeros((8, 4), dtype=torch.int32, device=cuda_device)
    ranges = torch.zeros(4096, device=cuda_device)
    cbin = torch.zeros(CFG.grid_size, dtype=torch.int32, device=cuda_device)
    cr = torch.zeros(CFG.grid_size, device=cuda_device)
    for args, match in (
            ((lo, box, ranges, cbin.long(), cr), "cbin"),
            ((lo, box, ranges, cbin, cr[:10]), "cr"),
            ((lo, box, ranges.cpu(), cbin, cr), "ranges"),
            ((lo, box, torch.zeros(16384, device=cuda_device), cbin, cr),
             "angle bins"),
            ((lo, torch.zeros((65, 4), dtype=torch.int32,
                              device=cuda_device), ranges, cbin, cr),
             "at most"),
            ((lo.t(), box, ranges, cbin, cr), "contiguous")):
        with pytest.raises(ValueError, match=match):
            cuda_raycast.fused_carve_update_cuda(*args, CFG)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["late_valid", "falling", "rising",
                                  "one_spot"])
def test_knn_kernel_when_threads_run_out_of_slots(cuda_device, case):
    """Clouds that fill a thread's candidate slots, so that the block has to
    select out of turn: the first 300 points of every slice invalid (no
    k-th key to hold the next ones against), distances that fall point after
    point (every point beats the k-th so far), distances that rise, and all
    points on one spot (every d2 tied). Equal to the twin, atol = 0."""
    rng = np.random.default_rng(len(case))
    n_rigs, p, d, k = 2, 8192, 11, 4
    t = np.arange(p, dtype=np.float32)
    uvd = np.zeros((n_rigs, p, 3), np.float32)
    valid = np.ones((n_rigs, p), bool)
    if case == "late_valid":
        uvd[:] = rng.uniform([0, 0, 1], [640, 480, 60], (n_rigs, p, 3))
        for lo in range(0, p, 512):
            valid[:, lo:lo + 300] = False
    elif case in ("falling", "rising"):
        far = (p - t) if case == "falling" else t
        uvd[..., 0] = 320.0 + 0.05 * far
        uvd[..., 1] = 240.0
        uvd[..., 2] = 1.0 + 0.01 * far
    else:
        uvd[:] = [100.0, 200.0, 7.0]
    centers = rng.uniform(0, 640, (n_rigs, d, 2)).astype(np.float32)
    uvd, valid, centers = (torch.as_tensor(a, device=cuda_device)
                           for a in (uvd, valid, centers))
    for lead in (slice(None), 0):                  # 2 rigs: 4 slices; 1: 32
        args = (uvd[lead].contiguous(), valid[lead].contiguous(),
                centers[lead].contiguous())
        got = cuda_knn.knn_median_depth_centers_cuda(*args, k)
        torch.cuda.synchronize()
        ref = cuda_knn.knn_median_depth_plain(*args, k)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # one slice a rig (the rigs fill the card): every chunk in one block
    many = 140
    assert cuda_knn.knn_split(many, p, d, k)[0] == 1
    got = cuda_knn.knn_median_depth_centers_cuda(
        uvd[:1].expand(many, p, 3).contiguous(),
        valid[:1].expand(many, p).contiguous(),
        centers[:1].expand(many, d, 2).contiguous(), k)
    assert torch.equal(got[7], cuda_knn.knn_median_depth_plain(
        uvd[0], valid[0], centers[0], k))


# ---- the grid and carve kernels with their epilogue (run gate + int8
# export), against the twins followed by rasterize.gate_and_export

GRID_SHAPES = {(500, 200): {},
               (150, 50): dict(grid_x=30, grid_y=10, resolution=0.2),
               (103, 33): dict(grid_x=31, grid_y=10, resolution=0.3)}


def _epilogue_case(rng, rigs, hw, n_boxes, device):
    """numpy-seeded log-odds, previous occupancy (each rig's first four
    cells on halves of the export's unit), a gate with every other rig off
    (rig 0 on), box ranges of n_boxes footprints (the first eight on one
    spot), the carve's profile and maps: the inputs of both gated
    kernels."""
    cfg = GridVisionConfig(**GRID_SHAPES[hw])
    lo = rng.uniform(-2, 3.6, (rigs,) + hw).astype(np.float32)
    prev = rng.random((rigs,) + hw).astype(np.float32)
    prev[:, 0, :4] = [0.125, 0.375, 0.625, 0.875]
    gate = np.arange(rigs) % 2 == 0
    n = max(n_boxes, 1)
    pos = np.zeros((rigs, n, 3), np.float32)
    cx = cfg.grid_center[0]
    pos[..., 0] = rng.uniform(cx - 0.6 * cfg.grid_x, cx + 0.6 * cfg.grid_x,
                              (rigs, n))
    pos[..., 1] = rng.uniform(-0.6 * cfg.grid_y, 0.6 * cfg.grid_y, (rigs, n))
    pos[:, :8] = pos[:, :1]
    poses = dataclasses.replace(
        LShapePoses.empty(n, device=device),
        position=torch.as_tensor(pos, device=device),
        length=torch.as_tensor(rng.uniform(0.3, 6, (rigs, n)).astype(
            np.float32), device=device),
        width=torch.as_tensor(rng.uniform(0.3, 3, (rigs, n)).astype(
            np.float32), device=device),
        valid=torch.ones((rigs, n), dtype=torch.bool, device=device))
    box = cuda_grid.box_index_ranges(poses, cfg)[:, :n_boxes].contiguous()
    origin = torch.tensor([1.5, 0.0], device=device)
    pts, valid = _scan(rng, (rigs,), 2000, device)
    ranges = raycast.range_profile(origin, pts, valid)
    cbin, cr = raycast.cell_polar_maps(origin, cfg)
    t = lambda a: torch.as_tensor(a, device=device)           # noqa: E731
    return cfg, t(lo), t(prev), t(gate), box, ranges, cbin, cr


def _gated(kernel, cfg, lo, prev, gate, box, ranges, cbin, cr):
    """(kernel outputs, plain outputs) of the grid or the carve kernel."""
    if kernel == "grid":
        got = cuda_grid.grid_update_gated(lo, box, gate, prev, cfg)
        plain = cuda_grid.grid_update_plain(lo, box, cfg)
    else:
        got = cuda_raycast.fused_carve_update_gated(lo, box, ranges, cbin,
                                                    cr, gate, prev, cfg)
        plain = cuda_raycast.carve_update_plain(lo, box, ranges, cbin, cr,
                                                cfg)
    return got, rasterize.gate_and_export(*plain, gate, lo, prev)


def _assert_epilogue_equal(got, ref):
    assert got[2].dtype == torch.int8
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-7)
    assert torch.equal(got[2], ref[2])


@pytest.mark.cuda
@pytest.mark.parametrize("n_boxes", [0, 64])
@pytest.mark.parametrize("hw", list(GRID_SHAPES))
@pytest.mark.parametrize("rigs", [1, 3, 64])
@pytest.mark.parametrize("kernel", ["grid", "carve"])
def test_gated_kernels_bit_equal_to_the_plain_path(cuda_device, kernel, rigs,
                                                   hw, n_boxes):
    """Log-odds and occupancy_i8 bit-equal, occupancy atol 1e-7, with every
    other rig gated off; (150, 50) straddles rows with 16-byte vectors,
    (103, 33) takes the scalar path. One launch a call; two calls on one
    stream without a sync in between give the same outputs."""
    rng = np.random.default_rng(rigs * 7 + hw[1] + n_boxes)
    args = _epilogue_case(rng, rigs, hw, n_boxes, cuda_device)
    mod = cuda_grid if kernel == "grid" else cuda_raycast
    n0 = mod.launches
    got, ref = _gated(kernel, *args)
    again, _ = _gated(kernel, *args)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 2
    _assert_epilogue_equal(got, ref)
    _assert_epilogue_equal(again, ref)
    cfg, lo, prev, gate, box, ranges, cbin, cr = args
    assert torch.equal(got[0][~gate], lo[~gate])
    if rigs > 1:
        assert got[2][1, 0, :4].tolist() == [12, 38, 62, 88]
    if kernel == "carve":
        # an all-invalid scan carves nothing: the grid kernel's three outputs
        none, _ = _gated("carve", cfg, lo, prev, gate, box,
                         torch.zeros_like(ranges), cbin, cr)
        hit, _ = _gated("grid", *args)
        assert all(torch.equal(a, b) for a, b in zip(none, hit))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grid", "carve"])
def test_gated_kernels_on_unaligned_grids(cuda_device, kernel):
    """Grids that start 4 bytes past a 16-byte boundary take the scalar
    path, with the same outputs."""
    rng = np.random.default_rng(21)
    cfg, lo, prev, gate, box, ranges, cbin, cr = _epilogue_case(
        rng, 3, (500, 200), 8, cuda_device)
    lo_u = torch.empty(lo.numel() + 1, device=cuda_device)[1:].view(lo.shape)
    lo_u.copy_(lo)
    got, ref = _gated(kernel, cfg, lo_u, prev, gate, box, ranges, cbin, cr)
    torch.cuda.synchronize()
    _assert_epilogue_equal(got, ref)


@pytest.mark.cuda
def test_gated_wrappers_reject_bad_epilogue_inputs(cuda_device):
    rng = np.random.default_rng(22)
    cfg, lo, prev, gate, box, ranges, cbin, cr = _epilogue_case(
        rng, 3, (500, 200), 8, cuda_device)
    for g, p, match in ((gate.int(), prev, "gate"),
                        (gate[:2], prev, "gate"),
                        (gate.cpu(), prev, "gate"),
                        (gate, prev.double(), "occ_prev"),
                        (gate, prev[:, :-1], "occ_prev"),
                        (gate, prev.transpose(1, 2), "occ_prev")):
        with pytest.raises(ValueError, match=match):
            cuda_grid.grid_update_gated(lo, box, g, p, cfg)
        with pytest.raises(ValueError, match=match):
            cuda_raycast.fused_carve_update_gated(lo, box, ranges, cbin, cr,
                                                  g, p, cfg)


# ---- the bf16 forms (compute_dtype="bfloat16") ---------------------------

BF = torch.bfloat16


def _bf16_hold(got, ref):
    """A bf16 form against its twin: the JAX package's bf16 kernel bar
    (rtol = atol = 0.06) and >= 99 % of the elements bit-equal."""
    assert got.dtype == ref.dtype == BF
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.06,
                               atol=0.06)
    assert (got == ref).float().mean().item() >= 0.99


def _frames8(rng, shape, device):
    return torch.as_tensor(rng.integers(0, 256, shape).astype(np.float32),
                           device=device).to(BF)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w,size", [(1, 480, 640, 416),
                                            (64, 480, 640, 416),
                                            (3, 200, 260, 148),
                                            (3, 480, 640, 416),
                                            (2, 120, 160, 150),
                                            (2, 100, 130, 68)])
def test_stem_bf16_kernel_matches_twin(cuda_device, batch, h, w, size):
    """1, 3 and 64 frames at the ticks' shapes, and unaligned sizes: ragged
    conv1 tiles, an odd conv0 output (ConvBN_1 pads (1, 1)), frame rows
    that do not start on a 16-byte boundary (130 x 3 bf16)."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_stem.prepare_stem_constants(det, BF)
    img = _frames8(np.random.default_rng(batch), (batch, h, w, 3),
                   cuda_device)
    n0 = cuda_stem.launches_bf16
    got = cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    assert cuda_stem.launches_bf16 == n0 + 1
    _bf16_hold(got, cuda_stem.detector_stem_plain(img, consts, size))


@pytest.mark.cuda
def test_stem_bf16_kernel_one_launch_and_batch_independent(cuda_device):
    """One launch a call; a frame's result does not depend on its place in
    the batch (the persistent blocks walk the tiles of every frame); a
    frame patch too large for a block, and frames off a 16-byte boundary,
    raise before anything runs."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_stem.prepare_stem_constants(det, BF)
    img = _frames8(np.random.default_rng(5), (5, 480, 640, 3), cuda_device)
    n0 = cuda_stem.launches_bf16
    got = cuda_stem.detector_stem_cuda(img, consts, 416)
    one = cuda_stem.detector_stem_cuda(img[3:4].contiguous(), consts, 416)
    torch.cuda.synchronize()
    assert cuda_stem.launches_bf16 == n0 + 2
    assert torch.equal(one[0], got[3])
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stem.detector_stem_cuda(
            torch.zeros((1, 2160, 3840, 3), dtype=BF, device=cuda_device),
            consts, 416)
    flat = torch.zeros(96 * 128 * 3 + 1, dtype=BF, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_stem.detector_stem_cuda(flat[1:].view(1, 96, 128, 3), consts,
                                     64)
    assert cuda_stem.launches_bf16 == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,atol", [
    (64, 16, 64, 1e-5), (128, 288, 64, 1e-5), (192, 64, 64, 1e-5),
    (64, 432, 128, 1e-4), (128, 432, 32, 1e-4), (192, 48, 96, 1e-4),
    (64, 16, 32, 1e-5), (128, 288, 32, 1e-5), (64, 576, 64, 1e-4),
    (128, 96, 96, 1e-5), (64, 576, 96, 1e-4)])
def test_wgmma_product_matches_f32_matmul(cuda_device, m, k, n, atol):
    """The bf16 kernels' wgmma path alone (B laid out by
    pack_wgmma_b_halves, at N = 64 pack_wgmma_b's layout as the stem's
    conv1 and the CSP stage's ConvBN_2 and 1x1 have it, 64 channels a
    product; at N = 32 and 96 pack_wgmma_b's layout on m64n32k16 /
    m64n96k16, the latter as the CSP stage's conv a and conv b have it;
    brought in by cp.async.bulk; A from
    registers in its k order) against torch.matmul in f32 of the same bf16
    operands: the products are exact, only the order of the f32 sums
    differs."""
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randn((m, k), generator=g, device=cuda_device).to(BF).float()
    b = torch.randn((k, n), generator=g, device=cuda_device).to(BF).float()
    got = cuda_orient.wgmma_product_bf16_cuda(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, torch.matmul(a, b), rtol=1e-5,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w", [(1, 104, 104), (64, 104, 104),
                                       (2, 38, 38), (3, 37, 53),
                                       (2, 18, 22), (1, 105, 31),
                                       (5, 104, 104)])
def test_csp_bf16_kernel_matches_twin(cuda_device, batch, h, w):
    """The tick's shapes (1 and 64 frames: bands of one pooled row, one
    band a strip), the tests' 38 x 38, odd and non-square frames (pool by
    floor; a last strip narrower than 52 columns), a few-frame band plan;
    one launch a call."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_csp.prepare_csp_constants(det, BF)
    g = torch.Generator(device=cuda_device).manual_seed(batch)
    x = (torch.rand((batch, h, w, 64), generator=g, device=cuda_device)
         * 4).to(BF)
    n0 = cuda_csp.launches_bf16
    with torch.no_grad():
        got = cuda_csp.detector_csp_cuda(x, det, consts)
        torch.cuda.synchronize()
        ref = cuda_csp.detector_csp_plain(x, det, consts)
    assert cuda_csp.launches_bf16 == n0 + 1
    assert got.shape == (batch, h // 2, w // 2, 128)
    _bf16_hold(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w", [(1, 104, 104), (2, 38, 38),
                                       (3, 37, 53), (2, 18, 22),
                                       (1, 5, 7), (7, 104, 104),
                                       (20, 104, 104)])
def test_csp_bf16_kernel_bit_equal_on_exact_data(cuda_device, batch, h, w):
    """Where every f32 sum is exact (tests/test_torch_csp_bf16.py
    exact_constants) the kernel equals the twin bit for bit, whatever the
    order of its sums: any slip of a ring row, tap, swizzle, mask or
    fragment shows as a difference. The twin runs on the CPU (cuDNN may
    pick a Winograd or FFT conv, which is not exact)."""
    from .test_torch_csp_bf16 import exact_constants, exact_input
    cpu = exact_constants(batch + h + w)
    consts = {k: v.to(cuda_device) if torch.is_tensor(v) else v
              for k, v in cpu.items()}
    x = exact_input((batch, h, w, 64), h * w)
    got = cuda_csp.detector_csp_cuda(x.to(cuda_device), None, consts).cpu()
    ref = cuda_csp._csp_plain_bf16(x, cpu)
    assert torch.equal(got, ref), (
        f"{int((got != ref).sum())} of {got.numel()} differ; rows "
        f"{sorted(set((got != ref).nonzero()[:, 1].tolist()))[:20]}, "
        f"columns {sorted(set((got != ref).nonzero()[:, 2].tolist()))[:20]}"
        f", channels {sorted(set((got != ref).nonzero()[:, 3].tolist()))}")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,h,w", [(1, 104, 104), (64, 104, 104),
                                       (5, 104, 104), (2, 38, 38),
                                       (3, 37, 53), (200, 104, 104)])
def test_csp_bf16_plan_is_the_kernels(cuda_device, batch, h, w):
    """cuda_csp.csp_bf16_plan is the kernel's own plan at the card's SM
    count, and its block is resident (one an SM)."""
    sms, plan = cuda_csp.bf16_plan_on_card(batch, h, w)
    assert plan[:4] == tuple(cuda_csp.csp_bf16_plan(batch, h, w, sms))
    assert plan[5] == 1


@pytest.mark.cuda
def test_csp_bf16_one_launch_and_unaligned_frames(cuda_device):
    """One kernel in the profiler a call (and one count); an activation
    off a 16-byte boundary raises before anything runs; an empty output
    launches nothing."""
    from torch.profiler import ProfilerActivity, profile
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    consts = cuda_csp.prepare_csp_constants(det, BF)
    x = torch.rand((2, 38, 38, 64), device=cuda_device).to(BF)
    cuda_csp.detector_csp_cuda(x, det, consts)
    torch.cuda.synchronize()
    n0 = cuda_csp.launches_bf16
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_csp.detector_csp_cuda(x, det, consts)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "gv_" in e.name]
    assert len(names) == 1 and "gv_csp_bf16_kernel" in names[0]
    assert cuda_csp.launches_bf16 == n0 + 1
    flat = torch.zeros(38 * 38 * 64 + 4, dtype=BF, device=cuda_device)
    assert flat[4:].data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte"):
        cuda_csp.detector_csp_cuda(flat[4:].view(1, 38, 38, 64), det,
                                   consts)
    assert cuda_csp.launches_bf16 == n0 + 1
    empty = cuda_csp.detector_csp_cuda(x[:, :1].contiguous(), det, consts)
    assert empty.shape == (2, 0, 19, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("rigs,n", [(1, 7), (64, 320)])
def test_orient_bf16_kernel_matches_twin(cuda_device, rigs, n):
    """Clamped, tiny and invalid boxes over 1 and 64 frames; an invalid
    crop gives relu(t) rounded once."""
    cfg = GridVisionConfig(vision_weights_file="weights/orientation.npz")
    net = weights.load_all(cfg, device=cuda_device)["orientation"]
    consts = cuda_orient.prepare_orient_constants(net, BF)
    rng = np.random.default_rng(rigs)
    images = _frames8(rng, (rigs, 480, 640, 3), cuda_device)
    x0 = rng.uniform(-40, 600, n)
    y0 = rng.uniform(-40, 440, n)
    xyxy = np.stack([x0, y0, x0 + rng.uniform(8, 300, n),
                     y0 + rng.uniform(8, 250, n)], -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    valid[0] = False
    rig = np.sort(rng.integers(0, rigs, n)).astype(np.int32)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (xyxy, valid, rig)]
    n0 = cuda_orient.launches_bf16
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, *args, net, consts, 224)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, *args, net, 224, consts)
    assert cuda_orient.launches_bf16 == n0 + 1
    assert got.shape == (n, 28, 28, 128)
    _bf16_hold(got, ref)
    assert torch.equal(got[0], torch.relu(consts["t"]).to(BF).expand(
        28, 28, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 96, 224])
@pytest.mark.parametrize("f", [32, 64, 128])
def test_orient_bf16_plan_is_the_kernels(cuda_device, size, f):
    """orient_bf16_plan (the wrapper's refusal) is the kernel's own plan,
    and at least one cluster of it is resident on the card."""
    plan = cuda_orient.bf16_plan_on_card(size, f)
    assert plan[:6] == cuda_orient.orient_bf16_plan(size, f)
    assert plan[6] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("size,width,h,w", [(64, 8, 96, 128),
                                            (96, 16, 120, 160),
                                            (224, 32, 480, 640),
                                            (224, 16, 480, 640),
                                            (64, 32, 50, 60),
                                            (64, 8, 61, 83),
                                            (224, 8, 300, 401)])
@pytest.mark.parametrize("rig_dtype", [torch.int32, torch.int64])
def test_orient_bf16_kernel_other_sizes_and_widths(cuda_device, size, width,
                                                   h, w, rig_dtype):
    """Sizes 64, 96 and 224 (clusters of 1 and 4 blocks) at F = 32, 64
    and 128 on a randomly initialized net with non-trivial BN; clamped,
    sliver and invalid boxes, frames of an odd width, and 3 frames of odd
    height and width (the last pixel of the last frame, which boxes 4 and
    5 tap, ends at an even element); int32 and int64 rigs; one launch a
    call; an all-invalid batch gives relu(t)."""
    torch.manual_seed(size + width)
    net = orientation_net.OrientationNetS2D(orientation_net.OrientationConfig(
        input_size=size, width=width)).eval()
    bn = net.ConvBN_0.BatchNorm_0
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.5)
        bn.running_mean.normal_(0, 0.3)
        bn.running_var.uniform_(0.5, 2.0)
    net = net.to(cuda_device)
    consts = cuda_orient.prepare_orient_constants(net, BF)
    rng = np.random.default_rng(size + width)
    images = _frames8(rng, (3, h, w, 3), cuda_device)
    xyxy = torch.tensor([[-10.0, -6, 50, 40], [20, 10, 48, 45],
                         [20.2, 20.7, 26.4, 25.1], [5, 5, 30, 30],
                         [w - 30.0, h - 20, w + 40, h + 30],
                         [0, 0, w, h], [7, 9, 7.3, 9.4]],
                        device=cuda_device)
    valid = torch.tensor([True, True, True, False, True, True, True],
                         device=cuda_device)
    rig = torch.tensor([0, 1, 1, 0, 2, 2, 1], dtype=rig_dtype,
                       device=cuda_device)
    n0 = cuda_orient.launches_bf16
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, size)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             size, consts)
        none = cuda_orient.orient_front_cuda(
            images, xyxy, torch.zeros_like(valid), rig, net, consts, size)
        torch.cuda.synchronize()
    assert cuda_orient.launches_bf16 == n0 + 2
    q = size // 8
    assert got.shape == (7, q, q, 4 * width)
    # the sliver (row 6) is a flat crop: held to finiteness
    _bf16_hold(got[:6], ref[:6])
    assert torch.isfinite(got[6].float()).all()
    relu_t = torch.relu(consts["t"]).to(BF).expand(q, q, 4 * width)
    assert torch.equal(got[3], relu_t)
    assert torch.equal(none, relu_t.expand_as(none))


@pytest.mark.cuda
def test_orient_bf16_kernel_frames_off_a_16_byte_boundary(cuda_device):
    """bf16 frames need only start at a 4-byte boundary: the second of two
    375 x 1242 frames (4 bytes past one) gives what its copy gives, bit for
    bit, and agrees with the twin at the JAX package's bf16 bar; frames 2
    bytes past a boundary are refused. (The >= 99 % bit-equal share is held
    where there are enough crops for it to be a share of many: at two
    crops it is one crop's moments rounding as the twin's or not.)"""
    cfg = GridVisionConfig(vision_weights_file="weights/orientation.npz")
    net = weights.load_all(cfg, device=cuda_device)["orientation"]
    consts = cuda_orient.prepare_orient_constants(net, BF)
    images = _frames8(np.random.default_rng(3), (2, 375, 1242, 3),
                      cuda_device)
    view = images[1:]
    assert view.data_ptr() % 16 == 4
    xyxy = torch.tensor([[100.0, 50, 400, 300], [900, 200, 1300, 400]],
                        device=cuda_device)
    valid = torch.ones(2, dtype=torch.bool, device=cuda_device)
    rig = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(view, xyxy, valid, rig, net,
                                            consts, 224)
        want = cuda_orient.orient_front_cuda(view.clone(), xyxy, valid, rig,
                                             net, consts, 224)
        ref = cuda_orient.orient_front_plain(view, xyxy, valid, rig, net,
                                             224, consts)
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.06,
                               atol=0.06)
    odd = images.view(-1)[1:1 + 375 * 1242 * 3].view(1, 375, 1242, 3)
    with pytest.raises(ValueError, match="4-byte"):
        cuda_orient.orient_front_cuda(odd, xyxy, valid, rig, net, consts,
                                      224)


@pytest.mark.cuda
def test_bf16_forms_raise_on_f32_inputs(cuda_device):
    """A bf16 form takes bf16 frames and activations, and raises on f32
    (it converts nothing silently)."""
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz",
                           vision_weights_file="weights/orientation.npz")
    nets = weights.load_all(cfg, device=cuda_device)
    det, net = nets["detector"], nets["orientation"]
    frames = torch.zeros((1, 96, 128, 3), device=cuda_device)
    with pytest.raises(ValueError, match="images must be"):
        cuda_stem.detector_stem_cuda(
            frames, cuda_stem.prepare_stem_constants(det, BF), 64)
    with pytest.raises(ValueError, match="x must be"):
        cuda_csp.detector_csp_cuda(
            torch.zeros((1, 16, 16, 64), device=cuda_device), det,
            cuda_csp.prepare_csp_constants(det, BF))
    box = torch.tensor([[0.0, 0.0, 50.0, 50.0]], device=cuda_device)
    with pytest.raises(ValueError, match="images must be"):
        cuda_orient.orient_front_cuda(
            frames, box, torch.ones(1, dtype=torch.bool, device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device), net,
            cuda_orient.prepare_orient_constants(net, BF), 64)


# -- the parallel layer on one card ------------------------------------------

SMALL_FLEET = dict(camera_image_height=96, camera_image_width=128,
                   detection_network_input_size=64, network_height=64,
                   network_width=64, orientation_width=8, fx=64.0, fy=64.0,
                   cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
                   resolution=0.25, max_static_depth=16,
                   detector_stem_backend="pallas2",
                   orientation_stem_backend="pallas", grid_backend="pallas",
                   knn_backend="pallas")


def _fleet_parts(dev, rigs, **kw):
    from grid_vision_tpu_torch.runtime.stream import FleetPool
    cfg = GridVisionConfig(**SMALL_FLEET, **kw)
    nets = weights.load_all(cfg, seed=3, device=dev)
    return cfg, nets, FleetPool(cfg, rigs, device=dev).obs(0)


@pytest.mark.cuda
def test_fleet_two_logical_shards_on_one_card(cuda_device):
    """RigMesh([cuda:0, cuda:0]): compacted_step is two Engine.fleet calls
    of half the rigs at half the budget each; __call__ runs the two shards
    as one batch (each kernel once a tick)."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.parallel import Fleet, RigMesh
    cfg, nets, obs = _fleet_parts(cuda_device, 4)
    fleet = Fleet(cfg, 4, mesh=RigMesh([cuda_device] * 2), params=nets)
    eng = pipeline.Engine(cfg, params=nets, device=cuda_device)
    states = fleet.init_states()
    s_c, o_c = fleet.compacted_step(states, obs, budget_per_rig=1)
    halves = [eng.fleet(states.select(slice(a, a + 2)),
                        obs.select(slice(a, a + 2)), 2) for a in (0, 2)]
    assert torch.equal(s_c.log_odds, torch.cat([h[0].log_odds
                                                for h in halves]))
    assert torch.equal(o_c.occupancy_i8, torch.cat([h[1].occupancy_i8
                                                    for h in halves]))
    n0 = cuda_stem.launches
    s_1, o_1 = fleet(states, obs)
    torch.cuda.synchronize()
    assert cuda_stem.launches == n0 + 1
    s_ref, o_ref = eng.fleet(states, obs)
    assert torch.equal(s_1.log_odds, s_ref.log_odds)
    assert torch.equal(o_1.occupancy_i8, o_ref.occupancy_i8)


@pytest.mark.cuda
def test_multi_fleet_streams_equal_fleets_alone(cuda_device):
    """Two fleets (f32, bf16) on one card, each on its own stream: step_all
    equals each fleet stepped alone on the caller's stream, twice over."""
    from grid_vision_tpu_torch.parallel import MultiFleet, RigMesh
    cfg, nets, obs = _fleet_parts(cuda_device, 2)
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    mf = MultiFleet([cfg, bf], 2, mesh=RigMesh([cuda_device] * 2),
                    params_list=[nets, nets])
    caller = torch.cuda.current_stream(cuda_device)
    assert all(s is not None and s != caller for s in mf.streams)
    obs_bf = dataclasses.replace(obs, image=obs.image.to(torch.bfloat16))
    states = mf.init_states()
    alone = [f.init_states(100 * i) for i, f in enumerate(mf.fleets)]
    for _ in range(2):
        states, outs = mf.step_all(states, [obs, obs_bf])
        refs = [f(s, o) for f, s, o in zip(mf.fleets, alone, [obs, obs_bf])]
        alone = [r[0] for r in refs]
        for s, o, (rs, ro) in zip(states, outs, refs):
            assert torch.equal(s.log_odds, rs.log_odds)
            assert torch.equal(o.occupancy_i8, ro.occupancy_i8)
            assert torch.equal(o.boxes.valid, ro.boxes.valid)


# --- training and evaluation on the card (train/) ---------------------------

def _sync_free(torch_mod):
    """A context that fails on any host sync of the card."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        torch_mod.cuda.synchronize()
        torch_mod.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch_mod.cuda.set_sync_debug_mode("default")
    return ctx()


@pytest.mark.cuda
def test_render_and_targets_on_card_equal_cpu(cuda_device):
    """The rendered batch drawn on the card: boxes, labels, valid and the
    dense targets bit-equal to the CPU's, the pixels to 1e-3; no host
    sync once the device constants are there."""
    from grid_vision_tpu_torch.models.yolov4_tiny import YoloConfig
    from grid_vision_tpu_torch.train import synth_data
    from grid_vision_tpu_torch.utils import prng
    cfg = YoloConfig(input_size=128)
    key, card_key = prng.prng_key(3), prng.prng_key(3, device=cuda_device)
    synth_data.make_batch_on_device(card_key, 2, cfg, (96, 128))
    with _sync_free(torch):
        got = synth_data.make_batch_on_device(card_key, 6, cfg, (96, 128))
    want = synth_data.make_batch_on_device(key, 6, cfg, (96, 128))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)
    img, boxes, labels, valid = synth_data.render_image(
        prng.split(card_key, 4), 96, 128)
    ref = synth_data.render_image(prng.split(key, 4), 96, 128)
    assert torch.equal(boxes.cpu(), ref[1])
    assert torch.equal(labels.cpu(), ref[2])
    assert torch.equal(valid.cpu(), ref[3])
    torch.testing.assert_close(img.cpu(), ref[0], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["yolo", "multibin"])
def test_train_steps_on_card_without_host_sync(cuda_device, kind):
    """f32 on the card against the CPU from the same weights and batch: one
    train-mode forward and backward, the loss and aux to rtol 1e-5, the
    new batch statistics to atol 1e-5 and every gradient to atol 1e-5 /
    rtol 1e-4 (the bars of tests/test_torch_train_losses.py); then three
    train steps, the second and third under set_sync_debug_mode("error"),
    their losses to rtol 1e-4 of the CPU's."""
    import copy
    from grid_vision_tpu_torch.models.orientation_net import OrientationConfig
    from grid_vision_tpu_torch.models.yolov4_tiny import YoloConfig
    from grid_vision_tpu_torch.train import fit_orientation, synth_data
    from grid_vision_tpu_torch.train import trainer
    from grid_vision_tpu_torch.utils import prng
    if kind == "yolo":
        cfg = YoloConfig(input_size=64, compute_dtype=torch.float32)
        batch = synth_data.make_batch_on_device(prng.prng_key(1), 4, cfg,
                                                (96, 128))
    else:
        cfg = OrientationConfig(input_size=32, width=8, s2d_fold=False,
                                compute_dtype=torch.float32)
        crops, tgt_bin, off = fit_orientation.render_crop(
            prng.split(prng.prng_key(1), 8), 32)
        batch = (crops, torch.zeros((8, 3)), tgt_bin, off)
    schedule = trainer.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 10)
    tx = trainer.AdamW(schedule, weight_decay=1e-5)
    cpu_state = trainer.init_train_state(kind, cfg, tx, prng.prng_key(0))
    loss_fn = trainer._loss_fn(kind, cfg)

    grads = []
    for dev in ("cpu", cuda_device):
        model = copy.deepcopy(cpu_state.model).to(dev)
        loss, (mutated, aux) = loss_fn(model, *[x.to(dev) for x in batch],
                                       train=True)
        loss.backward()
        grads.append((loss.item(), {k: v.item() for k, v in aux.items()},
                      {k: v.cpu() for k, v in mutated.items()},
                      {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (cl, caux, cstats, cgrad), (gl, gaux, gstats, ggrad) = grads
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    assert gaux.keys() == caux.keys()
    for k, v in caux.items():
        np.testing.assert_allclose(gaux[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert gstats.keys() == cstats.keys()
    for k, v in cstats.items():
        torch.testing.assert_close(gstats[k], v, rtol=0, atol=1e-5, msg=k)
    assert ggrad.keys() == cgrad.keys()
    for k, v in cgrad.items():
        torch.testing.assert_close(ggrad[k], v, rtol=1e-4, atol=1e-5, msg=k)

    runs = []
    for dev in ("cpu", cuda_device):
        tx = trainer.AdamW(schedule, weight_decay=1e-5)
        state = trainer.init_train_state(kind, cfg, tx,
                                         prng.prng_key(0, device=dev))
        step = trainer.make_train_step(kind, cfg, tx)
        b = [x.to(dev) for x in batch]
        losses = []
        for i in range(3):
            if dev == "cpu" or i == 0:
                state, m = step(state, *b)
            else:
                with _sync_free(torch):
                    state, m = step(state, *b)
            losses.append(m["loss"])
        runs.append([x.item() for x in losses])
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-4)


@pytest.mark.cuda
def test_eval_map_on_card_equals_cpu(cuda_device):
    """evaluate_detector with the shipped weights on 8 synth frames: the
    card's pallas2 path (stem and CSP kernels) and its plain path give the
    CPU's mAP@0.5 within 1e-3 and its prediction count within 2 (at the
    eval confidence of 0.05 a box near it may cross on another device's
    rounding)."""
    from grid_vision_tpu_torch.train import eval_map
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    res = {}
    for dev, backend in (("cpu", "xla"), (cuda_device, "xla"),
                         (cuda_device, "pallas2")):
        c = dataclasses.replace(cfg, detector_stem_backend=backend)
        nets = weights.load_all(c, device=dev)
        res[str(dev), backend] = eval_map.evaluate_detector(
            nets, c, n_images=8, source="synth")
    ref = res["cpu", "xla"]
    for key, r in res.items():
        assert abs(r.n_pred - ref.n_pred) <= 2, (key, r.to_dict())
        assert abs(r.map50 - ref.map50) <= 1e-3, (key, r.to_dict())


_DEFAULT_FLAGS_TICK = r"""
import sys
import numpy as np
import torch
from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.demo import default_extrinsics
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.runtime.stream import obs_from_scene
if sys.argv[2] == "off":
    torch.backends.cudnn.allow_tf32 = False
cfg = GridVisionConfig(detection_weights_file="weights/detector.npz",
                       vision_weights_file="weights/orientation.npz",
                       detector_stem_backend="pallas")
eng = pipeline.Engine(cfg, extrinsics=default_extrinsics("cuda"))
scene = SyntheticScene(cfg, seed=0)
scene.add_default_traffic()
state, out = eng(eng.init_state(), obs_from_scene(scene, 0.0, cfg, "cuda"))
np.savez(sys.argv[1], lo=state.log_odds.cpu().numpy(),
         occ=out.occupancy_i8.cpu().numpy(), box=out.boxes.xyxy.cpu().numpy(),
         pos=out.poses.position.cpu().numpy(),
         legacy=np.asarray(torch.backends.cudnn.allow_tf32))
"""


@pytest.mark.cuda
def test_f32_tick_bit_equal_under_default_flags(cuda_device, tmp_path):
    """An f32 Engine tick in a process that leaves torch's TF32 flags at
    their defaults equals the tick of a process that turns them off, bit
    for bit (device.ieee_convs scopes the convs), and leaves the legacy
    flag readable."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = {}
    for flags in ("default", "off"):
        path = str(tmp_path / f"{flags}.npz")
        r = subprocess.run([sys.executable, "-c", _DEFAULT_FLAGS_TICK, path,
                            flags], capture_output=True, text=True,
                           cwd=root, env=dict(os.environ, PYTHONPATH=root),
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        res[flags] = dict(np.load(path))
    assert bool(res["default"]["legacy"]) and not bool(res["off"]["legacy"])
    for k in ("lo", "occ", "box", "pos"):
        np.testing.assert_array_equal(res["default"][k], res["off"][k],
                                      err_msg=k)


@pytest.mark.cuda
def test_bench_chunk_digest_equals_engine_fleet(cuda_device):
    """One chunk of the bench (bench.py's configuration at 8 rigs, 2 ticks)
    equals the same perturbed observations through Engine.fleet: digest
    and grid bit for bit; the bf16 stem once a tick."""
    from grid_vision_tpu_torch import bench, pipeline
    from grid_vision_tpu_torch.utils import prng
    cfg, n_rigs, scan, _, budget = bench.bench_config(
        {"GV_BENCH_RIGS": "8", "GV_BENCH_SCAN": "2"})
    eng = pipeline.Engine(cfg, device=cuda_device)
    pool = bench.build_pool(cfg, n_rigs, cuda_device)
    key = prng.prng_key(100, device=cuda_device)
    n0 = cuda_stem.launches_bf16
    states, acc, _ = bench.run_chunk(eng.params, eng.init_states(n_rigs),
                                     pool, eng.extrinsics, cfg, key, scan,
                                     budget)
    torch.cuda.synchronize()
    assert cuda_stem.launches_bf16 == n0 + scan
    _, sub = prng.split(key)
    bright, jitter = bench.draw_perturbations(sub, scan, n_rigs)
    ref_states, ref = eng.init_states(n_rigs), torch.zeros((),
                                                          device=cuda_device)
    for t in range(scan):
        ref_states, out = eng.fleet(
            ref_states, bench.apply_perturbation(pool, bright[t], jitter[t]),
            budget)
        ref = ref + bench.output_digest(out)
    np.testing.assert_array_equal(acc.cpu().numpy(), ref.cpu().numpy())
    assert torch.equal(states.log_odds, ref_states.log_odds)


def _int8_layers(device):
    from grid_vision_tpu_torch.models import yolov4_int8
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
    return yolov4_int8.quantize_detector(
        weights.load_all(cfg, device=device)["detector"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,size", [(1, 416), (3, 416), (2, 160)])
def test_int8_gemm_bit_equal_to_f64_conv_at_every_layer(cuda_device, batch,
                                                        size):
    """The int8 conv kernel (csrc/cuda_int8.cu) at every layer's shape (the
    19 sites of a forward): mode acc bit-equal to the plain f64 conv on the
    same int8 activations, mode requant bit-equal to requant of it; one
    launch a conv in a forward, which then runs 19."""
    from grid_vision_tpu_torch.models import yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops import cuda_int8
    cfg = GridVisionConfig(detection_weights_file="weights/detector.npz",
                           detection_network_input_size=size)
    det = weights.load_all(cfg, device=cuda_device)["detector"]
    q = yolov4_int8.quantize_detector(det)
    seen = []

    def both(x, site, layer, stride):
        sx = yolov4_int8.act_scale(x)
        xq = yolov4_int8.quantize_act(x, sx)
        acc = yolov4_int8.int8_conv(xq, layer, stride)
        ref = yolov4_int8.int8_conv_plain(xq, layer["wq"], stride)
        assert acc.dtype == torch.int32 and torch.equal(acc, ref), site
        y = yolov4_int8.int8_conv_requant(xq, sx, layer, stride)
        assert torch.equal(y, cuda_int8.int8_conv_requant_plain(
            xq, sx, layer, stride)), site
        seen.append(site)
        return y

    images = torch.rand((batch, size, size, 3), generator=torch.Generator(
        device="cuda").manual_seed(batch), device=cuda_device)
    n0 = yolov4_int8.launches
    yolov4_int8._topology(q, images, yolov4_tiny.YoloConfig(input_size=size),
                          both)
    assert sorted(seen) == sorted(yolov4_int8.LAYERS)
    assert yolov4_int8.launches - n0 == 2 * len(yolov4_int8.LAYERS)
    n0 = yolov4_int8.launches
    boxes, confs = yolov4_int8.forward_int8(
        q, images, yolov4_tiny.YoloConfig(input_size=size))
    assert yolov4_int8.launches - n0 == len(yolov4_int8.LAYERS)
    assert torch.isfinite(boxes).all() and torch.isfinite(confs).all()


@pytest.mark.cuda
@pytest.mark.parametrize("site,shape,stride", [
    ("ConvBN_0", (1, 3, 3, 3), 2),          # M = 4
    ("ConvBN_5", (1, 4, 4, 512), 1),        # M = 16: _int_mm refused it
    ("ConvBN_6", (1, 1, 1, 512), 1),        # M = 1
    ("ConvBN_1", (2, 15, 13, 32), 2),       # odd H and W, stride 2
    ("ConvBN_1", (1, 16, 10, 32), 2),       # stride 2, even: pad (0, 1)
    ("ConvBN_2", (3, 7, 9, 64), 1),         # odd, M = 189 (ragged tile)
    ("ConvBN_9", (1, 5, 3, 384), 1)])
def test_int8_kernel_small_and_odd_shapes(cuda_device, site, shape, stride):
    """Shapes torch._int_mm refused (M <= 16) and odd frames, both modes
    bit-equal to the plain versions; the static forward's 0-d scale."""
    from grid_vision_tpu_torch.ops import cuda_int8
    layer = _int8_layers(cuda_device)[site]
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    xq = torch.randint(-127, 128, shape, generator=g, device=cuda_device,
                       dtype=torch.int8)
    n0 = cuda_int8.launches
    acc = cuda_int8.int8_conv(xq, layer, stride)
    assert torch.equal(acc, cuda_int8.int8_conv_plain(xq, layer["wq"],
                                                      stride))
    for sx in (torch.rand((shape[0], 1, 1, 1), generator=g,
                          device=cuda_device) * 0.1 + 1e-3,
               torch.tensor(0.0123, device=cuda_device)):
        assert torch.equal(
            cuda_int8.int8_conv_requant(xq, sx, layer, stride),
            cuda_int8.int8_conv_requant_plain(xq, sx, layer, stride))
    torch.cuda.synchronize()
    assert cuda_int8.launches == n0 + 3


@pytest.mark.cuda
def test_int8_kernel_rejects_bad_inputs(cuda_device):
    from grid_vision_tpu_torch.ops import cuda_int8
    layer = _int8_layers(cuda_device)["ConvBN_2"]
    xq = torch.zeros((1, 8, 8, 64), dtype=torch.int8, device=cuda_device)
    n0 = cuda_int8.launches
    with pytest.raises(ValueError, match="contiguous"):
        cuda_int8.int8_conv(xq.permute(0, 2, 1, 3), layer, 1)
    with pytest.raises(ValueError, match="int8 or bf16"):
        cuda_int8.int8_conv(xq.float(), layer, 1)
    with pytest.raises(ValueError, match="dtype"):
        cuda_int8.int8_conv(xq, dict(layer, wt=layer["wt"].cpu()), 1)
    with pytest.raises(ValueError, match="1 or 1 elements"):
        cuda_int8.int8_conv_requant(xq, torch.ones(2, device=cuda_device),
                                    layer, 1)
    assert cuda_int8.launches == n0


@pytest.mark.cuda
def test_int8_matmul_bit_equal_to_int_mm(cuda_device):
    """The kernel's GEMM form at tools/bench_int8_mxu.py's default shape
    (M 8192, K 2304, N 256), b given in both layouts."""
    from grid_vision_tpu_torch.ops import cuda_int8
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-127, 127, (8192, 2304), generator=g,
                      device=cuda_device, dtype=torch.int8)
    bt = torch.randint(-127, 127, (256, 2304), generator=g,
                       device=cuda_device, dtype=torch.int8)
    ref = torch._int_mm(a, bt.t())
    assert torch.equal(cuda_int8.int8_matmul(a, bt.t()), ref)
    assert torch.equal(cuda_int8.int8_matmul(a, bt.t().contiguous()), ref)
    assert torch.equal(ref, cuda_int8.int8_matmul_plain(a, bt.t()))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(256, 384, 256), (100, 40, 72),
                                   (8192, 2304, 256)])
def test_bf16_matmul_within_the_cpu_bar(cuda_device, m, k, n):
    """bf16 x bf16 -> f32 on unit-normal inputs within 1e-4 of the f64
    sums at the CPU tests' K (tests/test_torch_int8_kernel.py holds the
    tool's Pallas kernel so), and at the tool's K = 2304 within
    cuda_int8.f32_sum_bound (f32 roundings of sums near 200 alone pass
    1e-4 there)."""
    from grid_vision_tpu_torch.ops import cuda_int8
    g = torch.Generator(device="cuda").manual_seed(k)
    a = torch.randn((m, k), generator=g, device=cuda_device).bfloat16()
    b = torch.randn((k, n), generator=g, device=cuda_device).bfloat16()
    got = cuda_int8.bf16_matmul(a, b)
    assert got.dtype == torch.float32
    err = (got - cuda_int8.bf16_matmul_plain(a, b)).abs()
    if k <= 384:
        assert err.max().item() <= 1e-4
    assert (err <= cuda_int8.f32_sum_bound(a, b)).all()


@pytest.mark.cuda
def test_forward_int8_launches_19_kernels(cuda_device):
    """forward_int8 and forward_int8_static launch the kernel once a conv
    and give the plain conv's outputs bit for bit."""
    from grid_vision_tpu_torch.models import yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops import cuda_int8
    q = _int8_layers(cuda_device)
    ycfg = yolov4_tiny.YoloConfig()
    images = torch.rand((2, 416, 416, 3), generator=torch.Generator(
        device="cuda").manual_seed(7), device=cuda_device)
    scales = yolov4_int8.calibrate_scales(q, [images], ycfg)
    runs = {}
    for name, conv in (("kernel", yolov4_int8.int8_conv_requant),
                       ("plain", cuda_int8.int8_conv_requant_plain)):
        saved = yolov4_int8.int8_conv_requant
        yolov4_int8.int8_conv_requant = conv
        try:
            n0 = cuda_int8.launches
            runs[name] = (yolov4_int8.forward_int8(q, images, ycfg),
                          yolov4_int8.forward_int8_static(q, scales, images,
                                                          ycfg))
            torch.cuda.synchronize()
            launched = cuda_int8.launches - n0
        finally:
            yolov4_int8.int8_conv_requant = saved
        assert launched == (2 * len(yolov4_int8.LAYERS)
                            if name == "kernel" else 0)
    for got, want in zip(runs["kernel"], runs["plain"]):
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)


def _int8_case(shape, n, k, seed, device):
    """Random int8 activations (B, H, W, C) and a random layer of n output
    channels (OIHW wq, its (n, Kp) GEMM matrix wt, scales and bias)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    xq = torch.randint(-127, 128, shape, generator=g, device=device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, c, k, k), generator=g, device=device,
                       dtype=torch.int8)
    kk = k * k * c
    wt = torch.nn.functional.pad(wq.permute(0, 2, 3, 1).reshape(n, kk),
                                 (0, -kk % 16)).contiguous()
    layer = dict(wq=wq, wt=wt,
                 sw=torch.rand(n, generator=g, device=device) * 1e-2 + 1e-4,
                 b=torch.randn(n, generator=g, device=device))
    sx = torch.rand((shape[0], 1, 1, 1), generator=g, device=device) * 0.1
    return xq, layer, sx + 1e-3


def _int8_both_modes(xq, layer, sx, stride):
    from grid_vision_tpu_torch.ops import cuda_int8
    acc = cuda_int8.int8_conv(xq, layer, stride)
    ref = cuda_int8.int8_conv_plain(xq, layer["wq"], stride)
    assert acc.dtype == torch.int32 and torch.equal(acc, ref)
    assert torch.equal(cuda_int8.int8_conv_requant(xq, sx, layer, stride),
                       cuda_int8.requant(ref, sx, layer))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n,k,stride", [
    ((1, 15, 13, 128), 32, 3, 1),       # M 195: a ragged row tile
    ((2, 9, 7, 128), 64, 3, 2),         # odd, stride 2
    ((1, 10, 12, 256), 128, 3, 1),
    ((1, 8, 8, 256), 256, 3, 2),        # N 256, even, stride 2
    ((1, 6, 5, 512), 512, 3, 1),        # N 512: two tiles of 256 or more
    ((2, 7, 7, 128), 40, 3, 1),         # a ragged N
    ((1, 9, 11, 16), 100, 3, 1),        # K 144: a partial stage
    ((1, 13, 13, 48), 72, 3, 2),        # K 432, N 72
    ((3, 11, 9, 64), 128, 1, 1),        # 1x1, M 297
    ((1, 200, 150, 64), 64, 3, 1)])     # 235 tiles: a block walks two
def test_int8_kernel_tile_and_ring_edges(cuda_device, shape, n, k, stride):
    """Row tiles that M does not fill, N tiles of 32 to 256 and ragged N,
    K not a multiple of a 128-byte stage, blocks that walk more than one
    tile: both modes bit-equal to the plain versions."""
    _int8_both_modes(*_int8_case(shape, n, k, sum(shape) + n, cuda_device),
                     stride)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(8, 8), (9, 7), (2, 3), (1, 1), (13, 13)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_int8_im2col_padding_at_every_border(cuda_device, h, w, stride, c):
    """The TMA im2col route (C = 128: a copy a stage; 32, 64: a copy a
    tap into 32- and 64-byte swizzled sub-tiles) against the gather route
    and the plain conv, stride 1 and 2 on even, odd and tiny frames: flax
    SAME's asymmetric padding at every border is the map's bounding box."""
    from grid_vision_tpu_torch.ops import cuda_int8
    xq, layer, sx = _int8_case((2, h, w, c), 64, 3, h * w + stride + c,
                               cuda_device)
    assert cuda_int8.plan_for(xq, layer["wt"], 3, stride).route == "im2col"
    _int8_both_modes(xq, layer, sx, stride)
    with cuda_int8.force_plan(route="gather"):
        _int8_both_modes(xq, layer, sx, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,stride", [(3, 3, 2), (32, 3, 2), (128, 3, 1),
                                        (64, 1, 1), (5, 3, 1)])
@pytest.mark.parametrize("tile_n", [32, 64, 128, 256])
def test_int8_kernel_every_route_and_tile(cuda_device, c, k, stride,
                                          tile_n):
    """Every route a layer can take (ops/cuda_int8.routes_for: runs,
    gather, im2col, tiled, bytes) at every N tile, B = 1 at 13 x 13 and
    3 frames of 9 x 11, bit-equal in both modes; the kernel's ring and
    shared memory equal to the plan's."""
    from grid_vision_tpu_torch.ops import cuda_build, cuda_int8
    lib = cuda_build.load("cuda_int8")
    assert lib.gv_int8_stages(tile_n) == cuda_int8.ring_stages(tile_n)
    assert lib.gv_int8_smem(tile_n) == cuda_int8.smem_bytes(tile_n)
    for shape in ((1, 13, 13, c), (3, 9, 11, c)):
        xq, layer, sx = _int8_case(shape, 96, k, c + tile_n, cuda_device)
        for route in cuda_int8.routes_for(c, k, stride):
            with cuda_int8.force_plan(tile_n=tile_n, route=route):
                _int8_both_modes(xq, layer, sx, stride)
        with cuda_int8.force_plan(tile_n=tile_n):
            _int8_both_modes(xq, layer,
                             torch.tensor(0.0123, device=cuda_device),
                             stride)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 2304, 256), (300, 208, 48),
                                   (300, 200, 48), (20000, 256, 512)])
def test_int8_matmul_routes_bit_equal(cuda_device, m, k, n):
    """The GEMM form by every route it can take (tiled, im2col where K is
    a multiple of 128, gather, bytes; K = 200 rows are no 16-byte pieces:
    bytes only), against torch._int_mm where it takes the shape, and the
    plain version."""
    from grid_vision_tpu_torch.ops import cuda_int8
    g = torch.Generator(device="cuda").manual_seed(m + k)
    a = torch.randint(-127, 127, (m, k), generator=g, device=cuda_device,
                      dtype=torch.int8)
    b = torch.randint(-127, 127, (n, k), generator=g, device=cuda_device,
                      dtype=torch.int8).t()
    ref = cuda_int8.int8_matmul_plain(a, b)
    routes = cuda_int8.routes_for(k, 1, 1)
    assert routes[0] == ("bytes" if k % 16 else "tiled")
    for route in routes:
        with cuda_int8.force_plan(route=route):
            assert torch.equal(cuda_int8.int8_matmul(a, b), ref), route
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        assert torch.equal(torch._int_mm(a, b), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [32, 64])
def test_int8_requant_past_2_24(cuda_device, tile_n):
    """Accumulators beyond 2^24 in magnitude (f32(acc) rounds) in some of
    a warp's chunks and not in others: the epilogue's rounded path and its
    exact one both bit-equal to requant."""
    from grid_vision_tpu_torch.ops import cuda_int8
    xq, layer, sx = _int8_case((2, 6, 6, 128), 64, 3, 5, cuda_device)
    xq.fill_(127)
    xq[0, :, :, :64] = -127
    layer["wq"][:32] = 127
    layer["wt"] = layer["wq"].permute(0, 2, 3, 1).reshape(64, -1).contiguous()
    acc = cuda_int8.int8_conv_plain(xq, layer["wq"], 1)
    assert acc.abs().max().item() > 2 ** 24
    assert (acc.abs() <= 2 ** 24).any()
    with cuda_int8.force_plan(tile_n=tile_n):
        _int8_both_modes(xq, layer, sx, 1)
